"""Model interface for serving: init / forward / prefill / decode.

Port of the decoder-only parts of ``src/repro/models/model.py``.
``build_model(cfg)`` returns an :class:`LM`; the families not ported yet
raise ``NotImplementedError``.  Parameters and caches are plain nested
dicts and lists of tensors with the reference's structure, so
``repro_torch.convert.lm_params_from_jax`` carries the reference's weights
across leaf by leaf.  Everything runs without autograd.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_apply
from repro_torch.models.params import Init
from repro_torch.models.ssm import ssm_dims


# ----------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, n: Optional[int], B: int, T: int,
                device) -> Dict:
    """KV cache for one run of n layers (n=None: unstacked)."""
    lead = () if n is None else (n,)
    shape = lead + (B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _ssm_cache(cfg: ModelConfig, n: Optional[int], B: int, device) -> Dict:
    s = cfg.ssm
    d_inner, H, N = ssm_dims(cfg)
    lead = () if n is None else (n,)
    return {
        "conv": torch.zeros(lead + (B, s.conv_width - 1, d_inner + 2 * N),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros(lead + (B, H, s.head_dim, N), dtype=torch.float32,
                           device=device),
    }


def init_cache(cfg: ModelConfig, B: int, T: int, device="cpu") -> List[Any]:
    """Fixed-capacity decode caches, one entry per run."""
    caches: List[Any] = []
    for run in tf.build_runs(cfg):
        n = run.n if tf.stacked(run, cfg) else None
        if run.kind == "attn_shared":
            caches.append(_attn_cache(cfg, None, B, T, device))
            continue
        make = {"attn": lambda k: _attn_cache(cfg, k, B, T, device),
                "ssm": lambda k: _ssm_cache(cfg, k, B, device)}.get(run.kind)
        if make is None:
            raise NotImplementedError(f"{run.kind!r} caches are not ported "
                                      f"yet (ROADMAP.md)")
        caches.append([make(None) for _ in range(run.n)] if n is None
                      else make(n))
    return caches


def _pad_attn_cache(cache: Dict, T: int) -> Dict:
    """Pad a prefill KV cache out to serving capacity T (seq axis -3)."""
    def pad(x):
        cur = x.shape[-3]
        return x if cur >= T else F.pad(x, (0, 0, 0, 0, 0, T - cur))
    return {"k": pad(cache["k"]), "v": pad(cache["v"])}


def pad_caches(cfg: ModelConfig, caches: List[Any], T: int) -> List[Any]:
    """Grow attention caches from prompt length to decode capacity T.
    SSM states are fixed-size and pass through."""
    out: List[Any] = []
    for run, cache in zip(tf.build_runs(cfg), caches):
        if run.kind in ("attn", "attn_shared"):
            if isinstance(cache, list):
                out.append([_pad_attn_cache(c, T) for c in cache])
            else:
                out.append(_pad_attn_cache(cache, T))
        else:
            out.append(cache)
    return out


# ----------------------------------------------------------------------
# decoder-only LM
# ----------------------------------------------------------------------

class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cpu") -> Dict:
        """Random parameters in ``param_dtype``, drawn from ``generator``
        on ``device`` (``"meta"`` allocates nothing)."""
        with torch.no_grad():
            return tf.init_stack(self.cfg, Init(generator, device))

    def _positions(self, B: int, S: int, device) -> torch.Tensor:
        if self.cfg.mrope:
            raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md)")
        return torch.arange(S, dtype=torch.int32,
                            device=device)[None, :].expand(B, S)

    @torch.no_grad()
    def forward(self, params: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole-sequence forward -> (logits [B,S,V], aux_loss)."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens, cfg.dtype)
        B, S = x.shape[:2]
        h, aux, _ = tf.stack_full(cfg, params, x,
                                  self._positions(B, S, x.device))
        return tf.lm_logits(cfg, params, h), aux

    @torch.no_grad()
    def prefill(self, params: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Any]]:
        """-> (last-token logits [B,V], caches).  Attention caches come back
        sized to the prompt; pad them with :func:`pad_caches`."""
        cfg = self.cfg
        x = embed_apply(params["embed"], tokens, cfg.dtype)
        B, S = x.shape[:2]
        h, _, caches = tf.stack_full(cfg, params, x,
                                     self._positions(B, S, x.device),
                                     collect_cache=True)
        logits = tf.lm_logits(cfg, params, h[:, -1:, :])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(self, params: Dict, token: torch.Tensor,
                    pos: torch.Tensor, caches: List[Any]
                    ) -> Tuple[torch.Tensor, List[Any]]:
        """One token ``[B]`` at positions ``pos [B]`` -> (logits [B,V],
        caches).  The caches are updated in place and returned."""
        cfg = self.cfg
        x = embed_apply(params["embed"], token[:, None], cfg.dtype)
        x, new_caches = tf.stack_decode(cfg, params, x, pos, caches)
        return tf.lm_logits(cfg, params, x)[:, 0], new_caches

    def init_cache(self, B: int, T: int, device="cpu") -> List[Any]:
        return init_cache(self.cfg, B, T, device)


#: leaves the reference casts to the compute dtype at every use
COMPUTE_LEAVES = frozenset({
    "table", "w", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "gate", "up",
    "down", "in_proj", "out_proj", "conv_w", "conv_b"})


def cast_for_compute(cfg: ModelConfig, params: Any, device=None,
                     key: Optional[str] = None) -> Any:
    """The parameter tree on ``device`` with every leaf that the reference
    casts to ``cfg.dtype`` at each use cast once, here; norm scales and the
    SSM's fp32 leaves keep ``param_dtype``.  The values each product sees
    are the same."""
    if isinstance(params, dict):
        return {k: cast_for_compute(cfg, v, device, k)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_for_compute(cfg, v, device, key) for v in params]
    dtype = cfg.dtype if key in COMPUTE_LEAVES else params.dtype
    return params.to(device=device, dtype=dtype)


def build_model(cfg: ModelConfig) -> LM:
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP.md, Queue 1 item 9)")
    for what, unported in (("MoE", cfg.moe), ("MLA", cfg.mla),
                           ("RWKV", cfg.rwkv), ("M-RoPE (VLM)", cfg.mrope)):
        if unported:
            raise NotImplementedError(f"{what} models are not ported yet "
                                      f"(ROADMAP.md, Queue 1 item 9)")
    return LM(cfg)


# ----------------------------------------------------------------------
# parameter counting (no allocation: the meta device)
# ----------------------------------------------------------------------

def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params_from_shapes(cfg: ModelConfig) -> int:
    params = build_model(cfg).init(device="meta")
    return sum(math.prod(t.shape) for t in _leaves(params))


def count_active_params(cfg: ModelConfig) -> int:
    """Params activated per token; equal to the total for the ported
    (dense, hybrid) families."""
    return count_params_from_shapes(cfg)
