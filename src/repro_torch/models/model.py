"""Model interface: init / forward_train / prefill / decode.

Port of ``src/repro/models/model.py``.  ``build_model(cfg)`` returns an
:class:`LM` (decoder stacks, the VLM stub's ``embeds=`` input included) or
an :class:`EncDecModel` (whisper).  Parameters and caches are plain nested
dicts and lists of tensors with the reference's structure, so
``repro_torch.convert.lm_params_from_jax`` carries the reference's weights
across leaf by leaf.  The training entry points (``forward_train``,
``forward_hidden``, ``mtp_logits``) run under autograd; ``forward`` is
``forward_train`` without it, and ``prefill`` and ``decode_step`` never
record a graph.  Parameters and caches are made on the card unless the
caller asks for ``device="cpu"`` (or ``"meta"``, which allocates
nothing); without CUDA that raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_apply, rms_norm
from repro_torch.models.params import Init
from repro_torch.models.rwkv import rwkv_dims
from repro_torch.models.sharding import compute_view, constrain
from repro_torch.tracing import span

#: the activations' logical axes (under a sharding policy)
ACT = ("batch", "seq", "embed_act")
from repro_torch.models.ssm import ssm_dims


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on CUDA and none is available; "
                           "pass device=\"cpu\" to run it on the CPU")
    return device


# ----------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------

def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _attn_cache(cfg: ModelConfig, n: Optional[int], B: int, T: int,
                device) -> Dict:
    """KV (or MLA latent) cache for one run of n layers (n=None:
    unstacked)."""
    lead = () if n is None else (n,)
    if cfg.mla:
        m = cfg.mla
        return {"c_kv": _zeros(lead + (B, T, m.kv_lora_rank), cfg.dtype,
                               device),
                "k_rope": _zeros(lead + (B, T, m.qk_rope_head_dim),
                                 cfg.dtype, device)}
    shape = lead + (B, T, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _zeros(shape, cfg.dtype, device),
            "v": _zeros(shape, cfg.dtype, device)}


def _attn_cache_axes(cfg: ModelConfig, stacked: bool) -> Dict:
    lead = ("layers",) if stacked else ()
    if cfg.mla:
        return {"c_kv": lead + ("batch", "seq", None),
                "k_rope": lead + ("batch", "seq", None)}
    return {"k": lead + ("batch", "seq", "kv_heads", None),
            "v": lead + ("batch", "seq", "kv_heads", None)}


def _ssm_cache(cfg: ModelConfig, n: Optional[int], B: int, device) -> Dict:
    s = cfg.ssm
    d_inner, H, N = ssm_dims(cfg)
    lead = () if n is None else (n,)
    return {
        "conv": _zeros(lead + (B, s.conv_width - 1, d_inner + 2 * N),
                       cfg.dtype, device),
        "ssm": _zeros(lead + (B, H, s.head_dim, N), torch.float32, device),
    }


def _ssm_cache_axes(cfg: ModelConfig, stacked: bool) -> Dict:
    lead = ("layers",) if stacked else ()
    return {"conv": lead + ("batch", None, "mlp"),
            "ssm": lead + ("batch", "heads", None, None)}


def _rwkv_cache(cfg: ModelConfig, n: Optional[int], B: int, device) -> Dict:
    H, N = rwkv_dims(cfg)
    lead = () if n is None else (n,)
    return {
        "time": {"S": _zeros(lead + (B, H, N, N), torch.float32, device),
                 "x_prev": _zeros(lead + (B, cfg.d_model), cfg.dtype,
                                  device)},
        "channel": {"x_prev": _zeros(lead + (B, cfg.d_model), cfg.dtype,
                                     device)},
    }


def _rwkv_cache_axes(cfg: ModelConfig, stacked: bool) -> Dict:
    lead = ("layers",) if stacked else ()
    return {"time": {"S": lead + ("batch", "heads", None, None),
                     "x_prev": lead + ("batch", "embed_act")},
            "channel": {"x_prev": lead + ("batch", "embed_act")}}


def init_cache(cfg: ModelConfig, B: int, T: int, device="cuda"
               ) -> List[Any]:
    """Fixed-capacity decode caches, one entry per run."""
    device = resolve_device(device)
    caches: List[Any] = []
    for run in tf.build_runs(cfg):
        if run.kind == "attn_shared":
            caches.append(_attn_cache(cfg, None, B, T, device))
            continue
        make = {"attn": lambda k: _attn_cache(cfg, k, B, T, device),
                "ssm": lambda k: _ssm_cache(cfg, k, B, device),
                "rwkv": lambda k: _rwkv_cache(cfg, k, B, device)}[run.kind]
        caches.append(make(run.n) if tf.stacked(run, cfg)
                      else [make(None) for _ in range(run.n)])
    return caches


def _pad_attn_cache(cfg: ModelConfig, cache: Dict, T: int) -> Dict:
    """Pad a prefill KV (or MLA latent) cache out to serving capacity T
    along its sequence axis (-3 for K/V, -2 for the latents)."""
    def pad(x, axis):
        cur = x.shape[axis]
        if cur >= T:
            return x
        widths = [0, 0] * (-axis - 1) + [0, T - cur]
        return F.pad(x, widths)

    if cfg.mla:
        return {"c_kv": pad(cache["c_kv"], -2),
                "k_rope": pad(cache["k_rope"], -2)}
    return {"k": pad(cache["k"], -3), "v": pad(cache["v"], -3)}


def pad_caches(cfg: ModelConfig, caches: List[Any], T: int) -> List[Any]:
    """Grow attention caches from prompt length to decode capacity T.
    SSM and RWKV states are fixed-size and pass through."""
    out: List[Any] = []
    for run, cache in zip(tf.build_runs(cfg), caches):
        if run.kind in ("attn", "attn_shared"):
            if isinstance(cache, list):
                out.append([_pad_attn_cache(cfg, c, T) for c in cache])
            else:
                out.append(_pad_attn_cache(cfg, cache, T))
        else:
            out.append(cache)
    return out


def cache_axes(cfg: ModelConfig) -> List[Any]:
    """The logical axes of :func:`init_cache`'s tree."""
    axes: List[Any] = []
    for run in tf.build_runs(cfg):
        stacked = tf.stacked(run, cfg)
        if run.kind == "attn_shared":
            axes.append(_attn_cache_axes(cfg, False))
            continue
        make = {"attn": _attn_cache_axes, "ssm": _ssm_cache_axes,
                "rwkv": _rwkv_cache_axes}[run.kind]
        a = make(cfg, stacked)
        axes.append(a if stacked else [a for _ in range(run.n)])
    return axes


def encdec_cache_axes(cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """The axes of :meth:`EncDecModel.init_cache`: the stacked
    self-attention caches and the cross K/V."""
    kv = ("layers", "batch", None, "kv_heads", None)
    return _attn_cache_axes(cfg, stacked=True), {"k": kv, "v": kv}


# ----------------------------------------------------------------------
# decoder-only LM
# ----------------------------------------------------------------------

class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Dict:
        """Random parameters in ``param_dtype``, drawn from ``generator``
        on ``device`` (``"meta"`` allocates nothing)."""
        with torch.no_grad():
            return tf.init_stack(self.cfg, Init(generator,
                                                resolve_device(device)))

    def logical_axes(self) -> Dict:
        return tf.stack_axes(self.cfg)

    def _positions(self, B: int, S: int, device) -> torch.Tensor:
        """``[B, S]``, or ``[B, 3, S]`` under M-RoPE (text: one id in all
        three channels)."""
        base = torch.arange(S, dtype=torch.int32, device=device)
        if self.cfg.mrope:
            return base[None, None, :].expand(B, 3, S)
        return base[None, :].expand(B, S)

    def _embed(self, params: Dict, tokens, embeds) -> torch.Tensor:
        if embeds is None:
            x = embed_apply(params["embed"], tokens, self.cfg.dtype)
        else:
            x = embeds.to(self.cfg.dtype)
        return constrain(x, ACT)

    def _inputs(self, params: Dict, tokens, embeds, positions
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedded inputs and their positions, laid out as the policy
        asks (the identity without one)."""
        with span("model.embed"):
            x = self._embed(params, tokens, embeds)
            if positions is None:
                positions = self._positions(*x.shape[:2], x.device)
            positions = constrain(positions, ("batch",) + (None,) * (
                positions.dim() - 2) + ("seq",))
        return x, positions

    def forward_hidden(self, params: Dict,
                       tokens: Optional[torch.Tensor] = None,
                       embeds: Optional[torch.Tensor] = None,
                       positions: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole-sequence forward over ``tokens [B, S]`` or the VLM stub's
        ``embeds [B, S, D]`` -> (final hidden states [B,S,D] before the
        norm, aux_loss), under autograd."""
        x, positions = self._inputs(params, tokens, embeds, positions)
        h, aux, _ = tf.stack_full(self.cfg, params, x, positions)
        return h, aux

    def forward_train(self, params: Dict,
                      tokens: Optional[torch.Tensor] = None,
                      embeds: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward_hidden`, then the LM head -> (logits [B,S,V],
        aux_loss)."""
        h, aux = self.forward_hidden(params, tokens, embeds, positions)
        return tf.lm_logits(self.cfg, params, h), aux

    @torch.no_grad()
    def forward(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward_train` without autograd."""
        return self.forward_train(params, tokens, embeds, positions)

    def mtp_logits(self, params: Dict, hidden: torch.Tensor,
                   next_tokens: torch.Tensor) -> torch.Tensor:
        """DeepSeek MTP head: predict token t+2 from (h_t, emb(token
        t+1))."""
        cfg = self.cfg
        emb = self._embed(params, next_tokens, None)
        h = torch.cat([hidden, emb], dim=-1) @ compute_view(
            params["mtp"], {"proj": ("embed", None)})["proj"].to(cfg.dtype)
        h = constrain(h, ACT)
        positions = constrain(self._positions(*h.shape[:2], h.device),
                              ("batch", "seq"))
        h, _, _ = tf.block_full(cfg, "attn",
                                "moe" if cfg.moe is not None else "dense",
                                params["mtp"]["block"], h, positions, None)
        h = rms_norm(h, params["mtp"]["norm"]["scale"])
        return tf.lm_logits(cfg, params, h)

    @torch.no_grad()
    def prefill(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Any]]:
        """-> (last-token logits [B,V], caches).  Attention caches come back
        sized to the prompt; pad them with :func:`pad_caches`."""
        cfg = self.cfg
        x, positions = self._inputs(params, tokens, embeds, None)
        h, _, caches = tf.stack_full(cfg, params, x, positions,
                                     collect_cache=True)
        with span("model.head"):
            logits = tf.lm_logits(cfg, params, h[:, -1:, :])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(self, params: Dict, token: torch.Tensor,
                    pos: torch.Tensor, caches: List[Any]
                    ) -> Tuple[torch.Tensor, List[Any]]:
        """One token ``[B]`` at positions ``pos [B]`` -> (logits [B,V],
        caches).  The caches are updated in place and returned."""
        cfg = self.cfg
        x = self._embed(params, token[:, None], None)
        x, new_caches = tf.stack_decode(cfg, params, x, pos, caches)
        return tf.lm_logits(cfg, params, x)[:, 0], new_caches

    def init_cache(self, B: int, T: int, device="cuda") -> List[Any]:
        return init_cache(self.cfg, B, T, device)

    def cache_axes(self) -> List[Any]:
        return cache_axes(self.cfg)


# ----------------------------------------------------------------------
# encoder-decoder (whisper)
# ----------------------------------------------------------------------

class EncDecModel:
    """Whisper: ``prefill(frames, tokens)`` encodes the frames once, keeps
    every decoder layer's cross K/V and returns the prompt's caches;
    ``decode_step`` extends them a token at a time."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Dict:
        with torch.no_grad():
            return encdec_mod.init_encdec(
                self.cfg, Init(generator, resolve_device(device)))

    def logical_axes(self) -> Dict:
        return encdec_mod.encdec_axes(self.cfg)

    def cache_axes(self) -> Tuple[Dict, Dict]:
        return encdec_cache_axes(self.cfg)

    def forward_train(self, params: Dict, frames: torch.Tensor,
                      tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (logits [B,S,V], a zero aux loss), under autograd."""
        enc = encdec_mod.encode(self.cfg, params, frames)
        logits, _ = encdec_mod.decode_full(self.cfg, params, tokens, enc)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    @torch.no_grad()
    def forward(self, params: Dict, frames: torch.Tensor,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward_train` without autograd."""
        return self.forward_train(params, frames, tokens)

    @torch.no_grad()
    def prefill(self, params: Dict, frames: torch.Tensor,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """-> (last-token logits [B,V], (self-attention caches, cross
        K/V)); pad the caches with ``_pad_attn_cache``."""
        enc = encdec_mod.encode(self.cfg, params, frames)
        logits, state = encdec_mod.decode_full(self.cfg, params, tokens, enc,
                                               collect_cache=True)
        return logits[:, -1], state

    @torch.no_grad()
    def decode_step(self, params: Dict, token: torch.Tensor,
                    pos: torch.Tensor, state: Any) -> Tuple[torch.Tensor, Any]:
        caches, kv = state
        logits, caches = encdec_mod.decode_step(
            self.cfg, params, token[:, None], pos, caches, kv)
        return logits[:, 0], (caches, kv)

    def init_cache(self, B: int, T: int, device="cuda") -> Any:
        cfg = self.cfg
        device = resolve_device(device)
        shape = (cfg.n_layers, B, cfg.encoder.n_frames, cfg.n_heads,
                 cfg.head_dim)
        return (_attn_cache(cfg, cfg.n_layers, B, T, device),
                {"k": _zeros(shape, cfg.dtype, device),
                 "v": _zeros(shape, cfg.dtype, device)})


#: leaves the reference casts to the compute dtype at every use; the rest
#: (norm scales and biases, the SSM's ``A_log``/``D``/``dt_bias``,
#: RWKV's ``w0``, ``u`` and group-norm ``ln_scale``/``ln_bias``) are read
#: in fp32 or as they are
COMPUTE_LEAVES = frozenset({
    "table", "w", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "gate", "up",
    "down", "in_proj", "out_proj", "conv_w", "conv_b",
    # MoE, MLA, the MTP head
    "router", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "proj",
    # RWKV
    "mu", "mu_x", "mu_k", "mu_r", "mix_w1", "mix_w2", "decay_w1",
    "decay_w2", "wr", "wg",
    # whisper
    "fc1", "b1", "fc2", "b2", "pos_embed"})


def cast_for_compute(cfg: ModelConfig, params: Any, device=None,
                     key: Optional[str] = None) -> Any:
    """The parameter tree on ``device`` with every leaf that the reference
    casts to ``cfg.dtype`` at each use cast once, here; the others keep
    ``param_dtype``.  The values each product sees are the same."""
    if isinstance(params, dict):
        return {k: cast_for_compute(cfg, v, device, k)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_for_compute(cfg, v, device, key) for v in params]
    dtype = cfg.dtype if key in COMPUTE_LEAVES else params.dtype
    return params.to(device=device, dtype=dtype)


def build_model(cfg: ModelConfig):
    return EncDecModel(cfg) if cfg.is_encdec else LM(cfg)


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
    """Params activated per token: MoE counts top_k (and the shared
    experts) only, in every MoE layer and in the MTP block."""
    total = count_params_from_shapes(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = sum(1 for i, k in enumerate(cfg.layer_kinds())
                       if k == "attn" and i >= m.first_k_dense)
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
    if cfg.mtp_depth > 0:
        inactive += (m.n_experts - m.top_k) * per_expert   # the MTP block
    return total - inactive
