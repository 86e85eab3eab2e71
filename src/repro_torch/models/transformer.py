"""Decoder-stack assembly: block kinds, runs of layers, decode caches.

Port of ``src/repro/models/transformer.py`` for the families the port
serves: runs of ``"ssm"`` blocks, ``"attn"`` blocks of the dense variant,
and ``"attn_shared"`` blocks (zamba2), whose one weight set is reused at
every occurrence with one KV cache per occurrence.  A run's parameters are
stacked ``[n, ...]`` as in the reference, and the reference's ``lax.scan``
over layers becomes a Python loop over the stacked weights.  ``remat`` and
the sharding constraints have no counterpart: the port serves on one card
without gradients.  MoE and RWKV blocks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    init_embedding,
    init_rms_norm,
    init_swiglu,
    rms_norm,
    swiglu_apply,
    unembed_apply,
)
from repro_torch.models.params import Init, normal_init


@dataclasses.dataclass(frozen=True)
class Run:
    kind: str       # attn | attn_shared | ssm | rwkv
    variant: str    # dense | moe | ""
    n: int


def build_runs(cfg: ModelConfig) -> List[Run]:
    kinds = cfg.layer_kinds()
    variants = []
    for i, k in enumerate(kinds):
        if k in ("attn",):
            if cfg.moe is not None and i >= cfg.moe.first_k_dense:
                variants.append("moe")
            else:
                variants.append("dense")
        else:
            variants.append("")
    runs: List[Run] = []
    for k, v in zip(kinds, variants):
        if runs and runs[-1].kind == k and runs[-1].variant == v \
                and k != "attn_shared":
            runs[-1] = dataclasses.replace(runs[-1], n=runs[-1].n + 1)
        else:
            runs.append(Run(k, v, 1))
    return runs


def stacked(run: Run, cfg: ModelConfig) -> bool:
    """Whether a run keeps ``[n, ...]`` stacked caches (the reference's
    scanned runs) rather than a list of per-layer caches."""
    return cfg.scan_layers and run.n > 1


def _unported(kind: str, variant: str) -> NotImplementedError:
    return NotImplementedError(
        f"block {kind!r}/{variant!r} is not ported yet (ROADMAP.md, "
        f"Queue 1 item 9)")


# ----------------------------------------------------------------------
# per-layer block init / apply
# ----------------------------------------------------------------------

def init_block(cfg: ModelConfig, kind: str, variant: str,
               init: Init) -> Dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    if kind in ("attn", "attn_shared") and variant != "moe" and not cfg.mla:
        return {"ln1": init_rms_norm(d, dt, init),
                "attn": attn.init_attention(cfg, init),
                "ln2": init_rms_norm(d, dt, init),
                "mlp": init_swiglu(d, cfg.d_ff, dt, init)}
    if kind == "ssm":
        return {"ln1": init_rms_norm(d, dt, init),
                "ssm": ssm_mod.init_ssm(cfg, init)}
    raise _unported(kind, variant)


def block_full(
    cfg: ModelConfig,
    kind: str,
    variant: str,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    state: Optional[Any],
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Whole-sequence block application -> (x, new_state, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "attn_shared") and variant != "moe" and not cfg.mla:
        h = rms_norm(x, p["ln1"]["scale"])
        y, cache = attn.attention_full(cfg, p["attn"], h, positions)
        x = x + y
        h = rms_norm(x, p["ln2"]["scale"])
        x = x + swiglu_apply(p["mlp"], h, x.dtype)
        return x, cache, aux
    if kind == "ssm":
        h = rms_norm(x, p["ln1"]["scale"])
        y, new_state = ssm_mod.ssm_full(cfg, p["ssm"], h, state)
        return x + y, new_state, aux
    raise _unported(kind, variant)


def block_decode(
    cfg: ModelConfig,
    kind: str,
    variant: str,
    p: Dict,
    x: torch.Tensor,                   # [B, 1, D]
    pos: torch.Tensor,                 # [B]
    state: Any,
) -> Tuple[torch.Tensor, Any]:
    if kind in ("attn", "attn_shared") and variant != "moe" and not cfg.mla:
        h = rms_norm(x, p["ln1"]["scale"])
        y, cache = attn.attention_decode(cfg, p["attn"], h, state, pos)
        x = x + y
        h = rms_norm(x, p["ln2"]["scale"])
        return x + swiglu_apply(p["mlp"], h, x.dtype), cache
    if kind == "ssm":
        h = rms_norm(x, p["ln1"]["scale"])
        y, new_state = ssm_mod.ssm_decode(cfg, p["ssm"], h, state)
        return x + y, new_state
    raise _unported(kind, variant)


# ----------------------------------------------------------------------
# stack init
# ----------------------------------------------------------------------

def _stack(trees: List[Dict]) -> Dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _layer(tree: Dict, i: int) -> Dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def init_stack(cfg: ModelConfig, init: Init) -> Dict:
    runs = build_runs(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(cfg.vocab, cfg.d_model, cfg.param_dtype,
                                init),
        "final_norm": init_rms_norm(cfg.d_model, cfg.param_dtype, init),
        "runs": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "w": normal_init(init, (cfg.d_model, cfg.vocab), cfg.param_dtype)
        }
    if any(r.kind == "attn_shared" for r in runs):
        params["shared_block"] = init_block(cfg, "attn_shared", "dense", init)
    for run in runs:
        if run.kind == "attn_shared":
            params["runs"].append({})      # weights live in shared_block
            continue
        params["runs"].append(_stack([
            init_block(cfg, run.kind, run.variant, init)
            for _ in range(run.n)]))
    if cfg.mtp_depth > 0:
        raise NotImplementedError("multi-token-prediction heads are not "
                                  "ported yet (ROADMAP.md)")
    return params


# ----------------------------------------------------------------------
# stack apply
# ----------------------------------------------------------------------

def stack_full(
    cfg: ModelConfig,
    params: Dict,
    x: torch.Tensor,                     # [B, S, D] embedded inputs
    positions: torch.Tensor,
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[Any]]:
    """Whole-sequence pass -> (hidden, aux_loss, caches per run).  Caches
    keep the reference's structure: stacked ``[n, ...]`` leaves for a
    scanned run, a list of per-layer caches otherwise."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Any] = []
    for run, rp in zip(build_runs(cfg), params["runs"]):
        if run.kind == "attn_shared":
            x, cache, aux = block_full(cfg, "attn", "dense",
                                       params["shared_block"], x, positions,
                                       None)
            aux_total = aux_total + aux
            caches.append(cache if collect_cache else None)
            continue
        run_cache = []
        for i in range(run.n):
            x, cache, aux = block_full(cfg, run.kind, run.variant,
                                       _layer(rp, i), x, positions, None)
            aux_total = aux_total + aux
            run_cache.append(cache if collect_cache else None)
        if stacked(run, cfg):
            run_cache = _stack(run_cache) if collect_cache else None
        caches.append(run_cache)
    return x, aux_total, caches


def stack_decode(
    cfg: ModelConfig,
    params: Dict,
    x: torch.Tensor,                     # [B, 1, D]
    pos: torch.Tensor,                   # [B]
    caches: List[Any],
) -> Tuple[torch.Tensor, List[Any]]:
    """One token through the stack.  A stacked run's new per-layer states
    are written into its ``[n, ...]`` cache tensors in place; KV caches
    take the new K/V in place (``attention_decode``)."""
    new_caches: List[Any] = []
    for run, rp, cache in zip(build_runs(cfg), params["runs"], caches):
        if run.kind == "attn_shared":
            x, c = block_decode(cfg, "attn", "dense",
                                params["shared_block"], x, pos, cache)
            new_caches.append(c)
            continue
        if stacked(run, cfg):
            for i in range(run.n):
                x, c = block_decode(cfg, run.kind, run.variant,
                                    _layer(rp, i), x, pos, _layer(cache, i))
                for k, v in c.items():
                    dst = cache[k][i]
                    if v.data_ptr() != dst.data_ptr():
                        dst.copy_(v)
            new_caches.append(cache)
        else:
            outs = []
            for i in range(run.n):
                x, c = block_decode(cfg, run.kind, run.variant,
                                    _layer(rp, i), x, pos, cache[i])
                outs.append(c)
            new_caches.append(outs)
    return x, new_caches


def lm_logits(cfg: ModelConfig, params: Dict, x: torch.Tensor
              ) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"]["scale"])
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], h, x.dtype)
    return h @ params["lm_head"]["w"].to(x.dtype)
