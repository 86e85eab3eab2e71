"""Softmax attention (GQA superset): prefill over a whole sequence on the
flash-attention kernel, and one-token decode against a KV cache.

Port of the standard-attention parts of ``src/repro/models/attention.py``.
``attention_full`` computes its inner product with
``kernels.flash_attention.flash_attention`` for both ``attention_impl``
values: the CUDA kernel (K2) on a CUDA tensor, its plain version on a CPU
tensor.  ``attention_decode`` stays plain PyTorch over the cache, as the
reference's does (it has no Pallas kernel).  MLA and cross-attention are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.params import Init, normal_init

NEG_INF = -1e30


def causal_mask(q_len: int, kv_len: int, window: Optional[int] = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] additive fp32 mask; sliding window and a query
    position offset (chunked prefill) supported."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,Hkv,D] -> [B,S,H,D]; GQA by grouping, fp32
    logits and softmax, the product with V in v's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, Dv)


def init_attention(cfg: ModelConfig, init: Init) -> Dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.param_dtype
    p = {
        "wq": normal_init(init, (d, qd), dt),
        "wk": normal_init(init, (d, kvd), dt),
        "wv": normal_init(init, (d, kvd), dt),
        "wo": normal_init(init, (qd, d), dt, fan_in=qd),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((qd,), 0.0, dt)
        p["bk"] = init.full((kvd,), 0.0, dt)
        p["bv"] = init.full((kvd,), 0.0, dt)
    if cfg.qk_norm:
        p["q_norm"] = init.full((cfg.head_dim,), 1.0, dt)
        p["k_norm"] = init.full((cfg.head_dim,), 1.0, dt)
    return p


def _project_qkv(cfg: ModelConfig, p: Dict, xq: torch.Tensor,
                 xkv: torch.Tensor, compute_dtype):
    B, S, _ = xq.shape
    T = xkv.shape[1]
    q = xq @ p["wq"].to(compute_dtype)
    k = xkv @ p["wk"].to(compute_dtype)
    v = xkv @ p["wv"].to(compute_dtype)
    if "bq" in p:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attention_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, S, D]
    positions: Optional[torch.Tensor],   # [B, S]
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill over the whole sequence -> (output, KV cache content).
    ``positions=None`` skips RoPE."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md)")
    dt = x.dtype
    q, k, v = _project_qkv(cfg, p, x, x, dt)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    window = cfg.sliding_window or 0
    # [B,S,H,D] -> [B,H,S,D] views: the kernel takes the strides as they are
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), cfg.head_dim ** -0.5,
                          causal=causal, window=window).transpose(1, 2)
    y = out.reshape(B, S, -1) @ p["wo"].to(dt)
    return y, {"k": k, "v": v}


def attention_decode(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, 1, D]
    cache: Dict,                         # {"k","v": [B, T, Hkv, Dh]}
    pos: torch.Tensor,                   # [B] current position index
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a fixed-capacity cache.  The new K/V are
    written into the cache tensors in place (the reference returns updated
    copies; the port saves a copy of every cache per step)."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md)")
    dt = x.dtype
    q, k_new, v_new = _project_qkv(cfg, p, x, x, dt)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    T = k.shape[1]
    b_idx = torch.arange(x.shape[0], device=x.device)
    k[b_idx, pos] = k_new[:, 0]
    v[b_idx, pos] = v_new[:, 0]
    k_pos = torch.arange(T, device=x.device)[None, :]
    ok = k_pos <= pos[:, None]
    if cfg.sliding_window is not None:
        ok &= k_pos > (pos[:, None] - cfg.sliding_window)
    mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    out = _sdpa(q, k, v, mask, cfg.head_dim ** -0.5)
    y = out.reshape(out.shape[0], 1, -1) @ p["wo"].to(dt)
    return y, {"k": k, "v": v}
