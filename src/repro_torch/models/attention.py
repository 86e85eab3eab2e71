"""Attention variants: GQA (llama/qwen), qk-norm, QKV bias, sliding
window, M-RoPE, cross-attention (whisper), and DeepSeek MLA with the
absorbed decode.

Port of ``src/repro/models/attention.py``.  ``attention_full`` and the
prefill cross-attention compute their inner product with
``kernels.flash_attention.flash_attention`` for both ``attention_impl``
values: the CUDA kernel (K2) on a CUDA tensor, its plain version on a CPU
tensor.  The one-token decodes (``attention_decode``, cross-attention at
decode, ``mla_decode``) stay plain PyTorch over the cache, as the
reference's do (it has no Pallas kernel for them).  ``mla_full`` is plain
``_sdpa`` too: its qk head (192 in deepseek-v3) differs from its v head
(128), and K2 takes one head dim for q, k and v, as the reference's
Pallas kernel does; the reference's MLA is XLA einsums as well.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm
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
    """q [B,S,H,Dqk], k [B,T,Hkv,Dqk], v [B,T,Hkv,Dv] -> [B,S,H,Dv]; GQA by
    grouping (MLA passes Dv != Dqk), fp32 logits and softmax, the product
    with V in v's dtype."""
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


def init_attention(cfg: ModelConfig, init: Init, cross: bool = False
                   ) -> Dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.param_dtype
    p = {
        "wq": normal_init(init, (d, qd), dt),
        "wk": normal_init(init, (d, kvd), dt),
        "wv": normal_init(init, (d, kvd), dt),
        "wo": normal_init(init, (qd, d), dt, fan_in=qd),
    }
    if cfg.qkv_bias and not cross:
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


def _flash(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool) -> torch.Tensor:
    """K2 on ``[B, S, H, D]`` activations, passed as ``[B, H, S, D]``
    views (the kernel takes the strides as they are)."""
    window = (cfg.sliding_window or 0) if causal else 0
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), cfg.head_dim ** -0.5,
                           causal=causal, window=window).transpose(1, 2)


def attention_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, S, D]
    positions: Optional[torch.Tensor],   # [B, S], or [B, 3, S] (M-RoPE)
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill over the whole sequence -> (output, KV cache content).
    ``positions=None`` skips RoPE (whisper adds absolute positions at the
    input instead)."""
    dt = x.dtype
    q, k, v = _project_qkv(cfg, p, x, x, dt)
    if positions is None:
        pass
    elif cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    out = _flash(cfg, q, k, v, causal)
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
    dt = x.dtype
    q, k_new, v_new = _project_qkv(cfg, p, x, x, dt)
    if not use_rope:
        pass
    elif cfg.mrope:
        # a decoded token is text: all three channels share the position
        pos3 = pos[:, None, None].expand(pos.shape[0], 3, 1)
        q = apply_mrope(q, pos3, cfg.rope_theta)
        k_new = apply_mrope(k_new, pos3, cfg.rope_theta)
    else:
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


def cross_attention(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, S, D] decoder states
    enc_kv: Dict,                        # {"k","v": [B, T, Hkv, Dh]}
    decode: bool = False,
) -> torch.Tensor:
    """Attention over precomputed encoder K/V, not causal.  The prefill
    (``S`` prompt tokens against ``T`` frames) runs K2; a decode step
    (``decode=True``) runs plain ``_sdpa``, as ``attention_decode`` does."""
    dt = x.dtype
    B, S, _ = x.shape
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if decode:
        out = _sdpa(q, enc_kv["k"], enc_kv["v"], None, cfg.head_dim ** -0.5)
    else:
        out = _flash(cfg, q, enc_kv["k"], enc_kv["v"], causal=False)
    return out.reshape(B, S, -1) @ p["wo"].to(dt)


def encode_cross_kv(cfg: ModelConfig, p: Dict, enc_out: torch.Tensor
                    ) -> Dict:
    """Encoder K/V for the cross-attention, once per request."""
    dt = enc_out.dtype
    B, T, _ = enc_out.shape
    k = enc_out @ p["wk"].to(dt)
    v = enc_out @ p["wv"].to(dt)
    return {"k": k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim),
            "v": v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)}


# ----------------------------------------------------------------------
# DeepSeek Multi-head Latent Attention
# ----------------------------------------------------------------------

def init_mla(cfg: ModelConfig, init: Init) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dt = cfg.param_dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": normal_init(init, (d, m.q_lora_rank), dt),
        "q_a_norm": init.full((m.q_lora_rank,), 1.0, dt),
        "wq_b": normal_init(init, (m.q_lora_rank, H * qk_head), dt),
        "wkv_a": normal_init(init, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                             dt),
        "kv_a_norm": init.full((m.kv_lora_rank,), 1.0, dt),
        "wk_b": normal_init(init, (m.kv_lora_rank, H * m.qk_nope_head_dim),
                            dt),
        "wv_b": normal_init(init, (m.kv_lora_rank, H * m.v_head_dim), dt),
        "wo": normal_init(init, (H * m.v_head_dim, d), dt,
                          fan_in=H * m.v_head_dim),
    }


def _mla_q(cfg: ModelConfig, p: Dict, x: torch.Tensor, dt):
    m = cfg.mla
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = rms_norm(x @ p["wq_a"].to(dt), p["q_a_norm"])
    q = (cq @ p["wq_b"].to(dt)).reshape(*x.shape[:2], cfg.n_heads, qk_head)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def mla_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, S, D]
    positions: torch.Tensor,             # [B, S]
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """MLA prefill -> (output, the *compressed* latents as the cache).
    Plain ``_sdpa`` for both ``attention_impl`` values (the reference's
    ``chunked`` form is the same function, summed in blocks)."""
    m = cfg.mla
    dt = x.dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, dt)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = x @ p["wkv_a"].to(dt)
    c_kv = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_a_norm"])
    k_rope = ckv_full[..., m.kv_lora_rank:][:, :, None, :]      # [B,S,1,dr]
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)

    k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(B, S, H, m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"].to(dt)).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    mask = (causal_mask(S, S, cfg.sliding_window, device=x.device)
            if causal else None)
    out = _sdpa(q, k, v, mask, scale)
    y = out.reshape(B, S, -1) @ p["wo"].to(dt)
    return y, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}


def mla_decode(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, 1, D]
    cache: Dict,                      # {"c_kv": [B,T,r], "k_rope": [B,T,dr]}
    pos: torch.Tensor,                   # [B]
) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matmul MLA decode: attention runs in the compressed space,
    so the cache stays rank-sized.  The new latents are written into the
    cache tensors in place."""
    m = cfg.mla
    dt = x.dtype
    B = x.shape[0]
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, dt)                      # [B,1,H,*]
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)

    ckv_full = x @ p["wkv_a"].to(dt)
    c_new = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_a_norm"])[:, 0]
    kr_new = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                        pos[:, None], cfg.rope_theta)[:, 0, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    b_idx = torch.arange(B, device=x.device)
    c_kv[b_idx, pos] = c_new
    k_rope[b_idx, pos] = kr_new

    # absorb W_k_b into the query: q_c [B,H,r]
    wk_b = p["wk_b"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)
    T = c_kv.shape[1]
    f32 = torch.float32
    logits = (torch.einsum("bhr,btr->bht", q_c.to(f32), c_kv.to(f32))
              + torch.einsum("bhd,btd->bht", q_rope[:, 0].to(f32),
                             k_rope.to(f32))
              ) * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    mask = torch.where(torch.arange(T, device=x.device)[None, None, :]
                       <= pos[:, None, None], 0.0, NEG_INF)
    w = torch.softmax(logits + mask, dim=-1).to(dt)
    ctx = torch.einsum("bht,btr->bhr", w, c_kv)                 # [B,H,r]
    wv_b = p["wv_b"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", ctx, wv_b)               # [B,H,dv]
    y = out.reshape(B, -1) @ p["wo"].to(dt)
    return y[:, None, :], {"c_kv": c_kv, "k_rope": k_rope}
