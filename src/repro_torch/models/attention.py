"""Attention variants: GQA (llama/qwen), qk-norm, QKV bias, sliding
window, M-RoPE, cross-attention (whisper), and DeepSeek MLA with the
absorbed decode.

Port of ``src/repro/models/attention.py``.  ``attention_full`` and the
prefill cross-attention compute their inner product with
``kernels.flash_attention.flash_attention`` on a CUDA tensor (the CUDA
kernel, K2) for both ``attention_impl`` values; on a CPU tensor they run
K2's plain version, or the blockwise online softmax ``_sdpa_chunked``
when ``attention_impl="chunked"``.  The one-token decodes
(``attention_decode``, cross-attention at decode, ``mla_decode``) stay
plain PyTorch over the cache, as the reference's do (it has no Pallas
kernel for them).  ``mla_full`` is plain ``_sdpa`` or ``_sdpa_chunked``
on both devices: its qk head (192 in deepseek-v3) differs from its v
head (128), and K2 takes one head dim for q, k and v, as the reference's
Pallas kernel does.

Under a sharding policy (``models/sharding.py``) the inner product runs
on each rank's local shards (``local_call``): batch over the batch axes,
heads over ``model``.  When the KV heads do not divide the ``model``
axis but the query heads do, each rank takes the KV heads its query
heads read.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                      apply_rope_qk, rms_norm)
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import (
    current_policy,
    is_dtensor,
    local_call,
    merge_last,
    mesh_coordinate,
    split_last,
)
from repro_torch.tracing import span

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


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, window: Optional[int],
                  block: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention in plain PyTorch: KV blocks of
    ``block`` with a running (max, normaliser, accumulator), so the
    ``[S, T]`` scores never exist whole.  q ``[B,S,H,D]``, k/v
    ``[B,T,Hkv,D|Dv]`` -> ``[B,S,H,Dv]``; the scores in fp32, the product
    with V in v's dtype, as the reference's ``preferred_element_type``
    asks."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    blk = min(block, T)
    nb = -(-T // blk)
    pad = nb * blk - T
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    qg = (q.reshape(B, S, Hkv, G, D) * scale).to(q.dtype).to(f32)
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, G, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, Dv), dtype=f32, device=q.device)
    for j in range(nb):
        kblk = k[:, j * blk:(j + 1) * blk]
        vblk = v[:, j * blk:(j + 1) * blk]
        s = torch.einsum("bshgd,bthd->bhgst", qg, kblk.to(f32))
        k_pos = j * blk + torch.arange(blk, device=q.device)[None, :]
        ok = k_pos < T
        if causal:
            ok = ok & (k_pos <= q_pos)
            if window is not None:
                ok = ok & (k_pos > q_pos - window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgst,bthd->bhgsd", p.to(vblk.dtype), vblk)
        acc = acc * corr[..., None] + pv.to(f32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, S, H, Dv).to(q.dtype)


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


def attention_axes(cfg: ModelConfig, cross: bool = False) -> Dict:
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
          "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias and not cross:
        ax.update({"bq": ("heads",), "bk": ("kv_heads",),
                   "bv": ("kv_heads",)})
    if cfg.qk_norm:
        ax.update({"q_norm": (None,), "k_norm": (None,)})
    return ax


def _project_qkv(cfg: ModelConfig, p: Dict, xq: torch.Tensor,
                 xkv: torch.Tensor, compute_dtype):
    q = xq @ p["wq"].to(compute_dtype)
    k = xkv @ p["wk"].to(compute_dtype)
    v = xkv @ p["wv"].to(compute_dtype)
    if "bq" in p:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = split_last(q, cfg.n_heads, cfg.head_dim)
    k = split_last(k, cfg.n_kv_heads, cfg.head_dim)
    v = split_last(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _heads_local(inner, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """``inner(q, k, v)`` on ``[B, S, H, D]`` tensors; under a policy, on
    each rank's shards (batch over the batch axes, heads over
    ``model``)."""
    pol = current_policy()
    if pol is None or not is_dtensor(q):
        return inner(q, k, v)
    from torch.distributed.tensor import Replicate, Shard

    qpl = pol.placements_for(q.shape, ("batch", None, "heads", None))
    kpl = list(pol.placements_for(k.shape, ("batch", None, "kv_heads", None)))
    sliced = False
    for qp, kp in zip(qpl, kpl):
        if qp != kp:                  # query heads split, KV heads whole
            assert qp == Shard(2) and kp == Replicate(), (qpl, kpl)
            sliced = True
    body = inner
    if sliced:
        H, Hkv = q.shape[2], k.shape[2]
        Hl = H // pol.shape["model"]
        G = H // Hkv
        i = mesh_coordinate("model")
        lo, hi = (i * Hl) // G, ((i + 1) * Hl - 1) // G + 1

        def body(ql, kl, vl):
            return inner(ql, kl[:, :, lo:hi], vl[:, :, lo:hi])
    return local_call(body, (q, k, v), (qpl, tuple(kpl), tuple(kpl)), qpl)


def _flash(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool) -> torch.Tensor:
    """K2 on ``[B, S, H, D]`` activations, passed as ``[B, H, S, D]``
    views (the kernel takes the strides as they are); on a CPU tensor
    with ``attention_impl="chunked"``, ``_sdpa_chunked``."""
    window = (cfg.sliding_window or 0) if causal else 0
    scale = cfg.head_dim ** -0.5

    def inner(q, k, v):
        if cfg.attention_impl == "chunked" and q.device.type != "cuda":
            return _sdpa_chunked(q, k, v, scale, causal, cfg.sliding_window,
                                 cfg.attention_block)
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale, causal=causal,
                               window=window).transpose(1, 2)

    return _heads_local(inner, q, k, v)


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
    with span("attn.qkv"):
        q, k, v = _project_qkv(cfg, p, x, x, dt)
    if positions is not None:
        with span("attn.rope"):
            if cfg.mrope:
                q = apply_mrope(q, positions, cfg.rope_theta)
                k = apply_mrope(k, positions, cfg.rope_theta)
            else:
                q, k = apply_rope_qk(q, k, positions, cfg.rope_theta)
    out = _flash(cfg, q, k, v, causal)
    with span("attn.out"):
        y = merge_last(out) @ p["wo"].to(dt)
    return y, {"k": k, "v": v}


def _seq_split(T_local: int):
    """(first cache row held here, the ``model`` group) when a decode
    cache's sequence is split over ``model`` inside ``local_call``; (0,
    None) otherwise."""
    pol = current_policy()
    if pol is None or pol.shape.get("model", 1) == 1 \
            or "model" not in pol.rules.get("seq", ()):
        return 0, None
    return (mesh_coordinate("model") * T_local,
            pol.mesh.get_group("model"))


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                lo: int, split: bool) -> None:
    """``cache[b, pos[b] - lo] = new[b]`` in place.  Whole (``split``
    false), a position past the capacity raises.  Split over ranks, only
    the rows held here (``lo ..``) change: a position held elsewhere
    rewrites the row it reads, so no shape depends on the data."""
    T = cache.shape[1]
    b_idx = torch.arange(cache.shape[0], device=cache.device)
    if not split:
        cache[b_idx, pos] = new
        return
    at = pos - lo
    held = (at >= 0) & (at < T)
    at = torch.clamp(at, 0, T - 1)
    keep = cache[b_idx, at]
    sel = held.reshape(-1, *([1] * (new.dim() - 1)))
    cache[b_idx, at] = torch.where(sel, new.to(cache.dtype), keep)


def _decode_ok(pos: torch.Tensor, T: int, lo: int,
               window: Optional[int]) -> torch.Tensor:
    """``[B, T]``: which cache rows (``lo ..``) a token at ``pos`` reads."""
    k_pos = lo + torch.arange(T, device=pos.device)[None, :]
    ok = k_pos <= pos[:, None]
    if window is not None:
        ok &= k_pos > (pos[:, None] - window)
    return ok


def _combine_split_softmax(s: torch.Tensor, v: torch.Tensor, eq: str,
                           group) -> torch.Tensor:
    """Softmax over a key axis split across ``group`` (the last of ``s``,
    fp32 scores with the mask added), then the product with the local
    ``v`` by ``eq``: the ranks' maxima, normalisers and weighted values
    merged by one max and two sums (flash decode)."""
    import torch.distributed._functional_collectives as funcol

    m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(s - m)
    w = p / funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    return funcol.all_reduce(torch.einsum(eq, w, v.to(torch.float32)),
                             "sum", group)


def _decode_local(body, *args):
    """``body(*queries, *new rows, cache_a, cache_b, pos)``; under a
    policy on each rank's batch and cache-sequence shards (``local_call``):
    the caches keep their layout, the rest is whole over ``model``."""
    pol = current_policy()
    if pol is None or not is_dtensor(args[-2]):
        return body(*args)

    def batch_only(t):
        return pol.placements_for(t.shape, ("batch",) + (None,) * (t.dim() - 1))

    def cache(t):
        return pol.placements_for(t.shape, ("batch", "seq")
                                  + (None,) * (t.dim() - 2))

    pls = [batch_only(t) for t in args[:-3]] + [cache(args[-3]),
                                                cache(args[-2]),
                                                batch_only(args[-1])]
    return local_call(body, args, pls, (pls[0], pls[-3], pls[-2]))


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
        q, k_new = apply_rope_qk(q, k_new, pos[:, None], cfg.rope_theta)
    scale = cfg.head_dim ** -0.5

    def body(q, k_new, v_new, k, v, pos):
        lo, group = _seq_split(k.shape[1])
        _write_rows(k, k_new[:, 0], pos, lo, group is not None)
        _write_rows(v, v_new[:, 0], pos, lo, group is not None)
        ok = _decode_ok(pos, k.shape[1], lo, cfg.sliding_window)
        mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
        if group is None:
            return _sdpa(q, k, v, mask, scale), k, v
        B, _, H, D = q.shape
        Hkv = k.shape[2]
        qg = q.reshape(B, 1, Hkv, H // Hkv, D).to(torch.float32)
        s = torch.einsum("bshgd,bthd->bhgst", qg,
                         k.to(torch.float32)) * scale + mask
        out = _combine_split_softmax(s, v, "bhgst,bthd->bshgd", group)
        return out.reshape(B, 1, H, D).to(v.dtype), k, v

    out, k, v = _decode_local(body, q, k_new, v_new, cache["k"], cache["v"],
                              pos)
    y = merge_last(out) @ p["wo"].to(dt)
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
    q = split_last(x @ p["wq"].to(dt), cfg.n_heads, cfg.head_dim)
    if decode:
        out = _sdpa(q, enc_kv["k"], enc_kv["v"], None, cfg.head_dim ** -0.5)
    else:
        out = _flash(cfg, q, enc_kv["k"], enc_kv["v"], causal=False)
    return merge_last(out) @ p["wo"].to(dt)


def encode_cross_kv(cfg: ModelConfig, p: Dict, enc_out: torch.Tensor
                    ) -> Dict:
    """Encoder K/V for the cross-attention, once per request."""
    dt = enc_out.dtype
    k = enc_out @ p["wk"].to(dt)
    v = enc_out @ p["wv"].to(dt)
    return {"k": split_last(k, cfg.n_kv_heads, cfg.head_dim),
            "v": split_last(v, cfg.n_kv_heads, cfg.head_dim)}


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


def mla_axes(cfg: ModelConfig) -> Dict:
    return {"wq_a": ("embed", "lora"), "q_a_norm": ("lora",),
            "wq_b": ("lora", "heads"), "wkv_a": ("embed", "lora"),
            "kv_a_norm": ("lora",), "wk_b": ("lora", "heads"),
            "wv_b": ("lora", "heads"), "wo": ("heads", "embed")}


def _mla_q(cfg: ModelConfig, p: Dict, x: torch.Tensor, dt):
    m = cfg.mla
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = rms_norm(x @ p["wq_a"].to(dt), p["q_a_norm"])
    q = split_last(cq @ p["wq_b"].to(dt), cfg.n_heads, qk_head)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def mla_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, S, D]
    positions: torch.Tensor,             # [B, S]
    causal: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """MLA prefill -> (output, the *compressed* latents as the cache).
    Plain ``_sdpa``, or ``_sdpa_chunked`` when
    ``attention_impl="chunked"``."""
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

    k_nope = split_last(c_kv @ p["wk_b"].to(dt), H, m.qk_nope_head_dim)
    v = split_last(c_kv @ p["wv_b"].to(dt), H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    def inner(q, k, v):
        if cfg.attention_impl == "chunked":
            return _sdpa_chunked(q, k, v, scale, causal, cfg.sliding_window,
                                 cfg.attention_block)
        mask = (causal_mask(S, S, cfg.sliding_window, device=q.device)
                if causal else None)
        return _sdpa(q, k, v, mask, scale)

    out = _heads_local(inner, q, k, v)
    y = merge_last(out) @ p["wo"].to(dt)
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
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, dt)                      # [B,1,H,*]
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)

    ckv_full = x @ p["wkv_a"].to(dt)
    c_new = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_a_norm"])[:, 0]
    kr_new = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                        pos[:, None], cfg.rope_theta)[:, 0, 0]
    # absorb W_k_b into the query: q_c [B,H,r]
    wk_b = split_last(p["wk_b"].to(dt), H, m.qk_nope_head_dim)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    def body(q_c, q_r, c_new, kr_new, c_kv, k_rope, pos):
        lo, group = _seq_split(c_kv.shape[1])
        _write_rows(c_kv, c_new, pos, lo, group is not None)
        _write_rows(k_rope, kr_new, pos, lo, group is not None)
        f32 = torch.float32
        logits = (torch.einsum("bhr,btr->bht", q_c.to(f32), c_kv.to(f32))
                  + torch.einsum("bhd,btd->bht", q_r.to(f32),
                                 k_rope.to(f32))) * scale
        ok = _decode_ok(pos, c_kv.shape[1], lo, None)
        logits = logits + torch.where(ok, 0.0, NEG_INF)[:, None, :]
        if group is None:
            w = torch.softmax(logits, dim=-1).to(dt)
            return torch.einsum("bht,btr->bhr", w, c_kv), c_kv, k_rope
        ctx = _combine_split_softmax(logits, c_kv, "bht,btr->bhr", group)
        return ctx.to(dt), c_kv, k_rope

    ctx, c_kv, k_rope = _decode_local(
        body, q_c, q_rope[:, 0], c_new, kr_new, cache["c_kv"],
        cache["k_rope"], pos)                                  # [B,H,r]
    wv_b = split_last(p["wv_b"].to(dt), H, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", ctx, wv_b)               # [B,H,dv]
    y = merge_last(out) @ p["wo"].to(dt)
    return y[:, None, :], {"c_kv": c_kv, "k_rope": k_rope}
