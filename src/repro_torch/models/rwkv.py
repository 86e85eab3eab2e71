"""RWKV-6 "Finch": attention-free time mixing with data-dependent decay.

Port of ``src/repro/models/rwkv.py``.  Per head (size N) the WKV state
``S`` (N x N, fp32) evolves as

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the decay ``w_t = exp(-exp(w0 + lora(x_t)))`` data-dependent and
token-shift interpolations (ddlerp) feeding every projection.  The
reference's ``lax.scan`` over time becomes a plain loop (the reference has
no Pallas kernel for it).  The loop carries only ``r_t . S_{t-1}`` and the
state update, two launches a step; the bonus term ``(r_t . (u * k_t))
v_t`` is computed for all steps at once, and the outer products
``k_t v_t^T`` a block of ``_BLOCK`` steps at a time, so their memory stays
bounded on long prompts.  Under a sharding policy the loop runs on each
rank's batch and head shards (``local_call``: DTensor has no rule for a
loop).  Decode carries ``(S, x_prev)``: a constant-size state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import (
    constrain,
    current_policy,
    local_call,
    merge_last,
    split_last,
)

MIX_NAMES = ("w", "k", "v", "r", "g")
#: time steps whose outer products k_t v_t^T are formed at once
_BLOCK = 128


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    N = cfg.rwkv.head_dim
    return cfg.d_model // N, N


def init_rwkv_time(cfg: ModelConfig, init: Init) -> Dict:
    d = cfg.d_model
    r = cfg.rwkv
    dt = cfg.param_dtype
    return {
        "mu_x": init.full((d,), 0.5, dt),
        "mix_w1": normal_init(init, (d, 5 * r.gate_lora), dt, scale=1e-2),
        "mix_w2": normal_init(init, (5, r.gate_lora, d), dt, scale=1e-2),
        "mu": init.full((5, d), 0.5, dt),
        "wr": normal_init(init, (d, d), dt),
        "wk": normal_init(init, (d, d), dt),
        "wv": normal_init(init, (d, d), dt),
        "wg": normal_init(init, (d, d), dt),
        "wo": normal_init(init, (d, d), dt),
        "w0": init.full((d,), -6.0, dt),          # slow initial decay
        "decay_w1": normal_init(init, (d, r.decay_lora), dt, scale=1e-2),
        "decay_w2": normal_init(init, (r.decay_lora, d), dt, scale=1e-2),
        "u": normal_init(init, (d,), dt, scale=0.5, fan_in=1),
        "ln_scale": init.full((d,), 1.0, dt),     # per-head group norm
        "ln_bias": init.full((d,), 0.0, dt),
    }


def rwkv_time_axes(cfg: ModelConfig) -> Dict:
    return {
        "mu_x": ("embed",), "mix_w1": ("embed", None),
        "mix_w2": (None, None, "embed"), "mu": (None, "embed"),
        "wr": ("embed", "mlp"), "wk": ("embed", "mlp"),
        "wv": ("embed", "mlp"), "wg": ("embed", "mlp"),
        "wo": ("mlp", "embed"), "w0": ("embed",),
        "decay_w1": ("embed", None), "decay_w2": (None, "embed"),
        "u": ("embed",), "ln_scale": ("embed",), "ln_bias": ("embed",),
    }


def init_rwkv_channel(cfg: ModelConfig, init: Init) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {
        "mu_k": init.full((d,), 0.5, dt),
        "mu_r": init.full((d,), 0.5, dt),
        "wk": normal_init(init, (d, f), dt),
        "wv": normal_init(init, (f, d), dt),
        "wr": normal_init(init, (d, d), dt),
    }


def rwkv_channel_axes(cfg: ModelConfig) -> Dict:
    return {"mu_k": ("embed",), "mu_r": ("embed",),
            "wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
            "wr": ("embed", "mlp")}


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along time; ``prev [B, D]`` seeds position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _ddlerp(p: Dict, x: torch.Tensor, x_prev: torch.Tensor,
            dt_c) -> List[torch.Tensor]:
    """Data-dependent token-shift mixes for (w, k, v, r, g)."""
    xx = x_prev - x
    xxx = x + xx * p["mu_x"].to(dt_c)
    h = torch.tanh(xxx @ p["mix_w1"].to(dt_c))             # [B,L,5*G]
    # split over the batch only, its gradient too (the constraint's
    # backward): split over model along the tokens, that gradient would
    # reach mix_w1's matmul as a strided shard of the flattened (pod,
    # data) batch, which DTensor cannot redistribute
    h5 = constrain(split_last(h, 5, h.shape[-1] // 5),
                   ("batch", None, None, None))
    mix = torch.einsum("blcg,cgd->cbld", h5, p["mix_w2"].to(dt_c))
    return [x + xx * (p["mu"][i].to(dt_c) + mix[i])
            for i in range(len(MIX_NAMES))]


def _group_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                H: int) -> torch.Tensor:
    """Per-head layer norm over the head dim: eps 64e-5, population
    variance, fp32 inside."""
    yh = split_last(y, H, y.shape[-1] // H).to(torch.float32)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    out = (merge_last(yh) * scale.to(torch.float32)
           + bias.to(torch.float32))
    return out.to(y.dtype)


def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, S: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence in fp32: ``r, k, v, w [B, L, H, N]``, ``u [H, N]``,
    ``S [B, H, N, N]`` -> (y ``[B, L, H, N]``, final S)."""
    L = r.shape[1]
    bonus = (r * u * k).sum(-1, keepdim=True) * v           # [B,L,H,N]
    # one unbind a tensor, not an index a step: the backward of r[:, t]
    # would make a zero tensor of all L steps for every step
    rs, ws = r.unbind(1), w.unbind(1)
    ys = []
    for t0 in range(0, L, _BLOCK):
        t1 = min(t0 + _BLOCK, L)
        kv = (k[:, t0:t1, :, :, None] * v[:, t0:t1, :, None, :]).unbind(1)
        for t in range(t0, t1):
            ys.append(torch.matmul(rs[t][:, :, None, :], S)[:, :, 0])
            S = torch.addcmul(kv[t - t0], ws[t][:, :, :, None], S)
    return torch.stack(ys, dim=1) + bonus, S


def rwkv_time_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, L, D]
    state: Optional[Dict] = None,        # {"S": [B,H,N,N], "x_prev": [B,D]}
) -> Tuple[torch.Tensor, Dict]:
    dt_c = x.dtype
    f32 = torch.float32
    H, N = rwkv_dims(cfg)
    B = x.shape[0]
    x_prev = None if state is None else state["x_prev"]
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shift(x, x_prev), dt_c)

    r = xr @ p["wr"].to(dt_c)
    k = xk @ p["wk"].to(dt_c)
    v = xv @ p["wv"].to(dt_c)
    g = F.silu(xg @ p["wg"].to(dt_c))
    lora = torch.tanh(xw @ p["decay_w1"].to(dt_c)) @ p["decay_w2"].to(dt_c)
    w = torch.exp(-torch.exp(p["w0"].to(f32) + lora.to(f32)))  # (0, 1)

    def heads(t):
        return split_last(t, H, N).to(f32)

    s0 = (torch.zeros(B, H, N, N, dtype=f32, device=x.device)
          if state is None else state["S"].to(f32))
    args = (heads(r), heads(k), heads(v), heads(w),
            split_last(p["u"].to(f32), H, N), s0)
    pol = current_policy()
    if pol is None:
        y, S_fin = _wkv(*args)
    else:
        hd = pol.placements_for(args[0].shape, ("batch", None, "heads", None))
        st = pol.placements_for(s0.shape, ("batch", "heads", None, None))
        u = pol.placements_for((H, N), ("heads", None))
        y, S_fin = local_call(_wkv, args, (hd,) * 4 + (u, st), (hd, st))
    y = merge_last(y).to(dt_c)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], H) * g
    return y @ p["wo"].to(dt_c), {"S": S_fin, "x_prev": x[:, -1, :]}


def rwkv_time_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token: the same function at L = 1."""
    return rwkv_time_full(cfg, p, x, state)


def rwkv_channel_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,
    state: Optional[Dict] = None,        # {"x_prev": [B, D]}
) -> Tuple[torch.Tensor, Dict]:
    dt_c = x.dtype
    x_prev = None if state is None else state["x_prev"]
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["mu_k"].to(dt_c)
    xr = x + (xs - x) * p["mu_r"].to(dt_c)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt_c)))
    kv = k @ p["wv"].to(dt_c)
    r = torch.sigmoid(xr @ p["wr"].to(dt_c))
    return r * kv, {"x_prev": x[:, -1, :]}
