"""Mamba2 (SSD) mixer — zamba2's backbone block.

Port of ``src/repro/models/ssm.py``.  Per head h, with scalar decay:

    s_t = a_t · s_{t-1} + dt_t · B_t ⊗ x_t          s ∈ R^{P×N}
    y_t = C_t · s_t  (+ D ⊙ x_t)

with ``a_t = exp(dt_t · A)``.  Prefill, from a zero or a given state, runs
the chunked SSD scan through ``kernels.ssm_scan.ssd_scan``: the CUDA kernel
(K3) on a CUDA tensor, the plain chunked scan on a CPU tensor.  Under a
sharding policy the scan runs on each rank's shards (batch over the
batch axes, heads over ``model``).  Decode keeps the O(1)-per-token
recurrence in plain PyTorch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import (
    constrain,
    current_policy,
    local_call,
    merge_last,
    split_last,
)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.d_state


def init_ssm(cfg: ModelConfig, init: Init) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, N = ssm_dims(cfg)
    dt = cfg.param_dtype
    conv_ch = d_inner + 2 * N            # x, B, C go through the conv
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    return {
        # in_proj -> [z, xBC, dt]
        "in_proj": normal_init(init, (d, 2 * d_inner + 2 * N + H), dt),
        "conv_w": normal_init(init, (s.conv_width, conv_ch), dt,
                              fan_in=s.conv_width),
        "conv_b": init.full((conv_ch,), 0.0, dt),
        "a_log": (a_log.to(dt).to(init.device)
                  if init.device.type != "meta" else init.full((H,), 0, dt)),
        "dt_bias": init.full((H,), 0.0, dt),
        "d_skip": init.full((H,), 1.0, dt),
        "norm": init.full((d_inner,), 1.0, dt),
        "out_proj": normal_init(init, (d_inner, d), dt, fan_in=d_inner),
    }


def ssm_axes(cfg: ModelConfig) -> Dict:
    return {"in_proj": ("embed", "mlp"), "conv_w": ("conv", None),
            "conv_b": (None,), "a_log": (None,), "dt_bias": (None,),
            "d_skip": (None,), "norm": ("mlp",),
            "out_proj": ("mlp", "embed")}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, H, N = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: 2 * d_inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt_raw


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x [B,L,C], w [W,C].

    Returns (silu(out) [B,L,C], new_state [B,W-1,C])."""
    W = w.shape[0]
    L = xBC.shape[1]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, xBC], dim=1)                  # [B, L+W-1, C]
    out = xp[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i: i + L, :] * w[i][None, None, :]
    out = out + b[None, None, :]
    new_state = xp[:, -(W - 1):, :] if W > 1 else pad
    return F.silu(out), new_state


def _mixer_inputs(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  conv_state: Optional[torch.Tensor]):
    """in_proj, conv and the decay: ``(z, xs, Bm, Cm, dt_v, a, new_conv)``."""
    dt_c = x.dtype
    d_inner, H, N = ssm_dims(cfg)
    # whole over model: z, xBC and dt split the projection where its
    # shards do not
    zxbcdt = constrain(x @ p["in_proj"].to(dt_c), ("batch", "seq", None))
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"].to(dt_c),
                                 p["conv_b"].to(dt_c), conv_state)
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner: d_inner + N]
    Cm = xBC[..., d_inner + N:]
    dt_v = F.softplus(dt_raw.to(torch.float32)
                      + p["dt_bias"].to(torch.float32))       # [B,L,H]
    A = -torch.exp(p["a_log"].to(torch.float32))              # [H]
    a = torch.exp(dt_v * A)                                   # decay
    return z, xs, Bm, Cm, dt_v, a, new_conv


def _mixer_output(cfg: ModelConfig, p: Dict, y: torch.Tensor,
                  xh: torch.Tensor, z: torch.Tensor, dt_c) -> torch.Tensor:
    y = y + xh.to(torch.float32) * p["d_skip"].to(torch.float32)[:, None]
    y = merge_last(y).to(dt_c)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(dt_c)


def _scan(xin, a, Bm, Cm, chunk: int, init_state):
    """``ssd_scan``; under a policy on each rank's batch and head
    shards."""
    pol = current_policy()
    args = (xin, a, Bm, Cm) + (() if init_state is None else (init_state,))

    def body(xin, a, Bm, Cm, *s0):
        return ssd_scan(xin, a, Bm, Cm, chunk,
                        init_state=s0[0] if s0 else None)

    if pol is None:
        return body(*args)
    B, _, H, P = xin.shape
    N = Bm.shape[-1]
    heads = pol.placements_for(xin.shape, ("batch", None, "heads", None))
    st = pol.placements_for((B, H, P, N), ("batch", "heads", None, None))
    pl = (heads, pol.placements_for(a.shape, ("batch", None, "heads")),
          pol.placements_for(Bm.shape, ("batch", None, None)),
          pol.placements_for(Cm.shape, ("batch", None, None)), st)
    return local_call(body, args, pl[:len(args)], (heads, st))


def ssm_full(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, L, D]
    state: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill pass -> (output, final recurrent state)."""
    s = cfg.ssm
    dt_c = x.dtype
    H = ssm_dims(cfg)[1]
    conv_state = None if state is None else state["conv"]
    z, xs, Bm, Cm, dt_v, a, new_conv = _mixer_inputs(cfg, p, x, conv_state)
    xh = split_last(xs, H, s.head_dim)
    xin = xh.to(torch.float32) * dt_v[..., None]
    # the configured chunk: the kernels' dispatch reads it, and each takes
    # min(chunk, L) itself (the wgmma kernel pads a shorter sequence)
    y, final = _scan(xin, a, Bm, Cm, s.chunk,
                     None if state is None else state["ssm"])
    out = _mixer_output(cfg, p, y, xh, z, dt_c)
    return out, {"conv": new_conv, "ssm": final.to(torch.float32)}


def ssm_decode(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                     # [B, 1, D]
    state: Dict,                         # {"conv": [B,W-1,C], "ssm": [B,H,P,N]}
) -> Tuple[torch.Tensor, Dict]:
    """O(1) single-token recurrence."""
    s = cfg.ssm
    dt_c = x.dtype
    H = ssm_dims(cfg)[1]
    z, xs, Bm, Cm, dt_v, a, new_conv = _mixer_inputs(cfg, p, x,
                                                     state["conv"])
    Bm, Cm, dt_v, a = Bm[:, 0], Cm[:, 0], dt_v[:, 0], a[:, 0]
    xh = split_last(xs[:, 0], H, s.head_dim).to(torch.float32)
    xin = xh * dt_v[..., None]                          # [B,H,P]
    s_new = (state["ssm"] * a[:, :, None, None]
             + xin[..., None] * Bm.to(torch.float32)[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm.to(torch.float32), s_new)
    out = _mixer_output(cfg, p, y[:, None], xh[:, None], z, dt_c)
    return out, {"conv": new_conv, "ssm": s_new}
