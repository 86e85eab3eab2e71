"""Mixture-of-Experts: top-k routing with capacity-based sorted dispatch.

Port of ``src/repro/models/moe.py``: mixtral-8x7b (8 experts, top-2,
softmax gate) and deepseek-v3-671b (256 routed + 1 shared expert, top-8,
sigmoid gate with normalised weights, the first 3 layers dense).

Each (token, slot) goes to row ``e * cap + pos`` of an ``[E * cap, D]``
buffer, ``pos`` being its place among the slots routed to expert ``e`` in
token-major order (found by a stable sort, where the reference scans a
one-hot); slots past ``cap`` are dropped.  The expert products
are dense ``[E, cap, D] x [E, D, F]`` batched matmuls, as the reference's
XLA einsums are (it has no Pallas kernel here).  Kept destinations are
unique, so the buffer is filled by copying each slot's token row (one
``index_copy_`` per slot, the dropped ones into a spare last row) where
the reference adds into zeros: the same values.

``n_groups == -1`` (the reference's shard-local dispatch inside
``shard_map``) has no mesh to split over on one card; it takes the
reference's own fallback, one global group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.params import Init, normal_init


def init_moe(cfg: ModelConfig, init: Init) -> Dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    dt = cfg.param_dtype
    p = {
        "router": normal_init(init, (d, E), dt, scale=0.02),
        "gate": normal_init(init, (E, d, f), dt, fan_in=d),
        "up": normal_init(init, (E, d, f), dt, fan_in=d),
        "down": normal_init(init, (E, f, d), dt, fan_in=f),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared"] = {
            "gate": normal_init(init, (d, fs), dt),
            "up": normal_init(init, (d, fs), dt),
            "down": normal_init(init, (fs, d), dt),
        }
    return p


def _route(m: MoEConfig, logits: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (weights [T,k] fp32, experts [T,k], aux_loss).  Softmax gate up
    to 64 experts; past that (deepseek-v3) sigmoid scores with the top k
    renormalised."""
    logits = logits.to(torch.float32)
    if m.n_experts > 64:
        scores = torch.sigmoid(logits)
        w, e = torch.topk(scores, m.top_k, dim=-1)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, e = torch.topk(probs, m.top_k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    T = logits.shape[0]
    f_e = torch.bincount(e.reshape(-1), minlength=m.n_experts).to(
        torch.float32) / (T * m.top_k)
    aux = m.n_experts * torch.sum(f_e * probs.mean(dim=0))
    return w, e, aux


def capacity(m: MoEConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens``: the reference's Python
    float arithmetic, at least 1, rounded up to a multiple of 8."""
    cap = max(int(m.capacity_factor * tokens * m.top_k / m.n_experts), 1)
    return -(-cap // 8) * 8


def _dispatch_group(m: MoEConfig, xt: torch.Tensor, w: torch.Tensor,
                    e: torch.Tensor, cap: int, p: Dict,
                    compute_dtype) -> torch.Tensor:
    """Scatter -> expert products -> gather for one token group.
    ``xt [T, D]``, ``w``/``e`` ``[T, k]`` -> ``[T, D]``."""
    T, D = xt.shape
    k, E = m.top_k, m.n_experts
    flat_e = e.reshape(-1)                                  # [T*k]
    # place of each (token, slot) within its expert, token-major order: its
    # rank in a stable sort by expert less the expert's first rank (the
    # reference's exclusive cumsum over a one-hot, without the [T*k, E]
    # scan)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(T * k, device=xt.device)
    pos = rank - (torch.cumsum(counts, 0) - counts)[flat_e]
    keep = pos < cap                                        # dropped past cap
    dest = (flat_e * cap + torch.where(keep, pos, 0)).reshape(T, k)
    keep = keep.reshape(T, k)

    buf = torch.zeros(E * cap + 1, D, dtype=compute_dtype, device=xt.device)
    xc = xt.to(compute_dtype)
    for j in range(k):          # dropped slots land in the spare last row
        buf.index_copy_(0, torch.where(keep[:, j], dest[:, j], E * cap), xc)
    eb = buf[:E * cap].view(E, cap, D)
    h = torch.bmm(eb, p["gate"].to(compute_dtype))
    u = torch.bmm(eb, p["up"].to(compute_dtype))
    out = torch.bmm(F.silu(h) * u, p["down"].to(compute_dtype))
    out = out.view(E * cap, D)
    del buf, eb, h, u

    wc = w.to(compute_dtype)
    y = None
    for j in range(k):
        g = torch.where(keep[:, j, None], out[dest[:, j]], 0) * wc[:, j, None]
        y = g if y is None else y + g
    return y


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, compute_dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> (output ``[B, S, D]``, aux_loss scalar).

    With ``n_groups > 1`` (GShard style) the tokens split into groups of
    independent capacity; ``G`` falls back to 1 when it does not divide
    the token count, as in the reference."""
    m = cfg.moe
    if m.n_groups == -1:        # shard-local: one global group on one card
        m = dataclasses.replace(m, n_groups=1)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    logits = xt @ p["router"].to(compute_dtype)
    w, e, aux = _route(m, logits)
    G = m.n_groups if T % m.n_groups == 0 else 1
    Tg = T // G
    cap = capacity(m, Tg)
    ys = [_dispatch_group(m, xt[g * Tg:(g + 1) * Tg],
                          w[g * Tg:(g + 1) * Tg], e[g * Tg:(g + 1) * Tg],
                          cap, p, compute_dtype) for g in range(G)]
    y = (ys[0] if G == 1 else torch.cat(ys)).reshape(B, S, D)
    if m.n_shared_experts:
        sp = p["shared"]
        h = F.silu(x @ sp["gate"].to(compute_dtype))
        h = h * (x @ sp["up"].to(compute_dtype))
        y = y + h @ sp["down"].to(compute_dtype)
    return y, aux
