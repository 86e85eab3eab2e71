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

``n_groups == -1`` is the reference's shard-local dispatch: under a
sharding policy whose batch axes split the batch, routing and dispatch
run on each rank's own tokens (``local_call``), so capacity is per shard
and ``aux`` is averaged over the batch axes.  Each rank runs its local
experts (or its slice of every expert's FFN) and the output is a partial
sum over ``model``.  Without such a policy it takes the reference's own
fallback, one global group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import (
    current_policy,
    is_dtensor,
    local_call,
    mesh_coordinate,
)
from repro_torch.tracing import span


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


def moe_axes(cfg: ModelConfig) -> Dict:
    ax = {"router": ("embed", None),
          "gate": ("experts", "embed", "expert_mlp"),
          "up": ("experts", "embed", "expert_mlp"),
          "down": ("experts", "expert_mlp", "embed")}
    if cfg.moe.n_shared_experts:
        ax["shared"] = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
                        "down": ("mlp", "embed")}
    return ax


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
    f_e = _counts(e.reshape(-1), m.n_experts).to(torch.float32) / (
        T * m.top_k)
    aux = m.n_experts * torch.sum(f_e * probs.mean(dim=0))
    return w, e, aux


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for ``idx < n``, with a shape that
    does not depend on the data (the dry run's fake tensors need that)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def capacity(m: MoEConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens``: the reference's Python
    float arithmetic, at least 1, rounded up to a multiple of 8."""
    cap = max(int(m.capacity_factor * tokens * m.top_k / m.n_experts), 1)
    return -(-cap // 8) * 8


def _dispatch_group(m: MoEConfig, xt: torch.Tensor, w: torch.Tensor,
                    e: torch.Tensor, cap: int, p: Dict,
                    compute_dtype, first_expert: int = 0) -> torch.Tensor:
    """Scatter -> expert products -> gather for one token group.
    ``xt [T, D]``, ``w``/``e`` ``[T, k]`` -> ``[T, D]``.  ``p`` may hold
    only experts ``first_expert ..`` (a rank's share): the other experts'
    slots then give zeros."""
    T, D = xt.shape
    k, E = m.top_k, m.n_experts
    with span("moe.dispatch"):
        flat_e = e.reshape(-1)                              # [T*k]
        # place of each (token, slot) within its expert, token-major order:
        # its rank in a stable sort by expert less the expert's first rank
        # (the reference's exclusive cumsum over a one-hot, without the
        # [T*k, E] scan)
        order = torch.argsort(flat_e, stable=True)
        counts = _counts(flat_e, E)
        rank = torch.empty_like(flat_e)
        rank[order] = torch.arange(T * k, device=xt.device)
        pos = rank - (torch.cumsum(counts, 0) - counts)[flat_e]
        keep = pos < cap                                    # dropped past cap
        dest = (flat_e * cap + torch.where(keep, pos, 0)).reshape(T, k)
        keep = keep.reshape(T, k)

        buf = torch.zeros(E * cap + 1, D, dtype=compute_dtype,
                          device=xt.device)
        xc = xt.to(compute_dtype)
        for j in range(k):      # dropped slots land in the spare last row
            buf.index_copy_(0, torch.where(keep[:, j], dest[:, j], E * cap),
                            xc)
        El = p["gate"].shape[0]
        eb = buf[first_expert * cap:(first_expert + El) * cap].view(
            El, cap, D)
    with span("moe.experts"):
        h = torch.bmm(eb, p["gate"].to(compute_dtype))
        u = torch.bmm(eb, p["up"].to(compute_dtype))
        with span("moe.swiglu"):
            a = F.silu(h) * u
        out = torch.bmm(a, p["down"].to(compute_dtype))
        out = out.view(El * cap, D)
        if El < E:              # zero rows for the other ranks' experts
            out = F.pad(out, (0, 0, first_expert * cap,
                              (E - first_expert - El) * cap))
    del buf, eb, h, u, a

    with span("moe.combine"):
        wc = w.to(compute_dtype)
        y = None
        for j in range(k):
            g = torch.where(keep[:, j, None], out[dest[:, j]], 0) \
                * wc[:, j, None]
            y = g if y is None else y + g
    return y


def _shared_mlp(sp: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = F.silu(x @ sp["gate"].to(compute_dtype))
    h = h * (x @ sp["up"].to(compute_dtype))
    return h @ sp["down"].to(compute_dtype)


def _moe_tokens(m: MoEConfig, p: Dict, xt: torch.Tensor, compute_dtype,
                first_expert: int = 0, with_shared: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing and grouped dispatch of tokens ``xt [T, D]`` -> (``[T, D]``,
    aux).  With ``n_groups > 1`` (GShard style) the tokens split into
    groups of independent capacity; ``G`` falls back to 1 when it does
    not divide the token count, as in the reference."""
    T = xt.shape[0]
    with span("moe.route"):
        w, e, aux = _route(m, xt @ p["router"].to(compute_dtype))
    G = m.n_groups if T % m.n_groups == 0 else 1
    Tg = T // G
    cap = capacity(m, Tg)
    ys = [_dispatch_group(m, xt[g * Tg:(g + 1) * Tg],
                          w[g * Tg:(g + 1) * Tg], e[g * Tg:(g + 1) * Tg],
                          cap, p, compute_dtype, first_expert)
          for g in range(G)]
    y = ys[0] if G == 1 else torch.cat(ys)
    if m.n_shared_experts and with_shared:
        y = y + _shared_mlp(p["shared"], xt, compute_dtype)
    return y, aux


def _moe_shard_local(cfg: ModelConfig, m: MoEConfig, p: Dict,
                     x: torch.Tensor, compute_dtype, bax: Tuple[str, ...]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_tokens` on each rank's tokens (``local_call``): the
    batch split over the mesh axes ``bax`` (none: every rank routes all
    tokens, the global groups), the expert weights as the policy lays
    them out for compute.  A rank holding a share of the experts (or of
    every expert's FFN) gives a partial sum over ``model``; the aux loss
    is the mean over the ``bax`` shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pol = current_policy()
    nb = math.prod(pol.shape[a] for a in bax) if bax else 1
    ffn = ("gate", "up", "down")
    axes = moe_axes(cfg)
    args = [x, p["router"]] + [p[n] for n in ffn]
    w_axes = [axes[n] for n in ffn]
    if m.n_shared_experts:
        args += [p["shared"][n] for n in ffn]
        w_axes += [axes["shared"][n] for n in ffn]
    w_pl = [pol.placements_for(a.shape, ax, compute=True)
            for a, ax in zip(args[2:], w_axes)]
    dims = pol.mesh.mesh_dim_names
    rep = tuple(Replicate() for _ in dims)
    split = w_pl[0] != rep
    skip_shared = False
    if m.n_shared_experts and (w_pl[3] != rep) != split:
        if split:       # whole shared FFN on every rank: add it once
            skip_shared = mesh_coordinate("model") != 0
        else:           # routed experts whole: so is the shared FFN
            w_pl[3:] = [rep] * 3
    x_pl = tuple(Shard(0) if n in bax else Replicate() for n in dims)
    # a partial output over model takes the aux loss on one model rank
    over_model = Partial() if split else Replicate()
    y_pl = tuple(Shard(0) if n in bax else over_model if n == "model"
                 else Replicate() for n in dims)
    aux_pl = tuple(Partial() if n in bax else over_model if n == "model"
                   else Replicate() for n in dims)
    aux_w = 0.0 if split and mesh_coordinate("model") else 1.0 / nb

    def body(x_loc, router, gate, up, down, *shared):
        B_loc, S, D = x_loc.shape
        first = 0
        if gate.shape[0] < m.n_experts:          # experts split over model
            first = mesh_coordinate("model") * gate.shape[0]
        lp = {"router": router, "gate": gate, "up": up, "down": down}
        if shared:
            lp["shared"] = dict(zip(ffn, shared))
        y, aux = _moe_tokens(m, lp, x_loc.reshape(B_loc * S, D),
                             compute_dtype, first, not skip_shared)
        return y.reshape(B_loc, S, D), aux * aux_w

    return local_call(body, args, [x_pl, rep] + w_pl, (y_pl, aux_pl))


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, compute_dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> (output ``[B, S, D]``, aux_loss scalar).

    ``n_groups == -1`` dispatches on each batch shard under a policy whose
    batch axes split the batch (capacity per shard), else in one global
    group, as the reference falls back.  Under a policy the dispatch runs
    in ``local_call`` (DTensor has no rule for it)."""
    m = cfg.moe
    pol = current_policy()
    sharded = pol is not None and is_dtensor(x)
    bax = ()
    if m.n_groups == -1:
        m = dataclasses.replace(m, n_groups=1)
        if sharded:
            bax = pol.batch_axes()
            if x.shape[0] % math.prod(pol.shape[a] for a in bax):
                bax = ()
    if sharded:
        return _moe_shard_local(cfg, m, p, x, compute_dtype, bax)
    B, S, D = x.shape
    y, aux = _moe_tokens(m, p, x.reshape(B * S, D), compute_dtype)
    return y.reshape(B, S, D), aux
