"""Plain float32 reference of Mixtral 8x7B (arXiv:2401.04088) as this
benchmark runs it.

Each layer, on x [B, S, d]: pre-norm grouped-query attention (32 query
heads, 8 key-value heads of 128) with RoPE (theta 1e6), causal and dense
(a ``sliding_window`` in the configuration limits it), added to the
residual; then a pre-norm sparse MoE: a
linear router over 8 experts, softmax, the top 2 experts of each token
with their probabilities renormalised to sum to one, each a SwiGLU, the
weighted sum added to the residual.  The head is RMSNorm, then W_head.

As configured, each expert takes at most ``capacity`` token slots a
call: ``int(capacity_factor * T * top_k / n_experts)`` rounded up to a
multiple of 8 over the call's T tokens, the slots ranked token-major
(token t's first choice, then its second, then token t+1's); a slot
past its expert's capacity adds nothing.

Departures from the published model, as the configuration states them
under ``reduced``: RMS norms use its ``rms_norm_eps`` (1e-6; published
1e-5); expert capacity (above) may drop slots, which the published model
never does.

Nothing here imports the program.  Weights come as one dict a layer and
are read in float32 while their layer runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from colobench.reference.common import (
    F32,
    Precision,
    attention,
    exact_fp32,
    logits_of,
    rms_norm,
    rope,
)


def capacity(m: Dict, tokens: int) -> int:
    cap = max(int(m["capacity_factor"] * tokens * m["top_k"]
                  / m["n_experts"]), 1)
    return -(-cap // 8) * 8


def moe(c: Dict, prec: Precision, L: Dict, h: torch.Tensor,
        diag: Optional[List[Dict]] = None) -> torch.Tensor:
    """-> the experts' weighted sum [B, S, d].  ``diag`` gets, for the
    layer, the share of slots dropped and, for each prompt's last token,
    the gap between its second and third router logits (``margin``) and
    how many slots its nearest slot lies from its expert's capacity, on
    either side (``edge``: 0 for the last slot kept or the first
    dropped)."""
    m = c["moe"]
    E, k = m["n_experts"], m["top_k"]
    Bsz, S, d = h.shape
    x = h.reshape(Bsz * S, d)
    T = x.shape[0]
    z = prec.mm(x, L["router"])
    probs = torch.softmax(z, dim=-1)
    w, e = torch.topk(probs, k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    flat = e.reshape(-1)                                   # token-major
    onehot = F.one_hot(flat, E)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    cap = capacity(m, T)
    keep = rank < cap
    out = torch.zeros_like(x)
    for j in range(E):
        slots = torch.nonzero((flat == j) & keep)[:, 0]
        if not len(slots):
            continue
        tok = slots // k
        xe = x[tok]
        ye = prec.mm(F.silu(prec.mm(xe, L["gate"][j])) * prec.mm(
            xe, L["up"][j]), L["down"][j])
        out.index_add_(0, tok, ye * w.reshape(-1)[slots, None])
    if diag is not None:
        last = torch.arange(1, Bsz + 1, device=x.device) * S - 1
        top = torch.topk(z[last], k + 1, dim=-1).values
        r = rank.reshape(T, k)[last]
        edge = torch.where(r < cap, cap - 1 - r, r - cap).min(-1).values
        diag.append({"dropped": float((~keep).float().mean()),
                     "margin": (top[:, k - 1] - top[:, k]).tolist(),
                     "edge": edge.tolist()})
    return out.reshape(Bsz, S, d)


def layer(c: Dict, prec: Precision, L: Dict, x: torch.Tensor,
          diag: Optional[List[Dict]] = None) -> Tuple[torch.Tensor, Dict]:
    Bsz, S, _ = x.shape
    D = c.get("head_dim") or c["d_model"] // c["n_heads"]
    eps = c.get("rms_norm_eps", 1e-6)
    h = rms_norm(x, L["ln1"], eps)
    q = prec.mm(h, L["wq"]).reshape(Bsz, S, c["n_heads"], D)
    k = prec.mm(h, L["wk"]).reshape(Bsz, S, c["n_kv_heads"], D)
    v = prec.mm(h, L["wv"]).reshape(Bsz, S, c["n_kv_heads"], D)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    o = attention(prec, q, k, v, c.get("sliding_window") or 0)
    x = x + prec.mm(o.reshape(Bsz, S, -1), L["wo"])
    y = moe(c, prec, L, rms_norm(x, L["ln2"], eps), diag)
    return x + y, {"k": k, "v": v}


@torch.no_grad()
def prefill(c: Dict, w: Dict, tokens: torch.Tensor,
            prec: Precision = Precision(),
            diag: Optional[List[Dict]] = None
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """-> (last position's logits [B, V], each layer's cache); ``diag``
    gets each layer's routing readings (:func:`moe`)."""
    with exact_fp32():
        x = w["embed"][tokens].to(F32)
        caches: List[Dict] = []
        for L in w["layers"]:
            x, cache = layer(c, prec, L, x, diag)
            caches.append(cache)
        return logits_of(prec, w, x[:, -1], c.get("rms_norm_eps", 1e-6)), \
            caches
