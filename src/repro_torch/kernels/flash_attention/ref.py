"""Plain PyTorch softmax attention: the flash kernel's plain version.

Port of ``src/repro/kernels/flash_attention/ref.py``.  Scores, softmax and
the product with V are fp32 (float64 when q is float64, for gradient
checks) written out with ``einsum``/``softmax``; masked scores are -1e30,
as in the kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,          # [B, H, Sq, D]
    k: torch.Tensor,          # [B, Hkv, Skv, D]
    v: torch.Tensor,          # [B, Hkv, Skv, D]
    scale: float,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Hkv, group, Sq, D).to(ct)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(ct)) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        ok = k_pos <= q_pos
        if window > 0:
            ok = ok & (k_pos > q_pos - window)
        s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.to(ct))
    return out.reshape(B, H, Sq, D).to(q.dtype)
