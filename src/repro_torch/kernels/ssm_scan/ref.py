"""Plain PyTorch SSD scans: the kernel's plain version and a second oracle.

Port of ``src/repro/kernels/ssm_scan/ref.py`` and of
``src/repro/models/ssm.py::ssd_chunked_ref``.  :func:`ssd_chunked_ref` is
the chunked scan (intra-chunk decay matmuls plus the inter-chunk state
carry), all fp32 (float64 when x is float64, for an oracle of the fp32
kernels); with a zero initial state it is the CUDA kernels' plain
version.  :func:`ssd_scan_sequential` is the literal per-step recurrence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked_ref(
    x: torch.Tensor,      # [B, L, H, P]  (dt already folded in)
    a: torch.Tensor,      # [B, L, H]     per-step decay in (0,1)
    Bm: torch.Tensor,     # [B, L, N]
    Cm: torch.Tensor,     # [B, L, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> ``(y [B, L, H, P], final_state [B, H, P, N])``,
    both fp32, or both float64 when ``x`` is float64."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = -L % Q
    if pad:
        # identity-pad the tail: decay 1 and zero input leave the state
        # untouched; the padded outputs are sliced away below
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // Q
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(Bsz, nc, Q, H, P).to(ct)
    ac = a.reshape(Bsz, nc, Q, H).to(ct)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(ct)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(ct)

    la = torch.log(torch.clamp_min(ac, 1e-20))
    cum = torch.cumsum(la, dim=2)                      # [B,nc,Q,H] inclusive
    # intra-chunk decay Lmat[i,j] = prod a_{j+1..i} for j <= i; masked
    # before exp so the i < j entries never overflow
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    i_ge_j = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    seg = torch.where(i_ge_j[None, None, :, :, None], seg,
                      torch.full((), -float("inf"), device=x.device))
    Lmat = torch.exp(seg)
    del seg

    # diagonal (intra-chunk) output: y_i = sum_j C_i.B_j L_ij x_j
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    ydiag = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * Lmat, xc)
    del Lmat

    # per-chunk input to the carried state: S_c = sum_j (decay j..end) B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
    Schunk = torch.einsum("bcjhp,bcjn->bchpn", xc * decay_to_end[..., None],
                          Bc)
    chunk_decay = torch.exp(cum[:, :, -1, :])          # [B,nc,H]

    s = (torch.zeros((Bsz, H, P, N), dtype=ct, device=x.device)
         if init_state is None else init_state.to(ct))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + Schunk[:, c]
    prev_states = torch.stack(prev, dim=1)             # [B,nc,H,P,N]

    # off-diagonal: contribution of the carried state entering each chunk
    decay_in = torch.exp(cum)                          # [B,nc,Q,H]
    yoff = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) \
        * decay_in[..., None]
    y = (ydiag + yoff).reshape(Bsz, Lp, H, P)[:, :L]
    return y, s


def ssd_scan_sequential(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Literal per-step recurrence: ``x [BH, L, P]``, ``a [BH, L]``,
    ``B/C [BH, L, N]`` -> ``(y [BH, L, P], final_state [BH, P, N])``."""
    BH, L, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, a, Bm, Cm = (t.to(f32) for t in (x, a, Bm, Cm))
    s = torch.zeros((BH, P, N), dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        s = s * a[:, t, None, None] + x[:, t, :, None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bn,bpn->bp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s
