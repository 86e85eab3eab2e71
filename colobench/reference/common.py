"""Plain float32 building blocks of the references: RMS norm, RoPE,
causal (windowed) attention, and the precision of products.

Nothing here imports the program.  Every product runs in true float32
(TF32 off, :func:`exact_fp32`).  :class:`Precision` rounds each product's
inputs: not at all for the reference, to float8 (e4m3, one scale a
tensor) for the control, the precision below the configurations' bf16.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
NEG_INF = -1e30
#: query rows of one attention block: the fp32 scores of a block are
#: heads x rows x keys (1 GiB at 32 heads, 1,024 rows and 8,192 keys)
Q_BLOCK = 1024


class Precision:
    """How a product's inputs are rounded: ``fp8=False`` leaves them
    float32; ``fp8=True`` rounds each to float8 e4m3 with one scale a
    tensor (its largest magnitude at 448), as an fp8 path would."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(F32)
        if not self.fp8:
            return x
        s = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(F32) * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


@contextlib.contextmanager
def exact_fp32():
    """Products in true float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, H, D]`` at positions 0..S-1, the
    split-half pairing (dims i and i + D/2 rotate together)."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=F32) / D)
    ang = torch.arange(S, device=x.device, dtype=F32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(prec: Precision, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal softmax attention, ``q [B, S, H, D]``, ``k``/``v``
    ``[B, S, Hkv, D]`` -> ``[B, S, H, D]``; query head h reads key head
    ``h // (H / Hkv)``; with ``window`` > 0 a query at i sees keys
    ``i - window < j <= i``.  One batch row and one block of query rows
    at a time."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = D ** -0.5
    pos = torch.arange(S, device=q.device)
    out = torch.empty(B, S, H, D, dtype=F32, device=q.device)
    for b in range(B):
        kb = prec.r(k[b]).repeat_interleave(G, dim=1).transpose(0, 1)
        vb = prec.r(v[b]).repeat_interleave(G, dim=1).transpose(0, 1)
        for lo in range(0, S, Q_BLOCK):
            hi = min(lo + Q_BLOCK, S)
            qb = prec.r(q[b, lo:hi]).transpose(0, 1)       # [H, rows, D]
            s = (qb @ kb.transpose(1, 2)) * scale          # [H, rows, S]
            ok = pos[None, :] <= pos[lo:hi, None]
            if window > 0:
                ok = ok & (pos[None, :] > pos[lo:hi, None] - window)
            s = torch.where(ok, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            out[b, lo:hi] = (prec.r(p) @ vb).transpose(0, 1)
    return out


def logits_of(prec: Precision, w: dict, h: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """The head over final hidden states ``h``."""
    return prec.mm(rms_norm(h, w["final_norm"], eps), w["lm_head"])
