"""The plain versions of the norm and RoPE kernels, in PyTorch ops on any
tensor: what ``models/layers.py``'s ``rms_norm`` and ``apply_rope`` run on
CPU and meta tensors, and what the kernels' backwards recompute and
differentiate.  Ports of ``src/repro/models/layers.py``'s ``rms_norm``,
``rope_freqs`` and ``apply_rope``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope_plain(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]`` (split-half
    rotation, fp32 inside)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv   # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_qk_plain(q: torch.Tensor, k: Optional[torch.Tensor],
                  positions: torch.Tensor, theta: float
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`apply_rope_plain` on q and on k (None stays None): the RoPE
    kernel's signature."""
    return (apply_rope_plain(q, positions, theta),
            None if k is None else apply_rope_plain(k, positions, theta))
