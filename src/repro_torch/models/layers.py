"""Shared layer primitives: RMS norm, RoPE, SwiGLU, embeddings.

Port of the parts of ``src/repro/models/layers.py`` that the ported
families use.  ``compute_dtype`` casts mirror the reference's ``astype``
calls; they cost nothing when the weights already hold that dtype.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.params import Init, normal_init, embed_init


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def init_rms_norm(d: int, dtype, init: Init) -> Dict:
    return {"scale": init.full((d,), 1.0, dtype)}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
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


def init_swiglu(d_model: int, d_ff: int, dtype, init: Init) -> Dict:
    return {
        "gate": normal_init(init, (d_model, d_ff), dtype),
        "up": normal_init(init, (d_model, d_ff), dtype),
        "down": normal_init(init, (d_ff, d_model), dtype),
    }


def swiglu_apply(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = x @ p["gate"].to(compute_dtype)
    u = x @ p["up"].to(compute_dtype)
    return (F.silu(h) * u) @ p["down"].to(compute_dtype)


def init_embedding(vocab: int, d_model: int, dtype, init: Init) -> Dict:
    return {"table": embed_init(init, (vocab, d_model), dtype)}


def embed_apply(p: Dict, tokens: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    return p["table"][tokens].to(compute_dtype)


def unembed_apply(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x @ p["table"].to(compute_dtype).T
