"""Public flash-attention op: ``[B, H, S, D]`` layout, GQA, sliding window.

Port of ``src/repro/kernels/flash_attention/ops.py``.  Runs a CUDA kernel
(``kernel.variant`` picks which) on CUDA tensors and the plain version
(``ref.attention_ref``) on CPU tensors.  Unlike the Pallas wrapper it pads
nothing: the kernels mask keys past ``Skv`` and skip query rows past
``Sq`` themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,          # [B, H, Sq, D]
    k: torch.Tensor,          # [B, Hkv, Skv, D]
    v: torch.Tensor,          # [B, Hkv, Skv, D]
    scale: float,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention, output in q's dtype; ``window=0`` means none."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale, causal, window)
    return flash_attention_cuda(q, k, v, scale, causal, window)
