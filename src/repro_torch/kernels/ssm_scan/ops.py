"""Public SSD-scan op in the model layout.

Port of ``src/repro/kernels/ssm_scan/ops.py``.  Runs the CUDA kernel that
``kernel.variant`` picks on CUDA tensors and the plain chunked scan
(``ref.ssd_chunked_ref``) on CPU tensors, both from the given initial state
or from zero.  No head-major
copies and no padding: the kernels read the model layout and pad the tail
chunk themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref

DEFAULT_CHUNK = 128


def ssd_scan(
    x: torch.Tensor,          # [B, L, H, P]  (dt folded in)
    a: torch.Tensor,          # [B, L, H]
    Bm: torch.Tensor,         # [B, L, N]     (shared across heads)
    Cm: torch.Tensor,         # [B, L, N]
    chunk: int = DEFAULT_CHUNK,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(y [B, L, H, P], final_state [B, H, P, N])``, fp32, from
    ``init_state`` (None: zero)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, a, Bm, Cm, min(chunk, x.shape[1]),
                               init_state)
    return ssd_scan_cuda(x, a, Bm, Cm, chunk, init_state)
