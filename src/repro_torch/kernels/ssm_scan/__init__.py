"""Chunked SSD (mamba2) scan from a given or a zero state.  Port of
``src/repro/kernels/ssm_scan/``: ``csrc/ssd_scan_wgmma.cu`` (bf16 tensor
cores) is the CUDA kernel, ``kernel.py`` its ctypes binding, ``ops.py``
the public op, ``ref.py`` the plain PyTorch versions (the chunked scan and
the literal recurrence)."""

from repro_torch.kernels.ssm_scan.ops import ssd_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    ssd_chunked_ref,
    ssd_scan_sequential,
)
