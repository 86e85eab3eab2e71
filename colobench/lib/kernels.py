"""Device records by family, matched on the kernel's name.

K2 is ``kernels/flash_attention``'s wgmma kernels, K3 is
``kernels/ssm_scan``'s (the scan, its short-sequence tile and the B/C
pre-pass); cuBLAS's Hopper GEMMs are named ``nvjet_*`` or
``sm90_xmma_*``.  A later kernel joins a family by a name added here.
"""

from __future__ import annotations

K2 = ("flash_wgmma_kernel", "flash_wgmma_split_kernel")
K3 = ("ssd_wgmma_kernel", "ssd_short_kernel", "split_bc_kernel")
GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
COPY = ("memcpy", "memset")


def family(name: str) -> str:
    """``k2``, ``k3``, ``copy``, ``matmul`` or ``other``."""
    n = name.lower()
    if any(k in n for k in K2):
        return "k2"
    if any(k in n for k in K3):
        return "k3"
    if any(k in n for k in COPY):
        return "copy"
    if any(k in n for k in GEMM):
        return "matmul"
    return "other"
