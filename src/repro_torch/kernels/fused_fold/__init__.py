"""Fused grouped power-sum fold: one device-memory pass per block for the
CSE shared-accumulator pool.  Port of ``src/repro/kernels/fused_fold/``:
``csrc/fused_fold.cu`` is the CUDA kernel, ``kernel.py`` its ctypes binding
and plain PyTorch version, ``ops.py`` the public op and cost helpers,
``ref.py`` the NumPy oracle."""

from repro_torch.kernels.fused_fold.ops import (   # noqa: F401
    canonical_names,
    fused_fold,
    kernel_flops,
    kernel_hbm_bytes,
    max_groups_for_smem,
)
from repro_torch.kernels.fused_fold.ref import fused_fold_numpy  # noqa: F401
