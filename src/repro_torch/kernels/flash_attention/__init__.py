"""Flash-attention forward (causal / sliding window, GQA by index).  Port of
``src/repro/kernels/flash_attention/``: ``csrc/flash_attention_wgmma.cu``
is the CUDA kernel (every head dim; bf16/f16, and f32 under the
split-precision contract), ``kernel.py`` its ctypes binding, ``ops.py``
the public op, ``ref.py`` the plain PyTorch version."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
