"""Flash-attention forward (causal / sliding window, GQA by index).  Port of
``src/repro/kernels/flash_attention/``: ``csrc/flash_attention_wgmma.cu``
(bf16/f16, head dims 64 and 128) and ``csrc/flash_attention.cu`` (the
rest) are the CUDA kernels, ``kernel.py`` their ctypes binding and the
rule between them, ``ops.py`` the public op, ``ref.py`` the plain PyTorch
version."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
