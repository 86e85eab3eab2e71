"""The flash-attention CUDA kernel: build, bind, launch.

Port of ``src/repro/kernels/flash_attention/kernel.py``.  The Pallas kernel
``_flash_kernel`` becomes ``csrc/flash_attention.cu`` (CUDA C++ for
``sm_90a``), built with ``nvcc`` at first use into ``build/kernels/`` and
bound through ``ctypes``.  The kernel takes any batch, head and sequence
strides, so the model hands it ``[B, S, H, D]`` activations as
``[B, H, S, D]`` views without a copy, and it masks its own ragged edges:
nothing is padded.  Its plain version is ``ref.attention_ref``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, ctypes.c_float, i, i,
                   p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu", _bind)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation).

    ``q [B, H, Sq, D]``, ``k, v [B, Hkv, Skv, D]`` on one CUDA device, one
    dtype (f32, bf16 or f16), unit stride along D; returns ``o`` shaped and
    strided like ``q``.  Raises on anything else, and when the launch
    reports an error.  Each launch bumps ``flash_attention_cuda.launches``.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                         f"got {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"flash_attention kernel does not take {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    B, H, Sq, D = q.shape
    Hkv, Skv = int(k.shape[1]), int(k.shape[2])
    if (k.shape != (B, Hkv, Skv, D) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype
            or k.device != q.device or v.device != q.device):
        raise ValueError("k and v must be [B, Hkv, Skv, D] in q's dtype, on "
                         "q's device")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)      # keeps q's strides: a [B,S,H,D] view stays one
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = LIBRARY.get()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
            B, H, Hkv, Sq, Skv, D, ctypes.addressof(strides), float(scale),
            int(bool(causal)), int(window), stream)
    check_launch(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
