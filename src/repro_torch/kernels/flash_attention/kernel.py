"""The flash-attention CUDA kernel: build, bind, dispatch, launch.

Port of ``src/repro/kernels/flash_attention/kernel.py``.  The Pallas kernel
``_flash_kernel`` becomes a hand-written CUDA C++ kernel for ``sm_90a``,
``csrc/flash_attention_wgmma.cu``, built with ``nvcc`` at first use into
``build/kernels/`` and bound through ``ctypes``.  It runs on the tensor
cores through ``wgmma`` at head dims 16, 32, 64 and 128 (the head dim is
a template parameter), in two instances: "wgmma" for bf16 and f16
(TMA-fed tiles), "wgmma_f32" for f32 under the split-precision contract
(every fp32 operand as bf16 hi/lo parts, three products for each, fp32
sums).

:func:`variant` names the instance a call takes.  A failed build or
launch raises.  Both take any batch, head and sequence strides, so the
model hands them ``[B, S, H, D]`` activations as ``[B, H, S, D]`` views
without a copy, and both mask their own ragged edges: nothing is padded.
The plain version is ``ref.attention_ref``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, tma_strides

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: the dtypes of its bf16/f16 instance and of its f32 (split-precision) one
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
WGMMA_F32_DTYPE = torch.float32
VARIANTS = ("wgmma", "wgmma_f32")
_CSRC = Path(__file__).resolve().parent / "csrc"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_wgmma_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, ctypes.c_float, i, i,
                   p]
    fn.restype = ctypes.c_int


#: links libcuda for ``cuTensorMapEncodeTiled``
WGMMA_LIBRARY = CudaLibrary(_CSRC / "flash_attention_wgmma.cu", _bind,
                            extra_flags=("-lcuda",))


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The instance a call takes, at every head dim of ``HEAD_DIMS``:
    ``"wgmma"`` for bf16/f16, ``"wgmma_f32"`` for f32."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {HEAD_DIMS}")
    if dtype in WGMMA_DTYPES:
        return "wgmma"
    if dtype == WGMMA_F32_DTYPE:
        return "wgmma_f32"
    raise TypeError(f"flash_attention kernel does not take {dtype}")


def wgmma_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(q, k, v, o, strides)`` as the wgmma kernel takes them: each input
    itself, or a contiguous copy where :func:`tma_strides` refuses it; a
    fresh output with q's strides (contiguous when q is not dense with
    unit stride along D); and the 12 element strides of the launch:
    (batch, head, sequence) of q, k, v and o."""
    o = (torch.empty_like(q) if q.stride(-1) == 1
         else torch.empty(q.shape, dtype=q.dtype, device=q.device))
    q, k, v = (t if tma_strides(t) else t.contiguous() for t in (q, k, v))
    strides = [s for t in (q, k, v) for s in tma_strides(t)]
    return q, k, v, o, strides + list(o.stride()[:3])


def _check(q, k, v) -> Tuple[int, int, int, int, int, int, int]:
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
    return code, B, H, Hkv, Sq, Skv, D


def _launch(q, k, v, o, strides, code, B, H, Hkv, Sq, Skv, D, scale, causal,
            window) -> None:
    st = (ctypes.c_longlong * 12)(*strides)
    fn = WGMMA_LIBRARY.get().flash_attention_wgmma_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 code, B, H, Hkv, Sq, Skv, D, ctypes.addressof(st),
                 float(scale), int(bool(causal)), int(window), stream)
    if err >= 1000:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - 1000}")
    check_launch(err, "flash_attention")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention_wgmma.cu`` on the current stream (no
    synchronisation): its bf16/f16 instance, or for f32 its
    split-precision instance.

    ``q [B, H, Sq, D]``, ``k, v [B, Hkv, Skv, D]`` on one CUDA device, one
    dtype (f32, bf16 or f16), D in ``HEAD_DIMS``; returns ``o`` shaped
    like ``q`` and, where q is dense, strided like it.  An operand TMA (or
    the f32 instance's 16-byte loads) cannot read as it lies is copied
    first (:func:`wgmma_operands`).  Raises on anything else, and when the
    build or the launch fails.  ``flash_attention_cuda.launches`` counts
    every launch, ``flash_attention_cuda.by_variant`` each instance's."""
    code, B, H, Hkv, Sq, Skv, D = _check(q, k, v)
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty sequence: Sq={Sq}, Skv={Skv}")
    q, k, v, o, strides = wgmma_operands(q, k, v)
    _launch(q, k, v, o, strides, code, B, H, Hkv, Sq, Skv, D, scale, causal,
            window)
    _count(variant(q.dtype, D))
    return o


def _count(name: str) -> None:
    flash_attention_cuda.launches += 1
    flash_attention_cuda.by_variant[name] += 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
