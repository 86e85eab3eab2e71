"""The SSD-scan CUDA kernel: build, bind, launch.

Port of ``src/repro/kernels/ssm_scan/kernel.py``.  The Pallas kernel
``_ssd_kernel`` becomes ``csrc/ssd_scan.cu`` (CUDA C++ for ``sm_90a``),
built with ``nvcc`` at first use into ``build/kernels/`` and bound through
``ctypes``.  It reads the model layout directly: x ``[B, L, H, P]``,
a ``[B, L, H]`` and B/C ``[B, L, N]`` indexed at each stream's batch (the
reference's ops layer copied B and C out per head), and it pads the tail
chunk itself.  Its plain version is ``ref.ssd_chunked_ref`` with a zero
initial state.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch

_BC_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the kernel's limits: chunk, head dim P, state dim N
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, p, p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu", _bind)


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (no synchronisation).

    ``x [B, L, H, P]`` and ``a [B, L, H]`` float32, ``Bm, Cm [B, L, N]``
    (f32, bf16 or f16), on one CUDA device, unit stride along P and N.
    Returns ``(y [B, L, H, P], final_state [B, H, P, N])``, fp32 and
    contiguous, for a zero initial state and chunks of ``min(chunk, L)``
    steps.  Raises on anything else, and when the launch reports an error.
    Each launch bumps ``ssd_scan_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 4 or a.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("x [B,L,H,P], a [B,L,H], B/C [B,L,N] expected")
    Bsz, L, H, P = x.shape
    N = int(Bm.shape[-1])
    code = _BC_CODES.get(Bm.dtype)
    if (x.dtype != torch.float32 or a.dtype != torch.float32 or code is None
            or Cm.dtype != Bm.dtype):
        raise TypeError("x and a must be float32; B and C one of "
                        f"{sorted(str(d) for d in _BC_CODES)}")
    if (a.shape != (Bsz, L, H) or Bm.shape != (Bsz, L, N)
            or Cm.shape != (Bsz, L, N)
            or any(t.device != x.device for t in (a, Bm, Cm))):
        raise ValueError("a, B, C shapes or devices do not match x")
    Q = min(int(chunk), L)
    if not (1 <= Q <= MAX_CHUNK and P <= MAX_P and N <= MAX_N):
        raise ValueError(f"chunk {Q}, P {P}, N {N} outside the kernel's "
                         f"limits ({MAX_CHUNK}, {MAX_P}, {MAX_N})")
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *a.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
        *y.stride()[:3])
    lib = LIBRARY.get()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), code,
            y.data_ptr(), state.data_ptr(), Bsz, L, H, P, N, Q,
            ctypes.addressof(strides), stream)
    check_launch(err, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
