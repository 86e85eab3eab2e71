"""The SSD-scan CUDA kernels: build, bind, dispatch, launch.

Port of ``src/repro/kernels/ssm_scan/kernel.py``.  The Pallas kernel
``_ssd_kernel`` becomes hand-written CUDA C++ kernels for ``sm_90a``, each
library built with ``nvcc`` at first use into ``build/kernels/`` and
bound through ``ctypes``:

- ``csrc/ssd_scan_wgmma.cu`` at P = N = 64 and a configured chunk of 128
  steps, for any L: TMA-fed ``wgmma`` tiles on the bf16 tensor cores,
  with every fp32 operand split into bf16 hi/lo parts, in two instances:
  "wgmma" for bf16 B/C, "wgmma_split" for f32 or f16 B/C (split too, by a
  pre-pass); each at two chunk tiles: 128 steps for L > 64, and for
  1 <= L <= 64 the short kernel's one chunk padded to 64 steps
  ("wgmma_short", "wgmma_split_short");
- ``csrc/ssd_scan.cu`` ("simt") takes everything else the op accepts
  (P or N under 64, a configured chunk under 128): fp32 products on the
  CUDA cores.

:func:`variant` is the rule between them.  It is a dispatch between
kernels, not a fallback: a failed build or launch raises.  All read the
model layout directly: x ``[B, L, H, P]``, a ``[B, L, H]`` and B/C
``[B, L, N]`` indexed at each stream's batch, with the caller's strides,
and all pad the tail chunk themselves.  All start from a given initial
state ``[B, H, P, N]`` fp32, or from zero.  The plain version is
``ref.ssd_chunked_ref`` from the same state.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, check_launch, tma_strides

_BC_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the simt kernel's limits: chunk, head dim P, state dim N
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64
#: what the wgmma kernel takes: P, N and the configured chunk; its bf16
#: instance takes bf16 B/C, its split instance f32 or f16 B/C
WGMMA_P, WGMMA_N, WGMMA_CHUNK = 64, 64, 128
WGMMA_BC_DTYPE = torch.bfloat16
WGMMA_SPLIT_BC_DTYPES = (torch.float32, torch.float16)
#: the short kernel's chunk tile: it takes every L up to it
SHORT_TILE = 64
VARIANTS = ("wgmma", "wgmma_split", "wgmma_short", "wgmma_split_short",
            "simt")
_CSRC = Path(__file__).resolve().parent / "csrc"
#: each launcher's arguments (p: pointer, i: int): the scans', and the
#: split instance's pre-pass
_SCAN_ARGS = "ppppipppiiiiiipp"
_SPLIT_BC_ARGS = "ppiiippp"
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def _binder(**signatures: str):
    def bind(lib: ctypes.CDLL) -> None:
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in args]
            fn.restype = ctypes.c_int
    return bind


LIBRARY = CudaLibrary(_CSRC / "ssd_scan.cu",
                      _binder(ssd_scan_launch=_SCAN_ARGS))
#: links libcuda for ``cuTensorMapEncodeTiled``
WGMMA_LIBRARY = CudaLibrary(_CSRC / "ssd_scan_wgmma.cu",
                            _binder(ssd_scan_wgmma_launch=_SCAN_ARGS,
                                    ssd_scan_split_launch=_SCAN_ARGS,
                                    ssd_scan_split_bc_launch=_SPLIT_BC_ARGS,
                                    ssd_scan_wgmma_ctas_per_sm="iii"),
                            extra_flags=("-lcuda",))


def variant(bc_dtype: torch.dtype, P: int, N: int, chunk: int,
            L: int) -> str:
    """Which kernel runs a call of ``L`` steps: at P = N = 64 with a
    configured chunk of 128 steps, ``"wgmma"`` for bf16 B/C and
    ``"wgmma_split"`` for f32 or f16 B/C, with the suffix ``"_short"``
    (the 64-step tile) when ``L <= SHORT_TILE``; ``"simt"`` otherwise."""
    if P == WGMMA_P and N == WGMMA_N and chunk == WGMMA_CHUNK:
        short = "_short" if L <= SHORT_TILE else ""
        if bc_dtype == WGMMA_BC_DTYPE:
            return "wgmma" + short
        if bc_dtype in WGMMA_SPLIT_BC_DTYPES:
            return "wgmma_split" + short
    return "simt"


def _check(x, a, Bm, Cm, chunk, init_state=None
           ) -> Tuple[int, int, int, int, int, int, int]:
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
    if init_state is not None and (
            init_state.dtype != torch.float32
            or init_state.shape != (Bsz, H, P, N)
            or init_state.device != x.device):
        raise ValueError(f"init_state must be float32 [{Bsz}, {H}, {P}, "
                         f"{N}] on x's device, got {init_state.dtype} "
                         f"{tuple(init_state.shape)} on {init_state.device}")
    Q = min(int(chunk), L)          # the simt kernel's chunk
    if not (1 <= Q <= MAX_CHUNK and P <= MAX_P and N <= MAX_N):
        raise ValueError(f"chunk {Q}, P {P}, N {N} outside the kernel's "
                         f"limits ({MAX_CHUNK}, {MAX_P}, {MAX_N})")
    return code, Bsz, L, H, P, N, Q


def _on_device(dev: torch.device):
    """``dev`` made the current device for a launch, unless it is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(lib: CudaLibrary, name: str, x, a, Bm, Cm, init_state, strides,
            code, Bsz, L, H, P, N, Q) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = x.device
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    init = None if init_state is None else init_state.contiguous()
    if init is not None and init.data_ptr() % 8:    # the kernels read pairs
        init = init.clone()
    st = (ctypes.c_longlong * 13)(*strides, L * H * P, H * P, P)
    fn = getattr(lib.get(), name)
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 code, y.data_ptr(), state.data_ptr(),
                 None if init is None else init.data_ptr(), Bsz, L, H, P, N, Q,
                 ctypes.addressof(st), stream)
    if err >= 1000:
        raise RuntimeError(f"ssd_scan {name}: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - 1000}")
    check_launch(err, f"ssd_scan ({name})")
    return y, state


def ssd_scan_simt(x, a, Bm, Cm, chunk: int, init_state=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan.cu`` (f32, bf16 or f16 B/C; P, N <= 64;
    chunks of ``min(chunk, L)`` up to 128).  Bumps
    ``ssd_scan_cuda.launches`` and its ``"simt"`` count."""
    code, Bsz, L, H, P, N, Q = _check(x, a, Bm, Cm, chunk, init_state)
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous()
                 for t in (x, Bm, Cm))
    strides = (*x.stride()[:3], *a.stride(), *Bm.stride()[:2],
               *Cm.stride()[:2])
    out = _launch(LIBRARY, "ssd_scan_launch", x, a, Bm, Cm, init_state,
                  strides, code, Bsz, L, H, P, N, Q)
    _count("simt")
    return out


def split_bc(Bm: torch.Tensor, Cm: torch.Tensor,
             strides: Tuple[int, ...]) -> torch.Tensor:
    """The split instance's pre-pass: f32 or f16 ``Bm, Cm [B, L, 64]`` on
    the card, as TMA reads them (``strides``: their :func:`tma_strides`,
    B's then C's), into bf16 planes ``[4, B, L, 64]``: B hi, B lo, C hi,
    C lo (hi = bf16(v), lo = bf16(v - hi)).  Counts no launch of its own:
    it is part of the split variants."""
    code = _BC_CODES[Bm.dtype]
    Bsz, L, N = Bm.shape
    planes = torch.empty((4, Bsz, L, N), dtype=torch.bfloat16,
                         device=Bm.device)
    st = (ctypes.c_longlong * 4)(*strides)
    fn = WGMMA_LIBRARY.get().ssd_scan_split_bc_launch
    with _on_device(Bm.device):
        stream = torch.cuda.current_stream(Bm.device).cuda_stream
        err = fn(Bm.data_ptr(), Cm.data_ptr(), code, Bsz, L,
                 ctypes.addressof(st), planes.data_ptr(), stream)
    check_launch(err, "ssd_scan (split pre-pass)")
    return planes


def _tma_ready(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``t`` as TMA can read it (copied when it cannot as it lies), with
    its :func:`tma_strides`."""
    st = tma_strides(t)
    if st is None:
        t = t.contiguous()
        st = tma_strides(t)
    return t, st


def ssd_scan_wgmma(x, a, Bm, Cm, chunk: int, init_state=None,
                   tile: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan_wgmma.cu`` (P = N = 64, a configured chunk of
    128, any L): its bf16 instance for bf16 B/C, its split instance for
    f32 or f16 B/C (:func:`split_bc`, then the scan on the planes), at the
    chunk tile ``tile``: 128 (any L) or 64 (L <= 64); None takes
    :func:`variant`'s (64 for L <= 64).  An x, B or C that TMA (or the
    pre-pass's 16-byte loads) cannot read as it lies (:func:`tma_strides`)
    is copied first.  Bumps ``ssd_scan_cuda.launches`` and the count of
    the variant that ran: ``"wgmma"`` or ``"wgmma_split"``, with
    ``"_short"`` at the 64-step tile."""
    code, Bsz, L, H, P, N, _ = _check(x, a, Bm, Cm, chunk, init_state)
    name = variant(Bm.dtype, P, N, int(chunk), L)
    if name == "simt":
        raise ValueError(f"the wgmma kernel takes P = N = {WGMMA_P} at a "
                         f"configured chunk of {WGMMA_CHUNK}, got "
                         f"{Bm.dtype}, P={P}, N={N}, chunk {chunk}")
    if tile is None:
        tile = SHORT_TILE if L <= SHORT_TILE else WGMMA_CHUNK
    if tile not in (SHORT_TILE, WGMMA_CHUNK) or (tile == SHORT_TILE
                                                 and L > SHORT_TILE):
        raise ValueError(f"chunk tile {tile} at L {L}: the wgmma kernel "
                         f"takes {WGMMA_CHUNK} for any L, {SHORT_TILE} for "
                         f"L <= {SHORT_TILE}")
    name = name.removesuffix("_short") + ("_short" if tile == SHORT_TILE
                                          else "")
    x, xs = _tma_ready(x)
    Bm, bs = _tma_ready(Bm)
    Cm, cs = _tma_ready(Cm)
    launcher, bc = "ssd_scan_wgmma_launch", (*bs, *cs)
    if name.startswith("wgmma_split"):
        # the planes [4, B, L, N] are read as 4 B batches of rows, so their
        # own batch stride, never a size-1 batch's stand-in
        Bm = Cm = split_bc(Bm, Cm, bc)
        launcher, bc = "ssd_scan_split_launch", Bm.stride()[1:3] * 2
    out = _launch(WGMMA_LIBRARY, launcher, x, a, Bm, Cm, init_state,
                  (*xs, *a.stride(), *bc), code, Bsz, L, H, P, N, tile)
    _count(name)
    return out


def ctas_per_sm(tile: int, split: bool, from_state: bool = False) -> int:
    """How many CTAs of the wgmma kernel's instance at ``tile`` (128 or
    64) fit on one SM of the current device (builds and sets it up)."""
    n = WGMMA_LIBRARY.get().ssd_scan_wgmma_ctas_per_sm(
        tile, int(split), int(from_state))
    check_launch(max(0, -n), "ssd_scan (occupancy query)")
    return n


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, chunk: int,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel :func:`variant` picks, on the current stream (no
    synchronisation).

    ``x [B, L, H, P]`` and ``a [B, L, H]`` float32, ``Bm, Cm [B, L, N]``
    (f32, bf16 or f16), on one CUDA device; ``init_state [B, H, P, N]``
    float32 on that device, or None for zero.  Returns
    ``(y [B, L, H, P], final_state [B, H, P, N])``, fp32 and contiguous:
    the reference's scan at chunks of ``min(chunk, L)`` steps (``chunk``
    is the configured chunk; the wgmma kernel runs a sequence of up to 64
    steps as one chunk padded to 64, which differs only in rounding).  Raises
    on anything else, and when the build or the launch fails.
    ``ssd_scan_cuda.launches`` counts every launch,
    ``ssd_scan_cuda.by_variant`` each kernel's."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    if variant(Bm.dtype, int(x.shape[-1]), int(Bm.shape[-1]), int(chunk),
               int(x.shape[1])) != "simt":
        return ssd_scan_wgmma(x, a, Bm, Cm, chunk, init_state)
    return ssd_scan_simt(x, a, Bm, Cm, chunk, init_state)


def _count(name: str) -> None:
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.by_variant[name] += 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    ssd_scan_cuda.launches = 0
    ssd_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
