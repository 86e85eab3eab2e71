"""The SSD-scan CUDA kernel: build, bind, dispatch, launch.

Port of ``src/repro/kernels/ssm_scan/kernel.py``.  The Pallas kernel
``_ssd_kernel`` becomes a hand-written CUDA C++ kernel for ``sm_90a``,
``csrc/ssd_scan_wgmma.cu``, built with ``nvcc`` at first use into
``build/kernels/`` and bound through ``ctypes``: TMA-fed ``wgmma`` tiles
on the bf16 tensor cores, with every fp32 operand split into bf16 hi/lo
parts, in two instances: "wgmma" for bf16 B/C, "wgmma_split" for f32 or
f16 B/C (split too, by a pre-pass); each at two chunk tiles: 128 steps for
L > 64, and for 1 <= L <= 64 the short kernel's one chunk padded to 64
steps ("wgmma_short", "wgmma_split_short").

It takes every P and N up to 64 (its tiles are 64 wide; TMA fills the
columns past the real dims with zeros) and any configured chunk: the
chunk only blocks one linear recurrence, so the tile, picked by L alone,
computes the same function up to rounding.  :func:`variant` names the
instance a call takes.  A failed build or launch raises.  It reads the
model layout directly: x ``[B, L, H, P]``, a ``[B, L, H]`` and B/C ``[B,
L, N]`` indexed at each stream's batch, with the caller's strides, and
pads the tail chunk itself.  It starts from a given initial state ``[B,
H, P, N]`` fp32, or from zero.  The plain version is
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
#: the largest head dim P and state dim N: the tiles' widths
MAX_P, MAX_N = 64, 64
#: the kernel's bf16 instance takes bf16 B/C, its split instance f32 or
#: f16 B/C
WGMMA_BC_DTYPE = torch.bfloat16
WGMMA_SPLIT_BC_DTYPES = (torch.float32, torch.float16)
#: the chunk tiles: the short kernel's takes every L up to it
SHORT_TILE, LONG_TILE = 64, 128
#: P and N reach the kernel as multiples of this (the wrapper pads others)
DIM_STEP = 8
VARIANTS = ("wgmma", "wgmma_split", "wgmma_short", "wgmma_split_short")
_CSRC = Path(__file__).resolve().parent / "csrc"
#: each launcher's arguments (p: pointer, i: int): the scans', and the
#: split instance's pre-pass
_SCAN_ARGS = "ppppipppiiiiiipp"
_SPLIT_BC_ARGS = "ppiiiippp"
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def _binder(**signatures: str):
    def bind(lib: ctypes.CDLL) -> None:
        for name, args in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[c] for c in args]
            fn.restype = ctypes.c_int
    return bind


#: links libcuda for ``cuTensorMapEncodeTiled``
WGMMA_LIBRARY = CudaLibrary(_CSRC / "ssd_scan_wgmma.cu",
                            _binder(ssd_scan_wgmma_launch=_SCAN_ARGS,
                                    ssd_scan_split_launch=_SCAN_ARGS,
                                    ssd_scan_split_bc_launch=_SPLIT_BC_ARGS,
                                    ssd_scan_wgmma_ctas_per_sm="iii"),
                            extra_flags=("-lcuda",))


def variant(bc_dtype: torch.dtype, P: int, N: int, L: int) -> str:
    """The instance a call of ``L`` steps takes, at any P, N <= 64 (the
    configured chunk picks nothing): ``"wgmma"`` for bf16 B/C and
    ``"wgmma_split"`` for f32 or f16 B/C, with the suffix ``"_short"``
    (the 64-step tile) when ``L <= SHORT_TILE``.  Raises for what the
    kernel does not take."""
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and L >= 1):
        raise ValueError(f"P {P}, N {N}, L {L} outside the kernel's limits "
                         f"(P <= {MAX_P}, N <= {MAX_N})")
    short = "_short" if L <= SHORT_TILE else ""
    if bc_dtype == WGMMA_BC_DTYPE:
        return "wgmma" + short
    if bc_dtype in WGMMA_SPLIT_BC_DTYPES:
        return "wgmma_split" + short
    raise TypeError(f"ssd_scan kernel does not take B/C in {bc_dtype}")


def _check(x, a, Bm, Cm, init_state=None
           ) -> Tuple[int, int, int, int, int, int]:
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
    return code, Bsz, L, H, P, N


def _on_device(dev: torch.device):
    """``dev`` made the current device for a launch, unless it is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(name: str, x, a, Bm, Cm, init_state, strides, code, Bsz, L,
            H, P, N, tile) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = x.device
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    init = None if init_state is None else init_state.contiguous()
    if init is not None and init.data_ptr() % 8:    # the kernel reads pairs
        init = init.clone()
    st = (ctypes.c_longlong * 13)(*strides, L * H * P, H * P, P)
    fn = getattr(WGMMA_LIBRARY.get(), name)
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 code, y.data_ptr(), state.data_ptr(),
                 None if init is None else init.data_ptr(), Bsz, L, H, P, N,
                 tile, ctypes.addressof(st), stream)
    if err >= 1000:
        raise RuntimeError(f"ssd_scan {name}: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - 1000}")
    check_launch(err, f"ssd_scan ({name})")
    return y, state


def split_bc(Bm: torch.Tensor, Cm: torch.Tensor,
             strides: Tuple[int, ...]) -> torch.Tensor:
    """The split instance's pre-pass: f32 or f16 ``Bm, Cm [B, L, N]`` (N a
    multiple of 8) on the card, as TMA reads them (``strides``: their
    :func:`tma_strides`, B's then C's), into bf16 planes ``[4, B, L, N]``:
    B hi, B lo, C hi, C lo (hi = bf16(v), lo = bf16(v - hi)).  Counts no
    launch of its own: it is part of the split variants."""
    code = _BC_CODES[Bm.dtype]
    Bsz, L, N = Bm.shape
    planes = torch.empty((4, Bsz, L, N), dtype=torch.bfloat16,
                         device=Bm.device)
    st = (ctypes.c_longlong * 4)(*strides)
    fn = WGMMA_LIBRARY.get().ssd_scan_split_bc_launch
    with _on_device(Bm.device):
        stream = torch.cuda.current_stream(Bm.device).cuda_stream
        err = fn(Bm.data_ptr(), Cm.data_ptr(), code, Bsz, L, N,
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


def pad_dims(x, Bm, Cm, init_state):
    """x's P and B's, C's and the initial state's N (and P) zero-padded to
    multiples of ``DIM_STEP``, where they are not: zero columns add
    nothing to y or to the state, and TMA then reads every row (a row of
    bf16 values must be a multiple of 16 bytes).  -> ``(x, Bm, Cm,
    init_state)``, each itself where it needs no padding."""
    P, N = int(x.shape[-1]), int(Bm.shape[-1])
    dp, dn = -P % DIM_STEP, -N % DIM_STEP
    pad = torch.nn.functional.pad
    if dp:
        x = pad(x, (0, dp))
    if dn:
        Bm, Cm = pad(Bm, (0, dn)), pad(Cm, (0, dn))
    if init_state is not None and (dp or dn):
        init_state = pad(init_state, (0, dn, 0, dp))
    return x, Bm, Cm, init_state


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  tile: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan_wgmma.cu`` on the current stream (no
    synchronisation): its bf16 instance for bf16 B/C, its split instance
    for f32 or f16 B/C (:func:`split_bc`, then the scan on the planes), at
    the chunk tile ``tile``: 128 (any L) or 64 (L <= 64); None takes
    :func:`variant`'s (64 for L <= 64).

    ``x [B, L, H, P]`` and ``a [B, L, H]`` float32, ``Bm, Cm [B, L, N]``
    (f32, bf16 or f16), P, N <= 64, on one CUDA device; ``init_state [B,
    H, P, N]`` float32 on that device, or None for zero.  Returns ``(y [B,
    L, H, P], final_state [B, H, P, N])``, fp32 and contiguous: the
    reference's scan at chunks of ``min(chunk, L)`` steps.  ``chunk``, the
    configured chunk, is taken so that the signature mirrors the op's and
    the plain version's, and is unused: the kernel runs its own tile,
    which differs only in rounding.  An x, B or C that TMA (or the pre-pass's 16-byte
    loads) cannot read as it lies is copied first (:func:`pad_dims`,
    :func:`tma_strides`).  Raises on anything else, and when the build or
    the launch fails.  ``ssd_scan_cuda.launches`` counts every launch,
    ``ssd_scan_cuda.by_variant`` each variant's."""
    code, Bsz, L, H, P, N = _check(x, a, Bm, Cm, init_state)
    name = variant(Bm.dtype, P, N, L)      # raises past the limits
    if tile is None:
        tile = SHORT_TILE if L <= SHORT_TILE else LONG_TILE
    if tile not in (SHORT_TILE, LONG_TILE) or (tile == SHORT_TILE
                                               and L > SHORT_TILE):
        raise ValueError(f"chunk tile {tile} at L {L}: the kernel takes "
                         f"{LONG_TILE} for any L, {SHORT_TILE} for "
                         f"L <= {SHORT_TILE}")
    name = name.removesuffix("_short") + ("_short" if tile == SHORT_TILE
                                          else "")
    x, Bm, Cm, init = pad_dims(x, Bm, Cm, init_state)
    Pk, Nk = int(x.shape[-1]), int(Bm.shape[-1])
    x, xs = _tma_ready(x)
    Bm, bs = _tma_ready(Bm)
    Cm, cs = _tma_ready(Cm)
    launcher, bc = "ssd_scan_wgmma_launch", (*bs, *cs)
    if name.startswith("wgmma_split"):
        # the planes [4, B, L, N] are read as 4 B batches of rows, so their
        # own batch stride, never a size-1 batch's stand-in
        Bm = Cm = split_bc(Bm, Cm, bc)
        launcher, bc = "ssd_scan_split_launch", Bm.stride()[1:3] * 2
    y, state = _launch(launcher, x, a, Bm, Cm, init, (*xs, *a.stride(), *bc),
                       code, Bsz, L, H, Pk, Nk, tile)
    _count(name)
    if (Pk, Nk) != (P, N):
        y = y[..., :P].contiguous()
        state = state[..., :P, :N].contiguous()
    return y, state


def ctas_per_sm(tile: int, split: bool, from_state: bool = False) -> int:
    """How many CTAs of the wgmma kernel's instance at ``tile`` (128 or
    64) fit on one SM of the current device (builds and sets it up)."""
    n = WGMMA_LIBRARY.get().ssd_scan_wgmma_ctas_per_sm(
        tile, int(split), int(from_state))
    check_launch(max(0, -n), "ssd_scan (occupancy query)")
    return n


def _count(name: str) -> None:
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.by_variant[name] += 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    ssd_scan_cuda.launches = 0
    ssd_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
