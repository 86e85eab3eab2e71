"""The fused grouped power-sum fold: CUDA kernel wrapper and plain version.

Port of ``src/repro/kernels/fused_fold/kernel.py``.  The Pallas kernel
``_fused_fold_kernel`` becomes ``csrc/fused_fold.cu`` (CUDA C++ for
``sm_90a``), built with ``nvcc`` at first use into ``build/kernels/`` at the
repository root (keyed by a hash of the source) and bound through ``ctypes``.
:func:`fused_fold_torch` is the same function in plain PyTorch: the CPU path
and the yardstick the kernel is held to on the card.

Both take one flattened block ``x [R, F]``, int32 ``gids [R]`` and a float32
row weight ``mask [R]`` (0/1 from the engine), and return fp32 ``count [G]``
and ``s_k [G, F]`` for the requested names.  A row contributes iff its
weight is non-zero and its gid lies in ``[0, G)``; the payload of a row
whose weight is not positive is zeroed before the powers are raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.chunk_model import SMEM_BYTES

#: canonical accumulator order (mirrors stats.SHARED_ACCUMULATORS — kept
#: literal here so the kernel package does not import the engine)
ACC_ORDER: Tuple[str, ...] = ("count", "s1", "s2", "s3", "s4")

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_fold.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"

#: payload dtypes the kernel reads natively (bool is one byte, read as u8)
_DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
    torch.float64: 3, torch.int32: 4, torch.int64: 5, torch.int16: 6,
    torch.int8: 7, torch.uint8: 8, torch.bool: 8,
}

#: thread-block widths tried in order: the widest whose shared-memory pool
#: fits.  The narrowest bounds G (see ``smem_bytes``/``max_groups``).
BLOCK_WIDTHS = (128, 64, 32)
#: CTAs the row splits aim for when there are few feature tiles
#: (4 per SM of an H100's 132), and the fewest rows a split walks
_TARGET_CTAS = 528
_MIN_SPLIT_ROWS = 64
#: cap on the [S, n_acc, G, F] split scratch
_SCRATCH_CAP_BYTES = 256 << 20


def smem_bytes(n_wide: int, num_groups: int, width: int) -> int:
    """Dynamic shared memory of one CTA: ``n_wide`` accumulators of
    ``[G, width]`` plus the ``[G]`` count."""
    return (n_wide * num_groups * width + num_groups) * 4


def max_groups(n_wide: int, smem: int = SMEM_BYTES) -> int:
    """Largest G the kernel accepts for ``n_wide`` power sums."""
    return smem // ((n_wide * BLOCK_WIDTHS[-1] + 1) * 4)


def launch_shape(R: int, F: int, G: int, n_wide: int
                 ) -> Tuple[int, int, int]:
    """``(block width, row splits S, rows per split)`` for one launch."""
    width = next((w for w in BLOCK_WIDTHS
                  if smem_bytes(n_wide, G, w) <= SMEM_BYTES), None)
    if width is None:
        raise ValueError(
            f"G={G} exceeds the fused fold kernel's shared-memory limit of "
            f"{max_groups(n_wide)} groups for {n_wide} power sums")
    tiles = max(1, -(-F // width))
    splits = max(1, -(-_TARGET_CTAS // tiles))
    splits = min(splits, max(1, -(-R // _MIN_SPLIT_ROWS)), 65535)
    per_split = max(1, n_wide * G * F * 4)
    splits = max(1, min(splits, _SCRATCH_CAP_BYTES // per_split))
    rows_per_split = max(1, -(-R // splits))
    splits = max(1, -(-R // rows_per_split))
    return width, splits, rows_per_split


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def fused_fold_torch(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                     num_groups: int, names: Tuple[str, ...]
                     ) -> Dict[str, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``index_add_`` in fp32 over
    the contributing rows (no one-hot matmul, so no TF32 can enter)."""
    G = int(num_groups)
    m = mask.to(torch.float32)
    g = gids.to(torch.int64)
    keep = (m != 0) & (g >= 0) & (g < G)
    mk, gk = m[keep], g[keep]
    out: Dict[str, torch.Tensor] = {}
    if "count" in names:
        out["count"] = torch.zeros(G, dtype=torch.float32,
                                   device=x.device).index_add_(0, gk, mk)
    wide = [n for n in names if n != "count"]
    if wide:
        v = x[keep].to(torch.float32)
        v = torch.where((mk > 0)[:, None], v, torch.zeros((), device=v.device))
        v2 = v * v
        powers = {"s1": v, "s2": v2, "s3": v2 * v, "s4": v2 * v2}
        w = mk[:, None]
        for n in wide:
            out[n] = torch.zeros((G, x.shape[1]), dtype=torch.float32,
                                 device=x.device).index_add_(
                0, gk, powers[n] * w)
    return out


# ----------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ----------------------------------------------------------------------

class _Library:
    """The built shared library, loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        #: compiler output of the build (``-Xptxas -v`` register report)
        self.build_log = ""
        self.build_seconds = 0.0
        self.path: Optional[Path] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> Path:
        src = _SOURCE.read_bytes()
        digest = hashlib.sha256(src).hexdigest()[:16]
        out = _BUILD_DIR / f"fused_fold-{digest}.so"
        self.path = out
        if out.exists():
            return out
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found (looked on PATH and in "
                               f"{cuda_home}/bin); cannot build {_SOURCE}")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{self.build_log}")
        os.replace(tmp, out)   # atomic: a racing process sees all or nothing
        return out

    @staticmethod
    def _load(path: Path) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(path))
        fn = lib.fused_fold_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, ll, ll, i, i, i, i, i, ll, p, p, p, p, p]
        fn.restype = ctypes.c_int
        return lib


LIBRARY = _Library()


def fused_fold_cuda(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                    num_groups: int, names: Tuple[str, ...]
                    ) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``x [R, F]`` contiguous on a CUDA device, ``gids [R]`` int32 and
    ``mask [R]`` float32 on the same device.  Raises on anything else, and
    when the launch reports an error.  Each launch bumps
    ``fused_fold_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_fold_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [R, F] tensor")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"fused_fold kernel does not take {x.dtype}")
    R, F = int(x.shape[0]), int(x.shape[1])
    if (gids.dtype != torch.int32 or mask.dtype != torch.float32
            or gids.shape != (R,) or mask.shape != (R,)
            or gids.device != x.device or mask.device != x.device
            or not gids.is_contiguous() or not mask.is_contiguous()):
        raise ValueError("gids must be int32 [R] and mask float32 [R], "
                         "contiguous, on x's device")
    G = int(num_groups)
    if G < 1:
        raise ValueError(f"num_groups must be >= 1, got {G}")
    wide = [n for n in names if n != "count"]
    flags = sum(1 << (int(n[1]) - 1) for n in wide)
    want_count = "count" in names
    width, S, rows_per_split = launch_shape(R, F, G, len(wide))

    dev = x.device
    out_s = torch.empty((len(wide), G, F), dtype=torch.float32, device=dev)
    out_c = torch.empty((G,), dtype=torch.float32, device=dev)
    scratch_s = scratch_c = None
    if S > 1:
        scratch_s = torch.empty((S, len(wide), G, F), dtype=torch.float32,
                                device=dev)
        scratch_c = torch.empty((S, G), dtype=torch.float32, device=dev)
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_fold_launch(
            x.data_ptr(), code, gids.data_ptr(), mask.data_ptr(), R, F, G,
            flags, int(want_count), width, S, rows_per_split,
            out_s.data_ptr(), out_c.data_ptr(),
            scratch_s.data_ptr() if scratch_s is not None else None,
            scratch_c.data_ptr() if scratch_c is not None else None,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_fold kernel launch failed: CUDA error {err}")
    fused_fold_cuda.launches += 1
    out: Dict[str, torch.Tensor] = {}
    if want_count:
        out["count"] = out_c
    for j, n in enumerate(wide):
        out[n] = out_s[j]
    return out


fused_fold_cuda.launches = 0


def fused_fold_block(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                     num_groups: int, names: Tuple[str, ...]
                     ) -> Dict[str, torch.Tensor]:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_fold_torch(x, gids, mask, num_groups, names)
    return fused_fold_cuda(x, gids, mask, num_groups, names)
