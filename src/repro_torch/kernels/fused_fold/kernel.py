"""The fused grouped power-sum fold: CUDA kernel wrapper and plain version.

Port of ``src/repro/kernels/fused_fold/kernel.py``.  The Pallas kernel
``_fused_fold_kernel`` becomes ``csrc/fused_fold.cu`` (CUDA C++ for
``sm_90a``), built with ``nvcc`` at first use into ``build/kernels/`` at the
repository root (keyed by a hash of the source) and bound through ``ctypes``.
:func:`launch_plan` lays out each launch (the register or shared-memory
path, the row splits of a narrow block, the row-list chunk, the persistent
grid) here in Python, where the CPU tests reach it.
:func:`fused_fold_torch` is the same function in plain PyTorch: the CPU path
and the yardstick the kernel is held to on the card.

Both take one flattened block ``x [R, F]``, int32 ``gids [R]`` and a float32
row weight ``mask [R]`` (0/1 from the engine), and return fp32 ``count [G]``
and ``s_k [G, F]`` for the requested names.  A row adds to its group iff
its weight is non-zero and its gid lies in ``[0, G)``; the payload of a row
whose weight is not positive is zeroed before the powers are raised.

Non-finite powers keep the reference's semantics (its one-hot contraction
meets every other group with weight 0, and 0 * Inf = NaN): ``s_k[g, f]`` is
NaN when a row with a positive weight and a gid other than ``g`` (in range
or not) has a non-finite ``x^k`` at ``f``.  The count is never poisoned.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core.chunk_model import SMEM_BYTES
from repro_torch.kernels._build import CudaLibrary, check_launch

#: canonical accumulator order (mirrors stats.SHARED_ACCUMULATORS — kept
#: literal here so the kernel package does not import the engine)
ACC_ORDER: Tuple[str, ...] = ("count", "s1", "s2", "s3", "s4")


#: payload dtypes the kernel reads natively (bool is one byte, read as u8)
_DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
    torch.float64: 3, torch.int32: 4, torch.int64: 5, torch.int16: 6,
    torch.int8: 7, torch.uint8: 8, torch.bool: 8,
}

#: the register path: CTA width, the most groups it compiles (its group
#: counts and power counts), and the rows of one row-list chunk at most
REG_THREADS = 256
REG_MAX_GROUPS = 8
REG_GROUPS = (1, 2, 4, 8)
_REG_POWERS = {1: 1, 2: 2, 3: 4, 4: 4}     # top power -> powers compiled
LIST_ROWS = 4096
#: one row-list entry (row, gid, weight) and the scratch words a CTA keeps
LIST_ENTRY_BYTES = 12
SCRATCH_BYTES = 256
#: the shared-memory path's CTA widths, tried in order: the widest whose
#: accumulators fit.  The narrowest bounds G (see ``smem_bytes``).
BLOCK_WIDTHS = (128, 64, 32)
PATHS = ("registers", "shared", "count")


def smem_bytes(n_wide: int, num_groups: int, width: int) -> int:
    """What G costs the shared-memory path: ``n_wide`` accumulators of
    ``[G, width]`` plus one word a group, which the row list gets at the
    least (the count's word in the first design)."""
    return (n_wide * num_groups * width + num_groups) * 4


def max_groups(n_wide: int, smem: int = SMEM_BYTES) -> int:
    """Largest G the kernel accepts for ``n_wide`` power sums."""
    return smem // ((n_wide * BLOCK_WIDTHS[-1] + 1) * 4)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one fold launches (``csrc/fused_fold.cu``'s ``fused_fold_launch``).

    ``path``: ``"registers"`` (G <= 8: ``groups`` and ``powers`` compiled
    into register accumulators), ``"shared"`` (accumulators in shared
    memory) or ``"count"`` (no power sums: one CTA).  A unit is ``lanes``
    adjacent columns; a CTA of ``threads`` threads folds ``threads //
    lanes`` row splits of one unit at a time, and the ``grid`` CTAs walk
    the ``units`` in turn.  Rows go through a row list ``chunk_rows`` rows
    at a time; ``smem`` is the dynamic shared memory of a CTA."""

    path: str
    threads: int
    lanes: int
    groups: int
    powers: int
    chunk_rows: int
    smem: int
    units: int
    grid: int


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_plan(R: int, F: int, G: int, flags: int,
                capacity: int = 0) -> LaunchPlan:
    """The launch of one fold over ``x [R, F]`` into ``G`` groups;
    ``flags`` bit k-1 asks for s_k.  ``capacity`` is how many CTAs of the
    plan the card holds at once (0: one a unit); the grid is the smaller
    of it and the units, so the CTAs persist over the units.

    G <= 8 takes the register path: a CTA of 256 threads whose unit is 256
    columns, or, for a block narrower than that, the next power of two
    above F, with the rows split over the rest of the threads.  Larger G
    takes the shared-memory path at the widest of 128/64/32 columns whose
    accumulators fit; its row list gets what they leave.  Raises when G is
    over :func:`max_groups`."""
    if R < 0 or R > 2 ** 31 - 1 or F < 0 or G < 1:
        raise ValueError(f"no fused fold launch for R={R}, F={F}, G={G}")
    n_wide = bin(flags).count("1")
    rows = max(1, R)
    if n_wide == 0:
        return LaunchPlan("count", REG_THREADS, REG_THREADS, 1, 0, 1, 0, 1, 1)
    if G <= REG_MAX_GROUPS:
        gt = next(g for g in REG_GROUPS if g >= G)
        npow = _REG_POWERS[flags.bit_length()]
        lanes = min(REG_THREADS, _next_pow2(max(1, F)))
        chunk = min(rows, LIST_ROWS)
        red = (REG_THREADS * npow * gt * 4 if lanes < REG_THREADS else 0)
        smem = chunk * LIST_ENTRY_BYTES + SCRATCH_BYTES + red
        path, threads = "registers", REG_THREADS
    else:
        width = next((w for w in BLOCK_WIDTHS
                      if smem_bytes(n_wide, G, w) <= SMEM_BYTES), None)
        if width is None:
            raise ValueError(
                f"G={G} exceeds the fused fold kernel's shared-memory limit "
                f"of {max_groups(n_wide)} groups for {n_wide} power sums")
        acc = n_wide * G * width * 4
        chunk = min(rows, LIST_ROWS,
                    (SMEM_BYTES - acc - SCRATCH_BYTES) // LIST_ENTRY_BYTES)
        if chunk < 1:
            raise ValueError(f"G={G}: no room for a row list")
        smem = acc + chunk * LIST_ENTRY_BYTES + SCRATCH_BYTES
        path, threads, lanes, gt, npow = "shared", width, width, G, n_wide
    units = max(1, -(-F // lanes))
    grid = units if capacity <= 0 else max(1, min(units, capacity))
    return LaunchPlan(path, threads, lanes, gt, npow, chunk, smem, units,
                      grid)


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------

def fused_fold_torch(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                     num_groups: int, names: Tuple[str, ...]
                     ) -> Dict[str, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``index_add_`` in fp32 over
    the contributing rows (no one-hot matmul, so no TF32 can enter), then
    NaN wherever another group's row has a non-finite power."""
    G = int(num_groups)
    m = mask.to(torch.float32)
    g = gids.to(torch.int64)
    in_range = (g >= 0) & (g < G)
    keep = (m != 0) & in_range
    mk, gk = m[keep], g[keep]
    out: Dict[str, torch.Tensor] = {}
    if "count" in names:
        out["count"] = torch.zeros(G, dtype=torch.float32,
                                   device=x.device).index_add_(0, gk, mk)
    wide = [n for n in names if n != "count"]
    if wide:
        # only rows with a positive weight raise powers: the others are
        # zeroed, add m * 0 to their group and are never non-finite
        pos = m > 0
        v = x[pos].to(torch.float32)
        gp, wp, own = g[pos], m[pos][:, None], in_range[pos]
        g_own = gp[own]
        v2 = v * v
        powers = {"s1": lambda: v, "s2": lambda: v2, "s3": lambda: v2 * v,
                  "s4": lambda: v2 * v2}
        nan = torch.full((), float("nan"), device=x.device)
        for n in wide:
            pw = powers[n]()
            acc = torch.zeros((G, x.shape[1]), dtype=torch.float32,
                              device=x.device).index_add_(
                0, g_own, (pw * wp)[own])
            bad = (~torch.isfinite(pw)).to(torch.int32)
            in_group = torch.zeros((G, x.shape[1]), dtype=torch.int32,
                                   device=x.device).index_add_(0, g_own,
                                                               bad[own])
            poisoned = bad.sum(0, dtype=torch.int32)[None, :] > in_group
            out[n] = torch.where(poisoned, nan, acc)
    return out


# ----------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ----------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.fused_fold_launch
    fn.argtypes = [p, i, p, p, ll, ll, i, i, i, i, i, i, i, i, i, i, i, p, p,
                   p]
    fn.restype = ctypes.c_int
    fn = lib.fused_fold_ctas_per_sm
    fn.argtypes = [i, i, i, i, i, i]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "fused_fold.cu", _bind)

#: each launch's plan with its grid, by (device, dtype code, R, F, G,
#: flags): the occupancy query runs once a kernel and shape
_PLANS: Dict[tuple, LaunchPlan] = {}


def _plan(lib: ctypes.CDLL, dev: torch.device, code: int, R: int, F: int,
          G: int, flags: int) -> LaunchPlan:
    key = (dev.index, code, R, F, G, flags)
    if key not in _PLANS:
        plan = launch_plan(R, F, G, flags)
        with torch.cuda.device(dev):
            per_sm = lib.fused_fold_ctas_per_sm(
                code, PATHS.index(plan.path), plan.groups, plan.powers,
                plan.threads, plan.smem)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if per_sm <= 0:
            raise RuntimeError(f"fused_fold: no CTA of {plan} fits an SM "
                               f"(occupancy query returned {per_sm})")
        _PLANS[key] = dataclasses.replace(
            plan, grid=max(1, min(plan.units, per_sm * sms)))
    return _PLANS[key]


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
    lib = LIBRARY.get()
    dev = x.device
    plan = _plan(lib, dev, code, R, F, G, flags)

    out_s = torch.empty((len(wide), G, F), dtype=torch.float32, device=dev)
    out_c = torch.empty((G,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_fold_launch(
            x.data_ptr(), code, gids.data_ptr(), mask.data_ptr(), R, F, G,
            flags, int(want_count), PATHS.index(plan.path), plan.groups,
            plan.powers, plan.threads, plan.lanes, plan.chunk_rows,
            plan.smem, plan.grid, out_s.data_ptr(), out_c.data_ptr(), stream)
    check_launch(err, "fused_fold")
    _count_launch()
    out: Dict[str, torch.Tensor] = {}
    if want_count:
        out["count"] = out_c
    for j, n in enumerate(wide):
        out[n] = out_s[j]
    return out


fused_fold_cuda.launches = 0
_COUNT_LOCK = threading.Lock()


def _count_launch() -> None:
    """One more launch on ``fused_fold_cuda.launches``; locked, since the
    frontend folds on several threads at once."""
    with _COUNT_LOCK:
        fused_fold_cuda.launches += 1


def fused_fold_block(x: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                     num_groups: int, names: Tuple[str, ...]
                     ) -> Dict[str, torch.Tensor]:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_fold_torch(x, gids, mask, num_groups, names)
    return fused_fold_cuda(x, gids, mask, num_groups, names)
