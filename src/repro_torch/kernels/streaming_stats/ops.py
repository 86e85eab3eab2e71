"""Public op: masked streaming stats over a chunk of rows.

Port of ``src/repro/kernels/streaming_stats/ops.py``.  A facade over the
fused fold (``repro_torch.kernels.fused_fold``): ``streaming_stats`` is the
``(count, s1, s2)`` subset of its grouped pool at ``G=1``, and
:func:`kernel_map_program` gives a MapReduce program whose map phase runs on
it, so ``GridSession.run(..., impl="kernel")`` folds every chunk through the
CUDA kernel on the card (its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.mapreduce import MapReduceProgram
from repro_torch.kernels.fused_fold.ops import fused_fold
from repro_torch.kernels.streaming_stats.ref import streaming_stats_ref
from repro_torch.utils import tree_map


def streaming_stats(
    rows: torch.Tensor,       # [R, *feature_shape]
    mask: torch.Tensor,       # [R]
    impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (sum, sumsq, count); sum/sumsq have the row's feature shape."""
    if impl == "ref":
        R = rows.shape[0]
        fshape = tuple(rows.shape[1:])
        s, sq, c = streaming_stats_ref(rows.reshape(R, -1), mask)
        return s.reshape(fshape), sq.reshape(fshape), c
    if impl != "kernel":
        raise ValueError(f"unknown streaming_stats impl {impl!r}")
    acc = fused_fold(rows, mask, names=("count", "s1", "s2"))
    return acc["s1"][0], acc["s2"][0], acc["count"][0]


@dataclasses.dataclass(frozen=True)
class KernelMeanProgram(MapReduceProgram):
    """MeanProgram with the fused fold kernel as the map-phase fold."""

    additive = True

    def zero(self, row_shape, dtype):
        return {"sum": torch.zeros(tuple(row_shape), dtype=torch.float32),
                "count": torch.zeros((), dtype=torch.float32)}

    def map_chunk(self, rows, valid):
        s, _, c = streaming_stats(rows, valid)
        return {"sum": s, "count": c}

    def merge(self, a, b):
        return tree_map(torch.add, a, b)

    def finalize(self, p):
        return p["sum"] / torch.clamp_min(p["count"], 1)


@dataclasses.dataclass(frozen=True)
class KernelSecondMomentProgram(MapReduceProgram):
    """Mean/variance/count from the kernel's ``(Σx, Σx², n)`` — the
    kernel-backed analogue of ``VarianceProgram``'s finalize contract
    (raw-sums form instead of the Chan merge; equal up to float
    associativity, and additive so the reduce stays one sum)."""

    additive = True

    def zero(self, row_shape, dtype):
        z = torch.zeros(tuple(row_shape), dtype=torch.float32)
        return {"s1": z, "s2": z, "count": torch.zeros((), dtype=torch.float32)}

    def map_chunk(self, rows, valid):
        s, sq, c = streaming_stats(rows, valid)
        return {"s1": s, "s2": sq, "count": c}

    def merge(self, a, b):
        return tree_map(torch.add, a, b)

    def finalize(self, p):
        n = torch.clamp_min(p["count"], 1)
        mean = p["s1"] / n
        var = torch.clamp_min(p["s2"] / n - mean * mean, 0)
        return {"mean": mean, "var": var, "count": p["count"]}


def kernel_map_program(program: MapReduceProgram,
                       impl: str = "kernel") -> MapReduceProgram:
    """The kernel map-phase twin of a sum/count-family program.

    ``GridSession.run(..., impl="kernel")`` routes through here: the
    returned program folds each chunk with :func:`streaming_stats` and
    finalizes to the same result contract as the plain program.  Programs
    whose statistic is not a projection of (Σx, Σx², n) have no kernel
    twin."""
    from repro_torch.core.stats import MeanProgram, VarianceProgram

    if impl != "kernel":
        raise ValueError(f"unknown map-phase impl {impl!r}; "
                         "use impl='kernel' or the default reference path")
    if isinstance(program, MeanProgram):
        return KernelMeanProgram()
    if isinstance(program, VarianceProgram):
        return KernelSecondMomentProgram()
    raise ValueError(
        f"no kernel map phase for {type(program).__name__}: the "
        "streaming_stats facade covers the sum/count family "
        "(MeanProgram, VarianceProgram)")
