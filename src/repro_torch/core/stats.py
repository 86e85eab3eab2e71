"""Summary-statistic MapReduce programs (§2.2's workload family).

The paper's exemplar is population-template construction: averaging 5,153
registered T1 volumes with ANTS ``AverageImages``.  That is a mean fold; this
module provides it plus the statistics a population study actually asks for
(variance via Chan/Welford parallel merge, higher moments, histograms), all as
:class:`~repro_torch.core.mapreduce.MapReduceProgram` monoids so the same engine,
chunk model and table scheme apply.

Accumulation dtype defaults to float32; pass ``acc_dtype=torch.float64``
for reference-grade accumulation.

Port of ``src/repro/core/stats.py``, exact programs only: the sketches
(count-min, HyperLogLog, quantiles) are not ported yet.  ``vmap`` over the
group axis becomes a loop over groups whose results are stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.mapreduce import MapReduceProgram
from repro_torch.utils import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _dtype_name(dt: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's pool key)."""
    return str(dt).replace("torch.", "")


def _add(a, b):
    return a + b


def _map_groups(fn, tree, G: int):
    """``vmap(fn)`` over the leading group axis of every leaf: ``fn`` runs
    once per group and the results stack back along a new group axis."""
    if G == 0:   # no groups: run once on a zero slice for the structure
        probe = fn(tree_map(lambda x: x.new_zeros(tuple(x.shape[1:])), tree))
        return tree_map(lambda y: y.new_zeros((0,) + tuple(y.shape)), probe)
    outs = [fn(tree_map(lambda x, g=g: x[g], tree)) for g in range(G)]
    return tree_map(lambda *xs: torch.stack(xs), *outs)


def _masked(rows: torch.Tensor, valid: torch.Tensor, acc_dtype
            ) -> torch.Tensor:
    """Zero out invalid rows and cast to the accumulator dtype."""
    v = valid.reshape(tuple(valid.shape) + (1,) * (rows.dim() - 1))
    return torch.where(v, rows.to(acc_dtype),
                       torch.zeros((), dtype=acc_dtype, device=rows.device))


def _merge_leafwise(a: Any, b: Any, ops) -> Any:
    """Pairwise combine honoring per-leaf merge operators (``None`` = all
    sum) — the eager analogue of the engine's collective dispatch."""
    if ops is None:
        return tree_map(_add, a, b)
    leaves_a, treedef = tree_flatten(a)
    leaves_b = tree_leaves(b)
    return tree_unflatten(
        treedef, [torch.maximum(x, y) if op == "max" else x + y
                  for x, y, op in zip(leaves_a, leaves_b, ops)])


#: The shared-accumulator vocabulary of the CSE protocol: the masked row
#: count and the elementwise raw power sums Σx..Σx⁴.  Every statistic that
#: is a projection of these (mean, variance, moments, ...) can declare
#: ``requires()`` and ride one shared fold inside a CSE'd FusedProgram.
SHARED_ACCUMULATORS: Tuple[str, ...] = ("count", "s1", "s2", "s3", "s4")


def shared_zero(names: Tuple[str, ...], row_shape, acc_dtype
                ) -> Dict[str, torch.Tensor]:
    z = torch.zeros(tuple(row_shape), dtype=acc_dtype)
    return {n: (torch.zeros((), dtype=acc_dtype) if n == "count" else z)
            for n in names}


def shared_map_chunk(rows: torch.Tensor, valid: torch.Tensor,
                     names: Tuple[str, ...], acc_dtype
                     ) -> Dict[str, torch.Tensor]:
    """Fold one chunk into exactly the requested shared accumulators.

    This is the CSE: the masked cast ``x`` and the square ``x²`` are each
    materialized once and reused across every moment that needs them,
    however many member programs asked.
    """
    out: Dict[str, torch.Tensor] = {}
    if "count" in names:
        out["count"] = valid.sum().to(acc_dtype)
    if any(n in names for n in ("s1", "s2", "s3", "s4")):
        x = _masked(rows, valid, acc_dtype)
        if "s1" in names:
            out["s1"] = x.sum(dim=0)
        if any(n in names for n in ("s2", "s3", "s4")):
            x2 = x * x
            if "s2" in names:
                out["s2"] = x2.sum(dim=0)
            if "s3" in names:
                out["s3"] = (x2 * x).sum(dim=0)
            if "s4" in names:
                out["s4"] = (x2 * x2).sum(dim=0)
    return out


@dataclasses.dataclass(frozen=True)
class MeanProgram(MapReduceProgram):
    """ANTS AverageImages analogue: elementwise mean over the population."""

    acc_dtype: torch.dtype = torch.float32
    additive = True

    def zero(self, row_shape, dtype):
        return {
            "sum": torch.zeros(tuple(row_shape), dtype=self.acc_dtype),
            "count": torch.zeros((), dtype=self.acc_dtype),
        }

    def map_chunk(self, rows, valid):
        return {
            "sum": _masked(rows, valid, self.acc_dtype).sum(dim=0),
            "count": valid.sum().to(self.acc_dtype),
        }

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        return p["sum"] / torch.clamp_min(p["count"], 1)

    def requires(self):
        return ("count", "s1")

    def finalize_shared(self, shared):
        return self.finalize({"sum": shared["s1"], "count": shared["count"]})

    def shared_fold_spec(self):
        if self.acc_dtype != torch.float32:
            return None
        return self.requires()

    def partial_from_shared(self, shared):
        return {"sum": shared["s1"], "count": shared["count"]}


@dataclasses.dataclass(frozen=True)
class VarianceProgram(MapReduceProgram):
    """Elementwise population mean/variance with Chan's parallel merge.

    Deliberately *non-additive* (partials carry running means), exercising the
    engine's all-gather + fold reduce path and demonstrating that arbitrary
    associative statistics ride the same colocation machinery.
    """

    acc_dtype: torch.dtype = torch.float32
    additive = False

    def zero(self, row_shape, dtype):
        return {
            "count": torch.zeros((), dtype=self.acc_dtype),
            "mean": torch.zeros(tuple(row_shape), dtype=self.acc_dtype),
            "m2": torch.zeros(tuple(row_shape), dtype=self.acc_dtype),
        }

    def map_chunk(self, rows, valid):
        x = _masked(rows, valid, self.acc_dtype)
        n = valid.sum().to(self.acc_dtype)
        safe_n = torch.clamp_min(n, 1)
        mean = x.sum(dim=0) / safe_n
        v = valid.reshape(valid.shape + (1,) * (rows.ndim - 1))
        centered = torch.where(v, x - mean, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        m2 = (centered * centered).sum(dim=0)
        return {"count": n, "mean": mean, "m2": m2}

    def merge(self, a, b):
        na, nb = a["count"], b["count"]
        n = na + nb
        safe_n = torch.clamp_min(n, 1)
        delta = b["mean"] - a["mean"]
        mean = a["mean"] + delta * (nb / safe_n)
        m2 = a["m2"] + b["m2"] + (delta * delta) * (na * nb / safe_n)
        # empty-side guards: merging with a zero partial must be identity
        mean = torch.where(na == 0, b["mean"],
                           torch.where(nb == 0, a["mean"], mean))
        m2 = torch.where(na == 0, b["m2"], torch.where(nb == 0, a["m2"], m2))
        return {"count": n, "mean": mean, "m2": m2}

    def finalize(self, p):
        var = p["m2"] / torch.clamp_min(p["count"], 1)
        return {"mean": p["mean"], "var": var, "count": p["count"]}

    def requires(self):
        # inside a CSE'd fusion the Chan partial gives way to the shared
        # raw sums (count, Σx, Σx²): same result up to float associativity,
        # and the shared path is additive — the fusion keeps the psum reduce
        return ("count", "s1", "s2")

    def finalize_shared(self, shared):
        n = torch.clamp_min(shared["count"], 1)
        mean = shared["s1"] / n
        var = torch.clamp_min(shared["s2"] / n - mean * mean, 0)
        return {"mean": mean, "var": var, "count": shared["count"]}

    def shared_fold_spec(self):
        if self.acc_dtype != torch.float32:
            return None
        return self.requires()

    def partial_from_shared(self, shared):
        # raw sums -> the Chan partial: mean = Σx/n, M2 = Σx² - n·mean²
        # (equal up to float associativity; merge stays the Chan merge)
        n = shared["count"]
        safe_n = torch.clamp_min(n, 1)
        mean = shared["s1"] / safe_n
        m2 = torch.clamp_min(shared["s2"] - mean * shared["s1"], 0)
        return {"count": n, "mean": mean, "m2": m2}


@dataclasses.dataclass(frozen=True)
class MomentsProgram(MapReduceProgram):
    """Raw moments 1..4 (additive) → mean/var/skew/kurtosis per voxel."""

    acc_dtype: torch.dtype = torch.float32
    additive = True

    def zero(self, row_shape, dtype):
        z = torch.zeros(tuple(row_shape), dtype=self.acc_dtype)
        return {"count": torch.zeros((), dtype=self.acc_dtype),
                "s1": z, "s2": z, "s3": z, "s4": z}

    def map_chunk(self, rows, valid):
        x = _masked(rows, valid, self.acc_dtype)
        x2 = x * x
        return {
            "count": valid.sum().to(self.acc_dtype),
            "s1": x.sum(dim=0),
            "s2": x2.sum(dim=0),
            "s3": (x2 * x).sum(dim=0),
            "s4": (x2 * x2).sum(dim=0),
        }

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        n = torch.clamp_min(p["count"], 1)
        m = p["s1"] / n
        ex2 = p["s2"] / n
        var = torch.clamp_min(ex2 - m * m, 0)
        std = torch.sqrt(torch.clamp_min(var, 1e-30))
        m3 = p["s3"] / n - 3 * m * ex2 + 2 * m**3
        m4 = (p["s4"] / n - 4 * m * (p["s3"] / n) + 6 * m * m * ex2 - 3 * m**4)
        return {
            "mean": m,
            "var": var,
            "skew": m3 / std**3,
            "kurtosis": m4 / torch.clamp_min(var * var, 1e-30),
            "count": p["count"],
        }

    def requires(self):
        return ("count", "s1", "s2", "s3", "s4")

    def finalize_shared(self, shared):
        # the private partial IS the raw power sums — reuse finalize as-is
        return self.finalize(dict(shared))

    def shared_fold_spec(self):
        if self.acc_dtype != torch.float32:
            return None
        return self.requires()

    def partial_from_shared(self, shared):
        return dict(shared)


@dataclasses.dataclass(frozen=True)
class CountProgram(MapReduceProgram):
    """Row count (additive) — the cheapest statistic, and an end-to-end
    oracle: a fold over a block-assembled layout must count exactly the
    slots the scan's row mask selected, so the differential harness checks
    it against ``QueryStats.rows_selected`` (a mask/padding bug anywhere in
    the block plumbing shows up here first).

    Accumulates in int32 (``psum`` is exact on integers; int64 would need
    x64 mode), not the float32 the statistic programs default to — callers
    assert exact equality and float32 loses integer exactness past 2^24
    rows.  Deliberately NOT in the CSE pool: the shared ``count``
    accumulates in the pool's float dtype, which would re-lose that
    exactness — the private int32 fold is the whole point."""

    acc_dtype: torch.dtype = torch.int32
    additive = True

    def zero(self, row_shape, dtype):
        return {"count": torch.zeros((), dtype=self.acc_dtype)}

    def map_chunk(self, rows, valid):
        return {"count": valid.sum().to(self.acc_dtype)}

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        return p["count"]


@dataclasses.dataclass(frozen=True)
class FusedProgram(MapReduceProgram):
    """The monoid product of N statistic programs — one pass, N answers.

    ``GridQuery`` fuses every ``.map(program)`` on a plan into one of these,
    so mean+variance+histogram share a single gather and a single engine
    pass.  With ``cse=True`` (the default) members that declare
    :meth:`~repro_torch.core.mapreduce.MapReduceProgram.requires` pool their raw
    accumulators: each shared accumulator (count, Σx, Σx², ...) is folded
    ONCE per chunk — via :func:`shared_map_chunk`, which also reuses the
    masked cast and the square across moments — and ``finalize`` projects
    every member's result from the pool.  Members without ``requires()``
    (histogram, the exact int32 count) keep their private folds alongside.

    The partial is ``{"shared": {dtype: {name: acc}}, "private": (...)}``;
    shared accumulators merge by sum, so the fusion is additive (single
    ``psum``) unless a *private* member is non-additive.  ``cse=False``
    recovers the naive product (every member folds the chunk itself) — kept
    for the FLOP-comparison bench and as an escape hatch.
    """

    programs: Tuple[MapReduceProgram, ...] = ()
    cse: bool = True

    def __post_init__(self):
        if not self.programs:
            raise ValueError("FusedProgram needs at least one program")
        object.__setattr__(self, "programs", tuple(self.programs))
        # role per member: the index into the private tuple, or the shared
        # pool key (accumulator dtype) it projects from
        private: Tuple[MapReduceProgram, ...] = ()
        roles = []
        groups: Dict[str, Tuple[str, ...]] = {}
        for p in self.programs:
            req = p.requires() if self.cse else ()
            if req:
                dt = _dtype_name(getattr(p, "acc_dtype", torch.float32))
                merged = set(groups.get(dt, ())) | set(req)
                groups[dt] = tuple(n for n in SHARED_ACCUMULATORS
                                   if n in merged)
                roles.append(("shared", dt))
            else:
                roles.append(("private", len(private)))
                private = private + (p,)
        object.__setattr__(self, "_roles", tuple(roles))
        object.__setattr__(self, "_private", private)
        object.__setattr__(self, "_shared_groups",
                           tuple(sorted(groups.items())))
        object.__setattr__(
            self, "additive", all(p.additive for p in private))

    def zero(self, row_shape, dtype):
        shared = {dt: shared_zero(names, row_shape, getattr(torch, dt))
                  for dt, names in self._shared_groups}
        return {"shared": shared,
                "private": tuple(p.zero(row_shape, dtype)
                                 for p in self._private)}

    def map_chunk(self, rows, valid):
        shared = {dt: shared_map_chunk(rows, valid, names, getattr(torch, dt))
                  for dt, names in self._shared_groups}
        return {"shared": shared,
                "private": tuple(p.map_chunk(rows, valid)
                                 for p in self._private)}

    def merge(self, a, b):
        shared = tree_map(_add, a["shared"], b["shared"])
        private = tuple(p.merge(x, y) for p, x, y in
                        zip(self._private, a["private"], b["private"]))
        return {"shared": shared, "private": private}

    def merge_ops_for(self, partial):
        # compose per-leaf operators member by member: shared pool leaves
        # always sum; each private member contributes its own declaration.
        # Leaf order follows tree_flatten of {"private": ..., "shared":
        # ...} — dict keys sort, so private leaves come first.
        member_ops = [p.merge_ops_for(q) for p, q in
                      zip(self._private, partial["private"])]
        if all(ops is None for ops in member_ops):
            return None
        flat = []
        for q, ops in zip(partial["private"], member_ops):
            flat.extend(ops if ops is not None
                        else ["sum"] * len(tree_leaves(q)))
        flat.extend(["sum"] * len(tree_leaves(
            partial["shared"])))
        return flat

    def finalize(self, partial):
        out = []
        for p, (kind, ref) in zip(self.programs, self._roles):
            if kind == "shared":
                out.append(p.finalize_shared(partial["shared"][ref]))
            else:
                out.append(p.finalize(partial["private"][ref]))
        return tuple(out)

    def shared_fold_spec(self):
        # kernel-eligible iff the fusion is pure pool: no private member
        # folds alongside, and the pool is the kernel's fp32 accumulator
        if self._private or len(self._shared_groups) != 1:
            return None
        dt, names = self._shared_groups[0]
        if dt != "float32":
            return None
        return names

    def partial_from_shared(self, shared):
        dt, _ = self._shared_groups[0]
        return {"shared": {dt: dict(shared)}, "private": ()}


def grouped_shared_map_chunk(rows: torch.Tensor, gmask: torch.Tensor,
                             names: Tuple[str, ...], acc_dtype
                             ) -> Dict[str, torch.Tensor]:
    """Fold one chunk into per-group shared accumulators by segment-sum.

    ``gmask`` is the ``[G, eta]`` per-group row mask (rows of a chunk are
    partitioned across groups; invalid rows belong to no group).  Each raw
    power of ``x`` is materialized ONCE and contracted against the group
    weights in a single ``einsum`` — the grouped analogue of the CSE in
    :func:`shared_map_chunk`: G groups share one masked cast, one square,
    one cube, however many member statistics project from the pool.
    """
    out: Dict[str, torch.Tensor] = {}
    w = gmask.to(acc_dtype)                      # [G, eta] 0/1 weights
    if "count" in names:
        out["count"] = w.sum(dim=1)
    if any(n in names for n in ("s1", "s2", "s3", "s4")):
        # zero rows no group claims BEFORE raising powers, exactly like the
        # ungrouped _masked path: a NaN/Inf payload in a masked-off row
        # must not poison the segment sums (0-weight × NaN is NaN)
        x = _masked(rows, gmask.any(dim=0), acc_dtype)  # [eta, ...]

        def seg(v):                                  # [G, ...] segment sums
            return (w @ v.reshape(v.shape[0], -1)).reshape(
                (w.shape[0],) + tuple(v.shape[1:]))

        if "s1" in names:
            out["s1"] = seg(x)
        if any(n in names for n in ("s2", "s3", "s4")):
            x2 = x * x
            if "s2" in names:
                out["s2"] = seg(x2)
            if "s3" in names:
                out["s3"] = seg(x2 * x)
            if "s4" in names:
                out["s4"] = seg(x2 * x2)
    return out


@dataclasses.dataclass
class GroupedResult:
    """Per-group finalized statistics from a ``group_by`` plan.

    ``keys[g]`` labels row ``g`` of every leaf in ``values`` (leaves carry a
    leading group axis).  ``keys`` are the distinct group-key values among
    the selected rows, ascending — the same order ``np.unique`` gives a
    NumPy groupby oracle.
    """

    keys: np.ndarray               # [G] unique group-key values, sorted
    values: Any                    # result tree; leaves are [G, ...]

    def __len__(self) -> int:
        return len(self.keys)

    def index_of(self, key) -> int:
        if self.keys.dtype == object:      # composite keys: tuple labels
            want = tuple(key)
            for g, k in enumerate(self.keys):
                if tuple(k) == want:
                    return g
            raise KeyError(f"no group with key {key!r}")
        pos = int(np.searchsorted(self.keys, key))
        if pos >= len(self.keys) or self.keys[pos] != key:
            raise KeyError(f"no group with key {key!r}")
        return pos

    def group(self, key) -> Any:
        """The result tree of one group (leaves indexed at its row)."""
        g = self.index_of(key)
        return tree_map(lambda x: x[g], self.values)

    def asdict(self) -> Dict[Any, Any]:
        """``{group key: result tree}`` with native-Python scalar keys."""
        return {k.item() if hasattr(k, "item") else k: tree_map(
            lambda x, g=g: x[g], self.values)
            for g, k in enumerate(self.keys)}


@dataclasses.dataclass(frozen=True)
class GroupedProgram(MapReduceProgram):
    """Group-aware lift of a statistic program: one fold, G answers.

    Wraps ``base`` (a single program or a :class:`FusedProgram`) so every
    accumulator gains a leading group axis.  ``map_chunk`` receives the
    ``[G, eta]`` per-group row mask the engine derives from the chunk's
    group ids:

    - members in the CSE pool fold through
      :func:`grouped_shared_map_chunk` — the raw power sums are segment-
      summed by group id, so each power is computed once per chunk however
      many groups or member statistics there are;
    - private members (histogram, the exact int32 count) ``vmap`` their own
      fold over the group masks.

    Additivity is inherited: a grouped additive program still merges by
    elementwise sum (now ``[G, ...]``-shaped), so the tree-reduce/psum merge
    path stays available.  ``finalize`` projects per-group results with the
    base program's own finalizers (``vmap`` over the group axis).
    """

    base: MapReduceProgram = None  # type: ignore[assignment]
    num_groups: int = 0

    def __post_init__(self):
        if self.base is None:
            raise ValueError("GroupedProgram needs a base program")
        if self.num_groups < 0:
            raise ValueError(f"num_groups must be >= 0, got {self.num_groups}")
        fused = (self.base if isinstance(self.base, FusedProgram)
                 else FusedProgram((self.base,)))
        object.__setattr__(self, "_fused", fused)
        object.__setattr__(self, "_single",
                           not isinstance(self.base, FusedProgram))
        object.__setattr__(self, "additive", fused.additive)

    def cache_key(self) -> Tuple:
        return ("Grouped", int(self.num_groups), self.base.cache_key())

    def zero(self, row_shape, dtype):
        G = self.num_groups
        return tree_map(
            lambda x: x[None].expand((G,) + tuple(x.shape)),
            self._fused.zero(row_shape, dtype))

    def map_chunk(self, rows, gmask):
        # gmask: [G, eta] bool — disjoint per-group row masks for the chunk
        shared = {dt: grouped_shared_map_chunk(rows, gmask, names,
                                               getattr(torch, dt))
                  for dt, names in self._fused._shared_groups}
        private = tuple(
            _map_groups(lambda m, p=p: p.map_chunk(rows, m), gmask,
                        gmask.shape[0])
            for p in self._fused._private)
        return {"shared": shared, "private": private}

    def merge(self, a, b):
        if self.additive:
            # per-leaf sum/max per the fused declaration — the group axis
            # doesn't change leaf order or the elementwise operator
            return _merge_leafwise(a, b, self._fused.merge_ops_for(a))
        return _map_groups(lambda ab: self._fused.merge(*ab), (a, b),
                           self.num_groups)

    def merge_ops_for(self, partial):
        # the grouped partial is the fused partial with a leading group
        # axis on every leaf: same treedef, same per-leaf operators
        return self._fused.merge_ops_for(partial)

    def finalize(self, partial):
        out = _map_groups(self._fused.finalize, partial, self.num_groups)
        return out[0] if self._single else out

    def shared_fold_spec(self):
        # the grouped partial is the fused partial with a leading group
        # axis on every leaf — exactly what the kernel's [G, F] pool is
        return self._fused.shared_fold_spec()

    def partial_from_shared(self, shared):
        return self._fused.partial_from_shared(shared)


@dataclasses.dataclass(frozen=True)
class HistogramProgram(MapReduceProgram):
    """Global intensity histogram with fixed bin edges (additive)."""

    lo: float = 0.0
    hi: float = 1.0
    bins: int = 64
    additive = True

    def zero(self, row_shape, dtype):
        return {"hist": torch.zeros((self.bins,), dtype=torch.float32)}

    def map_chunk(self, rows, valid):
        x = rows.reshape(rows.shape[0], -1)
        scaled = (x - self.lo) / (self.hi - self.lo) * self.bins
        idx = torch.clamp(scaled.to(torch.int32), 0, self.bins - 1)
        onehot = torch.nn.functional.one_hot(
            idx.to(torch.int64), self.bins).to(torch.float32)
        w = valid.to(torch.float32)[:, None, None]
        return {"hist": (onehot * w).sum(dim=(0, 1))}

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        return p["hist"]
