"""Summary-statistic MapReduce programs (§2.2's workload family).

The paper's exemplar is population-template construction: averaging 5,153
registered T1 volumes with ANTS ``AverageImages``.  That is a mean fold; this
module provides it plus the statistics a population study actually asks for
(variance via Chan/Welford parallel merge, higher moments, histograms), all as
:class:`~repro_torch.core.mapreduce.MapReduceProgram` monoids so the same engine,
chunk model and table scheme apply.

Accumulation dtype defaults to float32; pass ``acc_dtype=torch.float64``
for reference-grade accumulation.

Port of ``src/repro/core/stats.py``: the exact programs and the three
sketches (count-min, HyperLogLog, dyadic quantiles).  ``vmap`` over the
group axis becomes a loop over groups whose results are stacked.  The
sketches' uint32 hashing runs in int64 masked to 32 bits (torch's
``uint32`` lacks most operators), with every product kept below 2⁴⁸, so
the card and the CPU hash bit-identically.
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


# ---------------------------------------------------------------------------
# sketch support: deterministic seeded hashing (identical on host and device)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in ``[0, 2^32)``: ``c`` splits
    into 16-bit halves so no product reaches 2^48 (no signed overflow),
    and the high half's product only matters mod 2^16."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (full avalanche) on uint32 values held
    in int64 tensors (``[0, 2^32)``; ``>>`` is logical on them).  Integer
    arithmetic only, so the card, the CPU and :func:`_host_fmix32` hash
    bit-identically."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _host_fmix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def _derive_seeds(seed: int, n: int) -> Tuple[int, ...]:
    """``n`` decorrelated 32-bit hash seeds from one user seed (golden-ratio
    stepping + fmix32) — Python-int arithmetic mod 2^32, computed once per
    program instance so folds never pay for it."""
    out = []
    base = seed & 0xFFFFFFFF
    for i in range(n):
        h = (base + i * 0x9E3779B9) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        h ^= h >> 16
        out.append(h)
    return tuple(out)


def _item_keys(x: torch.Tensor) -> torch.Tensor:
    """uint32 hash keys (int64 tensors in ``[0, 2^32)``) of values: the
    float32 bit pattern with ``-0.0`` canonicalized to ``+0.0``, so equal
    values always collide and the NumPy oracle
    (:mod:`repro_torch.core.ref`) can reproduce the exact same item
    universe.  ``torch.where`` keeps NaN payload bits, as the reference's
    ``jnp.where`` does."""
    xf = x.to(torch.float32)
    xf = torch.where(xf == 0.0, torch.zeros((), device=x.device), xf)
    return xf.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def _element_keys(rows: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten a ``[eta, ...]`` chunk into per-element uint32 hash keys
    and the element mask, as the reference does: invalid rows are zeroed
    before the bitcast — their keys are well-defined garbage that the
    returned element mask weights out.

    Sketches treat every element of every valid row as one item of the
    distribution (the same element-level semantics as
    :class:`HistogramProgram`)."""
    x = rows.reshape(rows.shape[0], -1)                       # [eta, E]
    v = valid.to(torch.bool)[:, None].expand(x.shape)
    xz = torch.where(v, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _item_keys(xz).reshape(-1), v.reshape(-1)


def _valid_items(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The elements of a chunk's valid rows, flat.  An invalid row adds
    nothing to a sketch (the reference hashes its zeroed items and weights
    them 0), so the port drops it before hashing: a grouped fold hashes
    each item once rather than once per group, and no zero-weight item
    crowds one counter of the scatter.  The counts are the same."""
    x = rows.reshape(rows.shape[0], -1)
    sel = torch.nonzero(valid.to(torch.bool)).reshape(-1)
    return x.index_select(0, sel).reshape(-1)


def host_element_keys(values: np.ndarray) -> np.ndarray:
    """Host mirror of the device key derivation: float32 bit patterns with
    ``-0.0`` canonicalized — the item identity both the sketch programs and
    the exact oracles share."""
    xf = np.asarray(values, np.float32).reshape(-1)
    xf = np.where(xf == 0.0, np.float32(0.0), xf)
    return xf.view(np.uint32)


def _compiled_scale(lo: float, hi: float, n: int) -> float:
    """The factor the reference's compiled fold multiplies ``x - lo`` by
    for ``(x - lo) / (hi - lo) * n``: XLA turns the division by a constant
    into a product with its float32 reciprocal and folds ``n`` into that
    constant, in float32 (a true division differs in the last bit)."""
    return float(np.float32(np.float32(1.0) / np.float32(hi - lo))
                 * np.float32(n))


def _saturating_index(scaled: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(scaled.astype(int32), 0, n - 1)`` as XLA computes it: its
    float→int32 cast saturates (NaN → 0), so clamping in float first and
    then casting gives the same index; torch's own cast of a value past
    2^31 (or of ±Inf) is undefined and lands in bucket 0 on the CPU."""
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=float(n - 1),
                              neginf=0.0)
    return torch.clamp(scaled, 0, n - 1).to(torch.int64)


def _item_count(items: torch.Tensor) -> torch.Tensor:
    """The sketch's exact int32 item count ``n``."""
    return torch.full((), items.numel(), dtype=torch.int32,
                      device=items.device)


def _scatter_counts(size: int, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``zeros(size, int32).at[idx].add(w)``: int32 adds are exact and
    commute, so the counts do not depend on the order of the adds."""
    return torch.zeros((size,), dtype=torch.int32,
                       device=idx.device).index_add_(0, idx, w)


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
        scaled = (x - self.lo) * _compiled_scale(self.lo, self.hi, self.bins)
        idx = _saturating_index(scaled, self.bins)
        onehot = torch.nn.functional.one_hot(idx, self.bins).to(
            torch.float32)
        w = valid.to(torch.float32)[:, None, None]
        return {"hist": (onehot * w).sum(dim=(0, 1))}

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        return p["hist"]


# ---------------------------------------------------------------------------
# approximate sketches: mergeable programs with provable error bounds
# ---------------------------------------------------------------------------
#
# All three sketches below keep their state in fixed-shape int32 tensors
# whose merge is a per-leaf elementwise sum or max.  That buys two
# properties the exact monoids already enjoy, for free:
#
# - they ride every engine fast path (block-partial caching + .npz spill,
#   grouped lifting, the tree reduce, frontend coalescing);
# - their MERGE LAW is exact: integer sums and maxes are associative and
#   commutative with no rounding, so funnel vs tree, owner pre-merge or not,
#   any owner count — the merged sketch state is BIT-IDENTICAL, and every
#   finalized estimate (a deterministic function of that state) is too.
#
# Determinism: all hashing is seeded murmur-fmix32 over canonicalized
# float32 bit patterns (see _element_keys), identical on device and host.
# Counts scatter with int32 ``index_add_``, which is exact and independent
# of the order of its adds on the card and the CPU alike.


def _host(x) -> np.ndarray:
    """A result leaf (tensor on any device, or array) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class CountMinProgram(MapReduceProgram):
    """Count-min frequency sketch (Cormode–Muthukrishnan) over the selected
    elements — the heavy-hitters program.

    ``depth`` hash rows × ``width`` int32 counters plus the exact item count
    ``n``.  Point estimates (:meth:`estimate`) never undercount, and
    overcount by at most ``(e / width) · n`` with probability
    ``1 - e^-depth`` per queried item (the classic ε–δ bound with
    ``ε = e / width``, ``δ = e^-depth``).  :meth:`heavy_hitters` screens a
    candidate set against a ``phi · n`` threshold: no true heavy hitter is
    ever missed (one-sided error)."""

    depth: int = 4
    width: int = 1024
    seed: int = 0
    additive = True

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.width < 2 or (self.width & (self.width - 1)):
            raise ValueError(
                f"width must be a power of two >= 2, got {self.width}")
        object.__setattr__(self, "_seeds",
                           _derive_seeds(self.seed, self.depth))

    def zero(self, row_shape, dtype):
        return {"cm": torch.zeros((self.depth, self.width), dtype=torch.int32),
                "n": torch.zeros((), dtype=torch.int32)}

    def map_chunk(self, rows, valid):
        keys = _item_keys(_valid_items(rows, valid))
        ones = torch.ones_like(keys, dtype=torch.int32)
        # one hash row at a time: the index stays [M] int64 however deep
        # the sketch (the counts equal one flat scatter's: int32 adds)
        cm = torch.zeros((self.depth, self.width), dtype=torch.int32,
                         device=keys.device)
        for d, seed in enumerate(self._seeds):
            idx = _fmix32(keys ^ seed) & (self.width - 1)
            cm[d].index_add_(0, idx, ones)
        return {"cm": cm, "n": _item_count(keys)}

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def finalize(self, p):
        return {"cm": p["cm"], "n": p["n"]}

    # --- host-side query helpers (operate on the finalized result) -----

    def _host_indices(self, values) -> np.ndarray:
        keys = host_element_keys(values)                      # [M]
        seeds = np.asarray(self._seeds, np.uint32)[:, None]   # [depth, 1]
        return (_host_fmix32(keys[None, :] ^ seeds)
                & np.uint32(self.width - 1)).astype(np.int64)

    def estimate(self, result, values) -> np.ndarray:
        """Frequency upper-estimates for ``values`` — min over the depth
        rows; exact lower bound: ``estimate >= true frequency`` always."""
        cm = _host(result["cm"])
        idx = self._host_indices(values)                      # [depth, M]
        rows = cm[np.arange(self.depth)[:, None], idx]
        return rows.min(axis=0).astype(np.int64)

    def heavy_hitters(self, result, values, phi: float):
        """``(value, estimate)`` pairs from ``values`` whose estimated
        frequency reaches ``phi * n``, descending.  One-sided: every true
        phi-heavy hitter in ``values`` is returned (estimates never
        undercount); false positives are bounded by the ε·n overcount."""
        vals = np.asarray(values, np.float32).reshape(-1)
        est = self.estimate(result, vals)
        thresh = float(phi) * float(_host(result["n"]))
        keep = est >= thresh
        order = np.argsort(-est[keep], kind="stable")
        return [(float(v), int(e))
                for v, e in zip(vals[keep][order], est[keep][order])]

    def error_bound(self, n: int) -> Tuple[float, float]:
        """The documented (ε·n overcount, δ failure probability) pair for
        one point query against a sketch holding ``n`` items."""
        return (np.e / self.width) * float(n), float(np.exp(-self.depth))


@dataclasses.dataclass(frozen=True)
class HyperLogLogProgram(MapReduceProgram):
    """HyperLogLog distinct-count sketch (Flajolet et al.) over the selected
    elements' canonicalized float32 values.

    ``m = 2^p`` int32 registers; each item's hash picks a register with its
    top ``p`` bits and offers ``1 + leading-zeros`` of the rest.  Registers
    merge by elementwise MAX — declared through
    :meth:`~repro_torch.core.mapreduce.MapReduceProgram.merge_ops_for`, so
    the engine's additive fast paths reduce with ``max(dim=0)`` instead of
    sum while everything else (caching, spill, grouping, tree reduce) is
    inherited unchanged.  Relative standard error of the estimate is
    ``1.04 / sqrt(m)``; the linear-counting correction handles the
    small-cardinality regime."""

    p: int = 12
    seed: int = 0
    additive = True

    def __post_init__(self):
        if not 4 <= self.p <= 16:
            raise ValueError(f"p must be in [4, 16], got {self.p}")
        object.__setattr__(self, "_seed32", _derive_seeds(self.seed, 1)[0])

    def merge_ops_for(self, partial):
        return ["max"] * len(tree_leaves(partial))

    def zero(self, row_shape, dtype):
        return {"regs": torch.zeros((1 << self.p,), dtype=torch.int32)}

    def map_chunk(self, rows, valid):
        keys = _item_keys(_valid_items(rows, valid))
        h = _fmix32(keys ^ self._seed32)
        m = 1 << self.p
        idx = h >> (32 - self.p)
        tail = (h << self.p) & _MASK32          # the 32-p low hash bits
        # clz of a 32-bit value is 32 minus its bit length, which frexp
        # gives exactly (t < 2^53 as float64; a zero tail gives 32)
        _, bits = torch.frexp(tail.to(torch.float64))
        rank = torch.clamp_max(32 - bits, 32 - self.p).to(torch.int32) + 1
        regs = torch.zeros((m,), dtype=torch.int32, device=keys.device)
        return {"regs": regs.scatter_reduce_(0, idx, rank, "amax",
                                             include_self=True)}

    def merge(self, a, b):
        return tree_map(torch.maximum, a, b)

    def finalize(self, p_):
        m = 1 << self.p
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
            m, 0.7213 / (1.0 + 1.079 / m))
        regs = p_["regs"]

        # a Python scalar divided by a tensor takes the tensor's reciprocal
        # first; a float32 tensor dividend divides as the reference does
        def const(c):
            return torch.full((), c, dtype=torch.float32, device=regs.device)

        raw = (const(alpha * m * m)
               / torch.sum(torch.exp2(-regs.to(torch.float32))))
        zeros = torch.sum(regs == 0).to(torch.float32)
        small = m * torch.log(const(m) / torch.clamp_min(zeros, 1.0))
        est = torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
        return {"estimate": est, "registers": regs}

    def std_error(self) -> float:
        """Documented relative standard error: ``1.04 / sqrt(m)``."""
        return 1.04 / float(np.sqrt(1 << self.p))


@dataclasses.dataclass(frozen=True)
class QuantileSketchProgram(MapReduceProgram):
    """Dyadic count-min rank/quantile sketch over a quantized universe.

    Values in ``[lo, hi)`` quantize to ``U = 2^log2_universe`` buckets; each
    item increments one count-min row per dyadic level (an item at bucket
    ``b`` lives in interval ``b >> lvl`` of level ``lvl``).  A rank query
    decomposes a prefix into at most ``log2_universe`` dyadic intervals and
    sums their count-min estimates; quantiles descend the dyadic trie with
    the same estimates.  All state is int32 counts, so — unlike a real
    KLL/t-digest, whose compactions make the result depend on merge order —
    the merged sketch is bit-identical under ANY merge tree, which is the
    engine's merge-law contract.

    **Dense fast path.**  Hashing into ``depth × width`` counters only pays
    off when the universe exceeds the table: for ``U <= depth * width`` the
    exact per-bucket counts fit in the SAME memory with strictly better
    accuracy (zero rank error) and a fold of one scatter entry per item
    instead of ``log2_universe · depth``.  Below that threshold the program
    keeps the exact ``[U]`` histogram (``dense`` is True,
    :meth:`rank_error_bound` returns 0); the count-min engages above it.
    Both modes share the quantized-universe semantics, the additive int32
    merge, and therefore the exact merge law.

    **Count-min fold, bounded.**  The hashed cell of an item depends only
    on its bucket, so a chunk with more items than buckets first counts
    its items per bucket (one ``[U]`` scatter, as in dense mode) and then
    scatters the ``U`` bucket counts into every (level, depth-row) lane;
    a smaller chunk scatters its items into every lane directly, as the
    reference does.  Either way the counts equal the reference's one flat
    per-item scatter (int32 adds commute), and the index never exceeds
    ``[L, D, U]`` however many items a chunk holds.

    Error decomposition (documented, asserted in tests):

    - rank: dense mode is exact over the quantized items.  In count-min
      mode each lookup overcounts by at most ``(e / width) · n`` with
      probability ``1 - e^-depth``; a prefix sums at most
      ``log2_universe`` lookups, so the rank error is bounded by
      ``log2_universe · (e / width) · n`` w.h.p. (never an undercount —
      count-min is one-sided).
    - value: quantization adds at most one bucket width
      ``(hi - lo) / U`` to the returned quantile value (both modes).
    """

    lo: float = 0.0
    hi: float = 1.0
    log2_universe: int = 12
    depth: int = 4
    width: int = 2048
    probes: Tuple[float, ...] = (0.5,)
    seed: int = 0
    additive = True

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError(f"need hi > lo, got [{self.lo}, {self.hi})")
        if not 1 <= self.log2_universe <= 20:
            raise ValueError(
                f"log2_universe must be in [1, 20], got {self.log2_universe}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.width < 2 or (self.width & (self.width - 1)):
            raise ValueError(
                f"width must be a power of two >= 2, got {self.width}")
        probes = tuple(float(q) for q in self.probes)
        if not probes or any(not 0.0 < q < 1.0 for q in probes):
            raise ValueError(f"probes must lie in (0, 1), got {probes}")
        object.__setattr__(self, "probes", probes)
        # exact dyadic counts beat the CM whenever they fit its memory
        object.__setattr__(self, "dense",
                           (1 << self.log2_universe)
                           <= self.depth * self.width)
        # one decorrelated seed per (level, depth-row)
        flat = _derive_seeds(self.seed, self.log2_universe * self.depth)
        object.__setattr__(
            self, "_seeds",
            tuple(flat[lvl * self.depth:(lvl + 1) * self.depth]
                  for lvl in range(self.log2_universe)))

    # --- shared bucket/hash arithmetic --------------------------------

    def _buckets(self, x, xp=torch):
        """Quantize float32 values to universe buckets (``torch`` tensors
        or, with ``xp=np``, numpy arrays), as the reference does:

        - a tensor (the fold) scales as the reference's compiled fold does
          (:func:`_compiled_scale`); a numpy array (the host helpers)
          divides, as the reference's NumPy path does;
        - the scaled value is clamped to ``[0, U - 1]`` in float before
          the cast, which equals XLA's saturating float→int32 cast followed
          by the clip (a plain cast of a value past 2^31 is undefined)."""
        U = 1 << self.log2_universe
        if xp is not np:
            return _saturating_index(
                (x - self.lo) * _compiled_scale(self.lo, self.hi, U), U)
        scaled = (x - self.lo) / (self.hi - self.lo) * U
        scaled = np.nan_to_num(scaled, nan=0.0, posinf=float(U - 1),
                               neginf=0.0)
        return np.clip(scaled, 0, U - 1).astype(np.int32)

    def zero(self, row_shape, dtype):
        if self.dense:
            return {"cm": torch.zeros((1 << self.log2_universe,),
                                      dtype=torch.int32),
                    "n": torch.zeros((), dtype=torch.int32)}
        return {"cm": torch.zeros((self.log2_universe, self.depth,
                                   self.width), dtype=torch.int32),
                "n": torch.zeros((), dtype=torch.int32)}

    def _lane_cells(self, b: torch.Tensor) -> torch.Tensor:
        """``[L, D, K]`` flat count-min cell of each of ``K`` buckets in
        every (level, depth-row) lane: bucket ``b`` lands in interval
        ``b >> lvl``, hashed with the lane's seed into its ``width``
        counters."""
        L, D = self.log2_universe, self.depth
        dev = b.device
        lvls = torch.arange(L, dtype=torch.int64, device=dev)
        j = b[None, :] >> lvls[:, None]                       # [L, K]
        seeds = torch.tensor(self._seeds, dtype=torch.int64, device=dev)
        idx = _fmix32(j[:, None, :] ^ seeds[:, :, None]) & (self.width - 1)
        lane = torch.arange(L * D, dtype=torch.int64,
                            device=dev).reshape(L, D, 1)
        return idx + lane * self.width

    def map_chunk(self, rows, valid):
        b = self._buckets(_valid_items(rows, valid).to(torch.float32))
        w = torch.ones_like(b, dtype=torch.int32)             # [M]
        U = 1 << self.log2_universe
        n = _item_count(b)
        if self.dense:                     # exact bucket counts, 1 scatter
            return {"cm": _scatter_counts(U, b, w), "n": n}
        L, D = self.log2_universe, self.depth
        if b.numel() > U:
            # more items than buckets: count per bucket first, then
            # scatter the U bucket counts into every lane
            b, w = torch.arange(U, device=b.device), _scatter_counts(U, b, w)
        cells = self._lane_cells(b).reshape(-1)
        cm = _scatter_counts(L * D * self.width, cells, w.repeat(L * D))
        return {"cm": cm.reshape(L, D, self.width), "n": n}

    def merge(self, a, b):
        return tree_map(_add, a, b)

    def _point_est(self, cm, lvl: int, j):
        """Count-min estimate for interval ``j`` of level ``lvl``."""
        seeds = torch.tensor(self._seeds[lvl], dtype=torch.int64,
                             device=cm.device)
        idx = _fmix32((j.to(torch.int64) & _MASK32) ^ seeds) \
            & (self.width - 1)
        return torch.min(cm[lvl, torch.arange(self.depth,
                                              device=cm.device), idx])

    def finalize(self, p):
        """Estimate each probe quantile — dense mode reads the exact rank
        off the bucket cumsum; count-min mode descends the dyadic trie in
        ``log2_universe`` steps of lookups, on the partial's device.
        ``n == 0`` finalizes to NaN quantiles."""
        cm, n = p["cm"], p["n"]
        L = self.log2_universe
        U = 1 << L
        dev = cm.device
        nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
        outs = []
        if self.dense:
            cum = torch.cumsum(cm, 0, dtype=torch.int32)
            for q in self.probes:
                r = torch.clamp_min(
                    torch.ceil(q * n.to(torch.float32)).to(torch.int32), 1)
                b = torch.clamp_max(
                    torch.searchsorted(cum, r.reshape(1), side="left")[0],
                    U - 1).to(torch.int32)
                val = self.lo + (b.to(torch.float32) + 0.5) \
                    * (self.hi - self.lo) / U
                outs.append(torch.where(n > 0, val, nan))
            return {"quantiles": torch.stack(outs), "n": n, "cm": cm}
        for q in self.probes:
            r = torch.clamp_min(
                torch.ceil(q * n.to(torch.float32)).to(torch.int32), 1)
            b = torch.zeros((), dtype=torch.int32, device=dev)
            cum = torch.zeros((), dtype=torch.int32, device=dev)
            for lvl in range(L - 1, -1, -1):
                c = self._point_est(cm, lvl, b >> lvl)
                go_right = cum + c < r
                cum = torch.where(go_right, cum + c, cum)
                b = torch.where(go_right, b + (1 << lvl), b)
            val = self.lo + (b.to(torch.float32) + 0.5) \
                * (self.hi - self.lo) / U
            outs.append(torch.where(n > 0, val, nan))
        return {"quantiles": torch.stack(outs), "n": n, "cm": cm}

    # --- host-side query helpers (operate on the finalized result) -----

    def rank_estimate(self, result, values) -> np.ndarray:
        """Estimated rank (count of items strictly below each value's
        bucket) — exact in dense mode; in count-min mode the dyadic
        decomposition never undercounts and overcounts by at most
        ``log2_universe * (e/width) * n`` w.h.p."""
        cm = _host(result["cm"])
        b = self._buckets(np.asarray(values, np.float32).reshape(-1), np)
        if self.dense:
            cum = np.cumsum(cm.astype(np.int64))
            return np.where(b > 0, cum[np.maximum(b, 1) - 1], 0)
        rank = np.zeros(b.shape, np.int64)
        for lvl in range(self.log2_universe):
            sel = (b >> lvl) & 1 == 1
            if not sel.any():
                continue
            j = ((b[sel].astype(np.int64) >> (lvl + 1)) << 1).astype(np.uint32)
            seeds = np.asarray(self._seeds[lvl], np.uint32)[:, None]
            idx = (_host_fmix32(j[None, :] ^ seeds)
                   & np.uint32(self.width - 1)).astype(np.int64)
            ests = cm[lvl][np.arange(self.depth)[:, None], idx].min(axis=0)
            rank[sel] += ests
        return rank

    def rank_error_bound(self, n: int) -> float:
        """Documented w.h.p. rank-error bound for one rank query — 0 in
        dense mode (exact over the quantized items)."""
        if self.dense:
            return 0.0
        return self.log2_universe * (np.e / self.width) * float(n)

    def value_resolution(self) -> float:
        """Quantization granularity: one universe bucket width."""
        return (self.hi - self.lo) / (1 << self.log2_universe)
