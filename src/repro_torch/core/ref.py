"""Exact NumPy oracles for the approximate-sketch programs.

Port of ``src/repro/core/ref.py`` (host-only, copied).

Every sketch in :mod:`repro_torch.core.stats` (count-min, HyperLogLog, the dyadic
quantile sketch) is verified in the test suite against the *exact* answer
computed here in float64 NumPy — no JAX, no hashing, no approximation — with
the documented error bound asserted explicitly (ε·n / δ for count-min,
``1.04/sqrt(m)`` standard-error multiples for HLL, the dyadic rank bound for
quantiles).

Item identity matters: the sketches hash the canonicalized float32 bit
pattern of each element (``-0.0 == +0.0``; see
:func:`repro_torch.core.stats.host_element_keys`), so the oracles quantize to the
same universe of items before counting.  Values stay float32 for identity
and are promoted to float64 only for order statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def canonical_items(values) -> np.ndarray:
    """Flatten to the sketch programs' item universe: canonical float32
    values (``-0.0`` folded into ``+0.0``), one item per element."""
    x = np.asarray(values, np.float32).reshape(-1)
    return np.where(x == 0.0, np.float32(0.0), x)


def exact_frequencies(values) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique_values, counts)`` over the canonical items — the count-min
    oracle.  Exact integer counts; NaNs collapse to one item like the
    sketch's single NaN bit pattern."""
    items = canonical_items(values)
    uniq, counts = np.unique(items, return_counts=True)
    return uniq, counts.astype(np.int64)


def exact_distinct(values) -> int:
    """Exact distinct-item count — the HyperLogLog oracle."""
    return int(len(np.unique(canonical_items(values))))


def exact_heavy_hitters(values, phi: float) -> Sequence[Tuple[float, int]]:
    """All items with exact frequency ``>= phi * n``, descending — the set
    count-min's one-sided screen must be a superset of."""
    uniq, counts = exact_frequencies(values)
    n = counts.sum()
    keep = counts >= phi * n
    order = np.argsort(-counts[keep], kind="stable")
    return [(float(v), int(c))
            for v, c in zip(uniq[keep][order], counts[keep][order])]


def exact_quantiles(values, probes: Sequence[float]) -> np.ndarray:
    """Exact order statistics at the probe ranks (float64 sort; the item at
    rank ``ceil(q * n)``) — the quantile-sketch oracle."""
    items = np.sort(canonical_items(values).astype(np.float64))
    n = len(items)
    if n == 0:
        return np.full(len(probes), np.nan)
    ranks = np.clip(np.ceil(np.asarray(probes, np.float64) * n).astype(
        np.int64), 1, n)
    return items[ranks - 1]


def rank_interval(values, vs) -> Tuple[np.ndarray, np.ndarray]:
    """Per query value, the exact rank interval ``[strictly_below,
    at_or_below]`` among the canonical items (int64).  A rank estimate r̂
    for ``v`` is correct within slack ``s`` iff the distance from r̂ to
    this interval is at most ``s`` — ties at ``v`` never count as error."""
    items = np.sort(canonical_items(values).astype(np.float64))
    q = np.asarray(vs, np.float64).reshape(-1)
    below = np.searchsorted(items, q, side="left").astype(np.int64)
    at_or_below = np.searchsorted(items, q, side="right").astype(np.int64)
    return below, at_or_below


def interval_distance(value, lo, hi) -> np.ndarray:
    """Elementwise distance from ``value`` to the closed interval
    ``[lo, hi]`` (0 inside) — the error a bound assertion charges."""
    v = np.asarray(value, np.float64)
    return np.maximum(np.maximum(np.asarray(lo, np.float64) - v,
                                 v - np.asarray(hi, np.float64)), 0.0)
