"""Arithmetic of the end-to-end metrics and of the trace: rates, tails
and the union of device intervals."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return amount / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) by linear interpolation
    between the closest ranks (numpy's default, and ``statistics``'
    ``inclusive`` method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps
    counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out: List[Tuple[float, float]] = []
    at = lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
