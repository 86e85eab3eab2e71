"""Regions — contiguous rowkey ranges of a TensorTable, with split policies.

Port of ``src/repro/core/regions.py`` (host-only, copied).

HBase splits a table into *regions*: half-open rowkey ranges ``[start, stop)``
that are the unit of placement and of map-task locality.  A region whose byte
size exceeds a policy threshold is split into two children.  The paper uses two
policies (Table 1, "Region split policy"):

- the *default* policy splits at the median rowkey of the region, and
- the *hierarchical* policy (ref. [2, 17] of the paper) uses the per-row size
  index column to pick the split point that balances **bytes**, which matters
  for medical images whose sizes vary 6-20 MB.

Regions here are pure values over ``(sorted rowkeys, per-row byte sizes)``
arrays owned by the table; they never hold data themselves.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

# Sentinels for the open ends of the keyspace, mirroring HBase's empty
# start/stop keys.  All real rowkeys compare strictly inside these.
KEY_MIN: bytes = b""           # inclusive lower bound of the keyspace
KEY_MAX: Optional[bytes] = None  # exclusive upper bound (None == +inf)


def _key_lt(a: bytes, b: Optional[bytes]) -> bool:
    """a < b with b possibly the +inf sentinel."""
    return b is None or a < b


@dataclasses.dataclass(frozen=True)
class Region:
    """A half-open rowkey range ``[start, stop)`` with a stable id."""

    rid: int
    start: bytes                  # inclusive; KEY_MIN for the first region
    stop: Optional[bytes]         # exclusive; None (KEY_MAX) for the last

    @property
    def signature(self) -> Tuple[int, bytes, Optional[bytes]]:
        """Stable identity for content-addressed consumers (the BlockStore's
        block keys).  rids are never reused, but carrying the key range makes
        a block's address self-describing and collision-proof by
        construction."""
        return (self.rid, self.start, self.stop)

    def contains(self, key: bytes) -> bool:
        return self.start <= key and _key_lt(key, self.stop)

    def row_slice(self, sorted_keys: np.ndarray) -> slice:
        """Resolve to a positional slice into the table's sorted row order."""
        lo = int(np.searchsorted(sorted_keys, self.start, side="left"))
        if self.stop is None:
            hi = len(sorted_keys)
        else:
            hi = int(np.searchsorted(sorted_keys, self.stop, side="left"))
        return slice(lo, hi)

    def num_rows(self, sorted_keys: np.ndarray) -> int:
        s = self.row_slice(sorted_keys)
        return s.stop - s.start

    def num_bytes(self, sorted_keys: np.ndarray, row_bytes: np.ndarray) -> int:
        s = self.row_slice(sorted_keys)
        return int(row_bytes[s.start:s.stop].sum())


class SplitPolicy:
    """Decides whether and where to split an over-threshold region."""

    def __init__(self, max_region_bytes: int):
        if max_region_bytes <= 0:
            raise ValueError("max_region_bytes must be positive")
        self.max_region_bytes = int(max_region_bytes)

    def should_split(self, region: Region, sorted_keys: np.ndarray,
                     row_bytes: np.ndarray) -> bool:
        return (region.num_rows(sorted_keys) >= 2
                and region.num_bytes(sorted_keys, row_bytes) > self.max_region_bytes)

    def split_key(self, region: Region, sorted_keys: np.ndarray,
                  row_bytes: np.ndarray) -> Optional[bytes]:
        raise NotImplementedError


class ConstantSizeSplitPolicy(SplitPolicy):
    """HBase default-like: split at the median *row* of the region."""

    def split_key(self, region, sorted_keys, row_bytes):
        s = region.row_slice(sorted_keys)
        n = s.stop - s.start
        if n < 2:
            return None
        mid = s.start + n // 2
        key = bytes(sorted_keys[mid])
        # The split key must strictly separate the two halves.
        if key == region.start:
            return None
        return key

    def __repr__(self):
        return f"ConstantSizeSplitPolicy(max_region_bytes={self.max_region_bytes})"


class HierarchicalSplitPolicy(SplitPolicy):
    """The paper's scheme: use the size index column to balance *bytes*.

    Picks the rowkey at which the cumulative byte count crosses half the
    region's total, so children carry near-equal data volume even when row
    sizes are skewed (6-20 MB NiFTI images).
    """

    def split_key(self, region, sorted_keys, row_bytes):
        s = region.row_slice(sorted_keys)
        n = s.stop - s.start
        if n < 2:
            return None
        sizes = row_bytes[s.start:s.stop].astype(np.int64)
        half = sizes.sum() / 2.0
        cum = np.cumsum(sizes)
        # first row index whose prefix sum reaches half; clamp inside (0, n)
        pos = int(np.searchsorted(cum, half, side="left")) + 1
        pos = max(1, min(pos, n - 1))
        key = bytes(sorted_keys[s.start + pos])
        if key == region.start:
            return None
        return key

    def __repr__(self):
        return f"HierarchicalSplitPolicy(max_region_bytes={self.max_region_bytes})"


class RegionSet:
    """A sorted, contiguous partition of the keyspace into regions.

    Invariants (checked by :meth:`check_invariants` and the property tests):
      * regions are sorted by ``start`` and tile the keyspace exactly:
        first.start == KEY_MIN, last.stop is KEY_MAX, and every adjacent pair
        satisfies ``regions[i].stop == regions[i+1].start``;
      * region ids are unique and never reused.
    """

    def __init__(self, policy: SplitPolicy):
        self.policy = policy
        self._regions: List[Region] = [Region(0, KEY_MIN, KEY_MAX)]
        self._next_rid = 1
        # sorted region start keys, maintained in lockstep with _regions so
        # every containment/overlap question is a bisect, never a rebuild
        self._starts: List[bytes] = [KEY_MIN]

    # -- accessors ---------------------------------------------------------

    @property
    def regions(self) -> Tuple[Region, ...]:
        return tuple(self._regions)

    def __len__(self) -> int:
        return len(self._regions)

    def __iter__(self) -> Iterator[Region]:
        return iter(self._regions)

    def regions_containing(self, keys: Iterable[bytes]) -> Set[int]:
        """Region ids whose key ranges contain any of ``keys``.

        The dirty-region primitive: a mutation touching ``keys`` invalidates
        exactly these regions' placements, nothing else.  O(m log n) — one
        bisect over the maintained start-key list per key, no linear walk.
        """
        starts = self._starts
        return {
            self._regions[bisect.bisect_right(starts, k) - 1].rid
            for k in keys
        }

    def region_for(self, key: bytes) -> Region:
        return self._regions[bisect.bisect_right(self._starts, key) - 1]

    def prune(self, start: Optional[bytes] = None,
              stop: Optional[bytes] = None) -> Tuple[Region, ...]:
        """Regions overlapping the half-open scan range ``[start, stop)``.

        The scan-pruning primitive (§2.3's rowkey scheme): a rowkey
        prefix/range predicate resolves to the regions it can possibly touch,
        so non-matching regions are never scanned and their device blocks
        never gathered.  ``None`` bounds mean the open keyspace ends.  Two
        bisects over the start-key list — O(log n) plus the output size.
        """
        if stop is not None and start is not None and start >= stop:
            return ()
        lo = 0
        if start is not None and start > KEY_MIN:
            lo = bisect.bisect_right(self._starts, start) - 1
        hi = len(self._regions)
        if stop is not None:
            # regions with r.start >= stop cannot overlap [start, stop)
            hi = bisect.bisect_left(self._starts, stop)
        return tuple(self._regions[lo:hi])

    # -- mutation ----------------------------------------------------------

    def pre_split(self, split_keys: Sequence[bytes]) -> None:
        """Pre-split the (single, empty) keyspace at the given keys.

        Mirrors the Upload interface's ``pre-split`` option: only valid on a
        fresh table.
        """
        if len(self._regions) != 1:
            raise ValueError("pre_split is only valid on an unsplit table")
        keys = sorted(set(split_keys))
        regions: List[Region] = []
        prev: bytes = KEY_MIN
        for k in keys:
            if k == prev:
                continue
            regions.append(Region(self._next_rid, prev, k))
            self._next_rid += 1
            prev = k
        regions.append(Region(self._next_rid, prev, KEY_MAX))
        self._next_rid += 1
        self._regions = regions
        self._starts = [r.start for r in regions]

    def maybe_split(self, sorted_keys: np.ndarray, row_bytes: np.ndarray
                    ) -> List[Tuple[Region, Region, Region]]:
        """Split every over-threshold region (repeatedly, as HBase would).

        Returns the list of ``(parent, left_child, right_child)`` splits that
        happened, so Placement can remap parents to children in place.
        """
        events: List[Tuple[Region, Region, Region]] = []
        i = 0
        while i < len(self._regions):
            region = self._regions[i]
            if self.policy.should_split(region, sorted_keys, row_bytes):
                key = self.policy.split_key(region, sorted_keys, row_bytes)
                if key is not None and region.contains(key) and key != region.start:
                    left = Region(self._next_rid, region.start, key)
                    right = Region(self._next_rid + 1, key, region.stop)
                    self._next_rid += 2
                    self._regions[i:i + 1] = [left, right]
                    self._starts[i:i + 1] = [left.start, right.start]
                    events.append((region, left, right))
                    continue  # re-examine children at the same index
            i += 1
        return events

    # -- validation --------------------------------------------------------

    def check_invariants(self) -> None:
        rs = self._regions
        assert rs, "RegionSet must never be empty"
        assert rs[0].start == KEY_MIN, "first region must start the keyspace"
        assert rs[-1].stop is None, "last region must end the keyspace"
        for a, b in zip(rs, rs[1:]):
            assert a.stop == b.start, f"gap/overlap between {a} and {b}"
            assert a.stop is not None
        rids = [r.rid for r in rs]
        assert len(set(rids)) == len(rids), "region ids must be unique"
        assert self._starts == [r.start for r in rs], \
            "start-key index out of sync with regions"
