"""Rapid NoSQL query — the paper's §2.3 table scheme, with byte accounting.

Port of ``src/repro/core/query.py`` (host-only, copied).

The proposed scheme puts small covariate indexes (age, sex, size, ...) in a
column family **separate** from the image payloads.  A subset query ("average
all female brains aged 20-40") then:

1. scans only the index family to build a rowkey mask — bytes touched are a
   few per row, not megabytes (``indexed_query``);
2. hands the mask to the MapReduce engine, where each map task gathers the
   selected payload rows *from its own shard* — the two families share rowkeys
   and placement, so locality survives the filter.

The naïve scheme (everything in one family) cannot evaluate the predicate
without dragging the payload bytes through the read path (HBase materializes
the row's store files around the cells it returns); ``naive_query`` returns
the *same mask* but charges the full row bytes — the 7× of Fig. 6 comes from
exactly this difference, and the simulator turns these byte counts into time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.table import (
    DATA_FAMILY,
    INDEX_FAMILY,
    TensorTable,
)

# A predicate maps {qualifier: column array} -> boolean row mask.
Predicate = Callable[[Mapping[str, np.ndarray]], np.ndarray]


@dataclasses.dataclass(frozen=True)
class QueryStats:
    """What the query *touched* — the quantity the table scheme optimizes."""

    rows_scanned: int             # rows whose cells were visited
    index_bytes_scanned: int      # small-column bytes read for the predicate
    payload_bytes_traversed: int  # payload bytes forced through the read path
    rows_selected: int
    # logical payload bytes the pushdown admitted into the fold: selected
    # rows × row bytes, the quantity the §2.3 scheme exists to minimize.
    # (Physical transfer is now block-granular and reported separately
    # below — a repeat plan can select many rows yet transfer nothing.)
    payload_bytes_moved: int = 0
    # region pruning efficacy: how many regions the scan range resolved to
    # vs how many the rowkey-range pushdown excluded outright (their device
    # blocks are never gathered).  scanned + pruned == total regions.
    regions_scanned: int = 0
    regions_pruned: int = 0
    # --- BlockStore oracles (copy-on-write block reuse observability) ----
    # The plan's layout is assembled from per-region device blocks; every
    # block it needed is exactly one of reused / transferred:
    blocks_total: int = 0         # blocks the plan's surviving regions span
    blocks_reused: int = 0        # already resident on the right device
    blocks_transferred: int = 0   # crossed host→device for this execution
    gather_count: int = 0         # blocks whose host payload was re-read
    payload_bytes_transferred: int = 0  # physical bytes of the transfers
    # --- fold-engine oracles (block-granular partial caching) ------------
    # The fold is block-at-a-time: each surviving block with selected rows
    # is one *partial*, either served from the partial cache or re-folded:
    partials_total: int = 0       # foldable (selected-row) blocks the plan spans
    partials_reused: int = 0      # partials served from the cache (zero rows read)
    rows_folded: int = 0          # payload rows the map phase actually read
    # which physical gather/fold path the planner chose for this execution:
    # "blocks" (block-granular fold), "compact" (one-shot compacted gather),
    # "retrieve" (host-side collect), "" for pre-fold stats objects.
    gather_path: str = ""
    # --- grouped-analytics oracles ---------------------------------------
    # distinct group-key values among the selected rows (0 = ungrouped);
    # grouping must never multiply gathers or folds — the per-block fold
    # segment-sums all G groups in its one pass.
    num_groups: int = 0
    # which physical reduce combined the partials: "tree" (psum over the
    # mesh's data axis, owner-local pre-merge) or "funnel" (single-device
    # jitted merge); "" when no merge ran (result-cache hit, compact path,
    # retrieve).
    merge_path: str = ""

    @property
    def total_bytes_scanned(self) -> int:
        return self.index_bytes_scanned + self.payload_bytes_traversed

    def check_block_invariant(self) -> None:
        """Every needed block is exactly one of reused / transferred, and a
        table re-read implies a transfer (the differential harness asserts
        this after every executed plan)."""
        assert self.blocks_reused + self.blocks_transferred == \
            self.blocks_total, self
        assert 0 <= self.gather_count <= self.blocks_transferred, self

    def check_partial_invariant(self) -> None:
        """Partial-cache consistency: a fully-reused plan folds zero rows,
        any fold implies a non-reused partial, and the compact path never
        touches blocks or partials (the differential harness asserts this
        after every executed plan)."""
        assert 0 <= self.partials_reused <= self.partials_total, self
        if self.partials_total and self.partials_reused == self.partials_total:
            assert self.rows_folded == 0, self
        if self.gather_path == "blocks" and self.rows_folded > 0:
            assert self.partials_reused < self.partials_total, self
        if self.gather_path == "compact":
            assert self.partials_total == 0 and self.blocks_total == 0, self


def _scan_range(
    table: TensorTable,
    start: Optional[bytes],
    stop: Optional[bytes],
) -> np.ndarray:
    lo, hi = table.row_range(start, stop)
    return np.arange(lo, hi, dtype=np.int64)


def _region_stats(
    table: TensorTable,
    start: Optional[bytes],
    stop: Optional[bytes],
) -> Tuple[int, int]:
    """``(regions_scanned, regions_pruned)`` for a scan range."""
    scanned = len(table.regions.prune(start, stop))
    return scanned, len(table.regions) - scanned


def indexed_query(
    table: TensorTable,
    predicate: Predicate,
    index_qualifiers: Sequence[str],
    index_family: str = INDEX_FAMILY,
    start: Optional[bytes] = None,
    stop: Optional[bytes] = None,
) -> Tuple[np.ndarray, QueryStats]:
    """Proposed scheme: evaluate ``predicate`` touching ONLY the index family.

    Returns a full-table boolean row mask plus byte accounting.
    """
    rows = _scan_range(table, start, stop)
    cols: Dict[str, np.ndarray] = {}
    idx_bytes = 0
    for q in index_qualifiers:
        col = table.column(index_family, q)
        cols[q] = col[rows]
        idx_bytes += len(rows) * table.column_spec(index_family, q).row_nbytes
    sel = np.asarray(predicate(cols), dtype=bool)
    if sel.shape != rows.shape:
        raise ValueError("predicate must return one bool per scanned row")
    mask = np.zeros(table.num_rows, dtype=bool)
    mask[rows[sel]] = True
    scanned, pruned = _region_stats(table, start, stop)
    return mask, QueryStats(
        rows_scanned=len(rows),
        index_bytes_scanned=idx_bytes,
        payload_bytes_traversed=0,
        rows_selected=int(sel.sum()),
        regions_scanned=scanned,
        regions_pruned=pruned,
    )


def naive_query(
    table: TensorTable,
    predicate: Predicate,
    index_qualifiers: Sequence[str],
    family: str = DATA_FAMILY,
    start: Optional[bytes] = None,
    stop: Optional[bytes] = None,
) -> Tuple[np.ndarray, QueryStats]:
    """Naïve scheme: indexes share the payload family, so every scanned row
    traverses its image bytes (the paper's Fig. 1C failure mode)."""
    rows = _scan_range(table, start, stop)
    cols: Dict[str, np.ndarray] = {}
    idx_bytes = 0
    for q in index_qualifiers:
        col = table.column(family, q)
        cols[q] = col[rows]
        idx_bytes += len(rows) * table.column_spec(family, q).row_nbytes
    sel = np.asarray(predicate(cols), dtype=bool)
    mask = np.zeros(table.num_rows, dtype=bool)
    mask[rows[sel]] = True
    # logical payload bytes of every row in the scan range — the traversal cost
    payload = int(table.row_bytes()[rows].sum())
    scanned, pruned = _region_stats(table, start, stop)
    return mask, QueryStats(
        rows_scanned=len(rows),
        index_bytes_scanned=idx_bytes,
        payload_bytes_traversed=payload,
        rows_selected=int(sel.sum()),
        regions_scanned=scanned,
        regions_pruned=pruned,
    )


def mask_to_device_layout(
    mask: np.ndarray, row_ids: np.ndarray, valid: np.ndarray
) -> np.ndarray:
    """Re-layout a full-table row mask to the ``[D, C]`` device layout so the
    MapReduce engine can apply it shard-locally."""
    return np.asarray(mask)[row_ids] & valid


def age_sex_predicate(
    age_lo: Optional[float] = None,
    age_hi: Optional[float] = None,
    sex: Optional[int] = None,
) -> Predicate:
    """The paper's Table-3 subset selector (age window × sex)."""

    def pred(cols: Mapping[str, np.ndarray]) -> np.ndarray:
        m = np.ones(len(cols["age"]), dtype=bool)
        if age_lo is not None:
            m &= cols["age"] >= age_lo
        if age_hi is not None:
            m &= cols["age"] < age_hi
        if sex is not None:
            m &= cols["sex"] == sex
        return m

    return pred
