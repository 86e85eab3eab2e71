"""TensorTable — an HBase-analogue columnar tensor store.

Port of ``src/repro/core/table.py`` (host-only, copied).

Follows HBase's simplified hierarchy from the paper (§2.1):

    Table -> Column family -> Column qualifier -> data

Each row has a unique ``rowkey`` (bytes; the paper uses the image file's unique
name).  Rows are kept **rowkey-sorted**, regions partition the keyspace, and a
split policy keeps region sizes bounded — exactly the structure the balancer
and the MapReduce engine rely on for locality.

The paper's recommended *table scheme* (§2.3) maps to: bulky tensor payloads in
one column family (e.g. ``img:data``) and small per-row indexes (age, sex,
file-size, ...) in a **separate** family (e.g. ``idx:age``), so predicates are
evaluated without touching the payloads (see :mod:`repro_torch.core.query`).

Storage is host-side numpy (the mutable source of truth); device placement and
sharded layouts are produced by :mod:`repro_torch.core.placement`.  Byte accounting
distinguishes *physical* bytes (what the arrays occupy here) from *logical*
bytes (the medical-image sizes the paper's time models consume), carried by the
``idx:size`` column when present — this is what lets the reproduction run the
paper's 77.4 GB workload on a laptop-scale container while keeping every time
model faithful.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.regions import (
    ConstantSizeSplitPolicy,
    Region,
    RegionSet,
    SplitPolicy,
)

RowKey = Union[bytes, str]

# The conventional families of the paper's proposed scheme.
DATA_FAMILY = "img"
INDEX_FAMILY = "idx"
SIZE_QUALIFIER = "size"


def _as_key(k: RowKey) -> bytes:
    return k.encode() if isinstance(k, str) else bytes(k)


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Schema of one column qualifier: fixed per-row shape and dtype."""

    qualifier: str
    shape: Tuple[int, ...] = ()
    dtype: np.dtype = dataclasses.field(default_factory=lambda: np.dtype(np.float32))

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))

    @property
    def row_nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class ColumnFamily:
    name: str
    columns: Tuple[ColumnSpec, ...]

    def spec(self, qualifier: str) -> ColumnSpec:
        for c in self.columns:
            if c.qualifier == qualifier:
                return c
        raise KeyError(f"unknown qualifier {self.name}:{qualifier}")


class TensorTable:
    """Rowkey-sorted columnar store with column families and regions."""

    def __init__(
        self,
        name: str,
        families: Sequence[ColumnFamily],
        split_policy: Optional[SplitPolicy] = None,
        presplit_keys: Optional[Sequence[RowKey]] = None,
    ):
        self.name = name
        self.families: Dict[str, ColumnFamily] = {f.name: f for f in families}
        if len(self.families) != len(families):
            raise ValueError("duplicate column family names")
        self.split_policy = split_policy or ConstantSizeSplitPolicy(1 << 62)
        self.regions = RegionSet(self.split_policy)
        if presplit_keys:
            self.regions.pre_split([_as_key(k) for k in presplit_keys])

        self._keys = np.empty((0,), dtype="S64")
        self._data: Dict[Tuple[str, str], np.ndarray] = {}
        for fam in families:
            for col in fam.columns:
                self._data[(fam.name, col.qualifier)] = np.empty(
                    (0,) + col.shape, dtype=col.dtype
                )
        # split events observed (parent, left, right) — consumed by Placement.
        self.split_log: List[Tuple[Region, Region, Region]] = []
        # bumped on every row-changing upload/delete; cheap cache-invalidation
        # signal for consumers holding positional indices (data pipeline).
        self.mutation_count = 0

    # ------------------------------------------------------------------
    # schema / introspection
    # ------------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return len(self._keys)

    @property
    def keys(self) -> np.ndarray:
        """Sorted rowkeys (read-only view)."""
        v = self._keys.view()
        v.flags.writeable = False
        return v

    def has_column(self, family: str, qualifier: str) -> bool:
        return (family, qualifier) in self._data

    def column(self, family: str, qualifier: str) -> np.ndarray:
        """Full column in row order (read-only view)."""
        v = self._data[(family, qualifier)].view()
        v.flags.writeable = False
        return v

    def column_spec(self, family: str, qualifier: str) -> ColumnSpec:
        return self.families[family].spec(qualifier)

    def physical_row_nbytes(self, families: Optional[Iterable[str]] = None) -> int:
        fams = self.families.keys() if families is None else families
        return sum(
            c.row_nbytes for f in fams for c in self.families[f].columns
        )

    def row_bytes(self) -> np.ndarray:
        """Per-row *logical* byte sizes.

        Uses the ``idx:size`` column when present (the paper's size index,
        which also feeds the hierarchical split policy); falls back to the
        physical row footprint otherwise.
        """
        if self.has_column(INDEX_FAMILY, SIZE_QUALIFIER):
            return self._data[(INDEX_FAMILY, SIZE_QUALIFIER)].astype(np.int64)
        # naive scheme: the size qualifier lives inside the payload family
        for fam in self.families:
            if self.has_column(fam, SIZE_QUALIFIER):
                return self._data[(fam, SIZE_QUALIFIER)].astype(np.int64)
        return np.full((self.num_rows,), self.physical_row_nbytes(), dtype=np.int64)

    def total_bytes(self) -> int:
        return int(self.row_bytes().sum()) if self.num_rows else 0

    # ------------------------------------------------------------------
    # selectors
    # ------------------------------------------------------------------

    def row_range(self, start: Optional[RowKey] = None,
                  stop: Optional[RowKey] = None) -> Tuple[int, int]:
        """Positional bounds ``(lo, hi)`` of the rowkey range ``[start, stop)``.

        The scan primitive every range consumer (selectors, queries, the
        GridQuery planner) shares: two binary searches over the sorted keys,
        never a linear walk.  ``hi`` is clamped so ``hi >= lo`` always.
        """
        lo = 0
        if start is not None:
            lo = int(np.searchsorted(self._keys, _as_key(start), side="left"))
        hi = len(self._keys)
        if stop is not None:
            hi = int(np.searchsorted(self._keys, _as_key(stop), side="left"))
        return lo, max(lo, hi)

    def existing_mask(self, rowkeys: Sequence[RowKey]) -> np.ndarray:
        """Bool per input key: is it already stored?  (The duplicate rule
        ``upload`` applies — shared so callers never re-derive it.)"""
        keys = np.array([_as_key(k) for k in rowkeys], dtype="S64")
        exists = np.zeros(len(keys), dtype=bool)
        pos = np.searchsorted(self._keys, keys, side="left")
        in_range = pos < len(self._keys)
        if in_range.any():
            exists[in_range] = self._keys[pos[in_range]] == keys[in_range]
        return exists

    def _select_positions(
        self,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> np.ndarray:
        """Resolve the Table-1 selector set to positional row indices.

        ``rowkey`` selects one row; otherwise ``[start, stop)`` selects a
        range (whole table when both empty); ``skip`` removes listed keys —
        mirroring the Retrieve interface's skip-file.
        """
        if rowkey is not None:
            k = _as_key(rowkey)
            pos = int(np.searchsorted(self._keys, k, side="left"))
            if pos >= len(self._keys) or self._keys[pos] != k:
                return np.empty((0,), dtype=np.int64)
            idx = np.array([pos], dtype=np.int64)
        else:
            lo, hi = self.row_range(start, stop)
            idx = np.arange(lo, hi, dtype=np.int64)
        if skip:
            skip_keys = np.array(sorted({_as_key(k) for k in skip}), dtype=self._keys.dtype)
            mask = ~np.isin(self._keys[idx], skip_keys)
            idx = idx[mask]
        return idx

    # ------------------------------------------------------------------
    # Upload / Retrieve / Delete (Table 1 interface)
    # ------------------------------------------------------------------

    def upload(
        self,
        rowkeys: Sequence[RowKey],
        data: Mapping[str, Mapping[str, np.ndarray]],
        overwrite: bool = False,
        on_duplicate: Optional[str] = None,
    ) -> int:
        """Insert (or update) a batch of rows.

        ``data[family][qualifier]`` is an array of shape ``(len(rowkeys),
        *spec.shape)``.  Every declared column must be provided — the store is
        columnar and dense.  Returns the number of rows written.

        Duplicate handling is uniform per row and independent of batch order
        or rowkey sort order.  A rowkey that appears twice *within* one batch
        always raises.  A rowkey already present in the table (uploaded by an
        earlier call) is governed by ``on_duplicate``:

        - ``"skip"`` (default): keep the stored row, don't write it — the
          interface's "avoid uploading duplicate data"; skipped rows do not
          count toward the return value;
        - ``"overwrite"``: replace the stored row with this batch's values;
        - ``"error"``: raise ``KeyError`` naming the duplicates, writing
          nothing.

        ``overwrite=True`` is the legacy spelling of
        ``on_duplicate="overwrite"``.
        """
        if on_duplicate is None:
            on_duplicate = "overwrite" if overwrite else "skip"
        if on_duplicate not in ("skip", "overwrite", "error"):
            raise ValueError(f"unknown on_duplicate mode {on_duplicate!r}")
        if not len(rowkeys):
            return 0
        new_keys = np.array([_as_key(k) for k in rowkeys], dtype="S64")
        if len(np.unique(new_keys)) != len(new_keys):
            raise ValueError("duplicate rowkeys within one upload batch")

        # validate payloads against the schema
        arrays: Dict[Tuple[str, str], np.ndarray] = {}
        for fam in self.families.values():
            fam_data = data.get(fam.name)
            if fam_data is None:
                raise ValueError(f"missing column family {fam.name!r} in upload")
            for col in fam.columns:
                if col.qualifier not in fam_data:
                    raise ValueError(f"missing column {fam.name}:{col.qualifier}")
                arr = np.asarray(fam_data[col.qualifier], dtype=col.dtype)
                want = (len(new_keys),) + col.shape
                if arr.shape != want:
                    raise ValueError(
                        f"{fam.name}:{col.qualifier} shape {arr.shape} != {want}"
                    )
                arrays[(fam.name, col.qualifier)] = arr

        # split batch into updates (existing keys) and inserts
        pos = np.searchsorted(self._keys, new_keys, side="left")
        exists = self.existing_mask(rowkeys)

        written = 0
        if exists.any():
            if on_duplicate == "error":
                dups = [k.decode(errors="replace") for k in new_keys[exists]]
                raise KeyError(f"rowkeys already uploaded: {dups}")
            if on_duplicate == "overwrite":
                upd = np.nonzero(exists)[0]
                tgt = pos[upd]
                for kq, arr in arrays.items():
                    self._data[kq][tgt] = arr[upd]
                written += len(upd)
            # else "skip": keep the stored rows (interface semantics)

        ins = np.nonzero(~exists)[0]
        if len(ins):
            ins_keys = new_keys[ins]
            order = np.argsort(ins_keys, kind="stable")
            ins_keys = ins_keys[order]
            ins_pos = np.searchsorted(self._keys, ins_keys, side="left")
            self._keys = np.insert(self._keys, ins_pos, ins_keys)
            for kq, arr in arrays.items():
                self._data[kq] = np.insert(
                    self._data[kq], ins_pos, arr[ins][order], axis=0
                )
            written += len(ins)

        events = self.regions.maybe_split(self._keys, self.row_bytes())
        self.split_log.extend(events)
        if written:
            self.mutation_count += 1
        return written

    def select_keys(
        self,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> np.ndarray:
        """Rowkeys matching the Table-1 selector (copy, sorted order)."""
        return self._keys[self._select_positions(rowkey, start, stop, skip)].copy()

    def retrieve(
        self,
        family: str,
        qualifier: str,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(rowkeys, values)`` for the selector (§Table 1 Retrieve)."""
        idx = self._select_positions(rowkey, start, stop, skip)
        col = self._data[(family, qualifier)]
        return self._keys[idx].copy(), col[idx].copy()

    def delete(
        self,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> int:
        """Delete whole rows matching the selector; returns rows removed.

        (HBase deletes cells; ColoGrid's columns are dense fixed-shape
        tensors, so row granularity is the faithful unit here.)
        """
        idx = self._select_positions(rowkey, start, stop, skip)
        if not len(idx):
            return 0
        keep = np.ones(self.num_rows, dtype=bool)
        keep[idx] = False
        self._keys = self._keys[keep]
        for kq in self._data:
            self._data[kq] = self._data[kq][keep]
        self.mutation_count += 1
        return int((~keep).sum())

    # ------------------------------------------------------------------
    # region helpers
    # ------------------------------------------------------------------

    def region_rows(self, region: Region) -> slice:
        return region.row_slice(self._keys)

    def region_positions(self, region: Region) -> np.ndarray:
        """Current positional row indices of a region (ascending)."""
        s = region.row_slice(self._keys)
        return np.arange(s.start, s.stop, dtype=np.int64)

    def region_column(self, region: Region, family: str,
                      qualifier: str) -> np.ndarray:
        """A private copy of one region's rows of one column — the BlockStore
        gather primitive.  A copy (not a view) because block content must
        survive later mutations that shift the backing arrays; any mutation
        to *this* region's rows invalidates the block by version instead."""
        s = region.row_slice(self._keys)
        return self._data[(family, qualifier)][s.start:s.stop].copy()

    def region_bytes(self) -> Dict[int, int]:
        rb = self.row_bytes()
        return {r.rid: r.num_bytes(self._keys, rb) for r in self.regions}

    def region_row_counts(self) -> Dict[int, int]:
        return {r.rid: r.num_rows(self._keys) for r in self.regions}

    def check_invariants(self) -> None:
        assert np.all(self._keys[:-1] < self._keys[1:]), "rowkeys must be strictly sorted"
        for kq, arr in self._data.items():
            assert arr.shape[0] == self.num_rows, f"column {kq} row count mismatch"
        self.regions.check_invariants()
        # regions must tile all rows exactly
        total = sum(r.num_rows(self._keys) for r in self.regions)
        assert total == self.num_rows


def make_mip_table(
    name: str = "mip",
    payload_shape: Tuple[int, ...] = (32, 32, 32),
    payload_dtype: np.dtype = np.float32,
    extra_index_columns: Sequence[ColumnSpec] = (),
    split_policy: Optional[SplitPolicy] = None,
    presplit_keys: Optional[Sequence[RowKey]] = None,
) -> TensorTable:
    """The paper's proposed scheme: ``img:data`` + separate ``idx`` family.

    ``idx`` always carries the ``size`` column (bytes; drives the hierarchical
    split policy) plus any study covariates (age, sex, ...).
    """
    idx_cols = [ColumnSpec(SIZE_QUALIFIER, (), np.int64)] + list(extra_index_columns)
    fams = [
        ColumnFamily(DATA_FAMILY, (ColumnSpec("data", payload_shape, payload_dtype),)),
        ColumnFamily(INDEX_FAMILY, tuple(idx_cols)),
    ]
    return TensorTable(name, fams, split_policy=split_policy, presplit_keys=presplit_keys)


def make_naive_table(
    name: str = "mip_naive",
    payload_shape: Tuple[int, ...] = (32, 32, 32),
    payload_dtype: np.dtype = np.float32,
    extra_index_columns: Sequence[ColumnSpec] = (),
    split_policy: Optional[SplitPolicy] = None,
) -> TensorTable:
    """The naïve scheme of §2.4.4: everything in ONE column family.

    Index qualifiers live next to the payload, so any index scan drags the
    image bytes through the read path (see :func:`repro_torch.core.query.naive_query`).
    """
    cols = [
        ColumnSpec("data", payload_shape, payload_dtype),
        ColumnSpec(SIZE_QUALIFIER, (), np.int64),
    ] + list(extra_index_columns)
    fams = [ColumnFamily(DATA_FAMILY, tuple(cols))]
    return TensorTable(name, fams, split_policy=split_policy)
