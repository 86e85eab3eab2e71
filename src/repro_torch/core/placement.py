"""Placement — region→device maps realized as per-owner layouts.

Port of ``src/repro/core/placement.py``.  The reference's ``Mesh`` and
``NamedSharding`` become the owner-device list: a ``[devices, capacity,
...]`` layout is handed over as one shard per owner, each a tensor on its
owner's device.

The balancer decides *which node owns which region*; this module turns that
decision into per-owner layouts.  As in the paper, which moves uniform
*regions* rather than bytes, heterogeneity is expressed as **different
numbers of row slots per device filled**: the table's rows are gathered into
a ``[devices, capacity, ...]`` layout (rowkey order preserved within a
device), padded with a validity mask.  Map tasks then iterate device-local
chunks; the mask keeps every owner's fold the same shape while owners carry
different amounts of real work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import (
    Allocation,
    NodeSpec,
    assign_new_regions,
    balanced_allocation,
    central_allocation,
    greedy_allocation,
    node_loads,
)
from repro_torch.core.table import TensorTable


@dataclasses.dataclass
class Placement:
    """A realized region→node assignment over a table."""

    table: TensorTable
    nodes: Tuple[NodeSpec, ...]
    alloc: Allocation  # region id -> node id
    # bumped whenever ``alloc`` changes (splits adopted, rebalance applied);
    # consumers caching derived row pools key on it.
    version: int = 0

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_strategy(
        cls,
        table: TensorTable,
        nodes: Sequence[NodeSpec],
        strategy: str = "greedy",
    ) -> "Placement":
        region_bytes = table.region_bytes()
        if strategy == "greedy":
            alloc = greedy_allocation(region_bytes, nodes)
        elif strategy == "balanced":
            alloc = balanced_allocation(region_bytes, nodes)
        elif strategy == "central":
            alloc = central_allocation(region_bytes, nodes)
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        return cls(table, tuple(nodes), alloc)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    def apply_splits(self) -> None:
        """Children of a split region inherit the parent's node (HBase
        keeps daughters on the same region server until a balancer run).

        ``version`` bumps only when the region→node map actually changed:
        consumers key caches on it (row pools, bound plan signatures), so a
        split-free upload must not read as a placement change."""
        changed = False
        for parent, left, right in self.table.split_log:
            if parent.rid in self.alloc:
                nid = self.alloc.pop(parent.rid)
                self.alloc[left.rid] = nid
                self.alloc[right.rid] = nid
                changed = True
        self.table.split_log.clear()
        # adopt any regions still missing (e.g. created before this placement)
        # at the neediest node vs its #CPU×MIPS share — not blindly node 0
        adopted = assign_new_regions(
            self.alloc, self.table.region_bytes(), self.nodes)
        if adopted:
            self.alloc.update(adopted)
            changed = True
        if changed:
            self.version += 1

    def node_bytes(self) -> Dict[int, float]:
        return node_loads(self.alloc, self.table.region_bytes(), self.nodes)

    def rows_for_node(self, node_id: int) -> np.ndarray:
        """Positional row indices owned by ``node_id``, in rowkey order."""
        keys = self.table.keys
        pieces: List[np.ndarray] = []
        for region in self.table.regions:
            if self.alloc.get(region.rid) == node_id:
                s = region.row_slice(keys)
                pieces.append(np.arange(s.start, s.stop, dtype=np.int64))
        if not pieces:
            return np.empty((0,), dtype=np.int64)
        return np.sort(np.concatenate(pieces))

    def node_row_counts(self) -> Dict[int, int]:
        counts = {n.node_id: 0 for n in self.nodes}
        rc = self.table.region_row_counts()
        for rid, nid in self.alloc.items():
            counts[nid] += rc.get(rid, 0)
        return counts

    # ------------------------------------------------------------------
    # device layouts
    # ------------------------------------------------------------------

    def device_layout(
        self, capacity: Optional[int] = None, chunk_size: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(row_ids[D, C], valid[D, C])`` with ``C`` a chunk_size multiple.

        ``row_ids`` holds positional indices into the table's row order
        (0 where padded); ``valid`` marks real slots.  ``capacity`` defaults
        to the maximum per-node row count, rounded up to ``chunk_size``.
        """
        per_node = [self.rows_for_node(n.node_id) for n in self.nodes]
        need = max((len(p) for p in per_node), default=0)
        cap = capacity if capacity is not None else need
        if cap < need:
            raise ValueError(f"capacity {cap} < max per-node rows {need}")
        cap = max(chunk_size, -(-cap // chunk_size) * chunk_size)
        D = len(self.nodes)
        row_ids = np.zeros((D, cap), dtype=np.int64)
        valid = np.zeros((D, cap), dtype=bool)
        for d, rows in enumerate(per_node):
            row_ids[d, : len(rows)] = rows
            valid[d, : len(rows)] = True
        return row_ids, valid

    def gather_column(
        self,
        family: str,
        qualifier: str,
        capacity: Optional[int] = None,
        chunk_size: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a column in device layout: ``values[D, C, ...], valid``."""
        row_ids, valid = self.device_layout(capacity, chunk_size)
        col = self.table.column(family, qualifier)
        values = col[row_ids]          # padded slots read row 0; masked off
        values = np.where(
            valid.reshape(valid.shape + (1,) * (values.ndim - 2)), values, 0
        )
        return values, valid

    def put_column(
        self,
        devices: Sequence[torch.device],
        family: str,
        qualifier: str,
        capacity: Optional[int] = None,
        chunk_size: int = 1,
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Copy a column to the owners with colocation: shard d ↔ node d's
        rows, as ``(values, valid)`` lists of per-owner tensors."""
        values, valid = self.gather_column(family, qualifier, capacity, chunk_size)
        if len(self.nodes) != len(devices):
            raise ValueError(
                f"placement has {len(self.nodes)} nodes but "
                f"{len(devices)} owner devices were given"
            )
        return ([torch.from_numpy(values[d]).to(dev)
                 for d, dev in enumerate(devices)],
                [torch.from_numpy(valid[d]).to(dev)
                 for d, dev in enumerate(devices)])

    # ------------------------------------------------------------------
    # schedule / diagnostics
    # ------------------------------------------------------------------

    def rounds(self, chunk_size: int) -> int:
        """SPMD map rounds = chunks on the busiest device (the wall clock)."""
        counts = self.node_row_counts().values()
        return max((-(-c // chunk_size) for c in counts), default=0)

    def total_chunks(self, chunk_size: int) -> int:
        """Σ real chunks (the resource clock; ≙ the paper's #job)."""
        return sum(-(-c // chunk_size) for c in self.node_row_counts().values() if c)

    def describe(self) -> str:
        nb = self.node_bytes()
        rc = self.node_row_counts()
        lines = [f"Placement over {len(self.nodes)} nodes, "
                 f"{len(self.table.regions)} regions, {self.table.num_rows} rows"]
        for n in self.nodes:
            lines.append(
                f"  node {n.node_id:4d} power={n.power:8.1f} "
                f"rows={rc[n.node_id]:6d} bytes={nb[n.node_id]:.3e}"
            )
        return "\n".join(lines)
