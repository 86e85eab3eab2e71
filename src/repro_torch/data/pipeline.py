"""Data pipeline: training batches and the imaging population, served
from the colocation grid.

Port of ``src/repro/data/pipeline.py``.  Token sequences are rows of a
``TensorTable`` (one row = one fixed-length sample), regions are the unit
of placement, and each owner draws its per-step share of a batch from the
rows its regions hold.  The generators draw exactly the reference's
numbers for one seed: the token corpus (``synthetic_token_table``) and the
paper's T1 population with the Table-3 age/sex strata.

A dataset has one shard per owner.  The owners are either a device list
(``repro_torch.utils.owner_devices``, as in ``core/placement.py``), and a
batch is then one tensor on the first owner's device; or a
``DeviceMesh``, the reference's ``Mesh``: one shard per rank along the
batch axes (``pod``, ``data``), and a batch is a DTensor split
``Shard(0)`` over them (:meth:`ColocatedTokenDataset.batch_sharding`),
each rank keeping its own shard.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.balancer import NodeSpec
from repro_torch.core.placement import Placement
from repro_torch.core.regions import HierarchicalSplitPolicy
from repro_torch.core.table import ColumnFamily, ColumnSpec, TensorTable
from repro_torch.utils import owner_devices


# ----------------------------------------------------------------------
# synthetic datasets
# ----------------------------------------------------------------------

def synthetic_token_table(
    n_rows: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    region_bytes: int = 1 << 22,
) -> TensorTable:
    """A token corpus as a TensorTable: ``tok:ids`` + ``idx:size``."""
    rng = np.random.default_rng(seed)
    table = TensorTable(
        "tokens",
        [
            ColumnFamily("tok", (ColumnSpec("ids", (seq_len,), np.int32),)),
            ColumnFamily("idx", (ColumnSpec("size", (), np.int64),)),
        ],
        split_policy=HierarchicalSplitPolicy(max_region_bytes=region_bytes),
    )
    # mixture of zipf-ish unigram draws — enough structure for loss to move
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    ids = rng.choice(vocab, size=(n_rows, seq_len), p=probs).astype(np.int32)
    sizes = np.full(n_rows, seq_len * 4, np.int64)
    table.upload(
        [f"doc{i:08d}" for i in range(n_rows)],
        {"tok": {"ids": ids}, "idx": {"size": sizes}},
    )
    return table


#: Table 3 of the paper: (age_lo, age_hi, female_count, male_count)
PAPER_STRATA = (
    (4.0, 20.0, 1157, 698),
    (20.0, 40.0, 651, 648),
    (40.0, 60.0, 230, 280),
    (60.0, 98.0, 332, 494),
)


def population_covariates(rng: np.random.Generator, scale: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``(ages float32, sexes int8)`` per Table 3, in upload order — the
    first draws :func:`synthetic_image_population` takes from ``rng``."""
    rows = []
    for lo, hi, f_cnt, m_cnt in PAPER_STRATA:
        for sex, cnt in ((1, f_cnt), (0, m_cnt)):
            n = max(int(round(cnt * scale)), 1)
            ages = rng.uniform(lo, hi, n).astype(np.float32)
            rows.extend((a, sex) for a in ages)
    n = len(rows)
    ages = np.array([r[0] for r in rows], np.float32)
    sexes = np.array([r[1] for r in rows], np.int8)
    order = rng.permutation(n)
    return ages[order], sexes[order]


def image_population_table(payload_shape: Tuple[int, ...]) -> TensorTable:
    """The empty population table: ``img:data`` volumes beside the
    ``idx`` family (logical size, age, sex), split by logical bytes."""
    return TensorTable(
        "t1_population",
        [
            ColumnFamily("img", (ColumnSpec("data", payload_shape, np.float32),)),
            ColumnFamily("idx", (
                ColumnSpec("size", (), np.int64),
                ColumnSpec("age", (), np.float32),
                ColumnSpec("sex", (), np.int8),
            )),
        ],
        split_policy=HierarchicalSplitPolicy(max_region_bytes=1 << 31),
    )


def synthetic_image_population(
    payload_shape: Tuple[int, ...] = (16, 16, 16),
    scale: float = 1.0,
    seed: int = 0,
) -> TensorTable:
    """The paper's study population per Table 3 strata (4,490 subjects;
    the paper's 5,153 figure counts *images* — some subjects have repeat
    scans), with logical sizes drawn from [SizeSmall, SizeBig] = [6, 20] MB.
    ``scale`` < 1 shrinks each stratum proportionally for CI-speed runs."""
    rng = np.random.default_rng(seed)
    ages, sexes = population_covariates(rng, scale)
    n = len(ages)
    table = image_population_table(payload_shape)
    data = rng.normal(0.0, 1.0, (n,) + payload_shape).astype(np.float32)
    # age covariate leaks into the volumes so subset averages differ measurably
    data += ages[:, None, None, None] / 100.0
    sizes = rng.integers(6_000_000, 20_000_001, n)
    table.upload(
        [f"sub{i:06d}" for i in range(n)],
        {"img": {"data": data},
         "idx": {"size": sizes, "age": ages, "sex": sexes}},
    )
    return table


# ----------------------------------------------------------------------
# colocated loader
# ----------------------------------------------------------------------

class ColocatedTokenDataset:
    """Serves ``[global_batch, seq]`` int32 batches, each owner's share
    drawn only from the rows of its own regions.

    ``devices`` is the owner list (None: one CUDA device), with ``D =
    len(devices)`` shards and the batch on the first owner's device; or a
    ``DeviceMesh``, with one shard per rank of its batch axes and the
    batch a DTensor.  A ``placement`` handed in (a ``GridSession``'s) must
    have D nodes."""

    def __init__(
        self,
        table: TensorTable,
        devices: Optional[Sequence[Any]],
        global_batch: int,
        strategy: str = "greedy",
        nodes: Optional[Sequence[NodeSpec]] = None,
        seed: int = 0,
        placement: Optional[Placement] = None,
    ):
        self.table = table
        self.mesh = devices if hasattr(devices, "mesh_dim_names") else None
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names
            self.batch_axes = tuple(a for a in ("pod", "data") if a in names)
            D = int(np.prod([self.mesh.size(names.index(a))
                             for a in self.batch_axes]))
            self.devices = [torch.device(self.mesh.device_type)]
        else:
            self.devices = owner_devices(devices)
            D = len(self.devices)
        self.global_batch = global_batch
        if global_batch % D != 0:
            raise ValueError(f"global_batch {global_batch} % {D} != 0")
        self.per_shard = global_batch // D
        self.D = D
        if placement is not None:
            # ride an existing region→device map (e.g. a GridSession's)
            if len(placement.nodes) != D:
                raise ValueError(
                    f"placement has {len(placement.nodes)} nodes, need {D}")
            self.placement = placement
        else:
            if nodes is None:
                nodes = [NodeSpec(i, cores=1, mips=1.0) for i in range(D)]
            self.placement = Placement.from_strategy(table, nodes, strategy)
        self._rng = np.random.default_rng(seed)
        self._pools_version = None
        self._compute_pools()
        self.seq_len = table.column_spec("tok", "ids").shape[0]

    def _compute_pools(self) -> None:
        """Per-shard row pools (positions into the table's row order).

        Cached by the (table mutations, placement version) pair: under a
        shared (GridSession) placement the table mutates between steps and
        positional indices shift; for an immutable table this is free.
        """
        version = (self.table.mutation_count, self.placement.version)
        if version == self._pools_version:
            return
        self._pools = [self.placement.rows_for_node(n.node_id)
                       for n in self.placement.nodes]
        for i, pool in enumerate(self._pools):
            if len(pool) == 0:
                raise ValueError(f"node {i} received no rows; "
                                 "table too small for this many owners")
        self._pools_version = version

    def next_batch(self, step: int) -> torch.Tensor:
        """Per-step batch: shard d draws from pool d.  The seed of each
        draw is the reference's ``hash(("batch", step, d))``, whose string
        hash Python salts per process (``PYTHONHASHSEED``): a step's batch
        repeats within a process, not across processes."""
        self._compute_pools()
        ids = np.empty((self.D, self.per_shard, self.seq_len), np.int32)
        col = self.table.column("tok", "ids")
        for d, pool in enumerate(self._pools):
            rng = np.random.default_rng(hash(("batch", step, d)) & 0x7FFFFFFF)
            take = rng.choice(pool, size=self.per_shard, replace=True)
            ids[d] = col[take]
        flat = torch.from_numpy(ids.reshape(self.global_batch, self.seq_len))
        if self.mesh is None:
            return flat.to(self.devices[0])
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(flat.to(self.devices[0]), self.mesh,
                                 self.batch_sharding(), src_data_rank=None)

    def batch_sharding(self):
        """The batch's DTensor placements: ``Shard(0)`` on the batch axes
        (pod-major), replicated on the others."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if a in self.batch_axes else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def __iter__(self) -> Iterator[torch.Tensor]:
        step = 0
        while True:
            yield self.next_batch(step)
            step += 1
