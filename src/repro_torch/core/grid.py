"""GridSession — the paper's backend API behind one session object.

Port of ``src/repro/core/grid.py``.  The reference's 1-D data ``Mesh``
becomes the owner-device list ``devices`` (default: one CUDA device; it may
repeat one physical device, so ``["cuda:0"] * 4`` gives four logical
owners).  Blocks commit to their owner with a copy from pinned host memory
(:meth:`GridSession._put_block`), and CSE-eligible folds run on the CUDA
fused fold kernel (``fold_impl="kernel"``).  ``token_dataset`` hands the
LM trainer a ``ColocatedTokenDataset`` over the same owners and placement.

The paper's contribution is an *interface* (Table 1): Upload, Retrieve,
Remove, a heterogeneity-aware Load balancer, and MapReduce templates over
colocated storage.  The repo implements each piece as a standalone module
(:mod:`table`, :mod:`regions`, :mod:`balancer`, :mod:`placement`,
:mod:`mapreduce`, :mod:`query`); ``GridSession`` owns the whole
table → regions → blockstore → balancer → placement → mapreduce → query
lifecycle and exposes the five verbs:

- :meth:`upload`    — batch insert with split handling and incremental
  placement (split children inherit their parent's node, HBase-style);
- :meth:`retrieve`  — the Table-1 selector read path;
- :meth:`remove`    — row deletion with dirty-region invalidation;
- :meth:`rebalance` — the paper's offline #CPU×MIPS balancer, applied to the
  *current* allocation (minimum region moves); ``auto=True`` derives node
  powers from :meth:`observe_round` history through the wired
  :class:`GridScheduler` / ``powers_from_observations`` loop;
- :meth:`scan`      — the query surface: a lazy :class:`GridQuery` plan
  (``scan(...).select(...).where(...).map(...).reduce()``) that prunes
  regions, pushes the projection down, and fuses all mapped statistics into
  one engine pass when ``.collect()``/``.stats()`` executes it;
- :meth:`run` / :meth:`run_where` — thin wrappers over :meth:`scan` for the
  full table and the predicate-pushdown subset.

Beneath every executed plan sits the :class:`~repro_torch.core.blockstore
.BlockStore`: a content-addressed, copy-on-write cache of per-region device
blocks keyed by ``(region signature, column, epoch-lineage)`` — and, stacked
on it, the **block-granular fold engine**.  Compute plans never assemble a
monolithic ``[D, C, ...]`` layout: each surviving block folds independently
on its owner device (:meth:`MapReduceEngine.fold_block`), the tiny partials
merge+finalize in one jitted reduce, and three content-addressed cache
levels make repeated compute collapse:

1. **Partial cache** (in the BlockStore).  Each block's fold result is
   cached under ``(block lineage, program, row-mask signature, η)``.  A
   mutation bumps only the touched regions' versions, so a repeat query
   re-folds exactly the dirty blocks and *merges* everything else; a repeat
   query at an unchanged table folds **zero payload rows**.  Mask
   signatures are content hashes — a range scan that exactly covers a
   region shares partials with the full-table plan, and two predicates
   selecting the same rows share partials too.
2. **Result cache.**  The finalized answer is memoized under the plan's
   full partial-key set: an identical re-execution returns without touching
   blocks, partials, or the engine.  Entries die eagerly when a member
   region's content changes and survive rebalances (the answer doesn't
   depend on which device folded it).
3. **Block cache.**  Blocks are fetched store-first only when a fold needs
   payload, so overlapping plans, later epochs, and retrieves ship each
   region's content once per (content, owner device).  The ``QueryStats``
   oracles (``blocks_*``, ``partials_*``, ``rows_folded``, ``gather_path``)
   make every level observable.

Pushdowns still run before any bytes move: region pruning (two bisects over
region start keys), index-family-only predicates (§2.3) folded through
per-block row masks, and projection.  Cold low-selectivity one-shot scans
take an **adaptive compact gather** (ship only the selected rows, cache
nothing) instead of whole-region blocks — the block path's shareability tax
is only paid where reuse can come (``compact_gather_threshold``).

Plans stratify and widen without extra passes: ``.select([c1, c2])`` folds
every mapped program over each selected column (per-column result-cache
entries, one scan resolution), and ``.group_by(key)`` lifts the fusion to
group-keyed partials (:class:`~repro_torch.core.stats.GroupedProgram`) — each
block segment-sums all G strata in its one fold, so groups never multiply
gathers, folds, or compiles.

Each block commits to its owner device and folds there — payload never
crosses between owners; only partials travel for the merge, which
tree-reduces across the owners (owner-local pre-merge, then one per-leaf
sum on the merge device) for additive programs and funnels to one device
otherwise (``QueryStats.merge_path``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import tempfile
from typing import (
    Any, Callable, Dict, FrozenSet, List, Mapping, Optional, Sequence, Set,
    Tuple,
)

import numpy as np
import torch

from repro_torch.core.balancer import (
    NodeSpec,
    allocation_imbalance,
    powers_from_observations,
    rebalance as rebalance_allocation,
)
from repro_torch.core.blockstore import (
    AtomicStats, BlockStore, DeviceBlock, LRUCache,
)
from repro_torch.core.chunk_model import TierCostModel
from repro_torch.core.faults import (
    DeviceLostError,
    FaultInjector,
    RetryPolicy,
    TransientFaultError,
)
from repro_torch.core.mapreduce import MapReduceEngine, MapReduceProgram, MapReduceStats
from repro_torch.core.placement import Placement
from repro_torch.core.plan import GridQuery, prefix_range
from repro_torch.core.query import Predicate, QueryStats, indexed_query
from repro_torch.core.regions import Region
from repro_torch.core.scheduler import GridScheduler
from repro_torch.core.stats import FusedProgram, GroupedProgram, GroupedResult
from repro_torch.core.table import (
    DATA_FAMILY,
    INDEX_FAMILY,
    RowKey,
    TensorTable,
    _as_key,
)
from repro_torch.utils import owner_devices

#: auto-named session spill dirs: grid-spill-<pid>-<hex session id>
_SPILL_DIR_RE = re.compile(r"^grid-spill-(\d+)-[0-9a-f]+$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:       # e.g. EPERM: the pid exists, owned by another user
        return True
    return True


def sweep_stale_spill_dirs(root: Optional[str] = None) -> int:
    """Best-effort removal of spill dirs leaked by *dead* sessions.

    The ``atexit``/``close`` teardown covers normal exits, but a SIGKILL
    (OOM killer, job scheduler preemption — routine on the paper's shared
    grid) leaves ``grid-spill-<pid>-*`` dirs behind.  Every session
    startup sweeps its temp root for dirs whose embedded pid no longer
    runs; live sessions (including our own process) are never touched.
    Returns the number of directories removed.
    """
    root = root if root is not None else tempfile.gettempdir()
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    swept = 0
    for name in names:
        m = _SPILL_DIR_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            swept += 1
    return swept


def _to_owner(host: np.ndarray, bucket: int,
              dev: torch.device) -> torch.Tensor:
    """One block committed to ``dev``, zero-padded to ``bucket`` rows.

    For a CUDA owner the rows are staged once in pinned host memory and
    copied asynchronously on the current stream (the staging buffer goes
    back to PyTorch's pinned-memory cache only once the copy is done); a
    CPU owner gets a private copy."""
    rows = len(host)
    dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
    shape = (bucket,) + tuple(host.shape[1:])
    staged = torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")
    staged_np = staged.numpy()
    staged_np[:rows] = host
    staged_np[rows:] = 0
    if dev.type == "cpu":
        return staged
    return staged.to(dev, non_blocking=True)


@dataclasses.dataclass
class SessionMetrics(AtomicStats):
    """Observable counters for the session's incremental machinery.

    Updated through :meth:`~repro_torch.core.blockstore.AtomicStats.inc` —
    concurrent frontend queries bump these from many threads, and a bare
    ``+=`` on a shared field loses updates.  Consistent multi-counter
    reads go through ``snapshot()``."""

    uploads: int = 0
    removes: int = 0
    rebalances: int = 0
    epochs: int = 0                 # mutation epochs advanced
    regions_dirtied: int = 0
    plan_hits: int = 0              # executions served whole from the result cache
    plan_misses: int = 0
    partials_folded: int = 0        # per-block folds executed (map tasks run)
    partials_reused: int = 0        # per-block partials served from the cache
    rows_folded: int = 0            # payload rows read by per-block folds
    rows_gathered: int = 0          # payload rows copied into device blocks
    pushdown_rows_gathered: int = 0  # payload rows gathered by pruned scans
    compact_scans: int = 0          # plans routed to the compacted one-shot gather
    scans: int = 0                  # GridQuery plans executed
    payload_gathers: int = 0        # payload gather passes (block or compact)
    programs_fused: int = 0         # programs that shared a fused engine pass
    # (session-lifetime block reuse counters live on BlockStore.stats —
    # hits/gathers/transfers/evictions/partial_hits/folds — not duplicated
    # here)


@dataclasses.dataclass(frozen=True)
class RunReport:
    """Accounting for one executed plan (``run``/``run_where``/``collect``)."""

    epoch: int
    eta: int
    plan_cache_hit: bool
    mapreduce: Optional[MapReduceStats]   # None for pure retrieve plans
    query: Optional[QueryStats] = None


class _SessionScheduler(GridScheduler):
    """The session-owned scheduler is observation/planning only.

    Node membership is pinned by the mesh (one device per node), and region
    moves must flow through :meth:`GridSession.rebalance` so mutation epochs
    invalidate cached layouts/plans — the fail/join verbs would mutate the
    shared placement behind the session's back, leaving stale device maps.
    """

    def handle_failure(self, dead_node_ids):
        raise NotImplementedError(
            "the session-owned scheduler cannot change node membership: the "
            "mesh pins one device per node; use GridSession.rebalance "
            "(optionally with refreshed NodeSpecs) for region moves")

    def handle_join(self, new_nodes):
        raise NotImplementedError(
            "the session-owned scheduler cannot change node membership: the "
            "mesh pins one device per node; use GridSession.rebalance "
            "(optionally with refreshed NodeSpecs) for region moves")


@dataclasses.dataclass
class _BlockAccount:
    """Per-execution block accounting, folded into ``QueryStats`` oracles."""

    total: int = 0
    reused: int = 0
    transferred: int = 0
    gathered: int = 0
    rows_gathered: int = 0
    bytes_transferred: int = 0

    def add(self, blk: DeviceBlock, reused: bool, gathered: bool) -> None:
        self.total += 1
        if reused:
            self.reused += 1
        else:
            self.transferred += 1
            # physical: the committed device copy may be fold-bucket padded
            self.bytes_transferred += blk.device_nbytes or blk.nbytes
        if gathered:
            self.gathered += 1
            self.rows_gathered += blk.rows

    @classmethod
    def all_reused(cls, n: int) -> "_BlockAccount":
        return cls(total=n, reused=n)

    def apply(self, qstats: QueryStats) -> QueryStats:
        return dataclasses.replace(
            qstats, blocks_total=self.total, blocks_reused=self.reused,
            blocks_transferred=self.transferred, gather_count=self.gathered,
            payload_bytes_transferred=self.bytes_transferred)


@dataclasses.dataclass
class _ResultEntry:
    """One cached query answer, content-addressed by its partial keys.

    The result cache closes the loop over the partial cache: a repeat
    execution whose every block lineage + row-mask signature is unchanged
    returns the finalized result without touching blocks, partials, or the
    engine.  Entries die eagerly when a mutation touches a member region
    (``_advance_epoch``) — a content change makes the key unmatchable
    forever — but survive rebalances: the answer does not depend on which
    device folded it.
    """

    result: Any
    partials_total: int        # foldable blocks the plan spanned
    blocks_total: int          # all blocks (incl. empty-selection regions)
    region_ids: FrozenSet[int] = frozenset()
    gather_path: str = "blocks"  # which path the miss execution took
    last_used: int = 0         # epoch of the last execution through this entry


@dataclasses.dataclass
class _RegionWork:
    """One surviving region's slice of a plan: owner device, positional
    row range (regions are contiguous in the sorted table), and the
    row-mask signature that content-addresses its partial."""

    region: Region
    owner: Optional[int]
    rows: slice
    mask_sig: str              # "full" | "empty" | digest of the bool mask
    selected: int              # mask-true rows (0 = nothing to fold)

    @property
    def n_rows(self) -> int:
        return self.rows.stop - self.rows.start


@dataclasses.dataclass
class _GroupInfo:
    """A plan's resolved stratification: the group-key column(s), the dense
    value→gid mapping over the *selected* rows, and the signature that
    content-addresses group-keyed partials (a gid assignment is only
    meaningful under the exact global mapping it was derived from).

    Composite keys (``group_by(["idx:site", "idx:scanner"])``) densify to
    ONE gid space: each column factorizes independently, the per-row codes
    combine lexicographically in listed-column order, and the observed
    combinations become gids 0..G-1 — so a stratified fold still segment-
    sums a single ``[G, ...]`` partial per block.  ``keys`` labels groups
    with scalar values for a single key column and with tuples (listed
    order) for composites.  The signature hashes the ordered column names
    with the mapping, so ``["site", "scanner"]`` and ``["scanner",
    "site"]`` address different partials.

    Only the distinct values (``keys`` — needed every execution for the
    result-cache key and the returned group labels) are materialized, and
    even they are memoized per plan lineage; per-row gids are derived
    lazily per region slice (:meth:`gids_for`), so result-cache hits and
    reused partials never pay a full-column densification."""

    columns: Tuple[Tuple[str, str], ...]  # (family, qualifier) per key col
    keys: np.ndarray           # [G] group labels: scalars or tuples
    per_col_keys: Tuple[np.ndarray, ...]  # per-column distinct values, asc
    combo_codes: np.ndarray    # [G] observed combined codes, ascending
    sig: str                   # digest of (ordered columns, mapping)
    row_nbytes: int            # per-row key bytes, all columns (accounting)

    @property
    def family(self) -> str:
        """Joined family label for gid-block cache addressing (the sig
        already pins the exact column set and order)."""
        return "|".join(f for f, _ in self.columns)

    @property
    def qualifier(self) -> str:
        return "|".join(q for _, q in self.columns)

    @property
    def num_groups(self) -> int:
        return len(self.combo_codes)

    def gids_for(self, values) -> np.ndarray:
        """Dense int32 group ids for one region's key-column rows —
        computed only when a block actually folds (partial-cache miss).
        ``values`` is one array (single key) or a tuple of per-column
        arrays (composite key, listed order), read from the table at call
        time (positions may shift under unrelated mutations; the mapping
        itself is pinned by the lineage-keyed memo).  Values outside the
        selected universe land on a clipped (valid but masked-off) gid."""
        cols = values if isinstance(values, (tuple, list)) else (values,)
        if len(cols) != len(self.columns):
            raise ValueError(
                f"expected {len(self.columns)} key column(s), got {len(cols)}")
        if not len(self.combo_codes):
            return np.zeros(len(cols[0]), np.int32)
        combined = np.zeros(len(cols[0]), np.int64)
        for vals, uniq in zip(cols, self.per_col_keys):
            code = np.searchsorted(uniq, vals).clip(
                0, max(len(uniq) - 1, 0))
            combined = combined * max(len(uniq), 1) + code
        return np.searchsorted(self.combo_codes, combined).clip(
            0, len(self.combo_codes) - 1).astype(np.int32)


@dataclasses.dataclass
class _ColumnOutcome:
    """One computed column's slice of a plan execution, combined by
    ``_run_fold`` into the plan-level ``QueryStats``/``RunReport``."""

    result: Any
    hit: bool                          # served whole from the result cache
    gather_path: str
    merge_path: str
    acct: _BlockAccount
    partials_total: int
    partials_reused: int
    rows_folded: int
    mr: MapReduceStats


class GridSession:
    """One object owning the grid lifecycle; the five-verb facade."""

    #: cached results untouched for this many epochs are evicted — a stale
    #: entry pins its finalized device arrays, so a long-lived mutating
    #: session must not keep it forever.
    RESULT_TTL_EPOCHS = 64

    def __init__(
        self,
        table: TensorTable,
        devices: Optional[Sequence[Any]] = None,
        nodes: Optional[Sequence[NodeSpec]] = None,
        strategy: str = "greedy",
        default_eta: int = 16,
        payload_family: str = DATA_FAMILY,
        payload_qualifier: str = "data",
        index_family: str = INDEX_FAMILY,
        plan_cache_cap: int = 64,
        block_cache_cap: Optional[int] = 256,
        partial_cache_cap: Optional[int] = 1024,
        compact_gather_threshold: float = 0.05,
        fold_impl: str = "kernel",
        device_budget: Optional[int] = None,
        host_budget: Optional[int] = None,
        disk_budget: Optional[int] = None,
        partial_budget: Optional[int] = None,
        spill_dir: Optional[str] = None,
        cost_model: Optional["TierCostModel"] = None,
        prefetch: bool = True,
        fault_injector: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.table = table
        #: the owner devices, one per node (entries may repeat a device)
        self.devices: List[torch.device] = owner_devices(devices)
        D = len(self.devices)
        if nodes is None:
            nodes = [NodeSpec(i) for i in range(D)]
        if len(nodes) != D:
            raise ValueError(f"{len(nodes)} nodes for {D} owner devices")
        self.default_eta = int(default_eta)
        self.payload_family = payload_family
        self.payload_qualifier = payload_qualifier
        self.index_family = index_family
        #: cold scans below this selectivity (and with no cached blocks or
        #: partials to reuse) gather compacted selected rows instead of
        #: whole-region blocks — the adaptive one-shot path that recovers
        #: the pre-block cold cost where reuse never comes.  0 disables.
        self.compact_gather_threshold = float(compact_gather_threshold)

        self.placement = Placement.from_strategy(table, nodes, strategy)
        self.table.split_log.clear()  # from_strategy saw the current regions
        #: ``fold_impl="kernel"`` (default) folds CSE-eligible blocks
        #: through the fused fold kernel (its plain version on CPU
        #: owners), falling back per fold signature (see
        #: ``MapReduceEngine.fold_path``); ``"torch"`` forces the chunked
        #: plain fold.
        self.engine = MapReduceEngine(self.devices,
                                      fold_impl=fold_impl,
                                      fault_injector=fault_injector)
        self.metrics = SessionMetrics()
        #: chaos harness + recovery policy.  ``fault_injector`` (usually
        #: None outside tests/benches) fires injected faults at the named
        #: sites; ``retry_policy`` bounds the in-place retries wrapped
        #: around device transfers, table gathers, folds, and spill I/O.
        #: Owner devices that fail PERMANENTLY land in ``_quarantined``
        #: and their regions re-home through the balancer (see
        #: :meth:`_quarantine`).
        self.faults = fault_injector
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        self._quarantined: Set[int] = set()
        #: tiered storage (device HBM → host RAM → disk): any byte budget
        #: bounds its tier; ``spill_dir`` enables the disk tier (a
        #: session-private temp dir is created — and removed on
        #: :meth:`close` — when a host/disk budget is set without one).
        #: ``cost_model`` tunes the spill-vs-refetch-vs-refold oracle;
        #: ``prefetch`` runs the background promotion worker that overlaps
        #: ``device_put`` of lower-tier blocks with in-flight folds.
        tiering = any(b is not None for b in
                      (device_budget, host_budget, disk_budget,
                       partial_budget)) or spill_dir is not None
        if spill_dir is None and (host_budget is not None
                                  or disk_budget is not None):
            # a crashed predecessor can't clean up after itself: sweep its
            # leaked dirs before creating our own under the same root
            sweep_stale_spill_dirs()
            spill_dir = os.path.join(
                tempfile.gettempdir(),
                f"grid-spill-{os.getpid()}-{id(self):x}")
        self.blocks = BlockStore(
            cap=block_cache_cap, partial_cap=partial_cache_cap,
            device_budget=device_budget, host_budget=host_budget,
            disk_budget=disk_budget, partial_budget=partial_budget,
            spill_dir=spill_dir, cost_model=cost_model,
            prefetch_workers=1 if (prefetch and tiering) else 0,
            fault_injector=fault_injector, retry_policy=self.retry_policy)
        self._tiering = tiering
        if fault_injector is not None and fault_injector.on_fire is None:
            # mirror every observed fire into the store's counters so one
            # snapshot tells the whole fault story
            fault_injector.on_fire = (
                lambda site, kind: self.blocks.stats.inc(faults_injected=1))

        self._epoch = 0
        # content-addressed finalized results: (program, partial keys, ...)
        # -> _ResultEntry.  The only plan-level cache the fold engine needs —
        # bound layouts and per-plan gathered blocks are gone; partials (in
        # the BlockStore) carry all cross-plan, cross-epoch compute reuse.
        self._results: LRUCache = LRUCache(plan_cache_cap)
        # (epoch, work list) for full-table plans — see _run_fold
        self._full_work: Optional[Tuple[int, List[_RegionWork]]] = None
        # resolved group mappings keyed (column, plan lineage) — repeat
        # grouped queries skip the unique+hash over the selection
        self._groups: LRUCache = LRUCache(32)
        self._node_index = {n.node_id: d for d, n in enumerate(nodes)}
        # per-owner devices for block placement (the owner list is always
        # one device per node)
        self._devices = self.devices
        # observed per-node round times (observe_round) -> auto-rebalance
        self._round_history: Dict[int, List[float]] = {
            n.node_id: [] for n in nodes
        }
        self._scheduler: Optional[GridScheduler] = None
        #: optional single-flight hook for cross-query partial coalescing
        #: (installed by a query frontend; the port has none yet).  Called
        #: as ``fold_gate(pkey, fn) -> (fn_result, coalesced)`` on every
        #: partial-cache miss: a leader runs ``fn`` (fetch + fold +
        #: put_partial) and followers blocked on the same ``pkey`` receive
        #: the leader's result with ``coalesced=True``, which this session
        #: accounts as a partial reuse rather than a second fold.
        self.fold_gate: Optional[Callable[[Tuple, Callable[[], Tuple]],
                                          Tuple[Tuple, bool]]] = None

    # ------------------------------------------------------------------
    # epoch / dirty tracking
    # ------------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def _advance_epoch(self, dirty_rids: Set[int],
                       touch_blocks: bool = True,
                       dropped_rids: FrozenSet[int] = frozenset()) -> None:
        self._epoch += 1
        self.metrics.inc(epochs=1, regions_dirtied=len(dirty_rids))
        if touch_blocks:
            # copy-on-write: only the touched regions' blocks and partials
            # version-bump; every other block, partial, and cached result
            # over untouched regions survives the mutation structurally
            self.blocks.touch(dirty_rids, self._epoch)
            # results spanning a dirtied region — or a split parent whose
            # rid will never reappear (dropped_rids) — are keyed on dead
            # lineage and can never hit again: release their device arrays
            # now.  Rebalance epochs (touch_blocks=False) skip this: a
            # result does not depend on which devices folded it.
            doomed = set(dirty_rids) | set(dropped_rids)
            dead = [k for k, e in self._results.items()
                    if e.region_ids & doomed]
            for k in dead:
                self._results.pop(k)
        self._prune_caches()

    def _prune_caches(self) -> None:
        """Evict long-idle cached results — they pin finalized device
        arrays, so a long-lived mutating session must not keep them
        forever.  (The LRU cap bounds entry COUNT; this bounds idle
        LIFETIME across mutation epochs.)"""
        idle = [k for k, e in self._results.items()
                if self._epoch - e.last_used > self.RESULT_TTL_EPOCHS]
        for k in idle:
            self._results.pop(k)

    # ------------------------------------------------------------------
    # the five verbs
    # ------------------------------------------------------------------

    def upload(
        self,
        rowkeys: Sequence[RowKey],
        data: Mapping[str, Mapping[str, np.ndarray]],
        on_duplicate: str = "skip",
    ) -> int:
        """Table-1 Upload: batch insert with incremental placement.

        Splits triggered by the insert keep daughters on the parent's node
        (rebalancing is an explicit :meth:`rebalance` call, as in the paper);
        only the regions containing the uploaded keys are invalidated.
        """
        # under "skip", duplicates leave their rows untouched — only the keys
        # actually written may dirty a region, so snapshot existence first
        keys = np.array([_as_key(k) for k in rowkeys], dtype="S64")
        if on_duplicate == "skip" and len(keys):
            written_keys = keys[~self.table.existing_mask(rowkeys)]
        else:
            written_keys = keys
        written = self.table.upload(rowkeys, data, on_duplicate=on_duplicate)
        self.metrics.inc(uploads=1)
        if not written:
            self.table.split_log.clear()
            return 0
        # split parents' rids never reappear: forget their blocks (and evict
        # cached results spanning them) before apply_splits consumes the
        # log, or they'd pin payload until cap pressure (their region set
        # membership is gone for good)
        parents = frozenset(
            parent.rid for parent, _, _ in self.table.split_log)
        self.blocks.drop_regions(parents)
        self.placement.apply_splits()
        dirty = self.table.regions.regions_containing(
            [bytes(k) for k in written_keys])
        self._advance_epoch(dirty, dropped_rids=parents)
        return written

    def retrieve(
        self,
        family: str,
        qualifier: str,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Table-1 Retrieve: ``(rowkeys, values)`` for the selector."""
        return self.table.retrieve(family, qualifier, rowkey=rowkey,
                                   start=start, stop=stop, skip=skip)

    def remove(
        self,
        rowkey: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
        skip: Optional[Sequence[RowKey]] = None,
    ) -> int:
        """Table-1 Remove: delete rows, invalidating only their regions.

        Only the touched regions' block versions bump: every other region's
        device block is reused object-for-object by the next layout build
        (the block-identity tests pin this)."""
        doomed = [bytes(k) for k in
                  self.table.select_keys(rowkey, start, stop, skip)]
        removed = self.table.delete(rowkey=rowkey, start=start, stop=stop,
                                    skip=skip)
        self.metrics.inc(removes=1)
        if removed:
            self._advance_epoch(self.table.regions.regions_containing(doomed))
        return removed

    def observe_round(self, node_times: Mapping[int, float]) -> None:
        """Feed measured per-node round times (the runtime re-measurement of
        the paper's ``linux perf`` MIPS probe).

        Observations accumulate in the session AND drive the wired
        :class:`GridScheduler` (its EWMA powers back ``makespan_estimate``
        and the round ledger); :meth:`rebalance` with ``auto=True`` then
        derives node powers from this history via
        :func:`~repro_torch.core.balancer.powers_from_observations` — no
        hand-supplied specs needed.
        """
        for nid, t in node_times.items():
            if nid in self._round_history and t > 0:
                hist = self._round_history[nid]
                hist.append(float(t))
                del hist[:-self.ROUND_HISTORY_CAP]
        self.scheduler.observe_round(node_times)

    #: round-time observations kept per node; the EWMA power fold saturates
    #: long before this, and an unbounded log would grow with session age
    ROUND_HISTORY_CAP = 64

    @property
    def scheduler(self) -> GridScheduler:
        """The session's passive :class:`GridScheduler` (observation ledger,
        makespan estimates).  Its auto-trigger threshold is infinite and its
        membership verbs are disabled — region moves stay under the
        session's explicit :meth:`rebalance`, which is what keeps
        epochs/dirty-tracking consistent."""
        if self._scheduler is None:
            self._scheduler = _SessionScheduler(
                self.placement, chunk_size=self.default_eta,
                rebalance_threshold=float("inf"))
        return self._scheduler

    def rebalance(
        self,
        tolerance: float = 0.05,
        nodes: Optional[Sequence[NodeSpec]] = None,
        auto: bool = False,
    ) -> List[int]:
        """The paper's offline balancer from the *current* allocation.

        ``nodes`` swaps in refreshed specs (elastic rescale, straggler
        deweighting via :func:`~repro_torch.core.balancer.powers_from_observations`)
        — node ids must be the existing ones.  ``auto=True`` derives those
        specs from the round times fed to :meth:`observe_round` instead
        (no observations yet -> powers unchanged).  Returns moved region ids.

        Moves do NOT bump block content versions: a moved region's payload is
        unchanged, so its cached host block re-commits to the new owner
        device (one transfer, zero table re-reads) while unmoved regions'
        device blocks are reused as-is.
        """
        if auto:
            if nodes is not None:
                raise ValueError(
                    "auto=True derives nodes from observe_round history; "
                    "pass one or the other")
            if any(self._round_history.values()):
                nodes = powers_from_observations(
                    self._round_history, self.placement.nodes)
        if nodes is not None:
            if {n.node_id for n in nodes} != set(self._node_index):
                raise ValueError("rebalance nodes must keep the same node ids")
            order = sorted(nodes, key=lambda n: self._node_index[n.node_id])
            self.placement.nodes = tuple(order)
        old = dict(self.placement.alloc)
        new_alloc, moved = rebalance_allocation(
            old, self.table.region_bytes(), self.placement.nodes, tolerance)
        self.metrics.inc(rebalances=1)
        if moved:
            self.placement.alloc.clear()
            self.placement.alloc.update(new_alloc)
            self.placement.version += 1
            self._advance_epoch(set(moved), touch_blocks=False)
        return moved

    # ------------------------------------------------------------------
    # permanent owner failure: quarantine + re-home
    # ------------------------------------------------------------------

    @property
    def quarantined_devices(self) -> FrozenSet[int]:
        """Device indices permanently quarantined after a non-transient
        failure; their regions were re-homed onto the survivors."""
        return frozenset(self._quarantined)

    def _quarantine(self, owner: Optional[int]) -> None:
        """Permanent owner failure: mark the device dead and re-home its
        regions through the balancer.  Idempotent per device; the first
        call counts one ``quarantines`` and pays one re-home epoch."""
        if owner is None or owner in self._quarantined:
            return
        self._quarantined.add(owner)
        if self.faults is not None:
            # keep the injector's sticky lost-set consistent even when the
            # loss was detected (a real device_put error), not injected
            self.faults.lost_devices.add(owner)
        self.blocks.stats.inc(quarantines=1)
        self._rehome_quarantined()

    def _rehome_quarantined(self) -> List[int]:
        """Drain every quarantined device's regions onto the survivors.

        This is the paper's region-server failover expressed through the
        offline balancer: dead nodes are simply *absent* from the node
        list handed to :func:`~repro_torch.core.balancer.rebalance`, so their
        regions are treated as homeless and re-assigned first, and the
        survivors rebalance around the new load.  Like any rebalance, the
        move bumps the placement version and advances a
        ``touch_blocks=False`` epoch — block content versions are
        untouched, so every still-resident host/disk block and cached
        partial survives and a moved region re-commits to its new owner
        with one ``device_put`` and ZERO table re-reads.  With no live
        node left the session keeps serving host-degraded (folds run on
        host copies; nothing is re-homed)."""
        live = [n for d, n in enumerate(self.placement.nodes)
                if d not in self._quarantined]
        if not live:
            return []
        old = dict(self.placement.alloc)
        new_alloc, moved = rebalance_allocation(
            old, self.table.region_bytes(), live, tolerance=0.05)
        self.metrics.inc(rebalances=1)
        if moved:
            self.placement.alloc.clear()
            self.placement.alloc.update(new_alloc)
            self.placement.version += 1
            self._advance_epoch(set(moved), touch_blocks=False)
        return moved

    # ------------------------------------------------------------------
    # GridQuery: lazy scan -> filter -> map -> reduce plans
    # ------------------------------------------------------------------

    def scan(
        self,
        prefix: Optional[RowKey] = None,
        start: Optional[RowKey] = None,
        stop: Optional[RowKey] = None,
    ) -> GridQuery:
        """Open a lazy :class:`GridQuery` plan over a rowkey range.

        ``prefix`` is sugar for the half-open range of keys sharing it
        (mutually exclusive with ``start``/``stop``).  Nothing is scanned,
        gathered, or compiled until ``.collect()``/``.stats()`` — the
        planner prunes regions, pushes the projection down, and fuses every
        ``.map`` program into one engine pass first.
        """
        if prefix is not None:
            if start is not None or stop is not None:
                raise ValueError("prefix is exclusive with start/stop")
            p, (start_b, stop_b) = _as_key(prefix), prefix_range(prefix)
            return GridQuery(self, start=start_b, stop=stop_b, prefix=p)
        return GridQuery(
            self,
            start=None if start is None else _as_key(start),
            stop=None if stop is None else _as_key(stop),
        )

    def run(
        self,
        program: MapReduceProgram,
        eta: Optional[int] = None,
        family: Optional[str] = None,
        qualifier: Optional[str] = None,
        impl: Optional[str] = None,
    ) -> Tuple[Any, RunReport]:
        """MapReduce over the whole table — a full-range one-program plan.

        ``impl="kernel"`` swaps a sum/count-family program for its
        ``streaming_stats``-backed map phase (see
        :func:`repro_torch.kernels.streaming_stats.ops.kernel_map_program`);
        ``impl="ref"``/``None`` keeps the plain fold.  The kernel program
        has its own cache identity, so ref and kernel runs keep separate
        partials and can be compared side by side.

        Orthogonally, the *fold phase itself* runs on the fused fold
        kernel whenever the session-level ``fold_impl="kernel"`` switch is
        on and the fold signature is eligible (see
        ``MapReduceEngine.fold_path``) — that path needs no per-call
        opt-in here.
        """
        if impl is not None and impl != "ref":
            from repro_torch.kernels.streaming_stats.ops import kernel_map_program
            program = kernel_map_program(program, impl=impl)
        q = self.scan().select(
            (family or self.payload_family,
             qualifier or self.payload_qualifier)).map(program)
        return q.collect(eta=eta)

    def run_where(
        self,
        predicate: Predicate,
        program: MapReduceProgram,
        index_qualifiers: Sequence[str],
        eta: Optional[int] = None,
        family: Optional[str] = None,
        qualifier: Optional[str] = None,
    ) -> Tuple[Any, RunReport]:
        """Predicate-pushdown MapReduce (§2.3 unified with §2.2) — a
        full-range ``.where`` plan.

        The predicate runs over the index family only; the fold then reads
        *just the selected payload slots* through per-block row masks
        (locality preserved because index and payload share rowkeys and
        placement), so ``QueryStats.payload_bytes_moved`` covers exactly
        the selected rows — never the full table.

        Physical transfer is adaptive: by default a selective query ships
        the surviving regions' whole blocks (observable via
        ``payload_bytes_transferred``), which lets every later plan — any
        predicate, any overlapping range, any later epoch — reuse blocks
        AND per-block fold partials without re-shipping or re-folding.  A
        COLD query below ``compact_gather_threshold`` selectivity with no
        cached state to reuse ships only the compacted selected rows
        instead (``QueryStats.gather_path == "compact"``).
        """
        q = (self.scan()
             .select((family or self.payload_family,
                      qualifier or self.payload_qualifier))
             .where(predicate, index_qualifiers)
             .map(program))
        return q.collect(eta=eta)

    # ------------------------------------------------------------------
    # the planner/executor behind GridQuery
    # ------------------------------------------------------------------

    def _execute_plan(
        self, plan: GridQuery, eta: Optional[int] = None
    ) -> Tuple[Any, RunReport]:
        """Compile + execute a :class:`GridQuery` with all three pushdowns."""
        eta = int(eta or self.default_eta)
        self.metrics.inc(scans=1)
        if not plan.programs:
            if plan.group_key is not None:
                raise ValueError(
                    "group_by needs at least one map(program); a grouped "
                    "retrieve has no statistic to stratify")
            return self._collect_rows(plan, eta)
        program: MapReduceProgram
        if len(plan.programs) == 1:
            program = plan.programs[0]
        else:
            program = FusedProgram(plan.programs)
            self.metrics.inc(programs_fused=len(plan.programs))
        return self._run_fold(plan, program, eta)

    @staticmethod
    def _mask_sig(mask_slice: np.ndarray) -> str:
        """Content signature of one region's selected-row mask.

        ``"full"`` and ``"empty"`` are canonical — a range scan that exactly
        covers a region shares partials with the full-table plan; anything
        else hashes the packed mask bits plus the length (packbits pads to
        byte boundaries, so the length disambiguates).
        """
        if mask_slice.all():
            return "full"
        if not mask_slice.any():
            return "empty"
        h = hashlib.blake2b(digest_size=12)
        h.update(len(mask_slice).to_bytes(8, "little"))
        h.update(np.packbits(mask_slice).tobytes())
        return h.hexdigest()

    def _plan_work(
        self, mask: Optional[np.ndarray], regions: Sequence[Region]
    ) -> List[_RegionWork]:
        """Per-region work items, in start-key order: owner device,
        positional row range, and the partial-addressing mask signature.
        This runs on EVERY execution (it builds the result-cache key), so
        it stays allocation-light: slices, not index arrays."""
        work = []
        keys = self.table.keys
        alloc = self.placement.alloc
        for region in regions:
            owner = self._node_index.get(alloc.get(region.rid))
            if owner is not None and owner in self._quarantined:
                # permanently lost owner whose regions could not re-home
                # (no live node left): serve host-degraded
                owner = None
            rows = region.row_slice(keys)
            n = rows.stop - rows.start
            if n == 0:
                sig, sel = "empty", 0
            elif mask is None:
                sig, sel = "full", n
            else:
                sub = mask[rows]
                sig = self._mask_sig(sub)
                sel = int(sub.sum())
            work.append(_RegionWork(region, owner, rows, sig, sel))
        return work

    def _group_info(self, plan: GridQuery, mask: Optional[np.ndarray],
                    work_sig: Tuple) -> _GroupInfo:
        """Resolve a plan's ``group_by`` key to a dense gid mapping.

        The key column is read like an index column (a few bytes per row,
        never the payload); the distinct values among the *selected* rows
        become group ids 0..G-1 in ascending value order — exactly the
        grouping a NumPy ``np.unique``-based oracle produces.  The mapping
        signature content-addresses every group-keyed partial: a selection
        whose value universe differs folds under a different signature.

        The resolved info is memoized on ``(column, work_sig)`` — the
        plan's region lineage + row-mask signatures pin the selected key
        values exactly, so a repeat grouped query costs an LRU lookup, not
        an O(N log N) unique+hash over the selection.
        """
        key_cols = plan.group_key
        memo_key = (key_cols, work_sig)
        cached = self._groups.get(memo_key)
        if cached is not None:
            return cached
        row_nbytes = 0
        per_col_vals = []
        h = hashlib.blake2b(digest_size=12)
        for gf, gq in key_cols:
            spec = self.table.column_spec(gf, gq)
            if spec.shape != ():
                raise ValueError(
                    f"group_by column {gf}:{gq} must be scalar per row, "
                    f"got shape {spec.shape}")
            row_nbytes += spec.row_nbytes
            col = self.table.column(gf, gq)
            per_col_vals.append(col if mask is None else col[mask])
        per_col_keys = []
        combined = np.zeros(len(per_col_vals[0]), np.int64)
        for (gf, gq), vals in zip(key_cols, per_col_vals):
            uniq, inv = np.unique(vals, return_inverse=True)
            per_col_keys.append(uniq)
            combined = combined * max(len(uniq), 1) + inv.reshape(-1)
            # ordered column identity + per-column universe: the sig
            # distinguishes ["site","scanner"] from ["scanner","site"]
            h.update(f"{gf}:{gq}:{uniq.dtype.str}:{len(uniq)};".encode())
            h.update(uniq.tobytes())
        combo_codes = np.unique(combined)
        h.update(combo_codes.tobytes())
        if len(key_cols) == 1:
            keys = per_col_keys[0]
        else:
            # decode each observed combination back to a tuple label, in
            # listed-column (lexicographic) order
            keys = np.empty(len(combo_codes), object)
            for g, code in enumerate(combo_codes):
                parts = []
                rem = int(code)
                for uniq in reversed(per_col_keys):
                    rem, idx = divmod(rem, max(len(uniq), 1))
                    parts.append(uniq[idx].item()
                                 if hasattr(uniq[idx], "item")
                                 else uniq[idx])
                keys[g] = tuple(reversed(parts))
        info = _GroupInfo(tuple(key_cols), keys, tuple(per_col_keys),
                          combo_codes, h.hexdigest(), row_nbytes)
        self._groups.put(memo_key, info)
        return info

    def _run_fold(
        self, plan: GridQuery, program: MapReduceProgram, eta: int
    ) -> Tuple[Any, RunReport]:
        """The block-granular fold behind every compute plan.

        One scan resolution (range pruning + predicate mask + group-key
        mapping) feeds every computed column; each column then resolves
        independently through (1) the content-addressed result cache — a
        repeat query at unchanged block lineage returns the finalized
        answer and folds zero rows; (2) the adaptive compact gather for
        cold low-selectivity ungrouped one-shots; (3) block-at-a-time
        folding with the partial cache — only blocks whose partial is
        missing are fetched and folded, so a mutation re-folds exactly the
        dirty regions.  Grouped plans fold group-keyed partials (leaves
        gain a leading group axis) in the same single pass per block —
        grouping never multiplies gathers or folds.
        """
        cols = plan.compute_columns()
        full = (plan.start is None and plan.stop is None
                and plan.predicate is None)
        if full:
            mask = None
            # the full-table work list is a pure function of the epoch
            # (regions, row slices, owners, versions all mutate only
            # through _advance_epoch), so the repeat-query hot path skips
            # the per-region bisects entirely
            fw = self._full_work
            if fw is None or fw[0] != self._epoch:
                fw = (self._epoch,
                      self._plan_work(None, tuple(self.table.regions.regions)))
                self._full_work = fw
            work = fw[1]
            n = self.table.num_rows
            qstats = QueryStats(
                rows_scanned=n, index_bytes_scanned=0,
                payload_bytes_traversed=0, rows_selected=n,
                regions_scanned=len(work), regions_pruned=0)
        else:
            mask, qstats, regions = self._scan_mask(plan)
            work = self._plan_work(mask, regions)

        # the plan's lineage signature: region content versions + row-mask
        # signatures — shared by the group-mapping memo and every column's
        # result-cache key
        work_sig = tuple(
            (w.region.signature, self.blocks.version_of(w.region.rid),
             w.mask_sig) for w in work)

        group: Optional[_GroupInfo] = None
        if plan.group_key is not None:
            group = self._group_info(plan, mask, work_sig)
            program = GroupedProgram(program, group.num_groups)
            # the key column is scanned like any index column
            qstats = dataclasses.replace(
                qstats, num_groups=group.num_groups,
                index_bytes_scanned=qstats.index_bytes_scanned
                + qstats.rows_scanned * group.row_nbytes)
        per_row = sum(self.table.column_spec(f, q).row_nbytes
                      for f, q in cols)
        qstats = dataclasses.replace(
            qstats, payload_bytes_moved=qstats.rows_selected * per_row)

        outcomes = [
            self._fold_column(program, eta, mask, work, work_sig, f, q,
                              group)
            for f, q in cols
        ]

        # --- combine per-column outcomes into the plan-level report -------
        acct = _BlockAccount()
        for o in outcomes:
            a = o.acct
            acct.total += a.total
            acct.reused += a.reused
            acct.transferred += a.transferred
            acct.gathered += a.gathered
            acct.rows_gathered += a.rows_gathered
            acct.bytes_transferred += a.bytes_transferred

        def _combine_paths(paths) -> str:
            named = {p for p in paths if p}
            if not named:
                return ""
            return named.pop() if len(named) == 1 else "mixed"

        hit = all(o.hit for o in outcomes)
        if hit:
            self.metrics.inc(plan_hits=1)
        else:
            self.metrics.inc(plan_misses=1)
        qstats = dataclasses.replace(
            acct.apply(qstats),
            gather_path=_combine_paths(o.gather_path for o in outcomes),
            merge_path=_combine_paths(o.merge_path for o in outcomes),
            partials_total=sum(o.partials_total for o in outcomes),
            partials_reused=sum(o.partials_reused for o in outcomes),
            rows_folded=sum(o.rows_folded for o in outcomes))
        mr = MapReduceStats(
            local_rows_read=sum(o.mr.local_rows_read for o in outcomes),
            local_bytes_read=sum(o.mr.local_bytes_read for o in outcomes),
            shuffle_bytes=sum(o.mr.shuffle_bytes for o in outcomes),
            rounds=max(o.mr.rounds for o in outcomes),
            chunks=sum(o.mr.chunks for o in outcomes),
            chunk_size=eta)

        def _wrap(o: _ColumnOutcome) -> Any:
            if group is not None:
                return GroupedResult(keys=group.keys.copy(), values=o.result)
            return o.result

        if len(cols) == 1:
            results: Any = _wrap(outcomes[0])
        else:
            results = {f"{f}:{q}": _wrap(o)
                       for (f, q), o in zip(cols, outcomes)}
        return results, RunReport(epoch=self._epoch, eta=eta,
                                  plan_cache_hit=hit, mapreduce=mr,
                                  query=qstats)

    def _fold_column(
        self, program: MapReduceProgram, eta: int,
        mask: Optional[np.ndarray], work: Sequence[_RegionWork],
        work_sig: Tuple, family: str, qualifier: str,
        group: Optional[_GroupInfo],
    ) -> _ColumnOutcome:
        """Resolve one computed column: result cache → compact → blockwise."""
        spec = self.table.column_spec(family, qualifier)
        result_key = (
            "fold", program.cache_key(), family, qualifier, int(eta),
            self._mesh_shape(), group.sig if group is not None else "",
            work_sig,
        )
        entry = self._results.get(result_key)
        if entry is not None:
            entry.last_used = self._epoch
            self.metrics.inc(partials_reused=entry.partials_total)
            # zero-work execution: nothing was read, folded, or shuffled
            return _ColumnOutcome(
                result=entry.result, hit=True,
                gather_path=entry.gather_path, merge_path="",
                acct=_BlockAccount.all_reused(entry.blocks_total),
                partials_total=entry.partials_total,
                partials_reused=entry.partials_total, rows_folded=0,
                mr=MapReduceStats(0, 0, 0, 0, 0, eta))
        if (mask is not None and group is None
                and self._should_compact(work, family, qualifier)):
            return self._run_compact(program, eta, mask, work,
                                     family, qualifier, spec, result_key)
        return self._run_blockwise(program, eta, mask, work,
                                   family, qualifier, spec, result_key,
                                   group)

    def _should_compact(self, work: Sequence[_RegionWork],
                        family: str, qualifier: str) -> bool:
        """Adaptive cold-scan gather: take the compacted one-shot path when
        selectivity is below the threshold AND no reuse is in flight (no
        resident current-version block or partial for any surviving
        region).  Block granularity deliberately ships whole regions to
        make them shareable; a cold selective scan that will never share
        shouldn't pay for that."""
        thr = self.compact_gather_threshold
        if thr <= 0:
            return False
        in_range = sum(w.n_rows for w in work)
        sel = sum(w.selected for w in work)
        if sel == 0 or in_range == 0 or sel / in_range >= thr:
            return False
        for w in work:
            if w.selected == 0:
                continue
            if self.blocks.peek(w.region, family, qualifier) is not None:
                return False
            if self.blocks.has_partials(w.region.rid):
                return False
        return True

    def _run_compact(
        self, program: MapReduceProgram, eta: int, mask: np.ndarray,
        work: Sequence[_RegionWork],
        family: str, qualifier: str, spec, result_key: Tuple,
    ) -> _ColumnOutcome:
        """One-shot compacted gather: ONLY the selected rows ship, grouped
        by owner device (locality preserved), folded layout-at-a-time by
        :meth:`MapReduceEngine.run`.  Nothing enters the block or partial caches —
        this path exists precisely because no payload reuse is expected —
        but the tiny finalized RESULT is still memoized, so an identical
        repeat query pays nothing at all."""
        D = len(self.placement.nodes)
        sel_per_dev: List[List[np.ndarray]] = [[] for _ in range(D)]
        for w in work:
            if w.selected == 0 or w.owner is None:
                continue
            sel_per_dev[w.owner].append(
                np.nonzero(mask[w.rows])[0] + w.rows.start)
        rows_per_dev = [int(sum(len(x) for x in lst)) for lst in sel_per_dev]
        # capacity rounds up to a power-of-two chunk count so compact scans
        # of drifting selectivity share a few engine executables
        cap = self._capacity_for(rows_per_dev, eta)
        cap = eta * (1 << (max(1, cap // eta) - 1).bit_length())
        col = self.table.column(family, qualifier)
        host = np.zeros((D, cap) + tuple(spec.shape), spec.dtype)
        valid = np.zeros((D, cap), dtype=bool)
        for d in range(D):
            off = 0
            for sub in sel_per_dev[d]:
                host[d, off: off + len(sub)] = col[sub]
                off += len(sub)
            valid[d, :off] = True
        result, mr = self.engine.run(program, host, valid, eta)
        sel = sum(rows_per_dev)
        self.metrics.inc(compact_scans=1, pushdown_rows_gathered=sel,
                         payload_gathers=1, rows_folded=sel)
        self._results.put(result_key, _ResultEntry(
            result=result, partials_total=0, blocks_total=0,
            region_ids=frozenset(w.region.rid for w in work),
            gather_path="compact", last_used=self._epoch))
        acct = _BlockAccount()
        acct.bytes_transferred = sel * spec.row_nbytes
        return _ColumnOutcome(
            result=result, hit=False, gather_path="compact", merge_path="",
            acct=acct, partials_total=0, partials_reused=0,
            rows_folded=sel, mr=mr)

    def _run_blockwise(
        self, program: MapReduceProgram, eta: int,
        mask: Optional[np.ndarray], work: Sequence[_RegionWork],
        family: str, qualifier: str, spec, result_key: Tuple,
        group: Optional[_GroupInfo] = None,
    ) -> _ColumnOutcome:
        """Block-at-a-time map phase + one merge/finalize reduce.

        Per foldable block: partial-cache lookup first; on a miss the block
        is fetched store-first (reused / transferred / gathered classified
        by the BlockStore) and folded ON ITS OWNER DEVICE, and the partial
        is cached under the block's lineage.  Blocks with no selected rows
        contribute the monoid identity — neither payload nor partial is
        ever touched for them.  Grouped plans fold group-keyed partials in
        the same one pass per block: group ids ride beside the row mask, so
        G strata never multiply gathers, folds, or partials.
        """
        prog_key = program.cache_key()
        gsig = group.sig if group is not None else ""
        n_groups = group.num_groups if group is not None else 0
        # Partials from the fused kernel fold and the chunked plain fold
        # agree only to fp32 accumulation tolerance, so they must not
        # share cache slots.  The path is deterministic per (program,
        # dtype, G) — resolve it once and key partials on it ("" for the
        # plain fold, as the reference keys its XLA fold).
        fold_impl = self.engine.fold_path(program, spec.dtype, n_groups)
        impl_sig = fold_impl if fold_impl != "torch" else ""
        acct = _BlockAccount()
        if (self._tiering and self._devices is not None
                and self.blocks.prefetch_enabled):
            # overlap host→device promotion of upcoming cold blocks with
            # the folds of earlier ones: every work item whose partial
            # isn't servable and whose block sits in a lower tier gets a
            # background device_put; the fold loop below claims each
            # completed promotion with its original classification
            for w in work:
                if w.selected == 0 or w.owner is None:
                    continue
                pk = self.blocks.partial_key(
                    w.region, family, qualifier, prog_key, w.mask_sig,
                    eta, group_sig=gsig, impl=impl_sig)
                if self.blocks.peek_partial(pk):
                    continue
                self.blocks.prefetch(w.region, family, qualifier, w.owner,
                                     self._put_block)
        partials: List[Any] = []
        owners: List[Optional[int]] = []
        p_total = p_reused = rows_folded = local_rows = chunks = 0
        rounds: Dict[Optional[int], int] = {}
        for w in work:
            if w.selected == 0:
                acct.total += 1
                acct.reused += 1
                continue
            p_total += 1
            pkey = self.blocks.partial_key(
                w.region, family, qualifier, prog_key, w.mask_sig, eta,
                group_sig=gsig, impl=impl_sig)
            partial = self.blocks.get_partial(pkey)
            if partial is not None:
                p_reused += 1
                acct.total += 1
                acct.reused += 1
            else:
                gate = self.fold_gate
                if gate is None:
                    folded, coalesced = self._fold_cold(
                        program, eta, mask, w, family, qualifier, spec,
                        group, n_groups, pkey), False
                else:
                    folded, coalesced = gate(pkey, lambda: self._fold_cold(
                        program, eta, mask, w, family, qualifier, spec,
                        group, n_groups, pkey))
                partial = folded[0]
                if coalesced:
                    # a concurrent query's leader fold produced this
                    # partial while we waited — account it as a reuse, not
                    # a second fetch + fold
                    p_reused += 1
                    acct.total += 1
                    acct.reused += 1
                else:
                    _, blk, reused, gathered = folded
                    acct.add(blk, reused, gathered)
                    rows_folded += blk.rows
                    local_rows += w.selected
                    c = -(-blk.rows // eta)
                    chunks += c
                    rounds[w.owner] = rounds.get(w.owner, 0) + c
            partials.append(partial)
            owners.append(w.owner)
        result = self.engine.merge_finalize(program, partials,
                                            spec.shape, spec.dtype,
                                            owners=owners)
        self._results.put(result_key, _ResultEntry(
            result=result, partials_total=p_total, blocks_total=acct.total,
            region_ids=frozenset(w.region.rid for w in work),
            last_used=self._epoch))

        self.metrics.inc(
            partials_folded=p_total - p_reused, partials_reused=p_reused,
            rows_folded=rows_folded, rows_gathered=acct.rows_gathered,
            pushdown_rows_gathered=(acct.rows_gathered
                                    if mask is not None else 0),
            payload_gathers=1 if acct.gathered else 0)

        pb = self.engine.partial_nbytes(program, spec.shape, spec.dtype)
        # local_* use the layout path's logical convention (selected rows ×
        # row bytes); the PHYSICAL rows the folds traversed are the
        # rows_folded oracle on QueryStats
        mr = MapReduceStats(
            local_rows_read=local_rows,
            local_bytes_read=local_rows * spec.row_nbytes,
            shuffle_bytes=pb * len(partials),
            rounds=max(rounds.values(), default=0),
            chunks=chunks,
            chunk_size=eta)
        return _ColumnOutcome(
            result=result, hit=False, gather_path="blocks",
            merge_path=self.engine.last_merge_path, acct=acct,
            partials_total=p_total, partials_reused=p_reused,
            rows_folded=rows_folded, mr=mr)

    def _fold_cold(
        self, program: MapReduceProgram, eta: int,
        mask: Optional[np.ndarray], w: _RegionWork,
        family: str, qualifier: str, spec,
        group: Optional[_GroupInfo], n_groups: int, pkey: Tuple,
    ) -> Tuple[Any, DeviceBlock, bool, bool]:
        """Fetch one region's block, fold it on its owner device, and cache
        the partial under ``pkey``.  Returns ``(partial, block, reused,
        gathered)`` so the caller (or a coalescing fold gate's followers)
        can account the fetch classification exactly once."""
        blk, reused, gathered = self._fetch_block(
            w.region, family, qualifier, owner=w.owner)
        base_mask = None if w.mask_sig == "full" else mask[w.rows]
        gid_base = None
        if group is not None:
            # Densified gid blocks depend only on (region lineage,
            # mapping), not on the program — cache them so dirty-region
            # re-folds across plans skip the factorize pass.
            gid_base = self.blocks.get_gids(
                w.region, group.family, group.qualifier, group.sig)
            if gid_base is None:
                gid_base = group.gids_for(tuple(
                    self.table.column(f, q)[w.rows]
                    for f, q in group.columns))
                self.blocks.put_gids(
                    w.region, group.family, group.qualifier,
                    group.sig, gid_base)

        def fold_with(b: DeviceBlock, force_host: bool = False):
            # mask/gid padding is keyed off the actual source shape — the
            # committed device copy is pre-padded to the fold bucket, a
            # host-degraded copy is not.  ``force_host`` ignores a device
            # copy outright: after a quarantine it lives on dead silicon
            use_device = b.device is not None and not force_host
            src = b.device if use_device else b.host
            bmask, gid_arr = base_mask, gid_base
            src_rows = int(src.shape[0])
            if src_rows != b.rows:
                # committed pre-padded to the fold bucket: extend the
                # (tiny) mask/gid arrays host-side to match
                m = np.zeros(src_rows, bool)
                m[:b.rows] = True if bmask is None else bmask
                bmask = m
                if gid_arr is not None:
                    g2 = np.zeros(src_rows, np.int32)
                    g2[:b.rows] = gid_arr
                    gid_arr = g2
            return self.engine.fold_block(
                program, src, bmask, eta, spec.shape, spec.dtype,
                gids=gid_arr, num_groups=n_groups,
                owner=w.owner if use_device else None)

        def run(b: DeviceBlock, force_host: bool = False):
            if self.faults is None:
                return fold_with(b, force_host)
            return self.retry_policy.call(
                lambda: fold_with(b, force_host),
                key=f"fold:{w.region.rid}",
                on_retry=lambda e, a: self.blocks.stats.inc(retries=1))

        try:
            partial = run(blk)
        except DeviceLostError as e:
            # the owner died mid-fold: quarantine it (re-homing its
            # regions for later plans) and re-fold this block's host copy
            # — still resident in the store, so no table re-read unless
            # the host tier, too, was lost
            self._quarantine(e.device if e.device is not None else w.owner)
            hblk, regath = self.blocks.fetch_host(
                w.region, family, qualifier,
                gather_host=self._gather_fn(w.region, family, qualifier))
            gathered = gathered or regath
            blk = hblk
            partial = run(hblk, force_host=True)
        self.blocks.put_partial(pkey, partial)
        return partial, blk, reused, gathered

    def _scan_mask(
        self, plan: GridQuery
    ) -> Tuple[np.ndarray, QueryStats, Tuple[Region, ...]]:
        """Selected-row mask + accounting for a plan's scan stage, plus the
        pruned region set so downstream stages consume the SAME range
        resolution they were keyed on (range clipping itself lives in the
        mask — blocks keep whole regions).

        With a predicate this is :func:`indexed_query` over the scan range
        (index family only); without one, every row in range is selected and
        zero index bytes move.  Region stats always reflect the pruning.
        """
        regions = self.table.regions.prune(plan.start, plan.stop)
        pruned_count = len(self.table.regions) - len(regions)
        lo, hi = self.table.row_range(plan.start, plan.stop)
        if plan.predicate is not None:
            mask, qstats = indexed_query(
                self.table, plan.predicate, plan.index_qualifiers,
                index_family=self.index_family,
                start=plan.start, stop=plan.stop)
        else:
            mask = np.zeros(self.table.num_rows, dtype=bool)
            mask[lo:hi] = True
            qstats = QueryStats(
                rows_scanned=hi - lo, index_bytes_scanned=0,
                payload_bytes_traversed=0, rows_selected=hi - lo,
                regions_scanned=len(regions), regions_pruned=pruned_count)
        return mask, qstats, regions

    def _collect_rows(
        self, plan: GridQuery, eta: int
    ) -> Tuple[Tuple[np.ndarray, Dict[str, np.ndarray]], RunReport]:
        """Program-less plans are pruned retrieves: host-side rowkeys plus
        every selected column's values, charging only the selected rows.

        Retrieves route through the BlockStore's host blocks
        (:meth:`BlockStore.fetch_host`): each surviving region's column is
        read from the table once per content version, so retrieve-heavy
        workloads — and later folds over the same regions — share one
        gather.  In the accounting, ``reused`` is a content hit and
        ``transferred``/``gather_count`` a fresh table read (host-side;
        nothing ships to a device on this path).
        """
        mask, qstats, regions = self._scan_mask(plan)
        sel = np.nonzero(mask)[0]
        acct = _BlockAccount()
        cols: Dict[str, np.ndarray] = {}
        for f, q in plan.resolved_columns():
            spec = self.table.column_spec(f, q)
            parts = []
            for region in regions:
                rows = self.table.region_rows(region)
                if rows.stop <= rows.start:
                    continue
                sub = mask[rows]
                if not sub.any():
                    continue
                blk, gathered = self.blocks.fetch_host(
                    region, f, q,
                    gather_host=lambda r=region, fa=f, qu=q:
                        self.table.region_column(r, fa, qu))
                acct.add(blk, not gathered, gathered)
                parts.append(blk.host[sub])
            cols[f"{f}:{q}"] = (
                np.concatenate(parts) if parts
                else np.empty((0,) + tuple(spec.shape), spec.dtype))
        per_row = sum(self.table.column_spec(f, q).row_nbytes
                      for f, q in plan.resolved_columns())
        qstats = dataclasses.replace(
            acct.apply(qstats), gather_path="retrieve",
            payload_bytes_moved=len(sel) * per_row)
        report = RunReport(epoch=self._epoch, eta=eta, plan_cache_hit=False,
                           mapreduce=None, query=qstats)
        return (self.table.keys[sel].copy(), cols), report

    # ------------------------------------------------------------------
    # block fetch (the BlockStore plumbing)
    # ------------------------------------------------------------------

    @staticmethod
    def _capacity_for(rows_per_dev: List[int], chunk: int) -> int:
        """Slots per device: the busiest device's rows rounded up to a
        chunk multiple, at least one chunk (SPMD needs equal shards)."""
        need = max(rows_per_dev, default=0)
        return max(chunk, -(-max(need, 1) // chunk) * chunk)

    def _gather_fn(self, region: Region, family: str,
                   qualifier: str) -> Callable[[], np.ndarray]:
        """The table-read thunk handed to the BlockStore, wrapped (when a
        fault injector is live) so transient gather faults retry in place
        before the store ever sees an exception."""
        def base() -> np.ndarray:
            return self.table.region_column(region, family, qualifier)
        if self.faults is None:
            return base

        def attempt() -> np.ndarray:
            self.faults.fire("gather")
            return base()

        return lambda: self.retry_policy.call(
            attempt, key=f"gather:{region.rid}",
            on_retry=lambda e, a: self.blocks.stats.inc(retries=1))

    def _fetch_block(
        self, region: Region, family: str, qualifier: str,
        owner: Optional[int],
    ) -> Tuple[DeviceBlock, bool, bool]:
        """Store-first block access; ``owner`` is the region's device index
        (derived once per plan in ``_plan_work``, not re-derived per
        block).

        Degradation ladder on faults: transient ``device_put`` failures
        already retried inside :meth:`_put_block`; a PERMANENT owner loss
        quarantines the device (re-homing its regions for every later
        plan) and this fetch falls back to the host tier — the content is
        served without device commitment, so the query completes with the
        payload folding host-side instead of raising."""
        if owner is not None and owner in self._quarantined:
            owner = None       # stale work item from before a re-home
        gather = self._gather_fn(region, family, qualifier)
        to_device = None if self._devices is None else self._put_block
        try:
            return self.blocks.fetch(region, family, qualifier, owner,
                                     gather_host=gather,
                                     to_device=to_device)
        except DeviceLostError as e:
            self._quarantine(e.device if e.device is not None else owner)
        except TransientFaultError:
            pass               # retries exhausted: degrade below
        # device commitment failed for good: serve the host tier (the
        # store's cached copy, or one verified table re-read)
        blk, gathered = self.blocks.fetch_host(region, family, qualifier,
                                               gather_host=gather)
        return blk, False, gathered

    def _put_block(self, host: np.ndarray, owner_index: Optional[int]):
        """Commit one block to its owner's device (the per-block fold then
        runs where the committed tensor lives).

        The committed copy is padded to the engine's bucketed row count
        (next power of two), so every later fold hits an exact-shape
        executable with NO per-fold pad copy — the pad memcpy is paid once
        per gather, where it amortizes.  The block's ``host`` array and
        ``rows`` stay logical; ``_run_blockwise`` extends row masks/gids to
        the padded shape host-side (tiny bool/int32 arrays).

        Transient injected transfer faults retry here under the session
        policy; :class:`DeviceLostError` propagates to
        :meth:`_fetch_block`, which owns quarantine + host degrade."""
        bucket = self.engine.bucket_rows(len(host))
        dev = (self.engine._merge_device if owner_index is None
               else self._devices[owner_index])
        if self.faults is None:
            return _to_owner(host, bucket, dev)

        def attempt():
            self.faults.fire("device_put", device=owner_index)
            return _to_owner(host, bucket, dev)

        return self.retry_policy.call(
            attempt, key=f"device_put:{owner_index}",
            on_retry=lambda e, a: self.blocks.stats.inc(retries=1))

    # ------------------------------------------------------------------
    # helpers / diagnostics
    # ------------------------------------------------------------------

    def _mesh_shape(self) -> Tuple[Tuple[str, int], ...]:
        return (("data", len(self.devices)),)

    def close(self) -> None:
        """Release tier resources (the prefetch worker, every spill file,
        and the session-owned spill dir).  The session stays usable for
        in-memory work afterwards; cached lower-tier content re-gathers
        from the table on next use."""
        self.blocks.close()

    def __enter__(self) -> "GridSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def prefetch_plan(self, plan: GridQuery) -> int:
        """Kick background device promotion for the blocks a plan is about
        to fold; returns the number of promotions enqueued.

        Promotion-only and best-effort: a region whose block was demoted
        out of the device tier (or never committed) gets its
        ``device_put`` overlapped with the folds of earlier blocks in the
        same pass; regions that still have cached partials for their
        current content are skipped (a warm query folds nothing, so
        promoting its payload would waste HBM).  A no-op unless tiering is
        configured — flat unbounded sessions already keep every block
        device-resident.  Callers must hold whatever epoch isolation they
        run queries under (the frontend calls this inside its read lock).
        """
        if (not self._tiering or self._devices is None
                or not self.blocks.prefetch_enabled):
            return 0
        columns = plan.columns or ((self.payload_family,
                                    self.payload_qualifier),)
        regions = self.table.regions.prune(plan.start, plan.stop)
        alloc = self.placement.alloc
        issued = 0
        for region in regions:
            if self.blocks.has_partials(region.rid):
                continue
            owner = self._node_index.get(alloc.get(region.rid))
            if owner is None:
                continue
            for family, qualifier in columns:
                if self.blocks.prefetch(region, family, qualifier, owner,
                                        self._put_block):
                    issued += 1
        return issued

    def imbalance(self) -> float:
        """Max relative deviation of node work from #CPU×MIPS-proportional."""
        return allocation_imbalance(
            self.placement.alloc, self.table.region_bytes(),
            self.placement.nodes)

    def token_dataset(self, global_batch: int, seed: int = 0):
        """A :class:`ColocatedTokenDataset` sharing this session's owners
        and placement (training batches ride the same region→device map
        the verbs maintain)."""
        from repro_torch.data.pipeline import ColocatedTokenDataset
        return ColocatedTokenDataset(
            self.table, self.devices, global_batch,
            placement=self.placement, seed=seed)

    def describe(self) -> str:
        m = self.metrics
        lines = [
            f"GridSession(table={self.table.name!r}, epoch={self._epoch}, "
            f"eta={self.default_eta}, imbalance={self.imbalance():.3f})",
            self.placement.describe(),
            f"  results: {m.plan_hits} hits / {m.plan_misses} misses; "
            f"engine compiles: {self.engine.compile_count}",
            f"  folds: {m.partials_folded} block partials folded "
            f"({m.rows_folded} rows), {m.partials_reused} reused, "
            f"{m.compact_scans} compact one-shots",
            f"  blocks: {self.blocks.describe()}",
            f"  queries: {m.scans} plans executed, {m.programs_fused} "
            f"programs fused, {m.payload_gathers} payload gather passes "
            f"({m.rows_gathered} rows gathered, "
            f"{m.pushdown_rows_gathered} pushdown rows)",
        ]
        return "\n".join(lines)
