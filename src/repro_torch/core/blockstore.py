"""BlockStore — content-addressed, copy-on-write device blocks per region.

Port of ``src/repro/core/blockstore.py`` (copied; a committed device block
is a torch tensor on its owner device, and every gauge counts its bytes).
Spill files and their CRC sidecars are byte-compatible with the reference.

The paper's core claim is data *colocation*: computation moves to where the
image blocks already live, so mutations and repeated queries must not re-ship
or re-pad data that did not change.  Before this module, the session's caches
worked at two coarser granularities and paid for it twice:

- whole-table layouts were re-``device_put`` monolithically after every
  mutation (clean devices' payload re-crossed the host↔device boundary), and
- pruned-scan plans each gathered their own private copy of the selected
  regions, so two overlapping scans shipped the shared regions twice.

The missing abstraction is a **block**: one region's rows of one column,
materialized once on the device that owns the region.  Blocks are

- **content-addressed** — keyed by ``(region signature, column, version)``
  where the *version* is the mutation epoch that last touched the region
  (its epoch-lineage).  A key never maps to two different payloads;
- **copy-on-write** — a mutation never edits a block in place.  It bumps the
  touched regions' versions (:meth:`BlockStore.touch`), so the next request
  under the new key gathers a fresh block while live consumers (cached scan
  plans, assembled layouts) keep their references to the old object;
- **shared** — every consumer (whole-table layouts across epochs, pruned
  scans across overlapping plans) asks the store first, so a block crosses
  the host→device boundary once per (content, owner device), not once per
  plan or per epoch.

Stacked on the payload blocks is the **partial cache**: each block's
MapReduce fold result (one tiny accumulator pytree), keyed ``(block
lineage, program, row-mask signature, η)``.  Content addressing carries
over — a mutation's version bump invalidates a block's partials with it,
while every other partial survives to be *merged* instead of re-folded.
This is what makes a repeat query fold zero payload rows.

Capacity is a **tier chain**, not a flat cap: device HBM → host RAM → disk
(mmap'd ``.npy`` files under a session spill dir), each tier bounded by a
byte budget (``None`` = unbounded, the pre-tiering behavior).  Under
pressure the coldest payload *demotes* one tier instead of vanishing —

- device over budget: the device copy is dropped (the host copy, pulled
  back from the device first if it was the only one, stays);
- host over budget: the host copy spills to an ``.npy`` file when the
  :class:`~repro_torch.core.chunk_model.TierCostModel` oracle says a local disk
  read beats re-fetching from the backing table, else it is dropped;
- disk over budget: the coldest spill file is deleted (the table remains
  the source of truth, so every demotion is loss-free);

and reads *promote* transparently: a fetch finds the highest tier holding
the content, re-materializing host views from spill files via
``np.load(mmap_mode="r")`` (the mmap is charged to the disk tier — it pins
no RAM).  Evicted **partials demote too**: instead of silently re-folding
on next use, an evicted partial is flattened to host leaves and written
beside the blocks when the oracle prefers a disk round-trip to a re-fold.
A background **prefetcher** overlaps ``device_put`` of next-needed
lower-tier blocks with in-flight folds; its fetch classification is
recorded and *claimed* by the next query's own fetch, so per-query
transfer/gather oracles stay exact.

The store is storage + versioning only: *gathering* a block from the table,
choosing its owner device, and *folding* partials stay with
:class:`~repro_torch.core.grid.GridSession` / the engine, which own placement and
compute.  An entry evicted out of every tier is simply re-gathered — and a
lost partial re-folded — on next use (regression tests assert
re-materialization is loss-free).

Since ``GridFrontend`` (``core/frontend.py``) serves queries from a
thread pool, the store is safe under **concurrent readers with serialized
mutators**: every cache is a locked :class:`LRUCache` whose iterating
helpers return point-in-time lists, compound operations (fetch, partial
index maintenance, touch/drop, tier enforcement) run under one store-level
re-entrant lock, and the cumulative counters are an :class:`AtomicStats`
whose ``inc`` is lock-protected and whose ``snapshot()`` gives a
consistent point-in-time copy for benches and tests.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.chunk_model import TierCostModel
from repro_torch.core.faults import (FaultInjector, RetryPolicy,
                               SpillCorruptionError)
from repro_torch.core.regions import Region

#: (region signature, family, qualifier, version) — the content address.
BlockKey = Tuple[Tuple[int, bytes, Optional[bytes]], str, str, int]

_MISSING = object()


def _unlink(path: Optional[str]) -> None:
    if not path:
        return
    try:
        os.unlink(path)
    except OSError:
        pass


def _sidecar(path: str) -> str:
    """The CRC manifest that travels with every spill file."""
    return path + ".crc"


def _unlink_spill(path: Optional[str]) -> None:
    """Delete a spill payload together with its CRC sidecar."""
    if not path:
        return
    _unlink(path)
    _unlink(_sidecar(path))


def _crc_file(path: str) -> int:
    """CRC-32 of a file's bytes, streamed (spill files can be large)."""
    crc = 0
    with open(path, "rb") as f:
        for buf in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def _payload_nbytes(value: Any) -> int:
    """Total array bytes in a (possibly nested) accumulator pytree — the
    weigher behind the partial cache's byte budget.  Works on numpy and
    torch leaves (both expose ``nbytes``)."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, dict):
        return sum(_payload_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_payload_nbytes(v) for v in value)
    return 0


class AtomicStats:
    """Lock-protected counter mixin for the cumulative stats dataclasses.

    Bare ``+=`` on a shared dataclass field is a read-modify-write race
    under concurrent readers (two threads both load N, both store N+1, one
    update is lost); every writer goes through :meth:`inc` instead, and
    readers that need a *consistent* multi-field view (benches summing
    hits+misses, tests asserting exact fold counts) take :meth:`snapshot`.
    Direct attribute reads stay valid for single-counter checks.
    """

    def __post_init__(self):
        object.__setattr__(self, "_lock", threading.Lock())

    def inc(self, **deltas: int) -> None:
        """Atomically add each ``field=delta`` (a single lock for the whole
        batch, so multi-counter updates can't be observed half-applied)."""
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def imax(self, **values: int) -> None:
        """Atomically raise each ``field`` to ``max(current, value)`` —
        the monotone update behind high-water marks (peak queue depth)."""
        with self._lock:
            for name, v in values.items():
                if v > getattr(self, name):
                    setattr(self, name, v)

    def snapshot(self) -> "AtomicStats":
        """A point-in-time copy (its own lock, detached from the live
        counters) — the consistent read side of :meth:`inc`."""
        with self._lock:
            fields = {f.name: getattr(self, f.name)
                      for f in dataclasses.fields(self)}
        return type(self)(**fields)


class LRUCache:
    """A bounded mapping with least-recently-used eviction.

    Shared by every cache this backend keeps per session — device blocks,
    bound scan plans, compiled executables — so long-lived mutating sessions
    stay memory-bounded.  ``get`` refreshes recency; ``put`` evicts the
    coldest entries and reports them to ``on_evict`` (used to count
    evictions, to spill partials, and to observe re-materialization in
    tests).

    Capacity is expressed two ways, independently optional:

    - ``cap`` — maximum entry COUNT.  ``None`` means unbounded; ``0``
      means disabled (nothing is ever admitted).
    - ``max_bytes`` — maximum total WEIGHT, where each entry weighs
      ``weigher(value)`` (default: the value's ``nbytes``, 0 if absent).
      ``None`` unbounded, ``0`` disabled.

    Eviction happens **before** insert: victims are chosen only while a
    budget is actually exceeded, so the incoming entry never forces the
    cache over budget even transiently.  An entry whose own weight exceeds
    ``max_bytes`` is never admitted at all — admitting it and then purging
    colder victims would empty the cache for an entry that cannot fit; it
    is reported to ``on_evict`` like an immediate eviction and ``put``
    returns ``False``.

    Thread-safe: every operation holds an internal re-entrant lock (``get``
    mutates recency order, so even reads are writes here), and the iterating
    helpers ``keys``/``values``/``items`` return **point-in-time lists** — a
    reader walking entries while another thread inserts must never trip
    ``RuntimeError: dict changed size during iteration``.
    """

    def __init__(self, cap: Optional[int], *,
                 max_bytes: Optional[int] = None,
                 weigher: Optional[Callable[[Any], int]] = None,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        if cap is not None and cap < 0:
            raise ValueError(f"LRU cap must be >= 0 or None, got {cap}")
        if max_bytes is not None and max_bytes < 0:
            raise ValueError(
                f"LRU max_bytes must be >= 0 or None, got {max_bytes}")
        self.cap = None if cap is None else int(cap)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._weigher = weigher or _payload_nbytes
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._w: Dict[Any, int] = {}
        self.nbytes = 0
        self._on_evict = on_evict
        self._lock = threading.RLock()
        self.evictions = 0
        self.evict_errors = 0

    def _notify_evict(self, key, value) -> None:
        """Fire ``on_evict`` without letting a raising hook corrupt the
        sweep: the entry's own accounting (``nbytes``/``_w``/count) is
        settled by the caller *before* the callback, so a hook failure is
        counted and swallowed — the byte gauge stays exact and remaining
        victims still evict instead of aborting the sweep mid-way."""
        if self._on_evict is None:
            return
        try:
            self._on_evict(key, value)
        except Exception:
            self.evict_errors += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def get(self, key, default=None):
        with self._lock:
            if key not in self._d:
                return default
            self._d.move_to_end(key)
            return self._d[key]

    def peek(self, key, default=None):
        """Read without refreshing recency (diagnostics / identity tests)."""
        with self._lock:
            return self._d.get(key, default)

    def put(self, key, value) -> bool:
        """Insert ``value`` under ``key``; returns whether it was admitted.

        ``False`` means the cache is disabled (``cap==0`` / ``max_bytes==0``)
        or the entry alone exceeds ``max_bytes`` — either way the value is
        reported to ``on_evict``, so demotion/unindex hooks observe every
        entry that leaves (or never enters) the cache exactly once."""
        with self._lock:
            w = self._weigher(value) if self.max_bytes is not None else 0
            disabled = self.cap == 0 or self.max_bytes == 0
            if disabled or (self.max_bytes is not None
                            and w > self.max_bytes):
                # reject up front: no set of colder victims could make this
                # entry fit.  A previous value under the same key is stale
                # now — drop it silently (one on_evict per key, not two).
                prev = self._d.pop(key, _MISSING)
                if prev is not _MISSING:
                    self.nbytes -= self._w.pop(key, 0)
                self.evictions += 1
                self._notify_evict(key, value)
                return False
            prev = self._d.pop(key, _MISSING)
            if prev is not _MISSING:
                self.nbytes -= self._w.pop(key, 0)
            # evict BEFORE insert: victims leave only while a budget is
            # actually exceeded
            while self._d and (
                    (self.cap is not None and len(self._d) >= self.cap)
                    or (self.max_bytes is not None
                        and self.nbytes + w > self.max_bytes)):
                k, v = self._d.popitem(last=False)
                self.nbytes -= self._w.pop(k, 0)
                self.evictions += 1
                self._notify_evict(k, v)
            self._d[key] = value
            if self.max_bytes is not None:
                self._w[key] = w
                self.nbytes += w
            return True

    def replace(self, key, value) -> bool:
        """Swap the value under an existing ``key`` IN PLACE — recency is
        preserved, so a tier demotion can downgrade a cold block without
        promoting it to hottest (which would make the next victim scan
        pick a different, warmer block and cycle).  No budget enforcement:
        callers replace with equal-or-lighter values."""
        with self._lock:
            if key not in self._d:
                return False
            self._d[key] = value
            if self.max_bytes is not None:
                self.nbytes -= self._w.get(key, 0)
                w = self._weigher(value)
                self._w[key] = w
                self.nbytes += w
            return True

    def pop(self, key, default=None):
        with self._lock:
            if key in self._d:
                self.nbytes -= self._w.pop(key, 0)
            return self._d.pop(key, default)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._w.clear()
            self.nbytes = 0

    def keys(self) -> List[Any]:
        with self._lock:
            return list(self._d.keys())

    def values(self) -> List[Any]:
        with self._lock:
            return list(self._d.values())

    def items(self) -> List[Tuple[Any, Any]]:
        with self._lock:
            return list(self._d.items())


@dataclasses.dataclass
class DeviceBlock:
    """One region's rows of one column, resident on the owning device.

    ``host`` is a private copy of the region's column rows (positions inside
    the table may shift under unrelated mutations; content cannot — any
    mutation to *this* region bumps its version and a new block is born).
    ``None`` after a host-tier demotion: the content then lives in the
    spill file and/or the device copy, and a tier-aware fetch
    re-materializes it.  ``device`` is the committed on-device copy
    (``None`` while host-only, e.g. on meshes where per-shard placement is
    unavailable, or after a device-tier demotion); ``device_index`` records
    which mesh shard it was committed to, so a rebalance that moves the
    region re-ships the block without re-reading the table.
    """

    rid: int
    family: str
    qualifier: str
    version: int
    rows: int                      # logical rows (the region's real rows)
    nbytes: int                    # logical host bytes (unpadded)
    host: Optional[np.ndarray]
    device: Any = None             # torch tensor on the owner device
    device_index: Optional[int] = None
    # physical bytes of the committed device copy (0 while host-only) —
    # larger than ``nbytes`` when the session commits blocks pre-padded to
    # the fold bucket; transfer/residency oracles report THIS, not the
    # logical size
    device_nbytes: int = 0
    # disk-tier state: the spilled ``.npy`` file (None while not spilled)
    # and its on-disk size.  ``host_mmap`` marks a ``host`` that is an
    # mmap-backed view of the spill file: charged to the disk tier, not
    # host RAM
    spill_path: Optional[str] = None
    spill_nbytes: int = 0
    host_mmap: bool = False


@dataclasses.dataclass
class BlockStoreStats(AtomicStats):
    """Cumulative store counters (session lifetime).  Evictions are not
    duplicated here — the LRU already counts them; read
    :attr:`BlockStore.evictions`.

    ``device_bytes`` / ``host_bytes`` / ``disk_bytes`` are per-tier
    resident-byte GAUGES (inc'd with signed deltas under the store lock),
    not monotone counters — they track exactly what each tier currently
    holds: committed device payload, real (non-mmap) host copies, and
    spill files (blocks + partials).

    Updates go through :meth:`AtomicStats.inc` (concurrent queries bump
    these from many threads); consistent multi-counter reads through
    :meth:`AtomicStats.snapshot`."""

    gathers: int = 0        # host payloads read from the table (store misses)
    transfers: int = 0      # host→device block transfers
    hits: int = 0           # requests served by a resident current block
    touches: int = 0        # region versions bumped by mutations
    host_reads: int = 0     # host-only fetches that re-read the table
    partial_hits: int = 0   # per-block fold partials served from the cache
    folds: int = 0          # per-block fold partials computed and stored
    gid_hits: int = 0       # per-region gid blocks served from the cache
    gid_builds: int = 0     # gid blocks densified (searchsorted) and stored
    # --- tier chain ---------------------------------------------------
    host_serves: int = 0    # fold fetches served host-side (payload larger
    #                         than the whole device budget: never committed)
    demotions: int = 0      # device payloads dropped under the device budget
    spills: int = 0         # host payloads written to the disk tier
    spill_reads: int = 0    # spill files re-opened (mmap) to serve a block
    spill_drops: int = 0    # payloads dropped entirely (no tier below)
    partial_spills: int = 0       # evicted partials demoted to disk
    partial_spill_reads: int = 0  # spilled partials promoted back to RAM
    prefetches: int = 0     # background tier promotions completed
    prefetch_hits: int = 0  # fetches served by claiming a prefetch record
    device_bytes: int = 0   # gauge: committed device payload bytes
    host_bytes: int = 0     # gauge: real (non-mmap) host copies
    disk_bytes: int = 0     # gauge: spill files on disk (blocks + partials)
    # --- fault tolerance ----------------------------------------------
    spill_corruptions: int = 0  # spill reads that failed CRC / vanished
    spill_recoveries: int = 0   # lost spills re-derived (device or table)
    retries: int = 0        # retry attempts consumed, all sites
    faults_injected: int = 0    # FaultInjector fires observed via on_fire
    quarantines: int = 0    # owner devices permanently quarantined


def _never_gather() -> np.ndarray:   # pragma: no cover - guarded by callers
    raise RuntimeError("prefetch must not gather from the table")


class BlockStore:
    """Versioned tiered cache of :class:`DeviceBlock`, the substrate under
    layouts.

    One instance per :class:`~repro_torch.core.grid.GridSession`.  The session
    funnels every block request through :meth:`fetch`, which classifies the
    outcome for the ``QueryStats`` oracles:

    - *reused*      — current version resident on the current owner device;
    - *transferred* — host payload was shipped to a device (either because
      the block was freshly gathered, or because a rebalance moved the
      region so the cached host copy re-commits to its new owner);
    - *gathered*    — the host payload itself had to be (re-)read from the
      table (a store miss for this content version).

    Every fetched block satisfies ``reused or transferred`` — which is the
    testable invariant ``blocks_reused + blocks_transferred == blocks_total``
    carried on ``QueryStats``.

    Tier budgets (all optional, bytes): ``device_budget`` bounds committed
    device payload, ``host_budget`` bounds real host copies,
    ``disk_budget`` bounds spill files under ``spill_dir``.  ``None``
    leaves a tier unbounded (the pre-tiering behavior); without a
    ``spill_dir`` the disk tier is disabled and host-tier pressure drops
    payloads (loss-free — the table is the source of truth).  Placement
    decisions consult ``cost_model``
    (:class:`~repro_torch.core.chunk_model.TierCostModel`).
    """

    #: completed-but-unclaimed prefetch records kept around (bounded; a
    #: mutation clears them wholesale)
    PREFETCH_RECORDS = 64

    def __init__(self, cap: Optional[int] = 256,
                 partial_cap: Optional[int] = 1024,
                 *,
                 device_budget: Optional[int] = None,
                 host_budget: Optional[int] = None,
                 disk_budget: Optional[int] = None,
                 partial_budget: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 cost_model: Optional[TierCostModel] = None,
                 prefetch_workers: int = 1,
                 fault_injector: Optional[FaultInjector] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        self._closed = False
        self.stats = BlockStoreStats()
        self.device_budget = device_budget
        self.host_budget = host_budget
        self.disk_budget = disk_budget
        self.cost_model = cost_model if cost_model is not None \
            else TierCostModel()
        self._faults = fault_injector
        self._retry = retry_policy
        self.spill_dir = spill_dir
        self._owns_spill_dir = False
        self.orphans_swept = 0
        if spill_dir is not None:
            self._owns_spill_dir = not os.path.isdir(spill_dir)
            os.makedirs(spill_dir, exist_ok=True)
            self.orphans_swept = self._sweep_orphans()
            if self._owns_spill_dir:
                # belt under close(): even on abnormal exit (exception,
                # SIGTERM-handled shutdown) the dir leaves with the
                # process.  Harmless double-removal after a clean close.
                atexit.register(shutil.rmtree, spill_dir,
                                ignore_errors=True)
        self._spill_seq = 0
        # one re-entrant lock serializes every compound cache operation
        # (fetch's get-then-put, the partial index maintenance, touch/drop
        # sweeps, tier enforcement); individual LRUCache ops are locked on
        # their own, but the invariants here span several of them
        self._lock = threading.RLock()
        self._blocks: LRUCache = LRUCache(
            cap, on_evict=self._on_block_evict)
        # per-block fold partials, keyed (BlockKey, program, mask sig, eta):
        # the compute-side cache that lets a repeat query fold zero rows.
        # Partials are tiny (one accumulator pytree per block), so their cap
        # is several times the block cap; an evicted partial demotes to the
        # disk tier when spill is enabled, else it just re-folds.
        self._partials: LRUCache = LRUCache(
            partial_cap, max_bytes=partial_budget,
            on_evict=self._on_partial_evict)
        # (rid, version) -> live partial count: keeps has_partials O(1)
        # (it runs once per surviving region on every cold selective scan).
        # Spilled partials stay indexed — they are still servable.
        self._partial_index: Dict[Tuple[int, int], int] = {}
        # spilled partials: partial key -> (path, charged bytes, treedef)
        self._spilled_partials: "OrderedDict[Tuple, Tuple[str, int, Any]]" \
            = OrderedDict()
        # densified per-region gid blocks keyed (key-column block lineage,
        # mapping signature): a dirty-region re-fold touches OTHER regions'
        # partials but still needs THIS region's gids — caching them skips
        # the np.searchsorted re-densification on every such fold.  Tiny
        # (int32 per row), so a few hundred entries cost ~nothing.
        self._gids: LRUCache = LRUCache(512)
        # region id -> mutation epoch that last changed its content
        self._versions: Dict[int, int] = {}
        # background promotion: in-flight keys (single-flight) and
        # completed-but-unclaimed (block, reused, gathered) records the
        # next fetch of the key claims, preserving per-query accounting
        self._prefetch_workers = max(0, int(prefetch_workers))
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._prefetch_inflight: Set[BlockKey] = set()
        self._prefetched: "OrderedDict[BlockKey, Tuple[DeviceBlock, bool, bool]]" = OrderedDict()  # noqa: E501

    @property
    def evictions(self) -> int:
        """Blocks dropped by the LRU cap (counted once, by the LRU)."""
        return self._blocks.evictions

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Release tier resources: stop the prefetcher, delete every spill
        file, and remove the spill dir if this store created it.  The
        store stays usable afterwards as a pure in-memory cache."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pool, self._prefetch_pool = self._prefetch_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        with self._lock:
            for k, blk in self._blocks.items():
                if blk.spill_path:
                    self._drop_spill_file(k, blk)
            for key in list(self._spilled_partials):
                self._drop_spilled_partial(key)
        if self._owns_spill_dir and self.spill_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __del__(self):   # pragma: no cover - interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # epoch lineage
    # ------------------------------------------------------------------

    def version_of(self, rid: int) -> int:
        """The region's content version: the epoch of its last mutation
        (0 for regions never touched since the session opened)."""
        return self._versions.get(rid, 0)

    def touch(self, rids: Iterable[int], epoch: int) -> None:
        """Copy-on-write bump: mutated regions move to version ``epoch``.

        Superseded cache entries are dropped eagerly (they can never hit
        again); block objects stay alive wherever consumers still hold them.
        """
        with self._lock:
            touched = {int(rid) for rid in rids}
            for rid in touched:
                self._versions[rid] = int(epoch)
            self.stats.inc(touches=len(touched))
            doomed = [k for k in self._blocks.keys()
                      if k[0][0] in touched
                      and k[3] != self._versions[k[0][0]]]
            for k in doomed:
                self._drop_block(k)
            # superseded fold partials are as dead as their blocks: the
            # partial key embeds the block version, so they can never hit
            # again
            doomed_p = [k for k in self._partials.keys()
                        if k[0][0][0] in touched
                        and k[0][3] != self._versions[k[0][0][0]]]
            for k in doomed_p:
                self._pop_partial(k)
            doomed_sp = [k for k in self._spilled_partials
                         if k[0][0][0] in touched
                         and k[0][3] != self._versions[k[0][0][0]]]
            for k in doomed_sp:
                self._drop_spilled_partial(k)
            # superseded gid blocks die with their key-column block lineage
            doomed_g = [k for k in self._gids.keys()
                        if k[0][0][0] in touched
                        and k[0][3] != self._versions[k[0][0][0]]]
            for k in doomed_g:
                self._gids.pop(k)
            # unclaimed prefetch records may reference superseded content
            self._prefetched.clear()

    def drop_regions(self, rids: Iterable[int]) -> None:
        """Forget regions that no longer exist (split parents): their rids
        never reappear in the region set, so their blocks could otherwise
        pin host+device payload until cap pressure that may never come."""
        doomed_rids = {int(rid) for rid in rids}
        if not doomed_rids:
            return
        with self._lock:
            for k in [k for k in self._blocks.keys()
                      if k[0][0] in doomed_rids]:
                self._drop_block(k)
            for k in [k for k in self._partials.keys()
                      if k[0][0][0] in doomed_rids]:
                self._pop_partial(k)
            for k in [k for k in self._spilled_partials
                      if k[0][0][0] in doomed_rids]:
                self._drop_spilled_partial(k)
            for k in [k for k in self._gids.keys()
                      if k[0][0][0] in doomed_rids]:
                self._gids.pop(k)
            for rid in doomed_rids:
                self._versions.pop(rid, None)
            self._prefetched.clear()

    def lineage(self, regions: Iterable[Region]) -> Tuple[Tuple[int, int], ...]:
        """``((rid, version), ...)`` — the epoch-lineage signature of a
        region set.  Two plans over the same regions at the same versions may
        share everything; any difference forces a re-bind."""
        return tuple((r.rid, self.version_of(r.rid)) for r in regions)

    # ------------------------------------------------------------------
    # tier accounting
    # ------------------------------------------------------------------

    def _charge(self, device: int = 0, host: int = 0, disk: int = 0) -> None:
        """Apply signed deltas to the per-tier resident-byte gauges."""
        if device or host or disk:
            self.stats.inc(device_bytes=device, host_bytes=host,
                           disk_bytes=disk)

    @staticmethod
    def _block_charges(blk: DeviceBlock) -> Tuple[int, int, int]:
        """What this block currently contributes to each tier gauge."""
        dev = blk.device_nbytes if blk.device is not None else 0
        host = (blk.nbytes
                if blk.host is not None and not blk.host_mmap else 0)
        disk = blk.spill_nbytes if blk.spill_path is not None else 0
        return dev, host, disk

    def _on_block_evict(self, key, blk: DeviceBlock) -> None:
        """LRU-cap eviction hook: release every tier charge and the spill
        file (always fired under the store lock — every ``_blocks``
        mutation happens inside a compound store operation)."""
        d, h, k = self._block_charges(blk)
        self._charge(device=-d, host=-h, disk=-k)
        _unlink_spill(blk.spill_path)

    def _drop_block(self, key) -> None:
        """Pop one block and settle its tier charges (the non-LRU removal
        path: touch / drop_regions / clear / disk-tier drops)."""
        blk = self._blocks.pop(key)
        if blk is not None:
            self._on_block_evict(key, blk)

    def _put_and_charge(self, key, blk: DeviceBlock,
                        prev: Tuple[int, int, int] = (0, 0, 0)) -> None:
        """Insert/replace a block AND settle the tier gauges in one step.

        ``prev`` is what the superseded entry under the same key (if any)
        was charging.  Charging happens BEFORE the put: if the cache
        rejects the entry (``cap == 0``), its ``on_evict`` negates the new
        charges and the net effect is exactly ``-prev`` — the old entry
        left, the new one never became resident.  If the put is admitted,
        the delta stands and any *victims* it evicts settle through their
        own ``on_evict``."""
        d, h, k = self._block_charges(blk)
        self._charge(device=d - prev[0], host=h - prev[1], disk=k - prev[2])
        self._blocks.put(key, blk)

    def _new_spill_path(self, kind: str, suffix: str) -> str:
        self._spill_seq += 1
        return os.path.join(self.spill_dir,
                            f"{kind}-{self._spill_seq:06d}{suffix}")

    # ------------------------------------------------------------------
    # checksummed, crash-consistent spill I/O
    # ------------------------------------------------------------------

    def _sweep_orphans(self) -> int:
        """Startup crash-consistency sweep of the spill dir: delete
        half-written ``*.tmp`` files (a crash mid-write; ``os.replace``
        guarantees the final name is never half-written) and CRC sidecars
        whose payload is gone (a crash between payload unlink and sidecar
        unlink).  Returns the number of orphans removed."""
        try:
            names = os.listdir(self.spill_dir)
        except OSError:
            return 0
        present = set(names)
        removed = 0
        for name in names:
            full = os.path.join(self.spill_dir, name)
            if name.endswith(".tmp"):
                _unlink(full)
                removed += 1
            elif name.endswith(".crc") and name[:-4] not in present:
                _unlink(full)
                removed += 1
        return removed

    def _write_spill(self, path: str,
                     writer: Callable[[Any], None]) -> int:
        """Crash-consistent spill write: ``writer(file)`` fills a ``.tmp``
        sibling (an open file object, so numpy does not append its own
        extension), the CRC manifest is computed from the temp bytes, and
        ``os.replace`` publishes payload then sidecar atomically — a crash
        at any point leaves either nothing under the final name or a
        complete, verifiable pair (plus temps the startup sweep removes).
        Returns the payload's on-disk size.  Transient injected faults are
        retried under the store's policy; the final failure propagates so
        callers fall back to their lossy path."""
        def attempt() -> int:
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    writer(f)
                crc = _crc_file(tmp)
                sz = int(os.path.getsize(tmp))
                os.replace(tmp, path)
            except BaseException:
                _unlink(tmp)
                raise
            side = _sidecar(path)
            stmp = side + ".tmp"
            try:
                with open(stmp, "w") as f:
                    f.write(f"{crc:08x} {sz}\n")
                os.replace(stmp, side)
            except BaseException:
                _unlink(stmp)
                raise
            if self._faults is not None:
                # fired after publication so file-mangling fault kinds hit
                # the real spill file; the CRC check catches them on read
                self._faults.fire("spill_write", path=path)
            return sz

        if self._retry is not None:
            return self._retry.call(
                attempt, key=path,
                on_retry=lambda e, a: self.stats.inc(retries=1))
        return attempt()

    def _verify_spill(self, path: str) -> None:
        """Check a spill file against its CRC sidecar; raises
        :class:`SpillCorruptionError` on any mismatch, truncation, or a
        missing/unreadable file or sidecar."""
        side = _sidecar(path)
        try:
            with open(side, "r") as f:
                tok = f.read().split()
            want_crc, want_sz = int(tok[0], 16), int(tok[1])
        except (OSError, ValueError, IndexError):
            raise SpillCorruptionError(path, "missing/unreadable sidecar")
        try:
            have_sz = os.path.getsize(path)
        except OSError:
            raise SpillCorruptionError(path, "spill file missing")
        if have_sz != want_sz:
            raise SpillCorruptionError(
                path, f"size {have_sz} != {want_sz} (truncated?)")
        if _crc_file(path) != want_crc:
            raise SpillCorruptionError(path)

    def _read_spill_block(self, path: str) -> Optional[np.ndarray]:
        """Open one block spill file as a verified read-only mmap.
        ``None`` means the file is corrupt, truncated, or gone (or
        transient read faults exhausted their retries) — callers treat
        that as the tier being empty and recover from the next one."""
        def attempt():
            if self._faults is not None:
                self._faults.fire("spill_read", path=path)
            self._verify_spill(path)
            return np.load(path, mmap_mode="r")
        try:
            if self._retry is not None:
                return self._retry.call(
                    attempt, key=path,
                    on_retry=lambda e, a: self.stats.inc(retries=1))
            return attempt()
        except Exception:
            return None

    # ------------------------------------------------------------------
    # tier enforcement (demotions)
    # ------------------------------------------------------------------

    def _coldest(self, pred: Callable[[DeviceBlock], bool]
                 ) -> Optional[Tuple[Any, DeviceBlock]]:
        for k, b in self._blocks.items():    # coldest-first, point-in-time
            if pred(b):
                return k, b
        return None

    def _enforce_tiers(self) -> None:
        """Demote coldest payloads until every tier fits its byte budget.

        Runs under the store lock after any insertion/promotion, so
        *between* public store operations no tier gauge ever exceeds its
        budget.  Demotions cascade downward (device → host → disk → gone);
        every step is loss-free because the table remains authoritative."""
        if self.device_budget is not None:
            while self.stats.device_bytes > self.device_budget:
                victim = self._coldest(lambda b: b.device is not None)
                if victim is None:
                    break
                self._demote_device(*victim)
        if self.host_budget is not None:
            while self.stats.host_bytes > self.host_budget:
                victim = self._coldest(
                    lambda b: b.host is not None and not b.host_mmap)
                if victim is None:
                    break
                self._demote_host(*victim)
        if self.disk_budget is not None:
            self._enforce_disk()

    def _demote_device(self, key, blk: DeviceBlock) -> None:
        """Drop one block's device payload; the content survives one tier
        down.  COW: the cache entry is replaced in place (recency kept),
        never mutated — in-flight folds keep their device arrays alive."""
        if blk.host is None and blk.spill_path is None:
            # the device copy is the only one: pull it back to host first,
            # else the content would silently become a table re-read
            got = self._ensure_host(key, blk)
            assert got is not None   # the device copy guarantees a tier
            blk = got
        new = dataclasses.replace(blk, device=None, device_index=None,
                                  device_nbytes=0)
        self._blocks.replace(key, new)
        self._charge(device=-(blk.device_nbytes))
        self.stats.inc(demotions=1)

    def _demote_host(self, key, blk: DeviceBlock) -> None:
        """Demote one block's real host copy: spill to disk when the cost
        oracle prefers a local disk read to a table re-fetch, else drop."""
        if blk.spill_path is not None:
            # already on disk: just release the RAM copy
            new = dataclasses.replace(blk, host=None, host_mmap=False)
            self._blocks.replace(key, new)
            self._charge(host=-blk.nbytes)
            return
        if (self.spill_dir is not None and not self._closed
                and self.cost_model.should_spill_block(blk.nbytes)):
            path = self._new_spill_path("blk", ".npy")
            try:
                sz = self._write_spill(
                    path, lambda f: np.save(f, np.asarray(blk.host)))
            except Exception:
                # spill write failed outright (retries exhausted / disk
                # error): fall through to the lossy drop path below —
                # the table stays authoritative either way
                _unlink_spill(path)
                sz = None
            if sz is not None:
                new = dataclasses.replace(blk, host=None, host_mmap=False,
                                          spill_path=path, spill_nbytes=sz)
                self._blocks.replace(key, new)
                self._charge(host=-blk.nbytes, disk=sz)
                self.stats.inc(spills=1)
                self._enforce_disk_if_bounded()
                return
        # no disk tier below (or the oracle prefers re-gathering): drop the
        # payload; a block left with no payload at all leaves entirely and
        # re-gathers losslessly on next use
        if blk.device is not None:
            new = dataclasses.replace(blk, host=None, host_mmap=False)
            self._blocks.replace(key, new)
            self._charge(host=-blk.nbytes)
        else:
            self._drop_block(key)
        self.stats.inc(spill_drops=1)

    def _enforce_disk_if_bounded(self) -> None:
        if self.disk_budget is not None:
            self._enforce_disk()

    def _enforce_disk(self) -> None:
        while self.stats.disk_bytes > self.disk_budget:
            victim = self._coldest(lambda b: b.spill_path is not None)
            if victim is not None:
                key, blk = victim
                self._drop_spill_file(key, blk)
                self.stats.inc(spill_drops=1)
                continue
            if self._spilled_partials:
                # spilled partials go after block files: losing one costs a
                # re-fold, losing a block file only a table re-read
                k = next(iter(self._spilled_partials))
                self._drop_spilled_partial(k)
                continue
            break

    def _drop_spill_file(self, key, blk: DeviceBlock) -> None:
        """Delete one block's spill file (and any mmap view of it); the
        block survives only if another tier still holds the content."""
        _unlink_spill(blk.spill_path)
        self._charge(disk=-blk.spill_nbytes)
        keep_host = blk.host is not None and not blk.host_mmap
        new = dataclasses.replace(
            blk, spill_path=None, spill_nbytes=0,
            host=blk.host if keep_host else None, host_mmap=False)
        self._blocks.replace(key, new)
        if new.host is None and new.device is None:
            self._drop_block(key)   # remaining charges are zero by now

    # ------------------------------------------------------------------
    # tier promotion (reads walk down the chain)
    # ------------------------------------------------------------------

    def _ensure_host(self, key, blk: DeviceBlock) -> Optional[DeviceBlock]:
        """Re-materialize ``blk.host`` from the highest tier holding the
        content: spill file (as a verified read-only mmap, charged to
        disk) first, else the device copy (a real RAM copy, charged to
        host).  Returns the possibly-replaced cache entry — or ``None``
        when the only tier was a spill file that failed its CRC check (or
        vanished): the record is dropped and the caller re-derives the
        content losslessly from the table."""
        if blk.host is not None:
            return blk
        recovering = False
        if blk.spill_path is not None:
            host = self._read_spill_block(blk.spill_path)
            if host is not None:
                new = dataclasses.replace(blk, host=host, host_mmap=True)
                self._blocks.replace(key, new)
                self.stats.inc(spill_reads=1)
                return new
            # corrupt / truncated / deleted spill: detach it and fall
            # back to the next tier down
            self.stats.inc(spill_corruptions=1)
            _unlink_spill(blk.spill_path)
            self._charge(disk=-blk.spill_nbytes)
            blk = dataclasses.replace(blk, spill_path=None, spill_nbytes=0)
            self._blocks.replace(key, blk)
            recovering = True
        if blk.device is not None:
            host = np.ascontiguousarray(
                blk.device[:blk.rows].detach().cpu().numpy())
            host.flags.writeable = False
            new = dataclasses.replace(blk, host=host, host_mmap=False)
            if self._blocks.replace(key, new):
                self._charge(host=new.nbytes)
            if recovering:
                self.stats.inc(spill_recoveries=1)
            return new
        if recovering:
            # no tier left holding the content: drop the record (its
            # charges are zero by now) and let the caller re-gather
            self._drop_block(key)
            return None
        raise AssertionError(    # pragma: no cover - payload-less blocks
            "block with no payload in any tier")  # are dropped eagerly

    # ------------------------------------------------------------------
    # block access
    # ------------------------------------------------------------------

    def key_of(self, region: Region, family: str, qualifier: str) -> BlockKey:
        return (region.signature, family, qualifier,
                self.version_of(region.rid))

    def _gather_block(self, key: BlockKey, region: Region, family: str,
                      qualifier: str,
                      gather_host: Callable[[], np.ndarray]) -> DeviceBlock:
        """Gather one region column from the table into a fresh host block
        (the content-miss path, shared with spill-corruption recovery)."""
        host = np.ascontiguousarray(gather_host())
        host.flags.writeable = False
        blk = DeviceBlock(
            rid=region.rid, family=family, qualifier=qualifier,
            version=key[3], rows=int(host.shape[0]),
            nbytes=int(host.nbytes), host=host,
        )
        self.stats.inc(gathers=1)
        self._put_and_charge(key, blk)
        return blk

    def peek(self, region: Region, family: str,
             qualifier: str) -> Optional[DeviceBlock]:
        """Current-version block without touching recency (identity tests)."""
        return self._blocks.peek(self.key_of(region, family, qualifier))

    def _claim_prefetch(self, key: BlockKey, owner_index: Optional[int]
                        ) -> Optional[Tuple[DeviceBlock, bool, bool]]:
        """Pop a completed prefetch record for ``key`` so THIS fetch
        reports the classification the background promotion earned —
        per-query transfer/gather oracles attribute the work to the query
        that consumed it, exactly as if it had fetched synchronously."""
        rec = self._prefetched.pop(key, None)
        if rec is None:
            return None
        blk = rec[0]
        if blk.device is None or blk.device_index != owner_index:
            return None              # stale (e.g. rebalanced since): discard
        self._blocks.get(key)        # the claim is a use: refresh recency
        return rec

    def fetch(
        self,
        region: Region,
        family: str,
        qualifier: str,
        owner_index: Optional[int],
        gather_host: Callable[[], np.ndarray],
        to_device: Optional[Callable[[np.ndarray, Optional[int]], Any]],
    ) -> Tuple[DeviceBlock, bool, bool]:
        """Return ``(block, reused, gathered)`` for the current version.

        ``gather_host`` reads the region's column rows from the table (called
        only on a content miss).  ``to_device`` commits a host payload to the
        shard ``owner_index`` (``None`` disables device residency — the
        host-assembly fallback for meshes without per-shard placement).
        ``reused`` means no host→device transfer happened; ``gathered`` means
        the table was re-read.  ``not reused`` implies a transfer, so every
        fetch is exactly one of reused / transferred.

        Reads walk the tier chain transparently: a block whose host copy
        was demoted re-materializes from its spill file (mmap) or device
        copy before use, and a completed background prefetch of the key is
        claimed here with its original classification.
        """
        with self._lock:
            key = self.key_of(region, family, qualifier)
            if to_device is not None:
                rec = self._claim_prefetch(key, owner_index)
                if rec is not None:
                    self.stats.inc(prefetch_hits=1)
                    return rec
            blk = self._blocks.get(key)
            gathered = False
            if blk is None:
                blk = self._gather_block(key, region, family, qualifier,
                                         gather_host)
                gathered = True
            if to_device is None:
                # host-only fallback: every layout build re-ships the whole
                # assembled array, so no block is ever device-"reused" — a
                # content hit only avoids the table re-read.  Classifying
                # each fetch as transferred keeps payload_bytes_transferred
                # honest about what actually crosses host→device here.
                if not gathered:
                    self.stats.inc(hits=1)
                got = self._ensure_host(key, blk)
                if got is None:
                    # spill lost every copy: re-derive from the table
                    got = self._gather_block(key, region, family,
                                             qualifier, gather_host)
                    gathered = True
                    self.stats.inc(spill_recoveries=1)
                blk = got
                self.stats.inc(transfers=1)
                self._enforce_tiers()
                return blk, False, gathered

            if blk.device is not None and blk.device_index == owner_index:
                self.stats.inc(hits=1)
                return blk, True, False
            got = self._ensure_host(key, blk)
            if got is None:
                got = self._gather_block(key, region, family, qualifier,
                                         gather_host)
                gathered = True
                self.stats.inc(spill_recoveries=1)
            blk = got
            if (self.device_budget is not None
                    and blk.nbytes > self.device_budget):
                # larger than the whole device tier: committing would only
                # demote it straight back, so serve the fold host-side.
                # Classified as transferred (the payload still moves into
                # the fold), keeping gather ⟹ transfer intact.
                self.stats.inc(host_serves=1)
                self._enforce_tiers()
                return blk, False, gathered
            # fresh gather, a rebalance moved the region, or the device
            # payload was demoted: (re-)commit the host copy to its current
            # owner.  COW: a re-homed cached block is replaced, not mutated
            # — older consumers keep the old one.
            cached = self._blocks.peek(key)
            prev = self._block_charges(cached) if cached is not None \
                else (0, 0, 0)
            if blk.device is not None:
                blk = dataclasses.replace(blk)
            blk.device = to_device(blk.host, owner_index)
            blk.device_index = owner_index
            blk.device_nbytes = int(getattr(blk.device, "nbytes", blk.nbytes))
            self.stats.inc(transfers=1)
            self._put_and_charge(key, blk, prev)
            self._enforce_tiers()
            return blk, False, gathered

    def fetch_host(
        self,
        region: Region,
        family: str,
        qualifier: str,
        gather_host: Callable[[], np.ndarray],
    ) -> Tuple[DeviceBlock, bool]:
        """Current-version host payload WITHOUT device commitment — the
        retrieve path.  Returns ``(block, gathered)``; a later :meth:`fetch`
        for the fold path commits the same block to its owner device, so
        retrieve-heavy workloads and folds share one gather per content.

        Tier-aware: a host copy demoted to disk is served back as a
        read-only mmap view of its spill file; one demoted all the way out
        re-gathers from the table (loss-free)."""
        with self._lock:
            key = self.key_of(region, family, qualifier)
            blk = self._blocks.get(key)
            if blk is not None:
                self.stats.inc(hits=1)
                got = self._ensure_host(key, blk)
                if got is None:
                    # spill lost every copy: re-derive from the table
                    got = self._gather_block(key, region, family,
                                             qualifier, gather_host)
                    self.stats.inc(host_reads=1, spill_recoveries=1)
                    self._enforce_tiers()
                    return got, True
                self._enforce_tiers()
                return got, False
            blk = self._gather_block(key, region, family, qualifier,
                                     gather_host)
            self.stats.inc(host_reads=1)
            self._enforce_tiers()
            return blk, True

    # ------------------------------------------------------------------
    # background prefetch (tier promotion overlapped with folds)
    # ------------------------------------------------------------------

    @property
    def prefetch_enabled(self) -> bool:
        return self._prefetch_workers > 0 and not self._closed

    def _ensure_prefetch_pool(self) -> ThreadPoolExecutor:
        if self._prefetch_pool is None:
            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=self._prefetch_workers,
                thread_name_prefix="blockstore-prefetch")
        return self._prefetch_pool

    def prefetch(self, region: Region, family: str, qualifier: str,
                 owner_index: Optional[int],
                 to_device: Optional[Callable[[np.ndarray, Optional[int]],
                                              Any]]) -> bool:
        """Schedule background promotion of a lower-tier-resident block to
        its owner device; returns whether a job was enqueued.

        Promotion only: a block the store has never gathered is left to the
        query's own fetch (so table-read accounting stays with the epoch's
        first reader, and no table access ever races a mutation).  The
        completed ``(block, reused, gathered)`` record is claimed by the
        next :meth:`fetch` of the key — concurrent coalesced queries share
        one promotion through the in-flight single-flight set."""
        if not self.prefetch_enabled or to_device is None:
            return False
        with self._lock:
            key = self.key_of(region, family, qualifier)
            blk = self._blocks.peek(key)
            if blk is None or (blk.device is not None
                               and blk.device_index == owner_index):
                return False
            if (self.device_budget is not None
                    and blk.nbytes > self.device_budget):
                return False         # can never be device-resident
            if key in self._prefetch_inflight or key in self._prefetched:
                return False
            self._prefetch_inflight.add(key)
            pool = self._ensure_prefetch_pool()
        pool.submit(self._prefetch_job, key, region, family, qualifier,
                    owner_index, to_device)
        return True

    def _prefetch_job(self, key: BlockKey, region: Region, family: str,
                      qualifier: str, owner_index: Optional[int],
                      to_device) -> None:
        try:
            with self._lock:
                if self._closed:
                    return
                if self.key_of(region, family, qualifier) != key:
                    return           # superseded by a mutation meanwhile
                if self._blocks.peek(key) is None:
                    return           # evicted meanwhile: nothing to promote
                rec = self.fetch(region, family, qualifier, owner_index,
                                 gather_host=_never_gather,
                                 to_device=to_device)
                if not rec[1]:       # a transfer actually happened
                    self._prefetched[key] = rec
                    while len(self._prefetched) > self.PREFETCH_RECORDS:
                        self._prefetched.popitem(last=False)
                    self.stats.inc(prefetches=1)
        except Exception:            # pragma: no cover - promotion is
            pass                     # best-effort; the query path recovers
        finally:
            with self._lock:
                self._prefetch_inflight.discard(key)

    # ------------------------------------------------------------------
    # fold partials (the compute-side cache of the block-granular engine)
    # ------------------------------------------------------------------

    def partial_key(self, region: Region, family: str, qualifier: str,
                    program_key: Tuple, mask_sig: str, eta: int,
                    group_sig: str = "", impl: str = "") -> Tuple:
        """The content address of one block's fold partial: block lineage
        (signature + version) × program × row-mask signature × η × group-key
        signature × fold implementation.  Any mutation to the region bumps
        the embedded version; any change to the selected-row subset changes
        ``mask_sig`` — either way the key becomes unmatchable and the
        partial re-folds.

        ``group_sig`` (grouped plans only) signs the group column AND the
        global value→group-id mapping: a block's group-keyed partial is
        only valid under the exact mapping it was folded with, since gid
        assignment depends on which key values the whole selection
        contains.  Ungrouped partials keep ``""``.

        ``impl`` distinguishes fold implementations whose partials agree
        only up to float accumulation order (the fused Pallas kernel vs
        the XLA scan): flipping ``engine.fold_impl`` mid-session must not
        merge partials folded under different orders.  The XLA path keeps
        ``""``, so existing keys are unchanged.
        """
        return (self.key_of(region, family, qualifier),
                program_key, mask_sig, int(eta), group_sig, impl)

    @staticmethod
    def _partial_rid_version(key: Tuple) -> Tuple[int, int]:
        return key[0][0][0], key[0][3]

    def _unindex_partial(self, key: Tuple) -> None:
        with self._lock:
            k = self._partial_rid_version(key)
            n = self._partial_index.get(k, 0) - 1
            if n <= 0:
                self._partial_index.pop(k, None)
            else:
                self._partial_index[k] = n

    def _pop_partial(self, key: Tuple) -> None:
        with self._lock:
            if self._partials.pop(key) is not None:
                self._unindex_partial(key)

    def _on_partial_evict(self, key: Tuple, value) -> None:
        """Partial-cache eviction hook (fires under both the LRU and —
        because every ``_partials`` insert runs inside a store compound op
        — the store lock): demote to the disk tier when spill is enabled
        and the oracle prefers a disk round-trip to a re-fold, else
        unindex (the partial is gone and will re-fold)."""
        if self.spill_dir is not None and not self._closed:
            src = self._blocks.peek(key[0])
            block_nbytes = src.nbytes if src is not None else 0
            if self.cost_model.should_spill_partial(
                    _payload_nbytes(value), block_nbytes):
                try:
                    self._spill_partial(key, value)
                    return
                except Exception:    # pragma: no cover - fall through to
                    pass             # the lossy path on any I/O failure
        self._unindex_partial(key)

    def _spill_partial(self, key: Tuple, value) -> None:
        # lazy import: mapreduce imports this module at load time
        from repro_torch.core.mapreduce import partial_to_host
        leaves, treedef = partial_to_host(value)
        path = self._new_spill_path("part", ".npz")
        try:
            sz = self._write_spill(path, lambda f: np.savez(f, *leaves))
        except BaseException:
            _unlink_spill(path)
            raise
        old = self._spilled_partials.pop(key, None)
        if old is not None:          # re-spill: replace the stale file
            _unlink_spill(old[0])
            self._charge(disk=-old[1])
        self._spilled_partials[key] = (path, sz, treedef)
        self._charge(disk=sz)
        self.stats.inc(partial_spills=1)
        self._enforce_disk_if_bounded()

    def _discard_spilled_record(self, key: Tuple) -> bool:
        """Remove a spilled-partial file WITHOUT unindexing — for callers
        that keep the key servable (fresh re-fold, RAM promotion)."""
        rec = self._spilled_partials.pop(key, None)
        if rec is None:
            return False
        _unlink_spill(rec[0])
        self._charge(disk=-rec[1])
        return True

    def _drop_spilled_partial(self, key: Tuple) -> None:
        if self._discard_spilled_record(key):
            self._unindex_partial(key)

    def get_partial(self, key: Tuple):
        p = self._partials.get(key)
        if p is not None:
            self.stats.inc(partial_hits=1)
            return p
        with self._lock:
            rec = self._spilled_partials.pop(key, None)
            if rec is None:
                return None
            path, sz, treedef = rec
            from repro_torch.core.mapreduce import partial_from_host

            def read_npz():
                if self._faults is not None:
                    self._faults.fire("spill_read", path=path)
                self._verify_spill(path)
                with np.load(path) as z:
                    leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
                return partial_from_host(leaves, treedef)

            try:
                if self._retry is not None:
                    value = self._retry.call(
                        read_npz, key=path,
                        on_retry=lambda e, a: self.stats.inc(retries=1))
                else:
                    value = read_npz()
            except Exception:
                # corrupt/lost spilled partial: drop it and report a plain
                # miss — the caller re-folds losslessly from the payload
                self.stats.inc(spill_corruptions=1)
                self._charge(disk=-sz)
                self._unindex_partial(key)
                _unlink_spill(path)
                return None
            self._charge(disk=-sz)
            _unlink_spill(path)
            self.stats.inc(partial_hits=1, partial_spill_reads=1)
            # promote back into the RAM cache WITHOUT re-counting a fold or
            # re-indexing (the spilled entry stayed indexed); byte pressure
            # may demote something else — or re-spill this one — via the
            # eviction hook
            self._partials.put(key, value)
            return value

    def put_partial(self, key: Tuple, value) -> None:
        with self._lock:
            self.stats.inc(folds=1)
            if key in self._spilled_partials:
                # a fresh fold supersedes the spilled copy; discard the
                # file but KEEP the index entry (the key stays counted
                # once, now by the RAM copy)
                self._discard_spilled_record(key)
            elif key not in self._partials:
                k = self._partial_rid_version(key)
                self._partial_index[k] = self._partial_index.get(k, 0) + 1
            self._partials.put(key, value)

    def peek_partial(self, key: Tuple) -> bool:
        """Whether a partial is servable (RAM or spilled) without touching
        recency or stats — the prefetch planner's probe."""
        if self._partials.peek(key) is not None:
            return True
        with self._lock:
            return key in self._spilled_partials

    def has_partials(self, rid: int) -> bool:
        """Any cached partial for the region's current content (a reuse
        signal the adaptive gather consults before going compact)."""
        return (rid, self.version_of(rid)) in self._partial_index

    # ------------------------------------------------------------------
    # gid blocks (densified group ids per region × mapping)
    # ------------------------------------------------------------------

    def gid_key(self, region: Region, family: str, qualifier: str,
                group_sig: str) -> Tuple:
        """Content address of one region's densified gid block: the KEY
        column's block lineage × the global value→gid mapping signature.
        A mutation to the region bumps the embedded version; a selection
        whose value universe differs carries another ``group_sig`` —
        either way the stale gids can never be served again."""
        return (self.key_of(region, family, qualifier), group_sig)

    def get_gids(self, region: Region, family: str, qualifier: str,
                 group_sig: str) -> Optional[np.ndarray]:
        g = self._gids.get(self.gid_key(region, family, qualifier,
                                        group_sig))
        if g is not None:
            self.stats.inc(gid_hits=1)
        return g

    def put_gids(self, region: Region, family: str, qualifier: str,
                 group_sig: str, gids: np.ndarray) -> None:
        self.stats.inc(gid_builds=1)
        g = np.ascontiguousarray(gids, dtype=np.int32)
        g.flags.writeable = False
        self._gids.put(self.gid_key(region, family, qualifier, group_sig), g)

    @property
    def gid_count(self) -> int:
        return len(self._gids)

    def clear_partials(self) -> None:
        with self._lock:
            # a wholesale clear DISCARDS — detach the spill records first
            # so the LRU clear (which fires no on_evict) matches them
            for key in list(self._spilled_partials):
                self._drop_spilled_partial(key)
            self._partials.clear()
            self._partial_index.clear()
            self._gids.clear()

    def clear(self) -> None:
        """Drop every cached block AND partial (versions survive, so
        content addressing stays monotonic); consumers re-gather and
        re-fold losslessly on next use.  Benchmarks use this to time the
        cold-data regime without rebuilding sessions."""
        with self._lock:
            for k in self._blocks.keys():
                self._drop_block(k)
            self.clear_partials()
            self._prefetched.clear()

    @property
    def partial_count(self) -> int:
        return len(self._partials)

    @property
    def spilled_partial_count(self) -> int:
        with self._lock:
            return len(self._spilled_partials)

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------

    @property
    def cap(self) -> Optional[int]:
        return self._blocks.cap

    def __len__(self) -> int:
        return len(self._blocks)

    def resident_nbytes(self) -> int:
        """Physical bytes the store pins in RAM/HBM, summed **per payload
        actually held**: the host copy counts iff present (and a real copy,
        not an mmap view of a spill file), the device copy iff committed.
        Pre-tiering this summed ``nbytes + device_nbytes`` unconditionally,
        over-reporting every single-payload block (host-only after a device
        demotion, or device-only commits whose host side was demoted).
        Disk-tier bytes pin no memory — read ``tier_bytes()['disk']``."""
        total = 0
        for b in self._blocks.values():
            if b.host is not None and not b.host_mmap:
                total += b.nbytes
            if b.device is not None:
                total += b.device_nbytes
        return total

    def tier_bytes(self) -> Dict[str, int]:
        """Point-in-time per-tier resident-byte gauges."""
        s = self.stats.snapshot()
        return {"device": s.device_bytes, "host": s.host_bytes,
                "disk": s.disk_bytes}

    def describe(self) -> str:
        s = self.stats
        t = self.tier_bytes()
        return (f"BlockStore({len(self)}/{self.cap} blocks, "
                f"dev={t['device']}B host={t['host']}B disk={t['disk']}B; "
                f"{s.hits} hits, {s.gathers} gathers, {s.transfers} "
                f"transfers, {self.evictions} evictions; "
                f"{s.demotions} demotions, {s.spills} spills, "
                f"{s.spill_reads} spill reads; "
                f"{self.partial_count} partials, {s.partial_hits} partial "
                f"hits, {s.folds} folds)")
