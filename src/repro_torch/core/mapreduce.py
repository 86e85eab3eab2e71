"""MapReduce engine over the owner devices — the paper's §2.2 on a GPU.

Port of ``src/repro/core/mapreduce.py``.  The paper's Map phase sends each
chunk of η images to the node holding them; the Reduce phase combines the
per-chunk intermediates on one node.  Here the nodes are the session's
owner devices (a list that may repeat one physical card):

- **Map**: each owner folds its *local* rows — a block committed to its
  device, or its shard of a compact layout — chunk by chunk (a Python loop
  in place of ``lax.scan``), or in one pass through the fused CUDA fold
  kernel (``repro_torch.kernels.fused_fold``) when the program's partial is
  the fp32 shared-accumulator pool.
- **Reduce**: only the tiny partials move.  Additive programs tree-reduce:
  each owner pre-merges its own partials locally, then one per-leaf sum (or
  max) on the merge device joins the owners — the stand-in for the
  reference's ``psum``/``pmax``.  Everything else funnels to the merge
  device for a pairwise merge.

Two execution granularities share the program interface:

- :meth:`MapReduceEngine.run` — the layout-at-a-time path over ``[D, C,
  ...]`` per-owner shards (the compact one-shot gather uses it);
- :meth:`MapReduceEngine.fold_block` + :meth:`MapReduceEngine.merge_finalize`
  — the block-at-a-time path :class:`~repro_torch.core.grid.GridSession`
  drives; per-block partials are cacheable per block lineage in the
  :class:`~repro_torch.core.blockstore.BlockStore`.

PyTorch runs eagerly, so nothing is compiled; the reference's jit caches
become a cache of fold/merge closures under the same keys, and
``compile_count`` still counts builds of new keys (the plan-cache tests
hold the session to it).  Fold keys bucket block rows to a power of two and
funnel merges bucket the partial count the same way.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.blockstore import LRUCache
from repro_torch.utils import (
    owner_devices,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PyTree = Any


def partial_to_host(partial: PyTree) -> Tuple[List[np.ndarray], Any]:
    """Flatten a fold partial into host numpy leaves + its treedef — the
    serialization half of the BlockStore's partial spill tier."""
    leaves, treedef = tree_flatten(partial)
    return [_to_numpy(leaf) for leaf in leaves], treedef


def partial_from_host(leaves: Sequence[np.ndarray], treedef: Any) -> PyTree:
    """Rebuild a spilled fold partial from its host leaves as CPU tensors;
    the merge moves them to the merge device."""
    return tree_unflatten(treedef, [torch.from_numpy(np.array(x))
                                    for x in leaves])


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    """``a`` (tensor or array) as a tensor on ``dev``; a read-only numpy
    array (a BlockStore host copy) is copied rather than shared."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _to_device(tree: PyTree, dev: torch.device) -> PyTree:
    return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def _stack(trees: Sequence[PyTree]) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _sum0(s: torch.Tensor) -> torch.Tensor:
    return s.sum(dim=0, dtype=s.dtype)


def _max0(s: torch.Tensor) -> torch.Tensor:
    return s.amax(dim=0)


_aten = torch.ops.aten
_MATMULS = (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm)
_NO_TRAFFIC = (_aten.empty, _aten.empty_like, _aten.empty_strided)


class _CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the ATen ops run under it, by the rule
    :meth:`MapReduceEngine.fold_cost` states."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _aten.nonzero.default and args[0].is_meta:
            # a data-dependent shape, taken at its largest: all nonzero
            out = torch.empty((args[0].numel(), args[0].dim()),
                              dtype=torch.int64, device="meta")
        else:
            out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        ins = [x for x in tree_leaves((args, kwargs or {}))
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if func.overloadpacket in _MATMULS:
            a, b = ins[-2], ins[-1]          # addmm/baddbmm: bias first
            m, k = a.shape[-2], a.shape[-1]
            batch = a.numel() // (m * k)
            self.flops += 2 * batch * m * k * b.shape[-1]
        else:
            self.flops += max([x.numel() for x in ins + outs] or [0])
        self.bytes += sum(x.numel() * x.element_size() for x in ins + outs)
        return out


class MapReduceProgram:
    """An associative summary-statistic program (a commutative monoid).

    Subclasses define:
      * ``zero(row_shape, dtype)``  — identity partial;
      * ``map_chunk(rows, valid)``  — fold a ``[eta, ...]`` chunk (with a
        ``[eta]`` validity mask) into a partial;
      * ``merge(a, b)``             — associative combine of partials;
      * ``finalize(partial)``       — partial -> user-facing result.

    ``additive`` marks programs whose partials combine by a per-leaf
    elementwise operator — sum by default, or the operator named by
    :meth:`merge_ops_for` — enabling the single-collective reduce path
    (the tree reduce).

    Programs whose statistic is a projection of the raw power sums may also
    declare :meth:`requires` / :meth:`finalize_shared`; a CSE'd
    :class:`~repro_torch.core.stats.FusedProgram` then computes each shared
    accumulator once per chunk and projects per-member results, instead of
    re-folding the chunk once per member.
    """

    additive: bool = False

    def cache_key(self) -> Tuple[str, str]:
        """Stable identity for executable/plan caches.

        Default: type name + repr — correct for the frozen-dataclass
        programs in :mod:`repro_torch.core.stats` (repr encodes every parameter).
        Programs with unhashable/unstable reprs should override.
        """
        return (type(self).__name__, repr(self))

    def zero(self, row_shape: Tuple[int, ...], dtype) -> PyTree:
        raise NotImplementedError

    def map_chunk(self, rows: torch.Tensor, valid: torch.Tensor) -> PyTree:
        raise NotImplementedError

    def merge(self, a: PyTree, b: PyTree) -> PyTree:
        raise NotImplementedError

    def merge_ops_for(self, partial: PyTree) -> Optional[List[str]]:
        """Per-leaf merge operators for an ``additive`` program, aligned
        with ``tree_leaves(partial)``: each entry is ``"sum"`` or
        ``"max"``.  ``None`` (the default) means every leaf merges by
        elementwise sum — the classic additive monoid.

        This is how a max-merge sketch (HyperLogLog registers) rides the
        engine's additive fast paths: the tree reduce takes a max
        instead of a sum for ``"max"`` leaves, and the stacked funnel /
        owner pre-merge reduce with ``max(axis=0)`` instead of
        ``sum(axis=0)``.  Contract: ``zero()`` must be the identity of
        each leaf's operator (0 works for both sum and max over
        non-negative registers), and ``merge`` must agree leafwise with
        the declared operators.  Only consulted when ``additive``; implementations may inspect only the
        argument's tree structure, never its values."""
        return None

    def finalize(self, partial: PyTree) -> PyTree:
        raise NotImplementedError

    # --- common-subexpression sharing protocol (optional) -------------

    def requires(self) -> Tuple[str, ...]:
        """Raw shared accumulators this program's result projects from
        (a subset of ``repro_torch.core.stats.SHARED_ACCUMULATORS``: ``count``,
        ``s1`` .. ``s4``).  Empty (the default) means the program folds its
        own private accumulator even inside a CSE'd fusion."""
        return ()

    def finalize_shared(self, shared: Mapping[str, torch.Tensor]) -> PyTree:
        """Project the user-facing result from the shared accumulators
        named by :meth:`requires`.  Must agree with
        ``finalize(own fold)`` up to float associativity."""
        raise NotImplementedError

    # --- fused-kernel fold protocol (optional) ------------------------

    def shared_fold_spec(self) -> Optional[Tuple[str, ...]]:
        """The shared-accumulator names whose fp32 pool fully determines
        this program's partial, or ``None`` if the partial needs anything
        outside the pool (private accumulators, non-fp32 pools).  Non-None
        makes the program eligible for the engine's fused CUDA fold
        (``fold_impl="kernel"``): the kernel emits the pool in one HBM pass
        and :meth:`partial_from_shared` shapes it into the program's
        native partial — compatible with the plain fold up to fp32
        accumulation order."""
        return None

    def partial_from_shared(self, shared: Mapping[str, torch.Tensor]) -> PyTree:
        """Build this program's partial from the kernel-folded shared
        pool (``{name: acc}``; grouped folds carry a leading group axis on
        every leaf).  Must merge/finalize identically to a partial the
        program folded itself, up to float associativity."""
        raise NotImplementedError


def _checked_merge_ops(program: MapReduceProgram,
                       partial: PyTree) -> Optional[List[str]]:
    """The program's per-leaf merge operators, validated against the
    partial's actual leaf count — ``None`` for the all-sum common case."""
    ops = program.merge_ops_for(partial)
    if ops is None:
        return None
    n_leaves = len(tree_leaves(partial))
    if len(ops) != n_leaves:
        raise ValueError(
            f"{type(program).__name__}.merge_ops_for returned {len(ops)} "
            f"operators for a partial with {n_leaves} leaves")
    bad = sorted(set(ops) - {"sum", "max"})
    if bad:
        raise ValueError(f"unknown merge operators {bad}; "
                         "expected 'sum' or 'max'")
    return ops


def _combine_leafwise(partial_like: PyTree, ops: Optional[List[str]],
                      sum_fn: Callable[[Any], Any],
                      max_fn: Callable[[Any], Any]) -> PyTree:
    """Apply ``sum_fn`` / ``max_fn`` leaf-by-leaf per the operator list
    (``None`` = all sum) and rebuild the tree."""
    if ops is None:
        return tree_map(sum_fn, partial_like)
    leaves, treedef = tree_flatten(partial_like)
    out = [max_fn(leaf) if op == "max" else sum_fn(leaf)
           for leaf, op in zip(leaves, ops)]
    return tree_unflatten(treedef, out)


@dataclasses.dataclass
class MapReduceStats:
    """Byte accounting for one run (feeds the simulator cross-check)."""

    local_rows_read: int          # rows folded on their home device
    local_bytes_read: int         # physical payload bytes read from HBM
    shuffle_bytes: int            # partial bytes crossing the interconnect
    rounds: int                   # lockstep map rounds (wall-clock proxy)
    chunks: int                   # Σ real chunks (#job; resource proxy)
    chunk_size: int


class MapReduceEngine:
    """Executes MapReduce programs over the owner devices."""

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 executable_cache_cap: int = 64,
                 block_pad: str = "pow2",
                 merge_strategy: str = "auto",
                 fold_impl: str = "kernel",
                 fault_injector=None):
        #: the owner devices, in shard order (the reference's 1-D data
        #: mesh); entries may repeat one physical device
        self.devices: List[torch.device] = owner_devices(devices)
        #: optional chaos harness (repro_torch.core.faults.FaultInjector):
        #: every block-fold dispatch fires its "fold" site with the owner
        #: device; the session's retry/quarantine wrapper owns the response
        self.fault_injector = fault_injector
        # LRU-capped: one entry per fold/merge signature; an evicted entry
        # rebuilds on next use (compile_count bumps again)
        self._compiled = LRUCache(executable_cache_cap)
        # partial byte sizes per (program, row signature)
        self._partial_bytes: dict = {}
        # builds of new fold/merge entries (the recompile oracle
        # GridSession's plan cache is tested against)
        self.compile_count = 0
        #: "pow2" pads block rows up to the next power of two before the
        #: fold, so the key space stays O(log max_rows); "none" keys on
        #: exact row counts.
        if block_pad not in ("pow2", "none"):
            raise ValueError(f"unknown block_pad policy {block_pad!r}")
        self.block_pad = block_pad
        #: "auto" tree-reduces additive merges across owners; "funnel"
        #: forces the single-device reduce.
        if merge_strategy not in ("auto", "funnel"):
            raise ValueError(f"unknown merge_strategy {merge_strategy!r}")
        self.merge_strategy = merge_strategy
        #: "kernel" folds each CSE-eligible block through the fused fold
        #: (the CUDA kernel on a CUDA block, its plain version on a CPU
        #: block); "torch" forces the chunked plain fold.  The kernel
        #: setting falls back per fold signature — see :meth:`fold_path`.
        if fold_impl not in ("kernel", "torch"):
            raise ValueError(f"unknown fold_impl {fold_impl!r}")
        self.fold_impl = fold_impl
        #: folds dispatched per implementation; bumped under ``_count_lock``
        self.fold_path_counts: dict = {"kernel": 0, "torch": 0}
        self.merge_path_counts: dict = {"tree": 0, "funnel": 0}
        self._build_lock = threading.RLock()
        self._count_lock = threading.Lock()
        # the last merge path is per-thread: concurrent queries must each
        # read the path of THEIR merge
        self._tls = threading.local()

    @property
    def last_merge_path(self) -> str:
        """Which physical reduce the CALLING THREAD's last
        :meth:`merge_finalize` took ("tree" / "funnel"; "" before any)."""
        return getattr(self._tls, "last_merge_path", "")

    @last_merge_path.setter
    def last_merge_path(self, value: str) -> None:
        self._tls.last_merge_path = value

    @property
    def _merge_device(self) -> torch.device:
        """Where partials meet for the reduce phase: the first owner."""
        return self.devices[0]

    def _get_or_build(self, key, build: Callable[[], Any]):
        fn = self._compiled.get(key)
        if fn is None:
            with self._build_lock:
                fn = self._compiled.get(key)
                if fn is None:
                    self.compile_count += 1
                    fn = build()
                    self._compiled.put(key, fn)
        return fn

    @staticmethod
    def _next_pow2(n: int) -> int:
        return 1 << max(0, int(n) - 1).bit_length()

    def bucket_rows(self, rows: int) -> int:
        """The padded row count a block folds at: the next power of two
        under "pow2", the exact count under "none".  ``GridSession``
        commits device blocks pre-padded to this bucket, so the fold never
        pays a pad copy for them."""
        if self.block_pad == "pow2":
            return self._next_pow2(rows)
        return rows

    # ------------------------------------------------------------------
    # block-at-a-time path: per-block folds + one merge/finalize reduce
    # ------------------------------------------------------------------

    def fold_path(self, program: MapReduceProgram, dtype,
                  num_groups: int = 0) -> str:
        """Which implementation :meth:`fold_block` takes for this fold
        signature: ``"kernel"`` (the fused one-pass fold) or ``"torch"``
        (the chunked plain fold).  Deterministic per (engine config,
        program, dtype, G), so the session keys cached partials on it.
        Falls back to ``"torch"`` when:

        - the program needs accumulators outside the fp32 CSE pool
          (``shared_fold_spec() is None``);
        - the payload dtype is not real-valued;
        - G exceeds the kernel's shared-memory limit
          (``fused_fold.ops.max_groups_for_smem``).
        """
        if self.fold_impl != "kernel":
            return "torch"
        names = program.shared_fold_spec()
        if not names:
            return "torch"
        dt = np.dtype(dtype)
        if dt.kind not in "fiub":
            return "torch"
        from repro_torch.kernels.fused_fold.ops import max_groups_for_smem
        if max(1, int(num_groups)) > max_groups_for_smem(names=names):
            return "torch"
        return "kernel"

    def _kernel_fold_fn(self, program: MapReduceProgram, groups: int = 0):
        """The fused-kernel fold: one pass emits the whole shared pool; eta
        is absent from its key."""
        from repro_torch.kernels.fused_fold.ops import fused_fold

        names = program.shared_fold_spec()
        grouped = groups > 0
        G = max(1, groups)

        def fold(block, mask, gids):
            shared = fused_fold(block, mask, gids, num_groups=G, names=names)
            if not grouped:   # ungrouped folds are the G=1 degenerate case
                shared = {n: a[0] for n, a in shared.items()}
            return program.partial_from_shared(shared)

        return fold

    def _block_fold_fn(self, program: MapReduceProgram, rows: int,
                       row_shape, dtype, eta: int, groups: int = 0):
        """The chunked plain fold for one block signature ``(rows,
        row_shape, dtype, η[, groups])``: the block is padded to a chunk
        multiple (pad rows masked off) and folded chunk by chunk in order,
        as the reference's ``lax.scan`` does.  With ``groups > 0`` each
        chunk's ``[G, eta]`` group mask (segment membership × validity)
        feeds the grouped ``map_chunk``."""
        pad = -rows % eta
        n_chunks = (rows + pad) // eta
        shape = tuple(row_shape)

        def fold(block, mask, gids):
            dev = block.device
            m = (torch.ones((rows,), dtype=torch.bool, device=dev)
                 if mask is None else mask.to(torch.bool))
            v = block
            if pad:
                v = torch.cat([v, v.new_zeros((pad,) + shape)])
                m = torch.cat([m, m.new_zeros((pad,))])
                if groups:
                    gids = torch.cat([gids, gids.new_zeros((pad,))])
            with torch.device(dev):
                partial = program.zero(shape, dtype)
                if groups:
                    g = gids.to(torch.int32)
                    ar = torch.arange(groups, dtype=torch.int32)[:, None]
                for c in range(n_chunks):
                    sl = slice(c * eta, (c + 1) * eta)
                    if groups:
                        cm = (g[sl][None, :] == ar) & m[sl][None, :]
                    else:
                        cm = m[sl]
                    partial = program.merge(partial,
                                            program.map_chunk(v[sl], cm))
            return partial

        return fold

    def fold_block(
        self,
        program: MapReduceProgram,
        block: Any,                      # [rows, ...] tensor or host array
        mask: Optional[Any],             # [rows] bool; None = every row
        eta: int,
        row_shape: Tuple[int, ...],
        dtype,
        gids: Optional[Any] = None,      # [rows] int32 group ids (grouped)
        num_groups: int = 0,
        owner: Optional[int] = None,     # fault context: owning device index
    ) -> PyTree:
        """Fold one block into a partial — the map phase at block granularity.

        A tensor block folds on its own device, which is the colocation
        property: the payload never leaves its owner; only the partial
        will.  A host (numpy) block folds on the merge device.  Blocks are
        padded to the bucketed row count first (pad rows masked off), so
        two regions of 9 and 12 rows share the 16-row fold entry.  With
        ``gids``/``num_groups`` the partial's leaves carry a leading group
        axis (see :class:`~repro_torch.core.stats.GroupedProgram`).
        """
        if self.fault_injector is not None:
            self.fault_injector.fire("fold", device=owner)
        if not isinstance(block, torch.Tensor):
            block = _tensor(block, self._merge_device)
        dev = block.device
        rows = int(block.shape[0])
        grouped = num_groups > 0
        if grouped and gids is None:
            raise ValueError("grouped fold needs per-row group ids")
        if mask is not None:
            mask = _tensor(mask, dev).to(torch.bool)
        if grouped:
            gids = _tensor(gids, dev).to(torch.int32)
        bucket = self.bucket_rows(rows)
        if bucket != rows:
            block = torch.cat(
                [block, block.new_zeros((bucket - rows,) + block.shape[1:])])
            mask = torch.cat([
                torch.ones((rows,), dtype=torch.bool, device=dev)
                if mask is None else mask,
                torch.zeros((bucket - rows,), dtype=torch.bool, device=dev)])
            if grouped:
                gids = torch.cat([gids, gids.new_zeros((bucket - rows,))])
        impl = self.fold_path(program, dtype, num_groups)
        with self._count_lock:
            self.fold_path_counts[impl] += 1
        if impl == "kernel":
            key = ("pfold", program.cache_key(), bucket, tuple(row_shape),
                   str(dtype), mask is not None, int(num_groups))
            fn = self._get_or_build(
                key, lambda: self._kernel_fold_fn(program, int(num_groups)))
        else:
            key = ("bfold", program.cache_key(), bucket, tuple(row_shape),
                   str(dtype), int(eta), mask is not None, int(num_groups))
            fn = self._get_or_build(
                key, lambda: self._block_fold_fn(
                    program, bucket, row_shape, dtype, eta,
                    groups=int(num_groups)))
        return fn(block, mask, gids if grouped else None)

    def merge_finalize(
        self,
        program: MapReduceProgram,
        partials: Sequence[PyTree],
        row_shape: Tuple[int, ...],
        dtype,
        owners: Optional[Sequence[Optional[int]]] = None,
    ) -> PyTree:
        """Reduce phase: combine the per-block partials and finalize.

        - **tree** — additive programs over more than one owner with
          ``owners`` given: each owner pre-merges its own partials on its
          device (one stacked sum, identity-padded to a power-of-two count),
          then one per-leaf sum/max over the owners' results runs on the
          merge device, and finalize runs there.
        - **funnel** — everything else: partials move to the merge device
          and merge pairwise (additive programs: one stacked sum).

        Zero partials finalize the monoid identity.
        """
        if self._tree_merge_ok(program, partials, owners):
            self.last_merge_path = "tree"
            with self._count_lock:
                self.merge_path_counts["tree"] += 1
            return self._merge_tree(program, partials, owners,
                                    row_shape, dtype)
        self.last_merge_path = "funnel"
        with self._count_lock:
            self.merge_path_counts["funnel"] += 1
        return self._merge_funnel(program, partials, row_shape, dtype)

    def _tree_merge_ok(self, program, partials, owners) -> bool:
        D = len(self.devices)
        return (self.merge_strategy == "auto"
                and program.additive
                and D > 1
                and owners is not None
                and len(owners) == len(partials)
                and len(partials) > 1
                and all(o is not None and 0 <= o < D for o in owners))

    def _presum_fn(self, program, count: int, row_shape, dtype):
        """One per-owner stacked sum over ``count`` partials — the
        owner-local pre-merge of the tree reduce, keyed by the pow2-bucketed
        partial count (identity-padded)."""
        key = ("bpresum", program.cache_key(), int(count), tuple(row_shape),
               str(dtype))

        def build():
            def presum(*ps):
                ops = _checked_merge_ops(program, ps[0])
                return _combine_leafwise(_stack(ps), ops, _sum0, _max0)

            return presum

        return self._get_or_build(key, build)

    def _merge_tree(self, program, partials, owners, row_shape, dtype):
        """Owner-local pre-merge, then one per-leaf sum/max across owners."""
        D = len(self.devices)
        by_owner: List[List[PyTree]] = [[] for _ in range(D)]
        for p, o in zip(partials, owners):
            by_owner[o].append(p)

        def ident(dev):
            with torch.device(dev):
                return program.zero(tuple(row_shape), dtype)

        merge_dev = self._merge_device
        owner_sums = []
        for d, ps in enumerate(by_owner):
            dev = self.devices[d]
            if not ps:
                acc = ident(dev)
            elif len(ps) == 1:
                # a cached partial from a pre-rebalance owner re-homes here
                # (tiny — a partial, never a payload block)
                acc = _to_device(ps[0], dev)
            else:
                moved = [_to_device(p, dev) for p in ps]
                bucket = self._next_pow2(len(moved))
                moved.extend([ident(dev)] * (bucket - len(moved)))
                acc = self._presum_fn(program, bucket, row_shape,
                                      dtype)(*moved)
            owner_sums.append(_to_device(acc, merge_dev))

        key = ("btree", program.cache_key(), tuple(row_shape), str(dtype))

        def build():
            def reduce(sums):
                ops = _checked_merge_ops(program, sums[0])
                with torch.device(merge_dev):
                    return program.finalize(
                        _combine_leafwise(_stack(sums), ops, _sum0, _max0))

            return reduce

        return self._get_or_build(key, build)(owner_sums)

    def _merge_funnel(self, program, partials, row_shape, dtype):
        """Single-device reduce: partials meet on the merge device (count
        bucketed to a power of two with identity partials)."""
        n = len(partials)
        bucket = n if n <= 1 else self._next_pow2(n)
        key = ("bmerge", program.cache_key(), bucket, tuple(row_shape),
               str(dtype))
        dev = self._merge_device

        def build():
            shape = tuple(row_shape)

            def mf(*ps):
                with torch.device(dev):
                    if not ps:
                        acc = program.zero(shape, dtype)
                    elif program.additive and len(ps) > 1:
                        ops = _checked_merge_ops(program, ps[0])
                        acc = _combine_leafwise(_stack(ps), ops, _sum0, _max0)
                    else:
                        items: List[PyTree] = list(ps)
                        while len(items) > 1:
                            items = [
                                program.merge(items[i], items[i + 1])
                                if i + 1 < len(items) else items[i]
                                for i in range(0, len(items), 2)
                            ]
                        acc = items[0]
                    return program.finalize(acc)

            return mf

        fn = self._get_or_build(key, build)
        moved = [_to_device(p, dev) for p in partials]
        if bucket > n:
            with torch.device(dev):
                identity = program.zero(tuple(row_shape), dtype)
            moved.extend([identity] * (bucket - n))
        return fn(*moved)

    def partial_nbytes(self, program: MapReduceProgram,
                       row_shape: Tuple[int, ...], dtype) -> int:
        """Bytes of one partial (the unit of reduce-phase shuffle traffic),
        from the identity's shapes on the meta device (no allocation)."""
        key = (program.cache_key(), tuple(row_shape), str(dtype))
        nbytes = self._partial_bytes.get(key)
        if nbytes is None:
            with torch.device("meta"):
                tree = program.zero(tuple(row_shape), dtype)
            nbytes = sum(x.numel() * x.element_size()
                         for x in tree_leaves(tree))
            self._partial_bytes[key] = nbytes
        return nbytes

    def fold_cost(
        self,
        program: MapReduceProgram,
        rows: int,
        row_shape: Tuple[int, ...],
        dtype,
        eta: int,
        masked: bool = False,
        groups: int = 0,
    ) -> Mapping[str, float]:
        """FLOPs and bytes of the chunked plain fold of one ``rows``-row
        block (the fold :meth:`_block_fold_fn` builds, not the kernel) —
        the oracle that shows a CSE'd fusion computes its shared
        accumulators once per chunk (grouped folds via ``groups > 0``).

        The fold runs once on ``meta`` tensors (no memory, no device work,
        no ``compile_count`` bump) under a dispatch mode that counts every
        ATen op it issues, over the WHOLE block — all ``ceil(rows / eta)``
        chunks:

        - views and ops that neither read nor write (``empty``) count
          nothing;
        - a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``)
          counts ``2·M·N·K`` FLOPs;
        - every other op (elementwise, reduction, conversion, copy,
          scatter, factory) counts the larger of its largest tensor
          input's and its largest output's element count;
        - bytes count each counted op's tensor inputs and outputs;
        - a shape that depends on the data (``nonzero``, which the
          sketches use to drop invalid rows) is taken at its largest:
          every row valid.

        The reference reads XLA's ``cost_analysis``, which counts the
        ``lax.scan`` body once: its figure is one chunk's, and does not
        grow with ``rows`` at a fixed ``eta``.
        """
        fn = self._block_fold_fn(program, rows, row_shape, dtype, eta,
                                 groups=int(groups))
        tdt = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        meta = torch.device("meta")
        block = torch.empty((rows,) + tuple(row_shape), dtype=tdt,
                            device=meta)
        mask = (torch.empty((rows,), dtype=torch.bool, device=meta)
                if masked else None)
        gids = (torch.empty((rows,), dtype=torch.int32, device=meta)
                if groups else None)
        with _CostCounter() as cost:
            fn(block, mask, gids)
        return {"flops": float(cost.flops), "bytes": float(cost.bytes)}

    # ------------------------------------------------------------------
    # layout-at-a-time path
    # ------------------------------------------------------------------

    def _layout_fold_fn(self, program: MapReduceProgram, row_shape, dtype,
                        eta: int):
        """Fold ``[D, C, ...]`` per-owner shards: each owner scans its shard
        in chunks of ``eta`` on its own device, then the owners' partials
        join by one per-leaf sum/max (additive) or a merge in owner order,
        and finalize on the merge device."""
        shape = tuple(row_shape)
        merge_dev = self._merge_device

        def run(values, mask):
            parts = []
            for d, dev in enumerate(self.devices):
                v = torch.as_tensor(values[d]).to(dev)
                m = torch.as_tensor(mask[d]).to(dev)
                with torch.device(dev):
                    p = program.zero(shape, dtype)
                    for c in range(v.shape[0] // eta):
                        sl = slice(c * eta, (c + 1) * eta)
                        p = program.merge(p, program.map_chunk(v[sl], m[sl]))
                parts.append(_to_device(p, merge_dev))
            with torch.device(merge_dev):
                if program.additive:
                    ops = _checked_merge_ops(program, parts[0])
                    acc = _combine_leafwise(_stack(parts), ops, _sum0, _max0)
                else:
                    acc = parts[0]
                    for p in parts[1:]:
                        acc = program.merge(acc, p)
                return program.finalize(acc)

        return run

    def run(
        self,
        program: MapReduceProgram,
        values: Any,
        valid: Any,
        chunk_size: int,
        row_mask: Optional[Any] = None,
    ) -> Tuple[PyTree, MapReduceStats]:
        """Run ``program`` over a ``[D, C, ...]`` layout (one shard per
        owner device; numpy arrays or tensors, stacked or as a sequence).

        ``row_mask`` (``[D, C]`` bool) restricts the fold to a query subset.
        """
        valid_np = np.stack([_to_numpy(v) for v in valid]).astype(bool)
        if row_mask is not None:
            valid_np &= np.stack([_to_numpy(m) for m in row_mask]).astype(
                bool)
        D, C = valid_np.shape
        if D != len(self.devices):
            raise ValueError(f"{D} shards for {len(self.devices)} owners")
        shards = [torch.as_tensor(values[d]) for d in range(D)]
        row_shape = tuple(shards[0].shape[1:])
        dtype = np.dtype(str(shards[0].dtype).replace("torch.", ""))
        pad = -C % chunk_size
        if pad:
            shards = [torch.cat([s, s.new_zeros((pad,) + row_shape)])
                      for s in shards]
            valid_np = np.pad(valid_np, [(0, 0), (0, pad)])
            C += pad
        key = (program.cache_key(), row_shape, str(dtype), chunk_size, C)
        fn = self._get_or_build(
            key, lambda: self._layout_fold_fn(program, row_shape, dtype,
                                              chunk_size))
        result = fn(shards, torch.from_numpy(valid_np))

        # --- byte accounting (host-side; mask is tiny) -------------------
        per_dev_rows = valid_np.sum(axis=1)
        row_nbytes = int(np.prod(row_shape, dtype=np.int64)) * dtype.itemsize
        partial_bytes = self.partial_nbytes(program, row_shape, dtype)
        chunks_per_dev = np.ceil(per_dev_rows / chunk_size).astype(np.int64)
        shuffle = partial_bytes * (D if program.additive else D * D)
        stats = MapReduceStats(
            local_rows_read=int(per_dev_rows.sum()),
            local_bytes_read=int(per_dev_rows.sum()) * row_nbytes,
            shuffle_bytes=int(shuffle),
            rounds=C // chunk_size,
            chunks=int(chunks_per_dev.sum()),
            chunk_size=chunk_size,
        )
        return result, stats
