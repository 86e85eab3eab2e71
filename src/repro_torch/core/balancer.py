"""Data-allocation strategies — the paper's heterogeneity-aware load balancer.

Port of ``src/repro/core/balancer.py`` (host-only, copied).

HBase's built-in balancer equalizes the *number of regions* per server, which
on a heterogeneous cluster starves fast machines and overloads slow ones
(Fig. 1A).  The paper's contribution (Table 1, "Load Balancer") is an offline
greedy re-allocation so that each node's **data share matches its compute
share**:

    share(node)  ∝  #CPU(node) × MIPS(node)

with MIPS measured by ``linux perf``.  On TPU the analogue of MIPS is the
per-device effective FLOP/s (mixed-generation slices, DCN-attached pods, or
observed step throughput under straggling); the arithmetic is identical.

Three allocators (all pure functions over ``{region_id: bytes}``):

- :func:`balanced_allocation` — HBase default (equal region count) — the
  paper's *baseline*;
- :func:`greedy_allocation`   — the paper's #CPU×MIPS-proportional greedy
  allocation (LPT-style) from scratch;
- :func:`central_allocation`  — the SGE comparison: all data on one storage
  node, every task pulls over the network.

plus :func:`rebalance`, the faithful *offline* form ("first find all regions
... second, moving images based on region") that starts from the current
placement and moves the fewest regions needed to restore proportionality —
this is also ColoGrid's elastic-rescale and straggler-mitigation primitive.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

Allocation = Dict[int, int]  # region id -> node id


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One machine (or TPU device / device group) of the grid."""

    node_id: int
    cores: int = 1
    mips: float = 1.0           # per-core throughput (MIPS / effective FLOP/s)
    mem_bytes: int = 4 << 30    # paper: 4 GB per job slot
    disk_read_bps: float = 100e6   # paper §2.4: 100 MB/s
    disk_write_bps: float = 65e6   # paper §2.4: 65 MB/s

    @property
    def power(self) -> float:
        """The paper's allocation weight: #CPU × MIPS."""
        return self.cores * self.mips


def _targets(total_bytes: float, nodes: Sequence[NodeSpec]) -> Dict[int, float]:
    """Per-node target byte shares ∝ #CPU×MIPS."""
    total_power = sum(n.power for n in nodes)
    if total_power <= 0:
        raise ValueError("total node power must be positive")
    return {n.node_id: total_bytes * n.power / total_power for n in nodes}


def balanced_allocation(
    region_bytes: Mapping[int, int], nodes: Sequence[NodeSpec]
) -> Allocation:
    """HBase default balancer: equalize region COUNT per node (baseline).

    Region sizes and node speeds are ignored — exactly the behaviour the
    paper shows degrading heterogeneous-cluster wall time (Fig. 3).
    """
    alloc: Allocation = {}
    node_ids = [n.node_id for n in nodes]
    for i, rid in enumerate(sorted(region_bytes)):
        alloc[rid] = node_ids[i % len(node_ids)]
    return alloc


def greedy_allocation(
    region_bytes: Mapping[int, int], nodes: Sequence[NodeSpec]
) -> Allocation:
    """The paper's allocator: greedy placement to #CPU×MIPS-proportional shares.

    Largest-region-first into the node with the largest remaining *deficit*
    relative to its target share (classic LPT shape; optimal within one region
    size of the proportional target).
    """
    total = float(sum(region_bytes.values()))
    targets = _targets(total, nodes)
    assigned = {n.node_id: 0.0 for n in nodes}
    # heap keyed by -(deficit) so the neediest node pops first
    heap: List[Tuple[float, int]] = [(-targets[n.node_id], n.node_id) for n in nodes]
    heapq.heapify(heap)
    alloc: Allocation = {}
    for rid in sorted(region_bytes, key=lambda r: (-region_bytes[r], r)):
        neg_deficit, nid = heapq.heappop(heap)
        alloc[rid] = nid
        assigned[nid] += region_bytes[rid]
        heapq.heappush(heap, (assigned[nid] - targets[nid], nid))
    return alloc


def central_allocation(
    region_bytes: Mapping[int, int], nodes: Sequence[NodeSpec],
    storage_node: Optional[int] = None,
) -> Allocation:
    """SGE-style central storage: every region on one node; all reads remote."""
    nid = nodes[0].node_id if storage_node is None else storage_node
    return {rid: nid for rid in region_bytes}


def node_loads(
    alloc: Allocation, region_bytes: Mapping[int, int], nodes: Sequence[NodeSpec]
) -> Dict[int, float]:
    loads = {n.node_id: 0.0 for n in nodes}
    for rid, nid in alloc.items():
        loads[nid] += region_bytes[rid]
    return loads


def allocation_imbalance(
    alloc: Allocation, region_bytes: Mapping[int, int], nodes: Sequence[NodeSpec]
) -> float:
    """Max relative deviation of a node's *work* from proportional.

    Work on a node ≙ bytes/power (time-to-process proxy).  0.0 is perfectly
    proportional; the paper's Fig. 3 "before" corresponds to the default
    balancer's large value on a heterogeneous cluster.
    """
    total = float(sum(region_bytes.values()))
    if total == 0:
        return 0.0
    total_power = sum(n.power for n in nodes)
    loads = node_loads(alloc, region_bytes, nodes)
    # ideal makespan: every node finishes together
    ideal = total / total_power
    worst = max(loads[n.node_id] / n.power for n in nodes)
    return worst / ideal - 1.0


def rebalance(
    current: Allocation,
    region_bytes: Mapping[int, int],
    nodes: Sequence[NodeSpec],
    tolerance: float = 0.05,
) -> Tuple[Allocation, List[int]]:
    """The paper's offline balancer: move regions until shares ≈ #CPU×MIPS.

    Starts from ``current`` and greedily moves the largest useful region from
    the most-overloaded node (by surplus bytes over its target) to the
    neediest node, stopping when every node is within ``tolerance`` of its
    target or no move improves.  Returns ``(new_allocation, moved_region_ids)``
    — the move list is what an operator (or the elastic-rescale path) actually
    executes, so minimizing it matters.

    Dead/removed nodes: regions currently mapped to a node not in ``nodes``
    are treated as homeless and re-assigned first (failure handling).
    """
    live = {n.node_id for n in nodes}
    total = float(sum(region_bytes.values()))
    targets = _targets(total, nodes)
    alloc = dict(current)
    if total == 0:
        return alloc, []

    # Phase 1 (keep): each live node keeps its current regions,
    # largest-first, while staying within target·(1+tolerance); the rest are
    # evicted.  Orphans on dead nodes are evicted by construction.
    per_node: Dict[int, List[int]] = {nid: [] for nid in live}
    evicted: List[int] = []
    for rid in sorted(region_bytes, key=lambda r: (-region_bytes[r], r)):
        nid = alloc.get(rid)
        if nid in live:
            per_node[nid].append(rid)
        else:
            evicted.append(rid)
    loads = {nid: 0.0 for nid in live}
    for nid, rids in per_node.items():
        cap = targets[nid] * (1.0 + tolerance)
        for rid in rids:  # already largest-first
            b = region_bytes[rid]
            if loads[nid] + b <= cap:
                loads[nid] += b
            else:
                evicted.append(rid)

    # Phase 2 (place): greedy deficit-heap assignment of evicted regions,
    # largest-first — the same LPT shape as greedy_allocation.
    heap: List[Tuple[float, int]] = [
        (loads[nid] - targets[nid], nid) for nid in live
    ]
    heapq.heapify(heap)
    moved: List[int] = []
    for rid in sorted(evicted, key=lambda r: (-region_bytes[r], r)):
        _, nid = heapq.heappop(heap)
        if alloc.get(rid) != nid:
            moved.append(rid)
        alloc[rid] = nid
        loads[nid] += region_bytes[rid]
        heapq.heappush(heap, (loads[nid] - targets[nid], nid))
    return alloc, moved


def assign_new_regions(
    current: Allocation,
    region_bytes: Mapping[int, int],
    nodes: Sequence[NodeSpec],
) -> Allocation:
    """Adopt regions absent from ``current`` without moving existing ones.

    The incremental complement of :func:`rebalance`: each unassigned region
    (largest-first) goes to the node with the largest remaining deficit vs
    its #CPU×MIPS-proportional target, and every existing assignment stays
    put — this is what keeps an incremental upload cheap between full
    balancer runs.  Returns ONLY the new assignments.
    """
    new = [rid for rid in region_bytes if rid not in current]
    if not new:
        return {}
    targets = _targets(float(sum(region_bytes.values())), nodes)
    loads = {n.node_id: 0.0 for n in nodes}
    for rid, nid in current.items():
        if nid in loads and rid in region_bytes:
            loads[nid] += region_bytes[rid]
    heap: List[Tuple[float, int]] = [
        (loads[n.node_id] - targets[n.node_id], n.node_id) for n in nodes
    ]
    heapq.heapify(heap)
    out: Allocation = {}
    for rid in sorted(new, key=lambda r: (-region_bytes[r], r)):
        deficit, nid = heapq.heappop(heap)
        out[rid] = nid
        heapq.heappush(heap, (deficit + region_bytes[rid], nid))
    return out


def powers_from_observations(
    round_times: Mapping[int, Sequence[float]],
    nodes: Sequence[NodeSpec],
    ewma: float = 0.5,
) -> List[NodeSpec]:
    """Straggler mitigation: refresh node powers from observed round times.

    A node that keeps finishing its (equal-work) rounds slower than the mean
    gets its effective MIPS deweighted, so the next :func:`rebalance` shifts
    regions away from it — the runtime analogue of re-running ``linux perf``.
    """
    out: List[NodeSpec] = []
    for n in nodes:
        times = list(round_times.get(n.node_id, []))
        if not times:
            out.append(n)
            continue
        # observed throughput ∝ 1/time; EWMA over the sequence
        thr = 1.0 / max(times[0], 1e-9)
        for t in times[1:]:
            thr = (1 - ewma) * thr + ewma / max(t, 1e-9)
        out.append(dataclasses.replace(n, mips=thr / max(n.cores, 1)))
    return out
