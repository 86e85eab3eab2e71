"""Grid scheduler — rounds, straggler mitigation, failure handling.

Port of ``src/repro/core/scheduler.py`` (host-only, copied).

The paper's balancer is *offline*: measure MIPS once with ``linux perf``,
allocate, run.  At 1000+-node scale the measurement must be continuous —
effective device throughput drifts (thermal throttling, DCN congestion,
co-tenant noise) and devices fail outright.  ``GridScheduler`` closes the
loop:

1. every round it hands each node its chunk quota (from the placement);
2. observed per-node round times update effective powers (EWMA — the runtime
   re-measurement of "MIPS");
3. when the predicted makespan gain of re-balancing exceeds a threshold, it
   runs the paper's offline greedy :func:`~repro_torch.core.balancer.rebalance`
   (move-minimizing) and emits the move list;
4. a failed node's regions are orphaned and adopted by the same rebalance
   call — fault tolerance *is* the balancer, run with a shrunken node list.

The scheduler is deliberately host-side and pure (no device state): it plans;
the MapReduce engine / training loop executes.  That keeps it testable with
injected timings and reusable across the stats path and the data pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.balancer import (
    NodeSpec,
    allocation_imbalance,
    rebalance,
)
from repro_torch.core.placement import Placement


@dataclasses.dataclass
class RebalanceEvent:
    round_index: int
    reason: str                   # "straggler" | "failure" | "elastic"
    moved_regions: List[int]
    imbalance_before: float
    imbalance_after: float


class GridScheduler:
    def __init__(
        self,
        placement: Placement,
        chunk_size: int,
        rebalance_threshold: float = 0.20,
        ewma: float = 0.5,
        min_rounds_between_rebalance: int = 3,
    ):
        self.placement = placement
        self.chunk_size = chunk_size
        self.rebalance_threshold = rebalance_threshold
        self.ewma = ewma
        self.min_gap = min_rounds_between_rebalance
        self.round_index = 0
        self._last_rebalance = -(10**9)
        # effective throughput per node (chunks/s), EWMA-updated
        self._eff_power: Dict[int, float] = {
            n.node_id: n.power for n in placement.nodes
        }
        self.events: List[RebalanceEvent] = []

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------

    def plan_round(self) -> Dict[int, int]:
        """Chunk quota per node for the next lockstep round."""
        counts = self.placement.node_row_counts()
        rounds = max(self.placement.rounds(self.chunk_size), 1)
        return {
            nid: -(-c // self.chunk_size) // rounds
            + (1 if (-(-c // self.chunk_size)) % rounds > 0 else 0)
            for nid, c in counts.items()
        }

    def makespan_estimate(self) -> float:
        """Predicted wall time of draining all chunks at current powers."""
        counts = self.placement.node_row_counts()
        return max(
            (-(-c // self.chunk_size)) / max(self._eff_power[nid], 1e-9)
            for nid, c in counts.items()
        )

    # ------------------------------------------------------------------
    # observation / adaptation
    # ------------------------------------------------------------------

    def observe_round(self, node_times: Mapping[int, float]) -> Optional[RebalanceEvent]:
        """Feed measured per-node round times; maybe rebalance.

        ``node_times[nid]`` is the wall time node ``nid`` took for its quota
        this round.  Throughput = quota/time updates the node's effective
        power; a sustained straggler shifts the allocation away from itself.
        """
        self.round_index += 1
        quotas = self.plan_round()
        for nid, t in node_times.items():
            if nid not in self._eff_power or t <= 0:
                continue
            thr = max(quotas.get(nid, 1), 1) / t
            self._eff_power[nid] = (
                (1 - self.ewma) * self._eff_power[nid] + self.ewma * thr
            )
        return self._maybe_rebalance(reason="straggler")

    def handle_failure(self, dead_node_ids: Sequence[int]) -> RebalanceEvent:
        """Remove nodes; their regions are orphaned and re-adopted."""
        dead = set(dead_node_ids)
        survivors = tuple(n for n in self.placement.nodes if n.node_id not in dead)
        if not survivors:
            raise RuntimeError("all nodes failed")
        for nid in dead:
            self._eff_power.pop(nid, None)
        self.placement.nodes = survivors
        return self._force_rebalance(reason="failure")

    def handle_join(self, new_nodes: Sequence[NodeSpec]) -> RebalanceEvent:
        """Elastic scale-up: add nodes and shift regions onto them."""
        self.placement.nodes = tuple(self.placement.nodes) + tuple(new_nodes)
        for n in new_nodes:
            self._eff_power[n.node_id] = n.power
        return self._force_rebalance(reason="elastic")

    # ------------------------------------------------------------------

    def effective_nodes(self) -> List[NodeSpec]:
        """Node specs with MIPS refreshed from the scheduler's EWMA powers.

        The hand-off point for callers owning the rebalance decision: pass
        the result to ``GridSession.rebalance(nodes=...)`` to apply this
        scheduler's view of node speeds with the session's epoch machinery
        intact.  (``rebalance(auto=True)`` instead folds the session's own
        raw round-time history via :func:`powers_from_observations` —
        unbiased by quota estimates, per the paper's offline probe.)"""
        return self._current_nodes()

    def _current_nodes(self) -> List[NodeSpec]:
        """Node specs with MIPS refreshed from observed effective powers."""
        return [
            dataclasses.replace(
                n, mips=self._eff_power[n.node_id] / max(n.cores, 1)
            )
            for n in self.placement.nodes
        ]

    def _maybe_rebalance(self, reason: str) -> Optional[RebalanceEvent]:
        if self.round_index - self._last_rebalance < self.min_gap:
            return None
        nodes = self._current_nodes()
        region_bytes = self.placement.table.region_bytes()
        imb = allocation_imbalance(self.placement.alloc, region_bytes, nodes)
        if imb <= self.rebalance_threshold:
            return None
        return self._do_rebalance(nodes, region_bytes, imb, reason)

    def _force_rebalance(self, reason: str) -> RebalanceEvent:
        nodes = self._current_nodes()
        region_bytes = self.placement.table.region_bytes()
        imb = allocation_imbalance(
            {r: n for r, n in self.placement.alloc.items()
             if n in {x.node_id for x in nodes}},
            {r: b for r, b in region_bytes.items()
             if self.placement.alloc.get(r) in {x.node_id for x in nodes}}
            or region_bytes,
            nodes,
        ) if region_bytes else 0.0
        return self._do_rebalance(nodes, region_bytes, imb, reason)

    def _do_rebalance(self, nodes, region_bytes, imb_before, reason) -> RebalanceEvent:
        new_alloc, moved = rebalance(self.placement.alloc, region_bytes, nodes)
        self.placement.alloc = new_alloc
        self.placement.nodes = tuple(nodes)
        imb_after = allocation_imbalance(new_alloc, region_bytes, nodes)
        self._last_rebalance = self.round_index
        ev = RebalanceEvent(
            round_index=self.round_index,
            reason=reason,
            moved_regions=moved,
            imbalance_before=imb_before,
            imbalance_after=imb_after,
        )
        self.events.append(ev)
        return ev
