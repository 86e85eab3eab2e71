"""Discrete-event cluster simulator — reproduces the paper's experiments.

Port of ``src/repro/core/simulator.py`` (host-only, copied).

The paper's empirical platform is an in-house 224-core heterogeneous grid
(8 × 12 slow cores + 4 × 32 fast cores, §2.4/Fig. 3).  This container has one
CPU, so the *empirical* curves of Fig. 3/4/6 are reproduced by a
progress-based discrete-event simulation with max-min fair sharing of the
shared resources — the same modelling level the paper itself uses for its
"theoretical" curves, but with queueing and contention made explicit:

- each **node** has ``cores`` slots (a task holds one slot start-to-finish,
  which is what makes resource time = Σ task durations, the paper's metric),
  a disk read channel and a disk write channel (fair-shared among the node's
  concurrently-reading/writing tasks);
- the **network** is one shared full-duplex capacity, fair-shared among all
  active remote transfers (this is what saturates for SGE at small job
  lengths — Fig. 3A's flat region);
- a **task** runs READ → COMPUTE → WRITE; reads are disk-local when the
  executing node owns the input region, network otherwise; compute rate
  scales with the node's per-core MIPS.

Modes:
- ``hadoop``: tasks are queued on the node owning their input (data
  colocation); an idle node may steal from the longest queue, paying the
  network read — the paper's β rack-local fraction emerges from stealing.
- ``sge``: central storage; a single global FIFO, every read/write remote.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.balancer import NodeSpec

EPS = 1e-12


@dataclasses.dataclass
class SimTask:
    """One grid job (a map task, a compression job, ...)."""

    task_id: int
    input_bytes: float
    output_bytes: float
    work: float                      # seconds on a 1.0-MIPS core
    home_node: Optional[int] = None  # node owning the input region (None = central)
    sticky: bool = False             # if True, never stolen (strict locality)

    # -- filled by the simulator --
    exec_node: int = -1
    start: float = 0.0
    end: float = 0.0
    read_remote: bool = False
    write_remote: bool = False


@dataclasses.dataclass
class SimResult:
    wall_time: float
    resource_time: float              # Σ (end - start) over tasks — paper metric
    tasks: List[SimTask]
    remote_read_fraction: float
    node_busy: Dict[int, float]

    def summary(self) -> str:
        return (
            f"wall={self.wall_time:.1f}s resource={self.resource_time:.1f}s "
            f"tasks={len(self.tasks)} remote_reads={self.remote_read_fraction:.2f}"
        )


_PHASE_TOL = 1e-6  # units (bytes / work-seconds) below which a phase is done


class _Running:
    """A task in flight: phase ∈ {read, compute, write} with remaining units."""

    __slots__ = ("task", "node", "phase", "remaining")

    def __init__(self, task: SimTask, node: NodeSpec):
        self.task = task
        self.node = node
        self.phase = "read"
        self.remaining = max(task.input_bytes, 0.0)
        self._skip_empty()

    def _skip_empty(self) -> bool:
        """Advance through zero-length phases; True when the task is done."""
        while self.remaining <= _PHASE_TOL:
            if self.phase == "read":
                self.phase = "compute"
                self.remaining = max(self.task.work, 0.0)
            elif self.phase == "compute":
                self.phase = "write"
                self.remaining = max(self.task.output_bytes, 0.0)
            else:
                return True
        return False

    def advance(self, amount: float) -> bool:
        """Consume ``amount`` units; returns True when the task finished."""
        self.remaining -= amount
        return self._skip_empty()


class ClusterSim:
    def __init__(
        self,
        nodes: Sequence[NodeSpec],
        bandwidth: float = 70e6,
        allow_steal: bool = False,
    ):
        """``allow_steal=False`` is faithful to HBase MapReduce (map tasks are
        pinned to their region server — Fig. 3's starved fast nodes exist
        precisely because Hadoop does not steal).  ``allow_steal=True`` is
        ColoGrid's beyond-paper backlog-aware work stealing: an idle node may
        take from a victim whose queue exceeds one wave of its own cores,
        paying the remote read."""
        self.nodes = {n.node_id: n for n in nodes}
        self.bandwidth = bandwidth
        self.allow_steal = allow_steal

    # ------------------------------------------------------------------

    def run(self, tasks: Sequence[SimTask], mode: str = "hadoop") -> SimResult:
        if mode not in ("hadoop", "sge"):
            raise ValueError(f"unknown mode {mode!r}")
        tasks = [dataclasses.replace(t) for t in tasks]  # do not mutate input
        for t in tasks:
            t.write_remote = mode == "sge"

        queues: Dict[int, List[SimTask]] = {nid: [] for nid in self.nodes}
        global_queue: List[SimTask] = []
        if mode == "hadoop":
            for t in tasks:
                if t.home_node is not None and t.home_node in self.nodes:
                    queues[t.home_node].append(t)
                else:
                    global_queue.append(t)
        else:
            global_queue = list(tasks)

        free_slots: Dict[int, int] = {nid: n.cores for nid, n in self.nodes.items()}
        running: List[_Running] = []
        now = 0.0
        done: List[SimTask] = []
        node_busy: Dict[int, float] = {nid: 0.0 for nid in self.nodes}
        n_total = len(tasks)

        def schedule():
            for nid, node in self.nodes.items():
                while free_slots[nid] > 0:
                    task: Optional[SimTask] = None
                    if mode == "hadoop":
                        if queues[nid]:
                            task = queues[nid].pop(0)
                            task.read_remote = False
                        elif global_queue:
                            task = global_queue.pop(0)
                            task.read_remote = task.home_node != nid
                        elif self.allow_steal:
                            # backlog-aware: only steal from a victim whose
                            # queue exceeds one wave of its own cores
                            victims = [
                                q for q in queues
                                if q != nid
                                and len(queues[q]) > self.nodes[q].cores
                                and any(not t.sticky for t in queues[q])
                            ]
                            victim = max(victims, key=lambda q: len(queues[q]),
                                         default=None)
                            if victim is not None:
                                for i, cand in enumerate(queues[victim]):
                                    if not cand.sticky:
                                        task = queues[victim].pop(i)
                                        break
                                task.read_remote = True
                    else:  # sge: central storage, everything remote
                        if global_queue:
                            task = global_queue.pop(0)
                            task.read_remote = True
                    if task is None:
                        break
                    task.exec_node = nid
                    task.start = now
                    free_slots[nid] -= 1
                    running.append(_Running(task, node))

        schedule()
        while len(done) < n_total:
            if not running:
                raise RuntimeError("deadlock: tasks pending but none runnable")

            # --- max-min fair rates for every running phase ----------------
            net_users = sum(
                1 for r in running
                if (r.phase == "read" and r.task.read_remote)
                or (r.phase == "write" and r.task.write_remote)
            )
            disk_r_users: Dict[int, int] = {}
            disk_w_users: Dict[int, int] = {}
            for r in running:
                nid = r.node.node_id
                if r.phase == "read" and not r.task.read_remote:
                    disk_r_users[nid] = disk_r_users.get(nid, 0) + 1
                elif r.phase == "write" and not r.task.write_remote:
                    disk_w_users[nid] = disk_w_users.get(nid, 0) + 1

            rates: List[float] = []
            for r in running:
                nid = r.node.node_id
                if r.phase == "compute":
                    rate = r.node.mips  # work-seconds per second
                elif r.phase == "read":
                    rate = (
                        self.bandwidth / max(net_users, 1)
                        if r.task.read_remote
                        else r.node.disk_read_bps / max(disk_r_users.get(nid, 1), 1)
                    )
                else:  # write
                    rate = (
                        self.bandwidth / max(net_users, 1)
                        if r.task.write_remote
                        else r.node.disk_write_bps / max(disk_w_users.get(nid, 1), 1)
                    )
                rates.append(max(rate, EPS))

            # --- advance to the earliest phase completion -------------------
            dt = max(min(r.remaining / rate for r, rate in zip(running, rates)), 0.0)
            now += dt
            finished: List[_Running] = []
            for r, rate in zip(running, rates):
                if r.advance(rate * dt):
                    finished.append(r)
            for r in finished:
                running.remove(r)
                t = r.task
                t.end = now
                done.append(t)
                free_slots[r.node.node_id] += 1
                node_busy[r.node.node_id] += t.end - t.start
            if finished:
                schedule()

        resource = sum(t.end - t.start for t in done)
        remote = sum(1 for t in done if t.read_remote) / max(len(done), 1)
        return SimResult(
            wall_time=now,
            resource_time=resource,
            tasks=done,
            remote_read_fraction=remote,
            node_busy=node_busy,
        )


# ----------------------------------------------------------------------
# The paper's cluster (§2.4, Fig. 3 caption)
# ----------------------------------------------------------------------

def paper_cluster(slow_mips: float = 1.0, fast_mips: float = 1.6) -> List[NodeSpec]:
    """8 machines × 12 slow cores + 4 machines × 32 fast cores = 224 cores.

    MIPS ratio ~1:1.6 (older vs newer Xeons, measured by ``linux perf`` in the
    paper); absolute scale is irrelevant — only ratios move the allocation.
    """
    nodes = [
        NodeSpec(node_id=i, cores=12, mips=slow_mips, mem_bytes=48 << 30)
        for i in range(8)
    ]
    nodes += [
        NodeSpec(node_id=8 + i, cores=32, mips=fast_mips, mem_bytes=128 << 30)
        for i in range(4)
    ]
    return nodes


def mapreduce_job_tasks(
    n_img: int,
    eta: int,
    size_in: float,
    size_gen: float,
    avg_fn,
    placement_of_chunk,           # chunk index -> home node (or None)
    reference_mips: float = 1.0,
) -> Tuple[List[SimTask], SimTask]:
    """Build map tasks + the reduce task for a §2.2 averaging job.

    ``work`` is in reference-MIPS seconds so heterogeneous nodes run it at
    their own speed.  The reduce task averages the ⌊#img/η⌋ intermediates.
    """
    n_job = n_img // eta
    sizes = [eta] * n_job
    rem = n_img - n_job * eta
    if rem:
        sizes.append(rem)
    maps = [
        SimTask(
            task_id=i,
            input_bytes=sz * size_in,
            output_bytes=size_gen,
            work=avg_fn(sz) * reference_mips,
            home_node=placement_of_chunk(i),
        )
        for i, sz in enumerate(sizes)
    ]
    reduce_task = SimTask(
        task_id=len(maps),
        input_bytes=len(maps) * size_gen,
        output_bytes=size_gen,
        work=avg_fn(len(maps)) * reference_mips,
        home_node=None,
    )
    return maps, reduce_task
