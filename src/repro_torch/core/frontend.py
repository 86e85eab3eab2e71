"""GridFrontend — concurrent query serving with cross-query coalescing.

Port of ``src/repro/core/frontend.py`` (host-only, copied).

The paper's grid exists to serve *many simultaneous* analysis jobs against
colocated image data; everything below this module assumes one synchronous
caller.  ``GridFrontend`` is the serving layer on top of
:class:`~repro_torch.core.grid.GridSession`:

- **Concurrent submission** — ``submit(plan) -> Future`` from any number of
  client threads, plus a synchronous ``query()`` convenience.  A bounded
  admission window (``max_pending``) rejects excess load with
  :class:`FrontendOverloadedError` instead of queueing unboundedly, and a
  per-query ``deadline`` fails queries that sat in the queue too long with
  :class:`QueryTimeoutError`.

- **Readers–writer epoch isolation** — queries execute under a shared read
  lock; the mutating verbs (``upload``/``remove``/``rebalance``) take the
  writer side, which *drains* every in-flight query, applies the mutation
  atomically (the session bumps its epoch), and releases.  No query ever
  observes a half-applied mutation; writer priority keeps mutations from
  starving under a steady query stream.

- **Query-level coalescing (single-flight)** — in-flight and recently
  completed executions are registered under the plan's semantic
  :meth:`~repro_torch.core.plan.GridQuery.signature` + session epoch.  N clients
  asking the same question between two mutations share ONE execution: one
  leader runs, N-1 followers get futures chained off the leader's
  (``FrontendStats.coalesce_hits``).  Mutations clear the registry.

- **Batched device ticks** — distinct-program plans over the *same scan*
  (equal :meth:`~repro_torch.core.plan.GridQuery.batch_signature`) that arrive
  within one ``tick_ms`` scheduler window merge their program stacks into a
  single fused plan: one scan resolution, one gather, one CSE'd fold pass
  answers them all, and results split back per plan by program count.  This
  is the continuous-batching-lite pattern from :mod:`repro_torch.serve.engine`
  applied to analytics.

- **Partial-level coalescing (fold gate)** — *different* plans that need
  the same ``(block, program, mask-sig, group-sig)`` partial (overlapping
  range scans, a full-table plan racing a covering range plan) share one
  fold dispatch through a single-flight gate installed as
  ``session.fold_gate``, keyed on the BlockStore's content-addressed
  partial key.  Followers account the partial as reused.

On the card, the frontend inherits its session's devices, and every worker
thread issues on each device's current (default) stream: a follower that
reads a leader's partial relies on that one stream's order.  The session's
kernels set their device explicitly for each launch.

Quickstart::

    with GridFrontend(session, workers=8, tick_ms=2.0) as fe:
        futs = [fe.submit(plan) for _ in range(16)]     # one execution
        results, report = futs[0].result()
        fe.upload(keys, data)                            # drains, then applies
        print(fe.stats.snapshot())
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.blockstore import AtomicStats, LRUCache
from repro_torch.core.faults import (
    DeviceLostError,
    QueryFaultedError,
    RetryPolicy,
    TransientFaultError,
)
from repro_torch.core.grid import GridSession, RunReport
from repro_torch.core.plan import GridQuery
from repro_torch.core.stats import GroupedResult


class FrontendOverloadedError(RuntimeError):
    """Admission control: the frontend's open-query window is full."""


class QueryTimeoutError(TimeoutError):
    """The query's deadline passed before it could be served."""


@dataclasses.dataclass
class FrontendStats(AtomicStats):
    """Observable serving counters (atomic; read via ``snapshot()``).

    Latency percentiles come from a bounded reservoir of recent
    per-query service times — :meth:`latency_percentiles` — not from the
    dataclass fields, so ``snapshot()`` stays a cheap field copy.
    """

    submitted: int = 0          # submit() calls admitted
    served: int = 0             # futures resolved with a result
    failed: int = 0             # futures resolved with an error
    rejected: int = 0           # admission rejections (overload)
    timeouts: int = 0           # deadline expiries
    coalesce_hits: int = 0      # submissions served by another query's flight
    partial_coalesce_hits: int = 0  # block folds shared via the fold gate
    batch_merges: int = 0       # ticks that fused >= 2 plans into one pass
    batched_queries: int = 0    # queries answered through a merged pass
    ticks: int = 0              # scheduler windows that dispatched work
    mutations: int = 0          # write-side verbs applied
    queue_depth_peak: int = 0   # max tasks waiting in one tick window
    # --- fault tolerance ----------------------------------------------
    retries: int = 0            # dispatch-level query re-executions
    faults: int = 0             # fault-kind failures observed at dispatch
    breaker_opens: int = 0      # per-plan circuit breakers tripped open

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "_lat", deque(maxlen=2048))
        object.__setattr__(self, "_lat_lock", threading.Lock())

    def record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._lat.append(seconds)

    def latency_percentiles(self) -> Tuple[float, float]:
        """``(p50, p99)`` service latency in seconds over the reservoir."""
        with self._lat_lock:
            lat = sorted(self._lat)
        if not lat:
            return 0.0, 0.0
        return (lat[len(lat) // 2],
                lat[min(len(lat) - 1, (len(lat) * 99) // 100)])

    def reset_latencies(self) -> None:
        """Drop the reservoir (benches call this after warm-up so compile
        latencies don't pollute the steady-state percentiles)."""
        with self._lat_lock:
            self._lat.clear()


class _EpochRWLock:
    """Writer-priority readers–writer lock.

    Readers are executing queries; the writer is a mutating verb.  A
    waiting writer blocks NEW readers, so mutation latency is bounded by
    the in-flight queries it drains, not by the arrival stream.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class _GateEntry:
    """One in-flight fold behind the partial-level single-flight gate."""

    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result: Any = None
        self.exc: Optional[BaseException] = None


class _Breaker:
    """Per-plan-signature circuit breaker state (guarded by the
    frontend's breaker lock)."""

    __slots__ = ("failures", "opened_until")

    def __init__(self):
        self.failures = 0
        self.opened_until = 0.0


@dataclasses.dataclass
class _Task:
    """One admitted query waiting for (or in) execution."""

    plan: GridQuery
    eta: Optional[int]
    deadline: Optional[float]      # monotonic absolute, None = no deadline
    future: Future
    t_submit: float
    flight_key: Optional[Tuple] = None
    breaker_key: Optional[Tuple] = None
    # resolution claim: exactly ONE of _finish / _fail / _abandon settles
    # the task (guarded by the frontend's open lock), so a sync caller
    # abandoning a timed-out query and the executor finishing the same
    # flight can race without double-counting or double-resolving
    done: bool = False


class GridFrontend:
    """Concurrent query server over one :class:`GridSession`.

    Parameters
    ----------
    session:
        The session to serve.  The frontend installs itself as the
        session's ``fold_gate`` (when ``coalesce=True``) and assumes it is
        the only concurrent entry point — don't call session verbs
        directly while the frontend is open.
    workers:
        Executor threads running query groups (distinct scans proceed in
        parallel; the device serializes where it must).
    tick_ms:
        The batching window: after the first arrival the scheduler waits
        this long for same-scan plans to accumulate before dispatching.
        0 dispatches immediately (no cross-query program fusion).
    max_pending:
        Admission bound on open (submitted, unresolved) queries.
    coalesce:
        ``False`` disables all three sharing layers (single-flight,
        tick merging, fold gate) — the control arm for benchmarks.
    retry_policy:
        Backoff schedule for dispatch-level retries of fault-kind
        failures (transient device faults, device loss already handled
        by the session's quarantine).  Defaults to the session's policy.
    breaker_threshold:
        Consecutive fault-kind failures of one plan signature before its
        circuit breaker opens (0 disables breakers).
    breaker_cooldown_s:
        How long an open breaker fast-fails submissions of that plan
        before letting a probe through.
    """

    def __init__(self, session: GridSession, *, workers: int = 4,
                 tick_ms: float = 2.0, max_pending: int = 256,
                 coalesce: bool = True,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0):
        self.session = session
        self.tick_ms = float(tick_ms)
        self.max_pending = int(max_pending)
        self.coalesce = bool(coalesce)
        self.stats = FrontendStats()
        self._retry = (retry_policy if retry_policy is not None
                       else session.retry_policy)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        # per-plan-signature circuit breakers (bounded: cold plans age out)
        self._breakers: LRUCache = LRUCache(512)
        self._breaker_lock = threading.Lock()

        self._rwlock = _EpochRWLock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(workers)),
            thread_name_prefix="grid-frontend")
        # single-flight registry: (plan signature, eta, epoch) -> leader
        # Future.  Completed flights are RETAINED (bounded LRU) until the
        # next mutation, so repeat queries coalesce whether or not their
        # lifetimes overlap; mutation clears it wholesale.
        self._flights: LRUCache = LRUCache(512)
        self._flights_lock = threading.Lock()
        # partial-level single-flight: blockstore pkey -> _GateEntry
        self._gate_inflight: Dict[Tuple, _GateEntry] = {}
        self._gate_lock = threading.Lock()

        self._queue: List[_Task] = []
        self._queue_cond = threading.Condition()
        self._open = 0                     # admitted, not yet resolved
        self._open_lock = threading.Lock()
        self._closed = False
        # the task group an executor thread is currently serving — the
        # fold gate reads it to re-check deadlines mid-execution
        self._exec_tls = threading.local()

        # pin one bound-method object: attribute access mints a fresh
        # bound method each time, so install/uninstall must share it
        self._installed_gate = self._fold_gate
        if self.coalesce:
            session.fold_gate = self._installed_gate
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="grid-frontend-tick",
            daemon=True)
        self._scheduler.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------

    def submit(self, plan: GridQuery, *, eta: Optional[int] = None,
               deadline: Optional[float] = None) -> Future:
        """Admit one plan; returns a Future of ``(results, RunReport)``.

        ``deadline`` is a relative budget in seconds, enforced while
        queued, at dispatch, and at every fold-gate entry during
        execution: an expired query resolves with
        :class:`QueryTimeoutError` instead of running to completion.
        Raises :class:`FrontendOverloadedError` when the open-query window
        (``max_pending``) is full.
        """
        return self._submit(plan, eta=eta, deadline=deadline).future

    def _submit(self, plan: GridQuery, *, eta: Optional[int],
                deadline: Optional[float]) -> _Task:
        if self._closed:
            raise RuntimeError("frontend is closed")
        bkey: Optional[Tuple] = None
        if self.breaker_threshold > 0:
            bkey = plan.signature()
            with self._breaker_lock:
                br = self._breakers.peek(bkey)
                open_until = 0.0 if br is None else br.opened_until
            if time.monotonic() < open_until:
                self.stats.inc(rejected=1)
                raise QueryFaultedError(
                    "circuit breaker open for this plan "
                    f"(cooldown {self.breaker_cooldown_s}s after "
                    f"{self.breaker_threshold} consecutive faults)")
        with self._open_lock:
            if self._open >= self.max_pending:
                self.stats.inc(rejected=1)
                raise FrontendOverloadedError(
                    f"{self._open} open queries >= max_pending="
                    f"{self.max_pending}")
            self._open += 1

        now = time.monotonic()
        fut: Future = Future()
        task = _Task(plan=plan, eta=eta,
                     deadline=None if deadline is None else now + deadline,
                     future=fut, t_submit=now, breaker_key=bkey)
        self.stats.inc(submitted=1)

        if self.coalesce:
            key = (plan.signature(), eta, self.session.epoch)
            task.flight_key = key
            with self._flights_lock:
                leader: Optional[Future] = self._flights.get(key)
                if leader is None:
                    self._flights.put(key, fut)
            if leader is not None:
                self.stats.inc(coalesce_hits=1)
                leader.add_done_callback(
                    lambda lf, t=task: self._resolve_from_leader(t, lf))
                return task

        with self._queue_cond:
            self._queue.append(task)
            depth = len(self._queue)
            self._queue_cond.notify()
        self.stats.imax(queue_depth_peak=depth)
        return task

    def query(self, plan: GridQuery, *, eta: Optional[int] = None,
              timeout: Optional[float] = None) -> Tuple[Any, RunReport]:
        """Synchronous convenience: ``submit`` + wait.

        A timed-out wait ABANDONS the task — it is resolved (once) with
        :class:`QueryTimeoutError`, counted as a timeout, its flight is
        released so later submissions re-execute instead of chaining onto
        a doomed leader, and an in-flight execution serving only this
        query aborts at its next fold-gate entry rather than running to
        completion."""
        task = self._submit(plan, eta=eta, deadline=timeout)
        try:
            return task.future.result(timeout=timeout)
        except _FutureTimeout:
            self._abandon(task)
            raise QueryTimeoutError(
                f"query not served within {timeout}s") from None

    def _abandon(self, task: _Task) -> None:
        """The client stopped waiting: settle the task as a timeout if
        nothing else settled it first (the claim in ``_fail`` makes the
        race with a concurrently finishing execution single-winner)."""
        with self._queue_cond:
            try:
                self._queue.remove(task)
            except ValueError:
                pass                  # already dispatched (or a follower)
        self._fail(task, QueryTimeoutError("abandoned by caller"),
                   timeout=True)

    # --- mutating verbs (writer side) ---------------------------------

    def upload(self, *args, **kwargs):
        """Drain in-flight queries, then ``session.upload`` atomically."""
        return self._mutate(self.session.upload, *args, **kwargs)

    def remove(self, *args, **kwargs):
        """Drain in-flight queries, then ``session.remove`` atomically."""
        return self._mutate(self.session.remove, *args, **kwargs)

    def rebalance(self, *args, **kwargs):
        """Drain in-flight queries, then ``session.rebalance``."""
        return self._mutate(self.session.rebalance, *args, **kwargs)

    def _mutate(self, verb: Callable, *args, **kwargs):
        with self._rwlock.write():
            # every flight answered (or will answer) at the old epoch;
            # post-mutation submissions must re-execute
            with self._flights_lock:
                self._flights.clear()
            out = verb(*args, **kwargs)
        self.stats.inc(mutations=1)
        return out

    # --- lifecycle ----------------------------------------------------

    def close(self) -> None:
        """Stop admitting, drain the queue, release the session hook."""
        if self._closed:
            return
        self._closed = True
        with self._queue_cond:
            self._queue_cond.notify_all()
        self._scheduler.join(timeout=10.0)
        self._pool.shutdown(wait=True)
        if self.session.fold_gate is self._installed_gate:
            self.session.fold_gate = None

    def __enter__(self) -> "GridFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _scheduler_loop(self) -> None:
        while True:
            with self._queue_cond:
                while not self._queue and not self._closed:
                    self._queue_cond.wait()
                if self._closed and not self._queue:
                    return
            if self.tick_ms > 0:
                # accumulation window: let same-scan plans pile up
                time.sleep(self.tick_ms / 1000.0)
            with self._queue_cond:
                tasks, self._queue = self._queue, []
            if not tasks:
                continue
            self.stats.inc(ticks=1)
            for group in self._group_tasks(tasks):
                self._pool.submit(self._run_group, group)

    def _group_tasks(self, tasks: List[_Task]) -> List[List[_Task]]:
        """Partition one tick's tasks into mergeable groups.

        Compute plans sharing ``(batch_signature, eta)`` fuse; retrieves
        (no programs) and everything else run alone.  Coalescing off →
        every task is its own group.
        """
        if not self.coalesce:
            return [[t] for t in tasks]
        groups: Dict[Tuple, List[_Task]] = {}
        singles: List[List[_Task]] = []
        for t in tasks:
            if not t.plan.programs:
                singles.append([t])
                continue
            groups.setdefault(
                (t.plan.batch_signature(), t.eta), []).append(t)
        return list(groups.values()) + singles

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _run_group(self, tasks: List[_Task]) -> None:
        # dispatch-time deadline re-check: a query that expired while
        # queued (or was abandoned by its caller) must not start executing
        now = time.monotonic()
        live: List[_Task] = []
        for t in tasks:
            if t.done:
                continue               # abandoned while queued: settled
            if t.deadline is not None and now > t.deadline:
                self._fail(t, QueryTimeoutError(
                    "deadline passed while queued"), timeout=True)
            else:
                live.append(t)
        if not live:
            return
        self._exec_tls.tasks = live
        try:
            if len(live) == 1:
                t = live[0]
                out = self._execute_with_retries(
                    live, lambda: self._locked_exec(t.plan, t.eta))
                self._finish(t, out)
                return
            # merged tick: one fused pass answers every plan in the group
            offsets: List[Tuple[_Task, int, int]] = []
            programs: Tuple = ()
            for t in live:
                offsets.append((t, len(programs), len(t.plan.programs)))
                programs = programs + t.plan.programs
            merged = live[0].plan._fork(programs=programs)
            self.stats.inc(batch_merges=1, batched_queries=len(live))
            results, report = self._execute_with_retries(
                live, lambda: self._locked_exec(merged, live[0].eta))
            for t, off, k in offsets:
                self._finish(t, (self._split(results, off, k), report))
        except BaseException as e:     # noqa: BLE001 — resolve every future
            for t in live:
                self._fail(t, e)
        finally:
            self._exec_tls.tasks = None

    def _locked_exec(self, plan: GridQuery,
                     eta: Optional[int]) -> Tuple[Any, RunReport]:
        with self._rwlock.read():
            # one promotion sweep serves every coalesced member
            self.session.prefetch_plan(plan)
            return self.session._execute_plan(plan, eta=eta)

    def _execute_with_retries(self, live: List[_Task],
                              run: Callable[[], Tuple]) -> Tuple:
        """Run one execution attempt, retrying fault-kind failures.

        The session already degrades device→host→re-derive internally;
        what reaches here is a fault it could not absorb (an exhausted
        transient budget, or device loss surfacing mid-attempt before
        quarantine re-homing).  Each retry re-takes the read lock, so it
        executes against the freshly healed placement.  Retries stop at
        the policy's attempt budget or the group's last deadline,
        whichever is first; exhaustion raises :class:`QueryFaultedError`
        carrying the full fault chain for the client to inspect.
        """
        faults = self.session.faults
        chain: List[BaseException] = []
        attempt = 0
        while True:
            try:
                if faults is not None:
                    faults.fire("dispatch")
                return run()
            except (TransientFaultError, DeviceLostError) as e:
                chain.append(e)
                self.stats.inc(faults=1)
                attempt += 1
                delay = self._retry.delay_s(attempt - 1, key="dispatch")
                deadline = min(
                    (t.deadline for t in live
                     if not t.done and t.deadline is not None),
                    default=None)
                out_of_time = (deadline is not None
                               and time.monotonic() + delay > deadline)
                if attempt >= self._retry.max_attempts or out_of_time:
                    raise QueryFaultedError(
                        f"query faulted after {attempt} attempt(s)"
                        + (" (deadline reached)" if out_of_time else ""),
                        chain=tuple(chain)) from e
                self.stats.inc(retries=1)
                time.sleep(delay)

    def _check_deadline(self) -> None:
        """Mid-execution deadline gate, called from ``_fold_gate`` entry
        (i.e. between per-block folds): once EVERY task this thread is
        serving has expired or been abandoned, abort the execution with
        :class:`QueryTimeoutError` instead of running the remaining
        blocks for nobody.  While any member is still live, execution
        continues — expired members settle individually at resolution."""
        tasks = getattr(self._exec_tls, "tasks", None)
        if not tasks:
            return
        now = time.monotonic()
        for t in tasks:
            if t.done:
                continue
            if t.deadline is None or now <= t.deadline:
                return
        raise QueryTimeoutError("deadline passed during execution")

    @staticmethod
    def _split(results: Any, off: int, k: int) -> Any:
        """Project one member plan's results out of a merged pass.

        The merged plan has >= 2 programs, so each column's result is a
        tuple in program order (grouped columns wrap it in a
        :class:`GroupedResult`); a member with one program gets the bare
        element back, matching what its solo execution would return.
        """
        def one(val: Any) -> Any:
            if isinstance(val, GroupedResult):
                v = val.values
                sub = v[off] if k == 1 else tuple(v[off:off + k])
                return GroupedResult(keys=val.keys.copy(), values=sub)
            return val[off] if k == 1 else tuple(val[off:off + k])

        if isinstance(results, dict):
            return {col: one(v) for col, v in results.items()}
        return one(results)

    # --- future resolution --------------------------------------------

    def _claim(self, task: _Task) -> bool:
        """Settle-once guard: the first of finish / fail / abandon wins;
        everyone else observes ``done`` and walks away."""
        with self._open_lock:
            if task.done:
                return False
            task.done = True
            self._open -= 1
            return True

    def _finish(self, task: _Task, out: Tuple[Any, RunReport]) -> None:
        if not self._claim(task):
            return                # abandoned meanwhile: already settled
        self._breaker_ok(task)
        self.stats.record_latency(time.monotonic() - task.t_submit)
        self.stats.inc(served=1)
        task.future.set_result(out)

    def _fail(self, task: _Task, exc: BaseException,
              timeout: bool = False) -> None:
        if not self._claim(task):
            return
        # a failed flight must not be replayed to later submissions
        if task.flight_key is not None:
            with self._flights_lock:
                if self._flights.peek(task.flight_key) is task.future:
                    self._flights.pop(task.flight_key)
        if isinstance(exc, (QueryFaultedError, TransientFaultError,
                            DeviceLostError)):
            self._breaker_fault(task)
        timeout = timeout or isinstance(exc, QueryTimeoutError)
        self.stats.inc(failed=1, timeouts=1 if timeout else 0)
        task.future.set_exception(exc)

    # --- circuit breakers ---------------------------------------------

    def _breaker_ok(self, task: _Task) -> None:
        if task.breaker_key is None:
            return
        with self._breaker_lock:
            br = self._breakers.peek(task.breaker_key)
            if br is not None:
                br.failures = 0

    def _breaker_fault(self, task: _Task) -> None:
        """Count one fault-kind failure toward the plan's breaker; trip
        it open (cooldown fast-fail) at the threshold."""
        if task.breaker_key is None or self.breaker_threshold <= 0:
            return
        with self._breaker_lock:
            br = self._breakers.get(task.breaker_key)
            if br is None:
                br = _Breaker()
                self._breakers.put(task.breaker_key, br)
            br.failures += 1
            now = time.monotonic()
            if br.failures >= self.breaker_threshold and now >= br.opened_until:
                br.opened_until = now + self.breaker_cooldown_s
                br.failures = 0
                self.stats.inc(breaker_opens=1)

    def _resolve_from_leader(self, task: _Task, leader: Future) -> None:
        exc = leader.exception()
        if exc is not None:
            self._fail(task, exc)
        else:
            self._finish(task, leader.result())

    # ------------------------------------------------------------------
    # partial-level single-flight (installed as session.fold_gate)
    # ------------------------------------------------------------------

    def _fold_gate(self, pkey: Tuple,
                   fn: Callable[[], Tuple]) -> Tuple[Tuple, bool]:
        """Single-flight one block fold across concurrent queries.

        The first thread to miss on ``pkey`` runs ``fn`` (fetch + fold +
        put_partial); every thread that arrives while it runs blocks on
        the entry's event and receives the leader's result with
        ``coalesced=True`` — the session accounts those as partial
        reuses, so ``BlockStore.stats.folds`` counts each distinct
        partial exactly once however many queries needed it.

        The gate doubles as the mid-execution deadline checkpoint: it
        runs once per cold block, so an execution whose every consumer
        has expired (or abandoned) aborts here — between blocks, never
        mid-fold — instead of folding the rest of the table for nobody.
        """
        self._check_deadline()
        with self._gate_lock:
            entry = self._gate_inflight.get(pkey)
            leader = entry is None
            if leader:
                entry = _GateEntry()
                self._gate_inflight[pkey] = entry
        if leader:
            try:
                entry.result = fn()
            except BaseException as e:   # noqa: BLE001 — wake followers
                entry.exc = e
                raise
            finally:
                entry.event.set()
                with self._gate_lock:
                    self._gate_inflight.pop(pkey, None)
            return entry.result, False
        # follower: bounded waits so an expired query stops following a
        # slow leader instead of blocking past its own deadline
        while not entry.event.wait(timeout=0.05):
            self._check_deadline()
        if entry.exc is not None:
            raise entry.exc
        self.stats.inc(partial_coalesce_hits=1)
        return entry.result, True
