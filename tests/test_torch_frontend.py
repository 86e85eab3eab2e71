"""The port's ``GridFrontend`` on a CPU session, case for case with
``tests/test_frontend.py``: single-flight coalescing, batched ticks,
mutation isolation, admission, deadlines and close, the thread-safety
substrate and the stats — plus one barrier scenario run on both packages
whose results and ``FrontendStats`` snapshots must agree.

Every wait is bounded (``Future.result``, ``Barrier`` and ``join`` all take
a timeout), and the order between threads comes from events: a "slow"
query blocks on an event the test sets, never on a guessed sleep.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.frontend import GridFrontend as RefFrontend  # noqa: E402
from repro.core.grid import GridSession as RefSession  # noqa: E402
from repro.core.stats import MeanProgram as RefMean  # noqa: E402
from repro_torch.core import GridFrontend as _Exported  # noqa: E402
from repro_torch.core.blockstore import LRUCache  # noqa: E402
from repro_torch.core.frontend import (  # noqa: E402
    FrontendOverloadedError,
    FrontendStats,
    GridFrontend,
    QueryTimeoutError,
)
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.core.stats import (  # noqa: E402
    CountProgram,
    MeanProgram,
    VarianceProgram,
)
from test_grid import make_population, row_batch  # noqa: E402
from torch_port_util import port_table  # noqa: E402

WAIT = 60.0          # the bound on every wait; a healthy run takes ms
N = 8


def make_session(n=64, split_bytes=2000, **kw):
    return GridSession(port_table(make_population(n, split_bytes=split_bytes)),
                       devices=["cpu"], default_eta=8, **kw)


def fanout(n, fn):
    """Run ``fn(i)`` on n threads released by one barrier; re-raise the
    first worker exception in the caller."""
    barrier = threading.Barrier(n, timeout=WAIT)
    errors = []

    def run(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "client thread hung"
    if errors:
        raise errors[0]


def gated_plan(s, release, entered=None):
    """A Count plan whose predicate blocks until ``release`` is set (and
    sets ``entered`` when it starts): a query that holds its worker."""
    def pred(cols):
        if entered is not None:
            entered.set()
        assert release.wait(WAIT), "gate never released"
        return cols["age"] > -np.inf              # selects everything

    return s.scan().where(pred, ["age"]).map(CountProgram()).reduce()


def test_exported_from_the_package():
    assert _Exported is GridFrontend


class TestCoalescing:
    def test_barrier_identical_cold_queries_fold_once(self):
        s = make_session()
        plan = s.scan().map(MeanProgram()).reduce()
        n_regions = len(s.table.regions)
        assert n_regions > 1
        expect = s.table.column("img", "data").mean(axis=0)
        futs = [None] * N
        with GridFrontend(s, workers=4, tick_ms=5.0) as fe:
            fanout(N, lambda i: futs.__setitem__(i, fe.submit(plan)))
            results = [f.result(timeout=WAIT) for f in futs]
            stats = fe.stats.snapshot()
        for val, _rep in results:
            np.testing.assert_allclose(val.numpy(), expect, atol=1e-5)
        assert stats.coalesce_hits == N - 1
        assert stats.served == N
        assert s.blocks.stats.snapshot().folds == n_regions
        assert sum(s.engine.fold_path_counts.values()) == n_regions

    def test_warm_coalesce_zero_folds(self):
        s = make_session()
        plan = s.scan().map(MeanProgram()).reduce()
        with GridFrontend(s, workers=4, tick_ms=2.0) as fe:
            fe.query(plan, timeout=WAIT)
            folds0 = s.blocks.stats.folds
            futs = [None] * N
            fanout(N, lambda i: futs.__setitem__(i, fe.submit(plan)))
            for f in futs:
                f.result(timeout=WAIT)
            assert fe.stats.coalesce_hits >= N - 1
        assert s.blocks.stats.folds == folds0

    def test_sequential_submissions_coalesce_until_mutation(self):
        s = make_session()
        plan = s.scan().map(CountProgram()).reduce()
        with GridFrontend(s, workers=2, tick_ms=0.0) as fe:
            v1, _ = fe.query(plan, timeout=WAIT)
            v2, _ = fe.query(plan, timeout=WAIT)
            assert int(v1) == int(v2) == 64
            assert fe.stats.coalesce_hits >= 1
            scans_before = s.metrics.scans
            fe.upload(["zz1", "zz2"], row_batch(["zz1", "zz2"]))
            v3, _ = fe.query(plan, timeout=WAIT)
            assert int(v3) == 66
            assert s.metrics.scans > scans_before

    def test_no_coalesce_mode_executes_each_query(self):
        s = make_session()
        plan = s.scan().map(MeanProgram()).reduce()
        futs = [None] * 6
        with GridFrontend(s, workers=4, tick_ms=2.0, coalesce=False) as fe:
            fanout(6, lambda i: futs.__setitem__(i, fe.submit(plan)))
            for f in futs:
                f.result(timeout=WAIT)
            assert fe.stats.coalesce_hits == 0
            assert fe.stats.batch_merges == 0
            assert fe.stats.served == 6
        assert s.metrics.scans == 6
        assert s.blocks.stats.folds >= len(s.table.regions)

    def test_fold_gate_single_flight(self):
        """The leader's fold returns only once every thread has looked the
        key up, so all N-1 others are followers of that one flight."""
        s = make_session()
        with GridFrontend(s, workers=2) as fe:
            all_in = threading.Event()
            lookups = []

            class Watched(dict):
                def get(self, key, default=None):
                    lookups.append(key)
                    if len(lookups) == N:
                        all_in.set()
                    return super().get(key, default)

            fe._gate_inflight = Watched()
            calls = []

            def slow_fold():
                calls.append(1)
                assert all_in.wait(WAIT)
                return ("partial", None, False, False)

            out = [None] * N
            fanout(N, lambda i: out.__setitem__(
                i, s.fold_gate(("pkey",), slow_fold)))
            assert len(calls) == 1
            assert all(res == ("partial", None, False, False)
                       for res, _ in out)
            assert sum(1 for _, coalesced in out if coalesced) == N - 1
            assert fe.stats.partial_coalesce_hits == N - 1


class TestBatchedTicks:
    TICK = 200.0      # wide enough that two barrier-released submits share it

    def test_distinct_programs_merge_into_one_pass(self):
        s = make_session()
        p1 = s.scan().map(VarianceProgram()).reduce()
        p2 = s.scan().map(CountProgram()).reduce()
        out = [None, None]
        with GridFrontend(s, workers=4, tick_ms=self.TICK) as fe:
            fanout(2, lambda i: out.__setitem__(
                i, fe.submit(p1 if i == 0 else p2)))
            (v1, rep1), (v2, rep2) = (out[0].result(WAIT),
                                      out[1].result(WAIT))
            assert fe.stats.batch_merges == 1
            assert fe.stats.batched_queries == 2
        np.testing.assert_allclose(
            v1["var"].numpy(), s.table.column("img", "data").var(axis=0),
            atol=1e-4)
        assert int(v2) == 64
        assert rep1 is rep2
        assert s.metrics.scans == 1

    def test_grouped_plans_merge_and_split(self):
        s = make_session()
        g1 = s.scan().group_by("idx:sex").map(MeanProgram()).reduce()
        g2 = s.scan().group_by("idx:sex").map(CountProgram()).reduce()
        out = [None, None]
        with GridFrontend(s, workers=4, tick_ms=self.TICK) as fe:
            fanout(2, lambda i: out.__setitem__(
                i, fe.submit(g1 if i == 0 else g2)))
            gr1, _ = out[0].result(WAIT)
            gr2, _ = out[1].result(WAIT)
            assert fe.stats.batch_merges == 1
        sex = s.table.column("idx", "sex")
        data = s.table.column("img", "data")
        np.testing.assert_array_equal(gr1.keys, np.unique(sex))
        for gi, k in enumerate(gr1.keys):
            np.testing.assert_allclose(gr1.values[gi].numpy(),
                                       data[sex == k].mean(axis=0),
                                       atol=1e-4)
            assert int(gr2.values[gi]) == int((sex == k).sum())

    def test_multi_column_plans_merge_and_split(self):
        s = make_session()
        cols = ["img:data", "idx:age"]
        m1 = s.scan().select(cols).map(MeanProgram()).reduce()
        m2 = s.scan().select(cols).map(CountProgram()).reduce()
        out = [None, None]
        with GridFrontend(s, workers=4, tick_ms=self.TICK) as fe:
            fanout(2, lambda i: out.__setitem__(
                i, fe.submit(m1 if i == 0 else m2)))
            mv1, _ = out[0].result(WAIT)
            mv2, _ = out[1].result(WAIT)
        assert set(mv1) == set(cols)
        np.testing.assert_allclose(float(mv1["idx:age"]),
                                   s.table.column("idx", "age").mean(),
                                   atol=1e-3)
        assert int(mv2["img:data"]) == 64

    def test_different_scans_do_not_merge(self):
        s = make_session()
        pa = s.scan(prefix=b"img0000").map(CountProgram()).reduce()
        pb = s.scan().map(CountProgram()).reduce()
        out = [None, None]
        with GridFrontend(s, workers=4, tick_ms=self.TICK) as fe:
            fanout(2, lambda i: out.__setitem__(
                i, fe.submit(pa if i == 0 else pb)))
            va, _ = out[0].result(WAIT)
            vb, _ = out[1].result(WAIT)
            assert fe.stats.batch_merges == 0
        assert int(va) == 10 and int(vb) == 64


class TestMutationIsolation:
    def test_queries_never_observe_partial_uploads(self):
        """Counts observed under interleaved 2-row uploads are always in
        the set of committed totals; after each upload the test waits
        until a reader has seen the new total before the next one."""
        s = make_session()
        rounds, batch = 4, 2
        valid = {64 + r * batch for r in range(rounds + 1)}
        observed = []
        seen = threading.Condition()
        stop = threading.Event()
        with GridFrontend(s, workers=4, tick_ms=0.0) as fe:
            def reader():
                while not stop.is_set():
                    plan = s.scan().map(CountProgram()).reduce()
                    val, _ = fe.query(plan, timeout=WAIT)
                    with seen:
                        observed.append(int(val))
                        seen.notify_all()

            threads = [threading.Thread(target=reader) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                for r in range(rounds):
                    keys = [f"zz{r}_{j}" for j in range(batch)]
                    fe.upload(keys, row_batch(keys, seed=r + 10))
                    total = 64 + (r + 1) * batch
                    with seen:
                        assert seen.wait_for(lambda: total in observed,
                                             timeout=WAIT), \
                            "readers never saw the upload"
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=WAIT)
                    assert not t.is_alive()
            assert fe.stats.mutations == rounds
        assert set(observed) <= valid, sorted(set(observed) - valid)
        final, _ = s.scan().map(CountProgram()).reduce().collect()
        assert int(final) == 64 + rounds * batch

    def test_mutation_drains_in_flight_query(self):
        """An upload issued while a query executes waits for it; the
        query's answer reflects the pre-mutation epoch."""
        s = make_session()
        entered, release = threading.Event(), threading.Event()
        uploaded = threading.Event()
        with GridFrontend(s, workers=2, tick_ms=0.0) as fe:
            fut = fe.submit(gated_plan(s, release, entered))
            assert entered.wait(WAIT)

            def upload():
                fe.upload(["zz1"], row_batch(["zz1"]))
                uploaded.set()

            writer = threading.Thread(target=upload)
            writer.start()
            assert not uploaded.wait(0.2), "writer did not wait"
            release.set()
            writer.join(timeout=WAIT)
            assert uploaded.is_set()
            val, _ = fut.result(timeout=WAIT)
        assert int(val) == 64            # pre-upload snapshot
        assert s.table.num_rows == 65


class TestAdmission:
    def test_backpressure_rejects_beyond_max_pending(self):
        s = make_session()
        release = threading.Event()
        with GridFrontend(s, workers=1, tick_ms=0.0, max_pending=2) as fe:
            first = fe.submit(gated_plan(s, release))
            with pytest.raises(FrontendOverloadedError):
                for _ in range(4):
                    fe.submit(gated_plan(s, release))
            assert fe.stats.rejected >= 1
            release.set()
            first.result(timeout=WAIT)

    def test_deadline_expires_queued_query(self):
        s = make_session()
        entered, release = threading.Event(), threading.Event()
        with GridFrontend(s, workers=1, tick_ms=0.0) as fe:
            blocker = fe.submit(gated_plan(s, release, entered))
            assert entered.wait(WAIT)
            t0 = time.monotonic()
            doomed = fe.submit(s.scan().map(CountProgram()).reduce(),
                               deadline=1e-6)
            assert time.monotonic() > t0   # the deadline has passed
            release.set()
            with pytest.raises(QueryTimeoutError):
                doomed.result(timeout=WAIT)
            assert fe.stats.timeouts == 1
            blocker.result(timeout=WAIT)
            val, _ = fe.query(s.scan().map(CountProgram()).reduce(),
                              timeout=WAIT)
            assert int(val) == 64

    def test_deadline_enforced_during_execution(self):
        """A deadline that passes after dispatch aborts the query at its
        first fold-gate entry: the predicate holds the query until the
        deadline is behind it."""
        s = make_session()
        budget = 1.0
        start = {}

        def pred(cols):
            passed = threading.Event()
            while not passed.wait(0.01):
                if time.monotonic() > start["t"] + budget:
                    passed.set()
            return cols["age"] > -np.inf

        plan = s.scan().where(pred, ["age"]).map(CountProgram()).reduce()
        with GridFrontend(s, workers=1, tick_ms=0.0) as fe:
            start["t"] = time.monotonic()
            doomed = fe.submit(plan, deadline=budget)
            with pytest.raises(QueryTimeoutError):
                doomed.result(timeout=WAIT)
            assert fe.stats.timeouts == 1
            assert fe.stats.served == 0
            assert s.blocks.stats.folds == 0
            val, _ = fe.query(s.scan().where(
                lambda c: c["age"] > -np.inf, ["age"]).map(
                CountProgram()).reduce(), timeout=WAIT)
            assert int(val) == 64
            assert fe.stats.served == 1 and fe.stats.timeouts == 1

    def test_timed_out_sync_query_is_abandoned_once(self):
        s = make_session()
        entered, release = threading.Event(), threading.Event()
        with GridFrontend(s, workers=1, tick_ms=0.0) as fe:
            blocker = fe.submit(gated_plan(s, release, entered))
            assert entered.wait(WAIT)
            plan = s.scan().map(CountProgram()).reduce()
            with pytest.raises(QueryTimeoutError):
                fe.query(plan, timeout=0.05)
            assert fe.stats.timeouts == 1
            release.set()
            blocker.result(timeout=WAIT)
            val, _ = fe.query(s.scan().map(CountProgram()).reduce(),
                              timeout=WAIT)
            assert int(val) == 64
            snap = fe.stats.snapshot()
            assert snap.served == 2
            assert snap.failed == 1
            assert snap.timeouts == 1
            assert snap.served + snap.failed == snap.submitted

    def test_submit_after_close_raises(self):
        s = make_session()
        fe = GridFrontend(s, workers=1)
        fe.close()
        with pytest.raises(RuntimeError):
            fe.submit(s.scan().map(CountProgram()).reduce())
        assert s.fold_gate is None

    def test_double_close_is_idempotent(self):
        s = make_session()
        fe = GridFrontend(s, workers=1)
        fe.query(s.scan().map(CountProgram()).reduce(), timeout=WAIT)
        fe.close()
        fe.close()
        assert s.fold_gate is None
        with fe:
            pass

    def test_close_drains_in_flight_work(self):
        s = make_session()
        fe = GridFrontend(s, workers=2, tick_ms=0.0)
        futs = [fe.submit(s.scan().map(CountProgram()).reduce())
                for _ in range(4)]
        done = threading.Event()

        def mutate():
            fe.upload(["zzclose"], row_batch(["zzclose"]))
            done.set()

        mut = threading.Thread(target=mutate)
        mut.start()
        fe.close()
        mut.join(timeout=WAIT)
        assert done.is_set(), "mutation queued before close must complete"
        for f in futs:
            val, _rep = f.result(timeout=WAIT)
            assert int(val) in (64, 65)
        assert s.table.num_rows == 65
        snap = fe.stats.snapshot()
        assert snap.served == snap.submitted == 4
        assert snap.mutations == 1


def run_until(workers, watchers, enough):
    """Start ``workers`` and ``watchers`` (each ``fn(stop)``), stop them
    once ``enough`` is set, and join them all."""
    stop = threading.Event()
    threads = [threading.Thread(target=fn, args=(stop,))
               for fn in workers + watchers]
    for t in threads:
        t.start()
    try:
        assert enough.wait(WAIT)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()


class TestThreadSafetySubstrate:
    def test_lru_iteration_safe_under_concurrent_eviction(self):
        cache = LRUCache(32)
        errors = []
        walks = []
        enough = threading.Event()

        def churn(stop):
            i = 0
            while not stop.is_set():
                cache.put(i % 100, i)
                cache.get((i * 7) % 100)
                i += 1

        def walk(stop):
            try:
                while not stop.is_set():
                    for _, v in cache.items():
                        assert v is not None
                    list(cache.keys())
                    list(cache.values())
                    walks.append(1)
                    if len(walks) >= 3000:
                        enough.set()
            except RuntimeError as e:    # "dict changed size" = the bug
                errors.append(e)
                enough.set()

        run_until([churn] * 3, [walk] * 3, enough)
        assert not errors

    def test_atomic_stats_exact_under_contention(self):
        stats = FrontendStats()
        per = 500
        fanout(N, lambda i: [stats.inc(served=1, submitted=2)
                             for _ in range(per)])
        assert stats.served == N * per
        assert stats.submitted == 2 * N * per

    def test_atomic_stats_imax_monotone(self):
        stats = FrontendStats()
        fanout(8, lambda i: [stats.imax(queue_depth_peak=d)
                             for d in range(100)])
        assert stats.queue_depth_peak == 99

    def test_snapshot_is_consistent(self):
        stats = FrontendStats()
        torn = []
        looks = []
        enough = threading.Event()

        def bump(stop):
            while not stop.is_set():
                stats.inc(served=1, submitted=1)

        def observe(stop):
            while not stop.is_set():
                snap = stats.snapshot()
                if snap.served != snap.submitted:
                    torn.append((snap.served, snap.submitted))
                looks.append(1)
                if len(looks) >= 20000 and snap.served > 20000:
                    enough.set()

        run_until([bump] * 4, [observe] * 2, enough)
        assert not torn

    def test_blockstore_stats_snapshot(self):
        s = make_session()
        s.scan().map(CountProgram()).reduce().collect()
        snap = s.blocks.stats.snapshot()
        assert snap.folds == len(s.table.regions)
        s.upload(["zz1"], row_batch(["zz1"]))
        s.scan().map(CountProgram()).reduce().collect()
        assert s.blocks.stats.folds > snap.folds


class TestFrontendStats:
    def test_latency_percentiles(self):
        stats = FrontendStats()
        assert stats.latency_percentiles() == (0.0, 0.0)
        for ms in range(1, 101):
            stats.record_latency(ms / 1000.0)
        p50, p99 = stats.latency_percentiles()
        assert 0.045 <= p50 <= 0.055
        assert 0.095 <= p99 <= 0.100

    def test_queue_depth_peak_observed(self):
        s = make_session()
        plan_a = s.scan().map(MeanProgram()).reduce()
        plan_b = s.scan(prefix=b"img0000").map(MeanProgram()).reduce()
        with GridFrontend(s, workers=1, tick_ms=200.0) as fe:
            fa, fb = fe.submit(plan_a), fe.submit(plan_b)
            fa.result(timeout=WAIT)
            fb.result(timeout=WAIT)
            assert fe.stats.queue_depth_peak >= 2


def barrier_scenario(session, frontend_cls, plan):
    futs = [None] * N
    with frontend_cls(session, workers=4, tick_ms=5.0) as fe:
        fanout(N, lambda i: futs.__setitem__(i, fe.submit(plan)))
        results = [f.result(timeout=WAIT) for f in futs]
        snap = fe.stats.snapshot()
    return results, snap


def test_barrier_scenario_matches_reference():
    """The same eight-client barrier on both packages: one execution, one
    fold per region, equal results and equal ``FrontendStats``."""
    ref_table = make_population(64, split_bytes=2000)
    ref_s = RefSession(ref_table, default_eta=8)
    port_s = GridSession(port_table(ref_table), devices=["cpu"],
                         default_eta=8)
    want, wsnap = barrier_scenario(
        ref_s, RefFrontend,
        ref_s.scan().group_by("idx:sex").map(RefMean()).reduce())
    got, gsnap = barrier_scenario(
        port_s, GridFrontend,
        port_s.scan().group_by("idx:sex").map(MeanProgram()).reduce())
    assert dataclasses.asdict(gsnap) == dataclasses.asdict(wsnap)
    assert gsnap.coalesce_hits == N - 1 and gsnap.served == N
    for (w, wrep), (g, grep) in zip(want, got):
        np.testing.assert_array_equal(g.keys, np.asarray(w.keys))
        np.testing.assert_allclose(g.values.numpy(), np.asarray(w.values),
                                   rtol=1e-5, atol=1e-6)
        assert dataclasses.asdict(grep.query) == \
            dataclasses.asdict(wrep.query)
    first = got[0][0].values
    assert all(torch.equal(r.values, first) for r, _ in got)
    assert port_s.blocks.stats.folds == ref_s.blocks.stats.folds \
        == len(port_s.table.regions)
