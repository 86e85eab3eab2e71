"""The slice end to end: the port's ``GridSession`` against the reference's.

One small population table (``scale=0.05``, 4x4x4 volumes) is carried
across with ``repro_torch.convert.table_from_arrays`` and both sessions run
the same verb sequence: a cold grouped two-column query, a warm repeat, an
upload, a remove, a rebalance, a ``run_where`` and the kernel-backed
``run``.  Results must agree at fp32 tolerance (rtol 1e-4, atol 1e-3: both
fold in fp32, in different orders) and every ``QueryStats`` counter must be
equal, with ``fold_path_counts`` mapped pallas->kernel, xla->torch.  The
reference runs its Pallas kernel in interpret mode on one CPU device; the
port runs the kernel's plain version on ``devices=["cpu"]``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.grid import GridSession as RefSession  # noqa: E402
from repro.core.query import age_sex_predicate as ref_pred  # noqa: E402
from repro.core import stats as R  # noqa: E402
from repro.data.pipeline import (  # noqa: E402
    synthetic_image_population as ref_population,
)
from repro.utils import make_mesh  # noqa: E402
from repro_torch.core import stats as P  # noqa: E402
from repro_torch.core.balancer import NodeSpec  # noqa: E402
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.core.query import age_sex_predicate  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    synthetic_image_population,
)
from repro_torch.utils import tree_flatten  # noqa: E402
from torch_port_util import port_table  # noqa: E402

PAYLOAD = (4, 4, 4)


def new_rows(n, seed):
    r = np.random.default_rng(seed)
    return {"img": {"data": r.normal(size=(n,) + PAYLOAD).astype(np.float32)},
            "idx": {"size": r.integers(6_000_000, 20_000_001, n),
                    "age": r.uniform(4, 98, n).astype(np.float32),
                    "sex": r.integers(0, 2, n).astype(np.int8)}}


def grouped_query(s, M, Me, pred):
    return (s.scan().select(["img:data", "idx:age"])
            .where(pred(20.0, 60.0), ["age"]).group_by("idx:sex")
            .map(M()).map(Me()).reduce().collect())


def run_sequence(s, mod, pred, up_keys, up_rows):
    """The verb sequence; returns ``{step: (result, report)}``."""
    out = {}
    q = lambda: grouped_query(s, mod.MomentsProgram, mod.MeanProgram, pred)
    out["cold"] = q()
    out["warm"] = q()
    s.upload(up_keys, up_rows)
    out["upload"] = q()
    s.remove(start="sub000040", stop="sub000048")
    out["remove"] = q()
    s.rebalance()
    out["rebalance"] = q()
    out["run_where"] = s.run_where(pred(30.0, 50.0, sex=1),
                                   mod.VarianceProgram(), ["age", "sex"])
    out["run_kernel"] = s.run(mod.MeanProgram(),
                              impl="pallas" if mod is R else "kernel")
    return out


@pytest.fixture(scope="module")
def both():
    ref_table = ref_population(payload_shape=PAYLOAD, scale=0.05, seed=3)
    table = port_table(ref_table)
    up_keys = [f"sub{i:06d}a" for i in range(0, 60, 5)]
    up_rows = new_rows(len(up_keys), seed=4)
    ref = RefSession(ref_table, mesh=make_mesh((1,), ("data",)),
                     fold_interpret=True)
    port = GridSession(table, devices=["cpu"])
    got = run_sequence(port, P, age_sex_predicate, up_keys, up_rows)
    want = run_sequence(ref, R, ref_pred, up_keys, up_rows)
    return ref, port, want, got


def leaves(x):
    """Comparable numpy leaves of a (possibly grouped / per-column)
    result, in a structure-independent order."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in leaves(item)]
    if hasattr(x, "keys") and hasattr(x, "values"):       # GroupedResult
        return [np.asarray(x.keys)] + leaves(x.values)
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


STEPS = ["cold", "warm", "upload", "remove", "rebalance", "run_where",
         "run_kernel"]


@pytest.mark.parametrize("step", STEPS)
def test_results_match_reference(both, step):
    _, _, want, got = both
    w, g = leaves(want[step][0]), leaves(got[step][0])
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("step", STEPS)
def test_counters_match_reference(both, step):
    _, _, want, got = both
    assert dataclasses.asdict(got[step][1].query) == \
        dataclasses.asdict(want[step][1].query)
    assert dataclasses.astuple(got[step][1].mapreduce) == \
        dataclasses.astuple(want[step][1].mapreduce)
    assert got[step][1].plan_cache_hit == want[step][1].plan_cache_hit


def test_incremental_counters(both):
    _, _, _, got = both
    q = {k: v[1].query for k, v in got.items()}
    assert q["cold"].rows_folded > 0 and q["cold"].gather_count > 0
    assert q["warm"].rows_folded == 0 and q["warm"].gather_count == 0
    for step in ("upload", "remove"):   # only the dirty regions re-fold
        assert 0 < q[step].partials_total - q[step].partials_reused \
            < q[step].partials_total
    assert q["rebalance"].rows_folded == 0


def test_session_counters_match_reference(both):
    ref, port, _, _ = both
    assert port.engine.fold_path_counts == {
        "kernel": ref.engine.fold_path_counts["pallas"],
        "torch": ref.engine.fold_path_counts["xla"]}
    assert port.engine.compile_count == ref.engine.compile_count
    assert port.engine.merge_path_counts == ref.engine.merge_path_counts
    pm, rm = dataclasses.asdict(port.metrics), dataclasses.asdict(ref.metrics)
    assert pm == rm
    assert dataclasses.asdict(port.blocks.stats) == \
        dataclasses.asdict(ref.blocks.stats)


def test_retrieve_and_table_match(both):
    ref, port, _, _ = both
    rk, rv = ref.retrieve("img", "data", start="sub000010", stop="sub000020")
    pk, pv = port.retrieve("img", "data", start="sub000010", stop="sub000020")
    np.testing.assert_array_equal(rk, pk)
    np.testing.assert_array_equal(rv, pv)
    assert [r.signature for r in ref.table.regions] == \
        [r.signature for r in port.table.regions]


def test_compact_gather_matches_reference():
    ref_table = ref_population(payload_shape=PAYLOAD, scale=0.05, seed=5)
    ref = RefSession(ref_table, mesh=make_mesh((1,), ("data",)),
                     fold_interpret=True)
    port = GridSession(port_table(ref_table), devices=["cpu"])
    want = ref.run_where(ref_pred(20.0, 22.0), R.MeanProgram(), ["age"])
    got = port.run_where(age_sex_predicate(20.0, 22.0), P.MeanProgram(),
                         ["age"])
    assert got[1].query.gather_path == want[1].query.gather_path == "compact"
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-3)
    assert dataclasses.asdict(got[1].query) == dataclasses.asdict(
        want[1].query)


def test_population_draws_match_reference():
    ref = ref_population(payload_shape=(2, 3, 2), scale=0.02, seed=9)
    port = synthetic_image_population(payload_shape=(2, 3, 2), scale=0.02,
                                      seed=9)
    np.testing.assert_array_equal(ref.keys, port.keys)
    for fam, qual in [("img", "data"), ("idx", "age"), ("idx", "sex"),
                      ("idx", "size")]:
        np.testing.assert_array_equal(ref.column(fam, qual),
                                      port.column(fam, qual))


def test_four_owners_against_numpy_oracle():
    """Four logical owners on the CPU: regions spread, the tree merge runs,
    a rebalance with new node powers moves regions and re-folds nothing,
    and the grouped query equals a float64 numpy groupby."""
    table = synthetic_image_population(payload_shape=PAYLOAD, scale=0.2,
                                       seed=7)
    nodes = [NodeSpec(0, cores=12, mips=1.0), NodeSpec(1, cores=12, mips=1.0),
             NodeSpec(2, cores=32, mips=1.6), NodeSpec(3, cores=32, mips=1.6)]
    s = GridSession(table, devices=["cpu"] * 4, nodes=nodes)
    assert len(table.regions) >= 2
    res, rep = grouped_query(s, P.MomentsProgram, P.MeanProgram,
                             age_sex_predicate)
    assert rep.query.merge_path == "tree"
    assert len(set(s.placement.alloc.values())) > 1

    data = table.column("img", "data").astype(np.float64)
    age = table.column("idx", "age")
    sex = table.column("idx", "sex")
    sel = (age >= 20.0) & (age < 60.0)
    moments, mean = res["img:data"].values
    for g, key in enumerate(res["img:data"].keys):
        rows = data[sel & (sex == key)]
        np.testing.assert_allclose(mean[g].numpy(), rows.mean(0),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(moments["var"][g].numpy(), rows.var(0),
                                   rtol=1e-4, atol=1e-3)
        assert float(moments["count"][g]) == len(rows)

    moved = s.rebalance(nodes=[dataclasses.replace(n, mips=m) for n, m in
                               zip(nodes, (1.6, 1.6, 0.2, 0.2))])
    assert moved
    again, rep2 = grouped_query(s, P.MomentsProgram, P.MeanProgram,
                                age_sex_predicate)
    assert rep2.query.rows_folded == 0
    for a, b in zip(tree_flatten(res["img:data"].values)[0],
                    tree_flatten(again["img:data"].values)[0]):
        assert torch.equal(a, b)


def _tier_and_fault_run(GS, mod, pred, table, faults, tmp, **extra):
    inj = faults.FaultInjector(rules=(
        faults.FaultRule("gather", "transient", after=2, times=2),
        faults.FaultRule("device_put", "transient", after=1, times=1),
        faults.FaultRule("spill_read", "corrupt", after=0, times=1)), seed=1)
    s = GS(table, device_budget=3 * 4096, host_budget=2 * 4096,
           partial_budget=2000, spill_dir=str(tmp), prefetch=False,
           fault_injector=inj, retry_policy=faults.RetryPolicy(
               base_delay_s=0.0), **extra)
    q = lambda: grouped_query(s, mod.MomentsProgram, mod.MeanProgram, pred)
    out = [q()]
    keys = ["sub000003a", "sub000004a"]
    s.upload(keys, new_rows(len(keys), seed=12))
    out += [q(), q()]
    stats = dataclasses.asdict(s.blocks.stats)
    s.close()
    return out, stats


def test_tiers_spill_and_faults_match_reference(tmp_path):
    """Byte budgets small enough to demote and spill blocks and partials,
    with transient gather/transfer faults and one corrupted spill read:
    results and every counter, gauge and fault tally must match."""
    from repro.core import faults as RF
    from repro_torch.core import faults as PF
    ref_table = ref_population(payload_shape=PAYLOAD, scale=0.05, seed=11)
    port = port_table(ref_table)
    want, wstats = _tier_and_fault_run(
        RefSession, R, ref_pred, ref_table, RF, tmp_path / "ref",
        mesh=make_mesh((1,), ("data",)), fold_interpret=True)
    got, gstats = _tier_and_fault_run(
        GridSession, P, age_sex_predicate, port, PF, tmp_path / "port",
        devices=["cpu"])
    assert gstats == wstats
    assert gstats["partial_spills"] > 0 and gstats["retries"] > 0
    assert gstats["partial_spill_reads"] + gstats["spill_corruptions"] > 0
    for (gr, grep), (wr, wrep) in zip(got, want):
        assert dataclasses.asdict(grep.query) == dataclasses.asdict(
            wrep.query)
        for a, b in zip(leaves(wr), leaves(gr)):
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64),
                                       rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("impls", [("pallas", "kernel"), ("xla", "torch")])
def test_inf_voxel_in_selected_row_matches_reference(impls):
    """One Inf voxel in a row that the predicate selects: the grouped Mean
    and Moments carry NaN/Inf at the reference session's positions, on each
    fold path."""
    ref_impl, impl = impls
    ref_table = ref_population(payload_shape=PAYLOAD, scale=0.05, seed=11)
    age = ref_table.column("idx", "age")
    row = int(np.nonzero((age >= 20.0) & (age < 60.0))[0][0])
    data = ref_table.column("img", "data")[row:row + 1].copy()
    data[0, 1, 2, 3] = np.inf
    ref_table.upload(ref_table.keys[row:row + 1], {
        "img": {"data": data},
        "idx": {q: ref_table.column("idx", q)[row:row + 1]
                for q in ("size", "age", "sex")}}, on_duplicate="overwrite")
    table = port_table(ref_table)
    assert np.isinf(table.column("img", "data")[row, 1, 2, 3])
    ref = RefSession(ref_table, mesh=make_mesh((1,), ("data",)),
                     fold_impl=ref_impl, fold_interpret=True)
    port = GridSession(table, devices=["cpu"], fold_impl=impl)
    want, _ = grouped_query(ref, R.MomentsProgram, R.MeanProgram, ref_pred)
    got, _ = grouped_query(port, P.MomentsProgram, P.MeanProgram,
                           age_sex_predicate)
    w, g = leaves(want), leaves(got)
    assert len(w) == len(g)
    assert any(not np.isfinite(x).all() for x in w
               if np.issubdtype(x.dtype, np.floating))
    for a, b in zip(w, g):
        if not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
            continue
        for what in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(what(b), what(a))
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-4, atol=1e-3)
