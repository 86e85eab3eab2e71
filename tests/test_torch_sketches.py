"""The port's sketch programs against the reference's, bit for bit.

Count-min, HyperLogLog and the dyadic quantile sketch keep int32 state,
so the port is held to the reference exactly:

- the hashing (``_fmix32``, ``_derive_seeds``, the element keys) on
  ``-0.0``, NaN payloads, ±Inf and invalid rows;
- every program's ``map_chunk`` partial, the quantile sketch in its dense
  and count-min modes, at ±1e30 (past the float→int32 cast's range), NaN
  and ±Inf, against the reference's compiled fold (``jax.jit``, which is
  what its engine runs);
- finalize: count-min estimates and heavy hitters equal, HLL registers
  equal and its estimate at rtol 1e-6 (both sum 2^-register in float32, in
  different orders), quantile values at rtol 1e-7;
- end to end, a port ``GridSession(devices=["cpu"])`` and a reference
  session over one carried-across table: equal int leaves and equal
  ``QueryStats`` for plain, grouped and composite-key sketch queries, and
  after an upload and a remove.

Then the reference suite's own cases (``tests/test_sketches.py``) run on
the port: the error bounds against the port's exact oracles
(``repro_torch.core.ref``), the merge law, η invariance, the merge-ops
protocol, the engine funnel and the ``.npz`` spill round trip.
"""

import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stats as R  # noqa: E402
from repro.core.grid import GridSession as RefSession  # noqa: E402
from repro.utils import make_mesh  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core import stats as P  # noqa: E402
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.core.mapreduce import (  # noqa: E402
    MapReduceEngine,
    MapReduceProgram,
    partial_from_host,
    partial_to_host,
)
from repro_torch.core.stats import (  # noqa: E402
    CountMinProgram,
    FusedProgram,
    GroupedProgram,
    GroupedResult,
    HyperLogLogProgram,
    MeanProgram,
    QuantileSketchProgram,
)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_group_by import PAYLOAD, make_table  # noqa: E402
from torch_port_util import port_table  # noqa: E402


def both(name, mod):
    """One sketch spec, built from either package's stats module."""
    return {
        "countmin": lambda: mod.CountMinProgram(depth=4, width=1024, seed=11),
        "hll": lambda: mod.HyperLogLogProgram(p=11, seed=12),
        # dense: U = 2048 <= depth * width
        "quantile_dense": lambda: mod.QuantileSketchProgram(
            lo=-6.0, hi=7.0, log2_universe=11, depth=4, width=1024,
            probes=(0.25, 0.5, 0.9), seed=13),
        # count-min: U = 65536 > depth * width, hashed dyadic levels
        "quantile_cm": lambda: mod.QuantileSketchProgram(
            lo=-6.0, hi=7.0, log2_universe=16, depth=4, width=1024,
            probes=(0.5, 0.99), seed=14),
        # count-min with more items a chunk than buckets (U = 4096 > 2048):
        # the port counts per bucket first
        "quantile_cm_hist": lambda: mod.QuantileSketchProgram(
            lo=-4.0, hi=4.0, log2_universe=12, depth=1, width=2048,
            probes=(0.1, 0.5), seed=15),
    }[name]()


PROGRAMS = ["countmin", "hll", "quantile_dense", "quantile_cm",
            "quantile_cm_hist"]


def bits(v):
    return np.frombuffer(np.uint32(v).tobytes(), np.float32)[0]


def special_rows(seed, eta=16, E=300):
    """A chunk with every awkward value: ±0.0, NaN (two payloads), ±Inf,
    ±1e30 and ±3e9 bucket positions, and invalid rows."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(eta, E)) * 3).astype(np.float32)
    specials = [0.0, -0.0, np.nan, bits(0x7FC12345), bits(0xFFC00001),
                np.inf, -np.inf, 1e30, -1e30, 3e9, -3e9, 7.0, -6.0,
                6.9999995]
    flat = x.reshape(-1)
    pos = rng.choice(flat.size, 4 * len(specials), replace=False)
    flat[pos] = np.tile(np.asarray(specials, np.float32), 4)
    valid = rng.random(eta) < 0.75
    valid[0] = True
    return x, valid


def to_np(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.detach().cpu().numpy() for x in tree_leaves(tree)]


def ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_leaves_bitequal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        assert np.ascontiguousarray(x).tobytes() == \
            np.ascontiguousarray(y).tobytes()


# ----------------------------------------------------------------------
# hashing
# ----------------------------------------------------------------------

class TestHashing:
    def test_fmix32_bit_exact(self):
        rng = np.random.default_rng(0)
        h = np.concatenate([
            np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32),
            rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(
                np.uint32)])
        want = np.asarray(jax.jit(R._fmix32)(jnp.asarray(h)))
        got = P._fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        np.testing.assert_array_equal(P._host_fmix32(h), want)
        np.testing.assert_array_equal(R._host_fmix32(h), want)

    def test_mul32_is_the_uint32_product(self):
        rng = np.random.default_rng(1)
        h = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
        for c in (0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1, 0x10000):
            want = (h * np.uint32(c)).astype(np.int64)
            got = P._mul32(torch.from_numpy(h.astype(np.int64)), c).numpy()
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", [0, 1, 11, 2**32 - 1, 2**40 + 5, -1])
    def test_derive_seeds_equal(self, seed):
        assert P._derive_seeds(seed, 9) == R._derive_seeds(seed, 9)

    def test_host_element_keys_equal(self):
        x, _ = special_rows(2)
        np.testing.assert_array_equal(P.host_element_keys(x),
                                      R.host_element_keys(x))
        k = P.host_element_keys(np.array([0.0, -0.0], np.float32))
        assert k[0] == k[1] == 0

    @pytest.mark.parametrize("dtype", [np.float32, np.float16])
    def test_element_keys_bit_exact(self, dtype):
        x, valid = special_rows(3)
        with np.errstate(over="ignore"):     # ±1e30 is ±Inf in float16
            x = x.astype(dtype).reshape(16, 30, 10)
        rk, rv = jax.jit(R._element_keys)(jnp.asarray(x), jnp.asarray(valid))
        pk, pv = P._element_keys(torch.from_numpy(x), torch.from_numpy(valid))
        np.testing.assert_array_equal(pk.numpy(),
                                      np.asarray(rk).astype(np.int64))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


# ----------------------------------------------------------------------
# map_chunk partials and finalize
# ----------------------------------------------------------------------

def chunk_pair(name, seed, kind):
    rp, pp = both(name, R), both(name, P)
    if kind == "specials":
        x, valid = special_rows(seed)
    else:
        rng = np.random.default_rng(seed)
        x = (rng.normal(size=(16, 300)) * 2).astype(np.float32)
        valid = rng.random(16) < 0.8
    want = jax.jit(rp.map_chunk)(jnp.asarray(x), jnp.asarray(valid))
    got = pp.map_chunk(torch.from_numpy(x), torch.from_numpy(valid))
    return rp, pp, want, got


class TestPartials:
    @pytest.mark.parametrize("kind", ["normal", "specials"])
    @pytest.mark.parametrize("name", PROGRAMS)
    def test_map_chunk_bit_exact(self, name, kind):
        _, _, want, got = chunk_pair(name, 4, kind)
        assert_leaves_bitequal(to_np(got), ref_leaves(want))

    def test_far_values_land_in_the_top_bucket(self):
        """±1e30 and +Inf sit in bucket U-1 / 0 as the reference's
        saturating cast puts them, never in bucket 0 for +1e30."""
        qs = both("quantile_dense", P)
        x = torch.tensor([[1e30, -1e30, np.inf, -np.inf, np.nan, 3e9]],
                         dtype=torch.float32)
        cm = qs.map_chunk(x, torch.ones(1, dtype=torch.bool))["cm"]
        U = 1 << qs.log2_universe
        assert int(cm[U - 1]) == 3 and int(cm[0]) == 3
        b = qs._buckets(x.numpy().reshape(-1), np)
        np.testing.assert_array_equal(b, [U - 1, 0, U - 1, 0, 0, U - 1])

    @pytest.mark.parametrize("name", PROGRAMS)
    def test_merged_partials_and_finalize(self, name):
        parts = [chunk_pair(name, s, k) for s, k in
                 ((5, "normal"), (6, "specials"), (7, "normal"))]
        rp, pp = parts[0][0], parts[0][1]
        want, got = parts[0][2], parts[0][3]
        for _, _, w, g in parts[1:]:
            want, got = rp.merge(want, w), pp.merge(got, g)
        assert_leaves_bitequal(to_np(got), ref_leaves(want))
        rf, pf = rp.finalize(want), pp.finalize(got)
        for k in rf:
            a, b = np.asarray(rf[k]), pf[k].numpy()
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(b, a)
            elif k == "estimate":
                np.testing.assert_allclose(b, a, rtol=1e-6)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-7)

    def test_empty_quantile_finalizes_nan(self):
        for name in ("quantile_dense", "quantile_cm"):
            qs = both(name, P)
            res = qs.finalize(qs.zero((1,), np.float32))
            assert torch.isnan(res["quantiles"]).all()

    def test_countmin_host_helpers_equal(self):
        rng = np.random.default_rng(8)
        items = np.concatenate([np.full(700, 7.0, np.float32),
                                np.full(300, -0.0, np.float32),
                                rng.normal(size=2000).astype(np.float32)])
        rp, pp = both("countmin", R), both("countmin", P)
        rows = items.reshape(-1, 1)
        ok = np.ones(len(rows), bool)
        want = rp.finalize(jax.jit(rp.map_chunk)(jnp.asarray(rows),
                                                 jnp.asarray(ok)))
        got = pp.finalize(pp.map_chunk(torch.from_numpy(rows),
                                       torch.from_numpy(ok)))
        probe = np.unique(items)[:500]
        np.testing.assert_array_equal(pp.estimate(got, probe),
                                      rp.estimate(want, probe))
        assert pp.heavy_hitters(got, probe, 0.05) == \
            rp.heavy_hitters(want, probe, 0.05)
        assert pp.error_bound(3000) == rp.error_bound(3000)

    @pytest.mark.parametrize("name", ["quantile_dense", "quantile_cm"])
    def test_quantile_host_helpers_equal(self, name):
        rp, pp, want, got = chunk_pair(name, 9, "normal")
        rf, pf = rp.finalize(want), pp.finalize(got)
        probe = np.linspace(-5.5, 6.5, 97).astype(np.float32)
        np.testing.assert_array_equal(pp.rank_estimate(pf, probe),
                                      rp.rank_estimate(rf, probe))
        assert pp.rank_error_bound(4000) == rp.rank_error_bound(4000)
        assert pp.value_resolution() == rp.value_resolution()
        hp, hr = both("hll", P), both("hll", R)
        assert hp.std_error() == hr.std_error()


# ----------------------------------------------------------------------
# end to end: a port session against a reference session
# ----------------------------------------------------------------------

def sketch_plan(s, mod, group=None):
    q = s.scan().select("img:data")
    if group is not None:
        q = q.group_by(group)
    return (q.map(mod.CountMinProgram(depth=4, width=1024, seed=21))
            .map(mod.HyperLogLogProgram(p=10, seed=22))
            .map(mod.QuantileSketchProgram(lo=-5.0, hi=5.0, log2_universe=11,
                                           depth=4, width=1024,
                                           probes=(0.5, 0.95), seed=23))
            .map(mod.QuantileSketchProgram(lo=-4.0, hi=4.0, log2_universe=16,
                                           depth=2, width=512,
                                           probes=(0.5,), seed=24))
            .reduce().collect())


def run_steps(s, mod):
    out = {"plain": sketch_plan(s, mod),
           "grouped": sketch_plan(s, mod, "idx:site"),
           "composite": sketch_plan(s, mod, ["idx:site", "idx:sex"])}
    rng = np.random.default_rng(13)
    s.upload([b"b0003", b"c9999"], {
        "img": {"data": rng.normal(size=(2,) + PAYLOAD).astype(np.float32)},
        "idx": {"size": np.array([7_000_000, 8_000_000]),
                "age": np.array([33.0, 44.0], np.float32),
                "sex": np.array([1, 0], np.int8),
                "site": np.array([0, 2], np.int32)}},
        on_duplicate="overwrite")
    out["upload"] = sketch_plan(s, mod, "idx:site")
    s.remove(start="a0002", stop="a0007")
    out["remove"] = sketch_plan(s, mod)
    out["warm"] = sketch_plan(s, mod)
    return out


def result_leaves(x):
    if isinstance(x, (GroupedResult, R.GroupedResult)):
        return [np.asarray(x.keys)] + result_leaves(x.values)
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in result_leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in result_leaves(item)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


@pytest.fixture(scope="module")
def sessions():
    ref_table = make_table(per=16, seed=6, sites=3)
    ref_s = RefSession(ref_table, mesh=make_mesh((1,), ("data",)),
                       default_eta=8, fold_interpret=True)
    port_s = GridSession(port_table(ref_table), devices=["cpu"],
                         default_eta=8)
    return ref_s, port_s, run_steps(ref_s, R), run_steps(port_s, P)


STEPS = ["plain", "grouped", "composite", "upload", "remove", "warm"]


@pytest.mark.parametrize("step", STEPS)
def test_session_results_match_reference(sessions, step):
    _, _, want, got = sessions
    w, g = result_leaves(want[step][0]), result_leaves(got[step][0])
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.shape == b.shape
        if a.dtype == object or a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a)
        else:                 # HLL estimates, quantile values
            np.testing.assert_allclose(b, a, rtol=1e-6)


@pytest.mark.parametrize("step", STEPS)
def test_session_counters_match_reference(sessions, step):
    _, _, want, got = sessions
    assert dataclasses.asdict(got[step][1].query) == \
        dataclasses.asdict(want[step][1].query)


def test_session_engine_counters_match_reference(sessions):
    ref_s, port_s, _, got = sessions
    assert got["warm"][1].query.rows_folded == 0
    assert port_s.engine.fold_path_counts == {
        "kernel": ref_s.engine.fold_path_counts["pallas"],
        "torch": ref_s.engine.fold_path_counts["xla"]}
    assert port_s.engine.fold_path_counts["kernel"] == 0
    assert port_s.engine.merge_path_counts == ref_s.engine.merge_path_counts
    assert dataclasses.asdict(port_s.blocks.stats) == \
        dataclasses.asdict(ref_s.blocks.stats)


# ----------------------------------------------------------------------
# the reference suite's cases, on the port
# ----------------------------------------------------------------------

SKETCHES = [
    CountMinProgram(depth=4, width=1024, seed=11),
    HyperLogLogProgram(p=11, seed=12),
    QuantileSketchProgram(lo=-4.0, hi=4.0, log2_universe=11, depth=4,
                          width=1024, probes=(0.25, 0.5, 0.9), seed=13),
    QuantileSketchProgram(lo=-4.0, hi=4.0, log2_universe=16, depth=4,
                          width=1024, probes=(0.5,), seed=14),
]
SKETCH_IDS = ["countmin", "hll", "quantile_dense", "quantile_cm"]


def fold_items(program, items, eta=256):
    """Chunk ``items`` (as [n, 1] rows) through map_chunk + merge."""
    rows = torch.from_numpy(np.asarray(items, np.float32).reshape(-1, 1))
    acc = program.zero((1,), np.float32)
    for start in range(0, len(rows), eta):
        chunk = rows[start:start + eta]
        acc = program.merge(acc, program.map_chunk(
            chunk, torch.ones(len(chunk), dtype=torch.bool)))
    return acc


def host(tree):
    return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                    else x, tree)


def assert_trees_bitequal(a, b):
    assert_leaves_bitequal(to_np(a), to_np(b))


def quantile_rank_err(qs, items, quantiles, targets):
    res = qs.value_resolution()
    v = np.asarray(quantiles, np.float64)
    below, _ = ref.rank_interval(items, v - res)
    _, at_or_below = ref.rank_interval(items, v + res)
    return ref.interval_distance(targets, below, at_or_below)


class TestValidation:
    def test_bad_params_raise(self):
        for make in (lambda: CountMinProgram(depth=0),
                     lambda: CountMinProgram(width=1000),
                     lambda: HyperLogLogProgram(p=3),
                     lambda: HyperLogLogProgram(p=17),
                     lambda: QuantileSketchProgram(lo=1.0, hi=0.0),
                     lambda: QuantileSketchProgram(probes=(0.0,)),
                     lambda: QuantileSketchProgram(probes=()),
                     lambda: QuantileSketchProgram(width=100)):
            with pytest.raises(ValueError):
                make()

    def test_cache_keys_distinguish_params(self):
        assert CountMinProgram(seed=1).cache_key() != \
            CountMinProgram(seed=2).cache_key()
        assert QuantileSketchProgram(probes=(0.5,)).cache_key() != \
            QuantileSketchProgram(probes=(0.9,)).cache_key()


class TestBounds:
    def test_countmin_within_documented_bound(self):
        rng = np.random.default_rng(0)
        universe = np.arange(200, dtype=np.float32)
        weights = 1.0 / np.arange(1, 201) ** 1.2
        items = rng.choice(universe, size=8000, p=weights / weights.sum())
        cm = SKETCHES[0]
        res = host(cm.finalize(fold_items(cm, items)))
        uniq, counts = ref.exact_frequencies(items)
        est = cm.estimate(res, uniq)
        assert int(res["n"]) == len(items)
        assert (est >= counts).all()
        eps_n, delta = cm.error_bound(len(items))
        violations = int((est - counts > eps_n).sum())
        assert violations <= max(1, int(np.ceil(2 * delta * len(uniq))))
        exact = ref.exact_heavy_hitters(items, phi=0.05)
        got = {v for v, _ in cm.heavy_hitters(res, uniq, phi=0.05)}
        assert {v for v, _ in exact} <= got

    @pytest.mark.parametrize("n_distinct", [100, 2000, 20000])
    def test_hll_within_std_error_multiple(self, n_distinct):
        rng = np.random.default_rng(n_distinct)
        uniq = rng.normal(size=n_distinct).astype(np.float32)
        items = np.repeat(uniq, rng.integers(1, 5, n_distinct))
        hll = HyperLogLogProgram(p=12, seed=5)
        res = host(hll.finalize(fold_items(hll, items, eta=4096)))
        true = ref.exact_distinct(items)
        assert abs(float(res["estimate"]) - true) / true \
            <= 4 * hll.std_error()

    def test_hll_small_range_and_empty(self):
        hll = HyperLogLogProgram(p=12, seed=5)
        res = hll.finalize(fold_items(hll, np.arange(40, dtype=np.float32)))
        assert abs(float(res["estimate"]) - 40) <= 2
        empty = HyperLogLogProgram(p=10)
        assert float(empty.finalize(empty.zero((1,), None))["estimate"]) \
            == 0.0

    @pytest.mark.parametrize("mode", ["dense", "cm"])
    @pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
    def test_quantile_rank_error_within_documented_bound(self, dist, mode):
        rng = np.random.default_rng(["uniform", "lognormal",
                                     "bimodal"].index(dist))
        n = 6000
        if dist == "uniform":
            items = rng.uniform(-4, 4, n)
        elif dist == "lognormal":
            items = rng.lognormal(0.0, 0.7, n) - 2.0
        else:
            items = np.concatenate([rng.normal(-2, 0.3, n // 2),
                                    rng.normal(2.5, 0.5, n - n // 2)])
        items = np.clip(items, -4, 3.999).astype(np.float32)
        qs = QuantileSketchProgram(lo=-4.0, hi=4.0,
                                   log2_universe=11 if mode == "dense" else 16,
                                   depth=4, width=1024,
                                   probes=(0.1, 0.5, 0.9, 0.99), seed=13)
        assert qs.dense == (mode == "dense")
        res = host(qs.finalize(fold_items(qs, items, eta=2000)))
        assert int(res["n"]) == n
        targets = np.ceil(np.asarray(qs.probes) * n)
        err = quantile_rank_err(qs, items, res["quantiles"], targets)
        assert (err <= qs.rank_error_bound(n) + 1).all()
        ranks = qs.rank_estimate(res, res["quantiles"])
        b_items = qs._buckets(ref.canonical_items(items), np)
        b_query = qs._buckets(np.asarray(res["quantiles"], np.float32), np)
        true_ranks = np.array([(b_items < bq).sum() for bq in b_query])
        assert (ranks >= true_ranks).all()
        assert (ranks - true_ranks <= qs.rank_error_bound(n) + 1e-9).all()


class TestMergeLaw:
    @pytest.mark.parametrize("program", SKETCHES, ids=SKETCH_IDS)
    def test_merge_order_invariance_bitwise(self, program):
        rng = np.random.default_rng(7)
        items = rng.normal(size=3000).astype(np.float32).clip(-3.9, 3.9)
        cuts = np.sort(rng.choice(np.arange(1, 3000), 12, replace=False))
        parts = [fold_items(program, c) for c in np.split(items, cuts)]

        def funnel(ps):
            acc = ps[0]
            for p in ps[1:]:
                acc = program.merge(acc, p)
            return acc

        def tree(ps):
            ps = list(ps)
            while len(ps) > 1:
                ps = [program.merge(ps[i], ps[i + 1])
                      if i + 1 < len(ps) else ps[i]
                      for i in range(0, len(ps), 2)]
            return ps[0]

        perm = list(rng.permutation(len(parts)))
        merged = [funnel(parts), tree(parts),
                  funnel([parts[i] for i in perm])]
        for other in merged[1:]:
            assert_trees_bitequal(merged[0], other)
            assert_trees_bitequal(program.finalize(merged[0]),
                                  program.finalize(other))

    @pytest.mark.parametrize("program", SKETCHES, ids=SKETCH_IDS)
    def test_chunk_size_invariance_bitwise(self, program):
        rng = np.random.default_rng(8)
        items = rng.normal(size=1111).astype(np.float32).clip(-3.9, 3.9)
        assert_trees_bitequal(fold_items(program, items, eta=64),
                              fold_items(program, items, eta=333))

    @pytest.mark.parametrize("program", SKETCHES, ids=SKETCH_IDS)
    def test_engine_funnel_matches_pairwise_merge(self, program):
        rng = np.random.default_rng(9)
        items = rng.normal(size=900).astype(np.float32).clip(-3.9, 3.9)
        parts = [fold_items(program, c) for c in np.split(items, 3)]
        eng = MapReduceEngine(["cpu"], merge_strategy="funnel")
        got = eng.merge_finalize(program, parts, (1,), np.float32)
        want = program.finalize(
            program.merge(program.merge(parts[0], parts[1]), parts[2]))
        assert_trees_bitequal(got, want)

    def test_grouped_sketch_merge_respects_max(self):
        hll = HyperLogLogProgram(p=8, seed=1)
        gp = GroupedProgram(FusedProgram((MeanProgram(), hll)), 2)
        rng = np.random.default_rng(3)
        rows = torch.from_numpy(rng.normal(size=(8, 1)).astype(np.float32))
        even = torch.from_numpy(np.arange(8) % 2 == 0)
        gmask = torch.stack([even, ~even])
        a = gp.map_chunk(rows, gmask)
        b = gp.map_chunk(rows.flip(0), gmask)
        m = gp.merge(a, b)
        np.testing.assert_array_equal(
            m["private"][0]["regs"].numpy(),
            np.maximum(a["private"][0]["regs"].numpy(),
                       b["private"][0]["regs"].numpy()))
        (dt, pool), = m["shared"].items()
        np.testing.assert_array_equal(
            pool["count"].numpy(),
            a["shared"][dt]["count"].numpy()
            + b["shared"][dt]["count"].numpy())


class TestMergeOpsProtocol:
    def test_default_is_all_sum_and_hll_is_max(self):
        p = MeanProgram()
        assert p.merge_ops_for(p.zero((1,), np.float32)) is None
        hll = HyperLogLogProgram(p=6)
        assert hll.merge_ops_for(hll.zero((1,), np.float32)) == ["max"]

    def test_fused_composes_private_ops_before_shared(self):
        fused = FusedProgram((MeanProgram(), HyperLogLogProgram(p=6),
                              CountMinProgram(depth=2, width=64)))
        z = fused.zero((1,), np.float32)
        ops = fused.merge_ops_for(z)
        leaves = tree_leaves(z)
        assert len(ops) == len(leaves)
        assert ops.count("max") == 1
        max_leaf = leaves[ops.index("max")]
        assert tuple(max_leaf.shape) == (64,)
        assert max_leaf.dtype == torch.int32
        gp = GroupedProgram(fused, 3)
        assert gp.merge_ops_for(gp.zero((1,), np.float32)) == \
            fused.merge_ops_for(z)

    def test_engine_rejects_wrong_length_ops(self):
        class Bad(MapReduceProgram):
            additive = True

            def zero(self, row_shape, dtype):
                return {"a": torch.zeros((), dtype=torch.int32),
                        "b": torch.zeros((), dtype=torch.int32)}

            def map_chunk(self, rows, valid):
                return self.zero((), None)

            def merge(self, a, b):
                return tree_map(lambda x, y: x + y, a, b)

            def finalize(self, p):
                return p

            def merge_ops_for(self, partial):
                return ["max"]                    # wrong length

        eng = MapReduceEngine(["cpu"], merge_strategy="funnel")
        bad = Bad()
        with pytest.raises(ValueError, match="merge_ops_for"):
            eng.merge_finalize(bad, [bad.zero((), None), bad.zero((), None)],
                               (1,), np.float32)


class TestSpillRoundTrip:
    @pytest.mark.parametrize("program", SKETCHES, ids=SKETCH_IDS)
    def test_npz_round_trip_bitwise(self, program):
        rng = np.random.default_rng(5)
        items = rng.normal(size=500).astype(np.float32).clip(-3.9, 3.9)
        partial = fold_items(program, items)
        leaves, treedef = partial_to_host(partial)
        buf = io.BytesIO()
        np.savez(buf, *leaves)
        buf.seek(0)
        loaded = np.load(buf)
        back = partial_from_host([loaded[k] for k in loaded.files], treedef)
        assert_trees_bitequal(partial, back)
        assert_trees_bitequal(program.finalize(partial),
                              program.finalize(back))


def port_session(per, seed, sites=5, eta=8):
    return GridSession(port_table(make_table(per=per, seed=seed,
                                             sites=sites)),
                       devices=["cpu"], default_eta=eta)


class TestSessionIntegration:
    def test_sketches_match_oracles_end_to_end(self):
        s = port_session(32, 6)
        (cm_res, hll_res, q_res, _), _ = sketch_plan(s, P)
        data = s.table.column("img", "data")
        cm = CountMinProgram(depth=4, width=1024, seed=21)
        assert int(cm_res["n"]) == data.size
        uniq, counts = ref.exact_frequencies(data)
        assert (cm.estimate(host(cm_res), uniq) >= counts).all()
        hll = HyperLogLogProgram(p=10, seed=22)
        true_d = ref.exact_distinct(data)
        assert abs(float(hll_res["estimate"]) - true_d) \
            <= 4 * hll.std_error() * true_d
        qs = QuantileSketchProgram(lo=-5.0, hi=5.0, log2_universe=11,
                                   depth=4, width=1024, probes=(0.5, 0.95),
                                   seed=23)
        targets = np.ceil(np.asarray(qs.probes) * data.size)
        err = quantile_rank_err(qs, data, q_res["quantiles"].numpy(),
                                targets)
        assert (err <= qs.rank_error_bound(data.size) + 1).all()

    def test_repeat_query_folds_zero_rows_and_is_bitwise_stable(self):
        s = port_session(16, 7)
        cold, r1 = sketch_plan(s, P)
        assert r1.query.rows_folded == s.table.num_rows
        warm, r2 = sketch_plan(s, P)
        assert r2.query.rows_folded == 0
        assert r2.query.partials_reused == r2.query.partials_total
        assert_trees_bitequal(cold, warm)
        fresh, _ = sketch_plan(GridSession(s.table, devices=["cpu"],
                                           default_eta=8), P)
        assert_trees_bitequal(cold, fresh)

    def test_eta_invariance_bitwise(self):
        s = port_session(20, 9, eta=4)
        plan = lambda: (s.scan().select("img:data")         # noqa: E731
                        .map(SKETCHES[0]).map(SKETCHES[1]).map(SKETCHES[3])
                        .reduce())
        a, _ = plan().collect(eta=4)
        b, _ = plan().collect(eta=16)
        assert_trees_bitequal(a, b)

    def test_grouped_sketches_match_per_group_oracles(self):
        s = port_session(24, 10, sites=3)
        hll = HyperLogLogProgram(p=10, seed=31)
        res, _ = (s.scan().select("img:data").group_by("idx:site")
                  .map(hll).reduce().collect())
        data = s.table.column("img", "data")
        sites = s.table.column("idx", "site")
        for g, k in enumerate(res.keys):
            true_d = ref.exact_distinct(data[sites == k])
            assert abs(float(res.values["estimate"][g]) - true_d) \
                <= 4 * hll.std_error() * true_d

    def test_mutation_refolds_dirty_and_matches_fresh_session(self):
        s = port_session(16, 12)
        sketch_plan(s, P)
        rng = np.random.default_rng(13)
        s.upload([b"b0003"], {
            "img": {"data": rng.normal(size=(1,) + PAYLOAD)
                    .astype(np.float32)},
            "idx": {"size": np.array([7_000_000]),
                    "age": np.array([33.0], np.float32),
                    "sex": np.array([1], np.int8),
                    "site": np.array([0], np.int32)}},
            on_duplicate="overwrite")
        warm, rep = sketch_plan(s, P)
        assert 0 < rep.query.rows_folded < s.table.num_rows
        fresh, _ = sketch_plan(GridSession(s.table, devices=["cpu"],
                                           default_eta=8), P)
        assert_trees_bitequal(warm, fresh)
