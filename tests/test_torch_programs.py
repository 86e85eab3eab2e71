"""The port's MapReduce engine and exact statistic programs against the
reference (``repro.core.mapreduce`` / ``repro.core.stats``).

The same numpy blocks fold through both engines (``fold_block``), merge
and finalize (``merge_finalize``); the finalized results must agree at
fp32 tolerance (rtol 1e-4, atol 1e-3: both accumulate in fp32, in
different orders), and ``CountProgram``'s int32 results exactly.  The
reference runs its Pallas path in interpret mode; the port's "kernel" path
runs the kernel's plain version on these CPU tensors.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stats as R  # noqa: E402
from repro.core.mapreduce import MapReduceEngine as RefEngine  # noqa: E402
from repro.utils import make_mesh  # noqa: E402
from repro_torch.convert import partial_from_numpy  # noqa: E402
from repro_torch.core import stats as P  # noqa: E402
from repro_torch.core.mapreduce import (  # noqa: E402
    MapReduceEngine,
    partial_from_host,
    partial_to_host,
)
from repro_torch.utils import tree_flatten, tree_map  # noqa: E402

PAYLOAD = (3, 4)
ROWS = (40, 70, 90)
ETA = 4


def programs(mod, name):
    """One program spec, built from either package's stats module."""
    hist = mod.HistogramProgram(lo=-3.0, hi=3.0, bins=8)
    members = (mod.MeanProgram(), mod.VarianceProgram(), mod.MomentsProgram())
    return {
        "mean": mod.MeanProgram(),
        "variance": mod.VarianceProgram(),
        "moments": mod.MomentsProgram(),
        "count": mod.CountProgram(),
        "histogram": hist,
        "fused_cse": mod.FusedProgram(members),
        "fused_naive": mod.FusedProgram(members, cse=False),
        "fused_private": mod.FusedProgram((mod.MomentsProgram(),
                                           mod.CountProgram(), hist)),
    }[name]


NAMES = ["mean", "variance", "moments", "count", "histogram", "fused_cse",
         "fused_naive", "fused_private"]


def blocks(seed):
    r = np.random.default_rng(seed)
    out = []
    for n in ROWS:
        x = r.normal(size=(n,) + PAYLOAD).astype(np.float32)
        m = r.random(n) > 0.3
        x[~m] = np.nan                 # masked rows never reach a sum
        g = r.integers(0, 3, n).astype(np.int32)
        out.append((x, m, g))
    return out


def ref_run(program, bs, impl, groups, owners=None):
    eng = RefEngine(make_mesh((1,), ("data",)), fold_impl=impl,
                    fold_interpret=True)
    parts = [eng.fold_block(program, jnp.asarray(x), jnp.asarray(m), ETA,
                            PAYLOAD, np.float32,
                            gids=jnp.asarray(g) if groups else None,
                            num_groups=groups)
             for x, m, g in bs]
    return eng.merge_finalize(program, parts, PAYLOAD, np.float32), eng


def port_run(program, bs, impl, groups, devices=("cpu",), owners=None):
    eng = MapReduceEngine(list(devices), fold_impl=impl)
    parts = [eng.fold_block(program, torch.from_numpy(x), m, ETA, PAYLOAD,
                            np.float32, gids=g if groups else None,
                            num_groups=groups, owner=o)
             for (x, m, g), o in zip(bs, owners or [None] * len(bs))]
    return eng.merge_finalize(program, parts, PAYLOAD, np.float32,
                              owners=owners), eng


def assert_tree_close(got, want, exact=False):
    gl, gdef = tree_flatten(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64),
                                       rtol=1e-4, atol=1e-3)


IMPLS = [("pallas", "kernel"), ("xla", "torch")]


@pytest.mark.parametrize("impl", IMPLS, ids=["kernel", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_ungrouped_program_matches_reference(name, impl):
    bs = blocks(1)
    want, reng = ref_run(programs(R, name), bs, impl[0], 0)
    got, peng = port_run(programs(P, name), bs, impl[1], 0)
    assert_tree_close(got, want, exact=name == "count")
    assert peng.fold_path_counts == {
        "kernel": reng.fold_path_counts["pallas"],
        "torch": reng.fold_path_counts["xla"]}


@pytest.mark.parametrize("impl", IMPLS, ids=["kernel", "torch"])
@pytest.mark.parametrize("name", ["mean", "variance", "moments", "count",
                                  "fused_cse", "fused_naive",
                                  "fused_private"])
def test_grouped_program_matches_reference(name, impl):
    bs = blocks(2)
    want, reng = ref_run(R.GroupedProgram(programs(R, name), 3), bs,
                         impl[0], 3)
    got, peng = port_run(P.GroupedProgram(programs(P, name), 3), bs,
                         impl[1], 3)
    assert_tree_close(got, want, exact=name == "count")
    assert peng.fold_path_counts == {
        "kernel": reng.fold_path_counts["pallas"],
        "torch": reng.fold_path_counts["xla"]}


@pytest.mark.parametrize("name", ["moments", "fused_private", "fused_naive"])
def test_four_owner_merge_matches_single_device(name):
    """Four logical owners on one CPU: the additive programs take the tree
    merge (owner pre-merge, then one sum); the naive fusion, whose Chan
    member is not additive, the funnel."""
    bs = blocks(3) + blocks(4)
    owners = [0, 1, 1, 3, 3, 3]
    want, _ = ref_run(R.GroupedProgram(programs(R, name), 3), bs, "pallas", 3)
    got, eng = port_run(P.GroupedProgram(programs(P, name), 3), bs, "kernel",
                        3, devices=["cpu"] * 4, owners=owners)
    assert_tree_close(got, want, exact=False)
    path = "funnel" if name == "fused_naive" else "tree"
    assert eng.last_merge_path == path
    assert eng.merge_path_counts[path] == 1


def test_zero_partials_finalize_identity():
    eng = MapReduceEngine(["cpu"])
    got = eng.merge_finalize(P.MeanProgram(), [], PAYLOAD, np.float32)
    assert (got == 0).all()


def test_count_is_exact_int32():
    x = np.zeros((40,) + PAYLOAD, np.float32)
    eng = MapReduceEngine(["cpu"])
    p = eng.fold_block(P.CountProgram(), torch.from_numpy(x), None, 16,
                       PAYLOAD, np.float32)
    got = eng.merge_finalize(P.CountProgram(), [p] * 3, PAYLOAD, np.float32)
    assert got.dtype == torch.int32 and int(got) == 120


def test_fold_keys_and_compile_count():
    """Fold entries are keyed on the pow2 row bucket: blocks of 9 and 12
    rows share one; the kernel path leaves eta out of its key."""
    eng = MapReduceEngine(["cpu"])
    for n, eta in [(9, 4), (12, 8)]:
        eng.fold_block(P.MomentsProgram(), torch.zeros((n,) + PAYLOAD), None,
                       eta, PAYLOAD, np.float32)
    assert eng.compile_count == 1
    for n, eta in [(9, 4), (12, 4), (12, 8)]:
        eng.fold_block(P.HistogramProgram(), torch.zeros((n,) + PAYLOAD),
                       None, eta, PAYLOAD, np.float32)
    assert eng.compile_count == 3
    assert eng.fold_path_counts == {"kernel": 2, "torch": 3}


def test_fold_path_dispatch_matrix():
    eng = MapReduceEngine(["cpu"])
    ref = RefEngine(make_mesh((1,), ("data",)), fold_interpret=True)
    cases = [
        (P.MomentsProgram(), R.MomentsProgram(), np.float32, 0),
        (P.MeanProgram(acc_dtype=torch.float64),
         R.MeanProgram(acc_dtype=jnp.float64), np.float32, 0),
        (P.CountProgram(), R.CountProgram(), np.float32, 0),
        (P.MeanProgram(), R.MeanProgram(), np.complex64, 0),
        (P.MeanProgram(), R.MeanProgram(), np.int8, 0),
        (P.MeanProgram(), R.MeanProgram(), np.bool_, 5),
        (P.MomentsProgram(), R.MomentsProgram(), np.float32, 100),
    ]
    mapping = {"pallas": "kernel", "xla": "torch"}
    for pp, rp, dt, G in cases:
        assert eng.fold_path(pp, dt, G) == mapping[ref.fold_path(rp, dt, G)]
    assert eng.fold_path(P.MomentsProgram(), np.float32, 451) == "torch"
    assert MapReduceEngine(["cpu"], fold_impl="torch").fold_path(
        P.MomentsProgram(), np.float32) == "torch"


def test_partial_host_round_trip():
    prog = P.GroupedProgram(P.FusedProgram((P.MomentsProgram(),
                                            P.CountProgram())), 2)
    with torch.device("cpu"):
        part = prog.zero(PAYLOAD, np.float32)
    part = tree_map(lambda x: x + 1, part)
    leaves, treedef = partial_to_host(part)
    back = partial_from_host(leaves, treedef)
    for a, b in zip(tree_flatten(part)[0], tree_flatten(back)[0]):
        assert torch.equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("name", ["moments", "count", "fused_private"])
def test_partial_from_numpy_carries_reference_partials(name):
    """Partials the reference folded, saved as numpy leaves, load into the
    port (``convert.partial_from_numpy``) and merge/finalize there to the
    reference's own result."""
    bs = blocks(6)
    rprog = R.GroupedProgram(programs(R, name), 3)
    pprog = P.GroupedProgram(programs(P, name), 3)
    want, reng = ref_run(rprog, bs, "pallas", 3)
    with torch.device("cpu"):
        _, treedef = tree_flatten(pprog.zero(PAYLOAD, np.float32))
    parts = []
    for x, m, g in bs:
        rp = reng.fold_block(rprog, jnp.asarray(x), jnp.asarray(m), ETA,
                             PAYLOAD, np.float32, gids=jnp.asarray(g),
                             num_groups=3)
        leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(rp)]
        parts.append(partial_from_numpy(leaves, treedef, device="cpu"))
    got = MapReduceEngine(["cpu"]).merge_finalize(pprog, parts, PAYLOAD,
                                                  np.float32)
    assert_tree_close(got, want, exact=name == "count")


def test_layout_run_matches_reference():
    r = np.random.default_rng(5)
    vals = r.normal(size=(1, 24) + PAYLOAD).astype(np.float32)
    valid = r.random((1, 24)) > 0.2
    for rp, pp in [(R.MeanProgram(), P.MeanProgram()),
                   (R.VarianceProgram(), P.VarianceProgram())]:
        want, wstats = RefEngine(make_mesh((1,), ("data",))).run(
            rp, vals, valid, 8)
        got, gstats = MapReduceEngine(["cpu"]).run(pp, vals, valid, 8)
        assert_tree_close(got, want)
        assert dataclasses.astuple(gstats) == dataclasses.astuple(wstats)


@pytest.mark.parametrize("lo,hi,bins", [(-3.0, 3.0, 8), (-3.0, 3.0, 10),
                                        (-2.5, 4.0, 12)])
def test_histogram_bins_match_the_compiled_reference(lo, hi, bins):
    """Every item lands in the bin the reference's compiled fold gives it,
    ±Inf, NaN and values past 2^31 bin widths included (its float→int32
    cast saturates; torch's does not)."""
    r = np.random.default_rng(12)
    x = (r.normal(size=(64, 500)) * 4).astype(np.float32)
    x[0, :8] = [np.inf, -np.inf, np.nan, 1e30, -1e30, 3e9, -3e9, hi]
    valid = r.random(64) < 0.9
    valid[0] = True
    want = jax.jit(R.HistogramProgram(lo=lo, hi=hi, bins=bins).map_chunk)(
        jnp.asarray(x), jnp.asarray(valid))["hist"]
    got = P.HistogramProgram(lo=lo, hi=hi, bins=bins).map_chunk(
        torch.from_numpy(x), torch.from_numpy(valid))["hist"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
