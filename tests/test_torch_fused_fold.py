"""The port's fused fold (``repro_torch.kernels.fused_fold``) against the
reference Pallas kernel (interpret mode) and the float64 NumPy oracle.

On the CPU the port's op runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that version on the card by ``chip_smoke.py``.
Here also: the launch plan the kernel takes from Python, and a plain
emulation of its row list and register arithmetic held to the reference.
Tolerances are the reference suite's (``tests/test_fused_fold.py``): fp32
accumulation in a different order gives rtol 1e-4 / atol 1e-3 on f32 rows
(1e-3 / 1e-2 on the wide ragged shapes, where s4 sums grow), bf16 rows keep
about three significant digits (rtol 5e-2 / atol 2e-1), small integers are
exact, and counts are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_fold import (  # noqa: E402
    fused_fold as ref_fused_fold,
    kernel_flops as ref_kernel_flops,
    kernel_hbm_bytes as ref_kernel_hbm_bytes,
)
from repro.kernels.fused_fold.ref import fused_fold_numpy  # noqa: E402
from repro.kernels.streaming_stats.ops import (  # noqa: E402
    streaming_stats as ref_streaming_stats,
)
from repro_torch.kernels.fused_fold import (  # noqa: E402
    canonical_names,
    fused_fold,
    fused_fold_numpy as port_fused_fold_numpy,
    kernel_flops,
    kernel_hbm_bytes,
    max_groups_for_smem,
)
from repro_torch.kernels.fused_fold.kernel import (  # noqa: E402
    LIST_ENTRY_BYTES,
    REG_MAX_GROUPS,
    REG_THREADS,
    SCRATCH_BYTES,
    fused_fold_torch,
    launch_plan,
    smem_bytes,
)
from repro_torch.kernels.streaming_stats.ops import (  # noqa: E402
    streaming_stats,
)
from repro_torch.core.chunk_model import SMEM_BYTES  # noqa: E402

TOL = {"f32": (1e-4, 1e-3), "bf16": (5e-2, 2e-1), "i32": (0.0, 0.0)}
ACC_NAMES = ("count", "s1", "s2", "s3", "s4")


def flags_of(names):
    """The kernel's power flags: bit k-1 asks for s_k."""
    return sum(1 << (int(n[1]) - 1) for n in names if n != "count")


def make_rows(kind, R, shape, seed):
    """``(numpy f32 view, port tensor, reference array)`` of one dtype."""
    r = np.random.default_rng(seed)
    if kind == "i32":
        x = r.integers(-9, 10, size=(R,) + shape).astype(np.int32)
        return x.astype(np.float32), torch.from_numpy(x), jnp.asarray(x)
    x32 = r.normal(size=(R,) + shape).astype(np.float32)
    if kind == "f32":
        return x32, torch.from_numpy(x32), jnp.asarray(x32)
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    return (xb.to(torch.float32).numpy(), xb,
            jnp.asarray(x32).astype(jnp.bfloat16))


def assert_pool_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for n in want:
        g = got[n].numpy() if isinstance(got[n], torch.Tensor) else got[n]
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(want[n], np.float64),
                                   rtol=rtol, atol=atol, err_msg=n)


def assert_same_non_finite(got, ref, rtol, atol):
    """NaN and ±Inf in the same places as the reference, and the finite
    values close."""
    for n, want in ref.items():
        want = np.asarray(want, np.float64)
        have = got[n].numpy().astype(np.float64)
        for what in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(what(have), what(want),
                                          err_msg=f"{n} {what.__name__}")
        fin = np.isfinite(want)
        np.testing.assert_allclose(have[fin], want[fin], rtol=rtol,
                                   atol=atol, err_msg=n)


class TestAgainstReference:
    @pytest.mark.parametrize("G", [1, 7, 64])
    @pytest.mark.parametrize("kind", ["f32", "bf16", "i32"])
    def test_dtype_by_groups(self, kind, G):
        R, shape = 37, (5, 3)
        xf, xt, xj = make_rows(kind, R, shape, seed=10 * G + len(kind))
        r = np.random.default_rng(G)
        m = r.random(R) > 0.3
        g = r.integers(0, G, R).astype(np.int32)
        got = fused_fold(xt, torch.from_numpy(m), torch.from_numpy(g), G)
        assert got["count"].shape == (G,)
        assert got["s1"].shape == (G,) + shape
        assert all(v.dtype == torch.float32 for v in got.values())
        rtol, atol = TOL[kind]
        ref = ref_fused_fold(xj, jnp.asarray(m), jnp.asarray(g),
                             num_groups=G, interpret=True)
        assert_pool_close(got, {n: np.asarray(v) for n, v in ref.items()},
                          rtol=max(rtol, 1e-4) if kind == "i32" else rtol,
                          atol=atol)
        assert_pool_close(got, fused_fold_numpy(xf, m, g, num_groups=G),
                          rtol=rtol, atol=atol)
        np.testing.assert_array_equal(got["count"].numpy(),
                                      np.bincount(g[m], minlength=G))

    @pytest.mark.parametrize("R,shape", [(1, (1,)), (13, (130,)),
                                         (300, (4, 3)), (257, (4097,))])
    def test_ragged_shapes(self, R, shape):
        G = 7
        xf, xt, xj = make_rows("f32", R, shape, seed=R)
        r = np.random.default_rng(R + 1)
        m = r.random(R) > 0.25
        g = r.integers(0, G, R).astype(np.int32)
        got = fused_fold(xt, torch.from_numpy(m), torch.from_numpy(g), G)
        rtol, atol = (1e-3, 1e-2) if R * np.prod(shape) > 10_000 \
            else TOL["f32"]
        assert_pool_close(got, fused_fold_numpy(xf, m, g, num_groups=G),
                          rtol=rtol, atol=atol)
        ref = ref_fused_fold(xj, jnp.asarray(m), jnp.asarray(g),
                             num_groups=G, interpret=True)
        assert_pool_close(got, {n: np.asarray(v) for n, v in ref.items()},
                          rtol=rtol, atol=atol)

    @pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
    def test_masked_rows_never_poison(self, bad):
        G = 3
        x = np.random.default_rng(5).normal(size=(40, 6)).astype(np.float32)
        m = np.ones(40, bool)
        m[[3, 17, 30]] = False
        x[~m] = bad
        g = (np.arange(40) % G).astype(np.int32)
        got = fused_fold(torch.from_numpy(x), torch.from_numpy(m),
                         torch.from_numpy(g), G)
        for v in got.values():
            assert torch.isfinite(v).all()
        ref = ref_fused_fold(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g),
                             num_groups=G, interpret=True)
        assert_pool_close(got, {n: np.asarray(v) for n, v in ref.items()},
                          *TOL["f32"])

    def test_out_of_range_gids_contribute_nothing(self):
        G = 4
        x = np.random.default_rng(6).normal(size=(50, 8)).astype(np.float32)
        g = np.random.default_rng(7).integers(-2, G + 2, 50).astype(np.int32)
        got = fused_fold(torch.from_numpy(x), None, torch.from_numpy(g), G)
        ref = ref_fused_fold(jnp.asarray(x), None, jnp.asarray(g),
                             num_groups=G, interpret=True)
        assert_pool_close(got, {n: np.asarray(v) for n, v in ref.items()},
                          *TOL["f32"])
        # Inf in such a row adds to no group, but the reference's one-hot
        # contraction meets every group with weight 0: 0 * Inf = NaN in
        # every group's power sums; the count stays finite
        x[(g < 0) | (g >= G)] = np.inf
        again = fused_fold(torch.from_numpy(x), None, torch.from_numpy(g), G)
        ref = ref_fused_fold(jnp.asarray(x), None, jnp.asarray(g),
                             num_groups=G, interpret=True)
        assert_same_non_finite(again, ref, *TOL["f32"])
        assert torch.isnan(again["s1"]).all()
        torch.testing.assert_close(again["count"], got["count"])

    @pytest.mark.parametrize("G", [1, 2, 7])
    @pytest.mark.parametrize("bad", ["inf", "-inf", "nan", "1e20"])
    def test_non_finite_in_valid_rows(self, bad, G):
        """A valid row whose power x^k is not finite (Inf/NaN payloads, or
        x = 1e20, whose square overflows f32) poisons that feature of every
        OTHER group with NaN, as the reference's one-hot contraction does
        (0 * Inf); its own group takes the IEEE sum; gids in and out of
        range alike."""
        r = np.random.default_rng(G * 10 + len(bad))
        bad = float(bad)
        R, F = 41, 6
        x = r.normal(size=(R, F)).astype(np.float32)
        m = r.random(R) > 0.25
        g = r.integers(0, G, R).astype(np.int32)
        valid = np.nonzero(m)[0]
        x[valid[0], 1] = bad                       # one bad voxel
        x[valid[1], 3] = bad                       # two rows, maybe two groups
        x[valid[2], 3] = bad
        x[valid[3], 4] = bad
        g[valid[3]] = G + 1                        # out of range
        x[np.nonzero(~m)[0][0], 5] = bad           # masked off: no effect
        got = fused_fold(torch.from_numpy(x), torch.from_numpy(m),
                         torch.from_numpy(g), G)
        ref = ref_fused_fold(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g),
                             num_groups=G, interpret=True)
        ref = {n: np.asarray(v) for n, v in ref.items()}
        assert_same_non_finite(got, ref, *TOL["f32"])
        assert not np.isfinite(ref["s2"][:, 4]).any()
        assert np.isfinite(ref["count"]).all()
        assert not np.isfinite(ref["s2"][:, 1]).any()
        assert np.isnan(ref["s2"][:, 1]).sum() >= G - 1

    def test_defaults_and_subset(self):
        x = np.random.default_rng(8).normal(size=(33, 9)).astype(np.float32)
        got = fused_fold(torch.from_numpy(x))
        assert_pool_close(got, fused_fold_numpy(x), *TOL["f32"])
        sub = fused_fold(torch.from_numpy(x), names=("s2", "count"))
        assert tuple(sub) == ("count", "s2")
        with pytest.raises(ValueError):
            canonical_names(("s5",))

    def test_bool_payload(self):
        r = np.random.default_rng(9)
        x = r.random((25, 6)) > 0.5
        m = r.random(25) > 0.2
        g = r.integers(0, 3, 25).astype(np.int32)
        got = fused_fold(torch.from_numpy(x), torch.from_numpy(m),
                         torch.from_numpy(g), 3)
        assert_pool_close(got, fused_fold_numpy(x, m, g, num_groups=3),
                          rtol=0, atol=0)


class TestCostHelpers:
    @pytest.mark.parametrize("names", [("count", "s1", "s2"),
                                       ("count", "s1", "s2", "s3", "s4"),
                                       ("s1",)])
    @pytest.mark.parametrize("G", [1, 7, 64, 500])
    def test_match_reference(self, names, G):
        for R, F, item in [(1, 1, 4), (512, 902629, 4), (300, 130, 2)]:
            assert kernel_hbm_bytes(R, F, item, names, G) == \
                ref_kernel_hbm_bytes(R, F, item, names, G)
            assert kernel_flops(R, F, names, G) == \
                ref_kernel_flops(R, F, names, G)

    def test_smem_limit_is_the_launch_limit(self):
        """The largest G ``max_groups_for_smem`` admits launches on the
        shared-memory path within one CTA's shared memory, with a row list
        of at least one chunk row; one group more is refused."""
        for names in [("count", "s1", "s2", "s3", "s4"),
                      ("count", "s1", "s2", "s3"), ("count", "s1", "s2"),
                      ("count", "s1")]:
            G = max_groups_for_smem(names)
            flags = flags_of(names)
            n_wide = sum(1 for n in names if n != "count")
            assert smem_bytes(n_wide, G, 32) <= SMEM_BYTES
            assert smem_bytes(n_wide, G + 1, 32) > SMEM_BYTES
            for R in (1, 100, 5000):
                plan = launch_plan(R, 1000, G, flags)     # fits
                assert plan.path == "shared" and plan.threads == 32
                assert plan.smem <= SMEM_BYTES and plan.chunk_rows >= 1
                assert plan.smem == (n_wide * G * 32 * 4 + SCRATCH_BYTES
                                     + plan.chunk_rows * LIST_ENTRY_BYTES)
            with pytest.raises(ValueError):
                launch_plan(100, 1000, G + 1, flags)

    def test_launch_shape_covers_every_row(self):
        """The row-list chunks cover every row once, in order."""
        for R, F, G in [(0, 5, 1), (1, 1, 1), (1000, 4097, 64),
                        (512, 902629, 2), (37, 130, 450), (9000, 3, 2),
                        (5000, 1000, 894)]:
            plan = launch_plan(R, F, G, 0b1111 if G <= 450 else 0b11)
            n_chunks = -(-R // plan.chunk_rows)
            rows = [r for c in range(n_chunks)
                    for r in range(c * plan.chunk_rows,
                                   min(R, (c + 1) * plan.chunk_rows))]
            assert rows == list(range(R))
            assert 1 <= plan.chunk_rows <= max(1, R)


def unit_walk(plan, cta):
    """The units CTA ``cta`` folds, in order, as ``fold_registers_kernel``
    groups them: two at a time while a CTA has one row split, then one
    (the shared-memory kernel has one split)."""
    out, u, g = [], cta, plan.grid
    splits = plan.threads // plan.lanes
    while u < plan.units:
        if splits == 1 and u + g < plan.units:
            out.append((u, u + g))
            u += 2 * g
        else:
            out.append((u,))
            u += g
    return out


class TestLaunchPlan:
    @pytest.mark.parametrize("R,F,G,capacity", [
        (256, 902629, 2, 528),     # the population path's largest block
        (256, 902629, 1, 396),     # its Mean run
        (256, 1, 2, 528),          # idx:age
        (37, 130, 7, 528), (1000, 4097, 64, 132), (300, 12, 450, 132),
        (0, 5, 1, 528), (5, 0, 3, 528), (9000, 3, 8, 528),
        (100, 7000, 3, 3), (100, 70_000, 20, 7),
    ])
    def test_plan_covers_every_column_and_row(self, R, F, G, capacity):
        """The CTAs' unit walks fold every column exactly once, a CTA with
        row splits holds every column of its unit in one lane, and the
        splits of a chunk's list cover every entry once."""
        plan = launch_plan(R, F, G, 0b1111, capacity)
        assert 1 <= plan.grid <= min(plan.units, capacity)
        splits = plan.threads // plan.lanes
        assert plan.lanes * splits == plan.threads
        seen = []
        for cta in range(plan.grid):
            for units in unit_walk(plan, cta):
                for u in units:
                    seen += [f for f in range(u * plan.lanes,
                                              (u + 1) * plan.lanes) if f < F]
        assert sorted(seen) == list(range(F))
        if splits > 1:
            assert plan.units == 1 and plan.lanes >= F
        for n in (0, 1, 7, plan.chunk_rows):
            per = -(-n // splits)
            parts = [range(min(n, s * per), min(n, s * per + per))
                     for s in range(splits)]
            assert [e for p in parts for e in p] == list(range(n))

    @pytest.mark.parametrize("names", [("count", "s1"), ("count", "s1", "s2"),
                                       ("count", "s1", "s2", "s3"),
                                       ("s2",), ACC_NAMES])
    def test_register_path_exactly_for_small_groups(self, names):
        """G <= 8 compiles its sums into registers (1, 2, 4 or 8 groups;
        1, 2 or 4 powers, enough for the highest requested); larger G keeps
        them in shared memory, up to the unchanged limit."""
        flags = flags_of(names)
        top = flags.bit_length()
        for G in range(1, max_groups_for_smem(names) + 1):
            plan = launch_plan(256, 902629, G, flags)
            if G <= REG_MAX_GROUPS:
                assert plan.path == "registers"
                assert plan.threads == REG_THREADS
                assert plan.groups == min(g for g in (1, 2, 4, 8) if g >= G)
                assert plan.powers == (4 if top == 3 else top)
            else:
                assert plan.path == "shared" and plan.groups == G
        assert launch_plan(10, 10, 3, 0).path == "count"

    def test_engine_routes_every_signature_the_plan_launches(self):
        """``MapReduceEngine.fold_path`` sends a fold to the kernel exactly
        up to the unchanged G limit, and every G it sends has a launch."""
        from repro_torch.core.mapreduce import MapReduceEngine
        from repro_torch.core.stats import (CountProgram, MeanProgram,
                                            MomentsProgram, VarianceProgram)
        engine = MapReduceEngine(devices=["cpu"])
        for prog in (MeanProgram(), VarianceProgram(), MomentsProgram(),
                     CountProgram()):
            names = prog.shared_fold_spec()
            if not names:              # outside the kernel's pool
                assert engine.fold_path(prog, np.float32, 2) == "torch"
                continue
            limit = max_groups_for_smem(names)
            for G in (0, 1, 2, 8, 9, limit):
                assert engine.fold_path(prog, np.float32, G) == "kernel"
                launch_plan(256, 902629, max(1, G), flags_of(names), 528)
            assert engine.fold_path(prog, np.float32, limit + 1) == "torch"

    @pytest.mark.parametrize("names,limit", [
        (("count", "s1", "s2", "s3", "s4"), 450),
        (("count", "s1", "s2", "s3"), 599),
        (("count", "s1", "s2"), 894),
        (("count", "s1"), 1760),
    ])
    def test_group_limit_is_unchanged(self, names, limit):
        assert max_groups_for_smem(names) == limit



def row_list_fold(x, mask, gids, G, names, chunk_rows, splits=1):
    """The register path's arithmetic in plain NumPy float32: rows with a
    positive weight listed in ascending order chunk by chunk, each listed
    row added into every group with its one-hot weight (the weight for its
    own gid, 0 for the others), the list split over ``splits`` and the
    splits summed in the kernel's fixed tree; the count over every row with
    a non-zero weight and a gid in range, in row order."""
    x = np.asarray(x, np.float32).reshape(len(mask), -1)
    m = np.asarray(mask, np.float32)
    g = np.asarray(gids, np.int64)
    R, F = x.shape
    GT = min(n for n in (1, 2, 4, 8) if n >= G)
    acc = np.zeros((splits, 4, GT, F), np.float32)
    for c0 in range(0, R, chunk_rows):
        listed = [r for r in range(c0, min(R, c0 + chunk_rows)) if m[r] > 0]
        per = -(-len(listed) // splits)
        for s in range(splits):
            for r in listed[s * per:(s + 1) * per]:
                v = x[r]
                w = np.where(np.arange(GT) == g[r], m[r], np.float32(0))
                with np.errstate(invalid="ignore", over="ignore"):
                    v2 = v * v
                    powers = np.stack([v, v2, v2 * v, v2 * v2])
                    acc[s] += w[None, :, None] * powers[:, None, :]
    half = splits // 2
    while half:
        acc[:half] += acc[half:2 * half]
        half //= 2
    out = {}
    for n in names:
        if n == "count":
            c = np.zeros(G, np.float32)
            for r in range(R):
                if m[r] != 0 and 0 <= g[r] < G:
                    c[g[r]] += m[r]
            out[n] = c
        else:
            out[n] = acc[0, int(n[1]) - 1, :G]
    return out


def weighted_numpy_oracle(x, mask, gids, G):
    """``fused_fold_numpy`` extended to fractional and negative weights and
    out-of-range gids: the sum over each distinct weight w of w times the
    oracle's 0/1 fold of the in-range rows of that weight.  Rows with a
    negative weight add to the count only (their payload is zeroed)."""
    out = {n: 0.0 for n in ACC_NAMES}
    in_range = (gids >= 0) & (gids < G)
    for w in np.unique(mask[mask != 0]):
        sel = (mask == w) & in_range
        part = fused_fold_numpy(x, sel, np.where(in_range, gids, 0),
                                num_groups=G)
        for n in ACC_NAMES:
            if n == "count" or w > 0:
                out[n] = out[n] + w * part[n]
    return out


@pytest.mark.parametrize("R,F,G,chunk_rows,splits", [
    (40, 6, 1, 4096, 1),
    (57, 33, 2, 16, 1),        # four list chunks
    (64, 5, 3, 4096, 8),       # row splits of a narrow block
    (90, 9, 7, 25, 4),         # both
    (33, 1, 8, 4096, 256),     # one column, a row a split
])
def test_row_list_emulation_matches_reference(R, F, G, chunk_rows, splits):
    """The row list, the one-hot register FMAs and the split tree, emulated
    in NumPy, agree with the reference Pallas kernel (interpret mode) and
    the float64 oracle, with weights -1, 0, 0.5, 1 and 2 and gids outside
    [0, G)."""
    r = np.random.default_rng(R + F + G)
    x = r.normal(size=(R, F)).astype(np.float32)
    m = r.choice(np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32), R)
    g = r.integers(-1, G + 2, R).astype(np.int32)
    x[m <= 0] = np.nan                 # never read: zeroed before the powers
    got = row_list_fold(x, m, g, G, ACC_NAMES, chunk_rows, splits)
    ref = ref_fused_fold(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g),
                         num_groups=G, interpret=True)
    assert_pool_close(got, {n: np.asarray(v) for n, v in ref.items()},
                      *TOL["f32"])
    assert_pool_close(got, weighted_numpy_oracle(x, m, g, G), *TOL["f32"])
    port = fused_fold(torch.from_numpy(x), torch.from_numpy(m),
                      torch.from_numpy(g), G)
    assert_pool_close(port, got, *TOL["f32"])


@pytest.mark.parametrize("bad", [np.inf, np.nan, 1e20])
def test_row_list_emulation_poisons_like_the_reference(bad):
    """The one-hot FMA of a non-finite power into the other groups (0 * Inf
    = NaN) is the reference's poisoning: same NaN and Inf positions."""
    r = np.random.default_rng(4)
    R, F, G = 30, 7, 3
    x = r.normal(size=(R, F)).astype(np.float32)
    m = (r.random(R) > 0.3).astype(np.float32)
    g = r.integers(-1, G + 1, R).astype(np.int32)
    valid = np.nonzero(m)[0]
    x[valid[0], 1] = bad
    x[valid[1], 2] = bad
    x[valid[2], 2] = bad
    got = row_list_fold(x, m, g, G, ACC_NAMES, 8, 2)
    ref = ref_fused_fold(jnp.asarray(x), jnp.asarray(m), jnp.asarray(g),
                         num_groups=G, interpret=True)
    assert_same_non_finite({n: torch.from_numpy(v) for n, v in got.items()},
                           {n: np.asarray(v) for n, v in ref.items()},
                           *TOL["f32"])


def test_plain_version_matches_numpy_oracle_copy():
    x = np.random.default_rng(11).normal(size=(30, 4)).astype(np.float32)
    m = np.random.default_rng(12).random(30) > 0.5
    g = np.random.default_rng(13).integers(0, 2, 30).astype(np.int32)
    got = fused_fold_torch(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(m).float(), 2,
                           ("count", "s1", "s2", "s3", "s4"))
    want = port_fused_fold_numpy(x, m, g, num_groups=2)
    ref = fused_fold_numpy(x, m, g, num_groups=2)
    for n in want:
        np.testing.assert_array_equal(want[n], ref[n])
    assert_pool_close(got, want, *TOL["f32"])


class TestStreamingStats:
    @pytest.mark.parametrize("R,shape", [(1, (8,)), (300, (12, 11)),
                                         (64, (32, 32, 4))])
    @pytest.mark.parametrize("dtype", [np.float32, np.float16])
    def test_matches_reference(self, R, shape, dtype):
        r = np.random.default_rng(R)
        x = r.normal(size=(R,) + shape).astype(dtype)
        m = r.random(R) > 0.25
        s, sq, c = streaming_stats(torch.from_numpy(x), torch.from_numpy(m))
        rs, rsq, rc = ref_streaming_stats(jnp.asarray(x), jnp.asarray(m),
                                          interpret=True)
        tol = 1e-5 if dtype == np.float32 else 5e-3
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(sq.numpy(), np.asarray(rsq), rtol=tol,
                                   atol=tol)
        assert float(c) == m.sum() == float(rc)
        ps, psq, pc = streaming_stats(torch.from_numpy(x),
                                      torch.from_numpy(m), impl="ref")
        np.testing.assert_allclose(ps.numpy(), s.numpy(), rtol=tol, atol=tol)

    def test_all_masked(self):
        x = np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32)
        s, sq, c = streaming_stats(torch.from_numpy(x),
                                   torch.zeros(32, dtype=torch.bool))
        assert float(c) == 0
        assert (s == 0).all() and (sq == 0).all()


def test_launch_count_exact_under_threads():
    """The frontend folds on several threads: the launch count loses no
    bump when sixteen threads count at once with a tiny switch interval."""
    import sys
    import threading

    from repro_torch.kernels.fused_fold import kernel as K

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    K.fused_fold_cuda.launches = 0
    try:
        threads = [threading.Thread(target=lambda: [K._count_launch()
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert K.fused_fold_cuda.launches == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        K.fused_fold_cuda.launches = 0
