"""The port's fused fold (``repro_torch.kernels.fused_fold``) against the
reference Pallas kernel (interpret mode) and the float64 NumPy oracle.

On the CPU the port's op runs the kernel's plain PyTorch version; the CUDA
kernel itself is held to that version on the card by ``chip_smoke.py``.
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
    fused_fold_torch,
    launch_shape,
    smem_bytes,
)
from repro_torch.kernels.streaming_stats.ops import (  # noqa: E402
    streaming_stats,
)
from repro_torch.core.chunk_model import SMEM_BYTES  # noqa: E402

TOL = {"f32": (1e-4, 1e-3), "bf16": (5e-2, 2e-1), "i32": (0.0, 0.0)}


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
        for names in [("count", "s1", "s2", "s3", "s4"), ("count", "s1"),
                      ("count",)]:
            G = max_groups_for_smem(names)
            n_wide = sum(1 for n in names if n != "count")
            assert smem_bytes(n_wide, G, 32) <= SMEM_BYTES
            assert smem_bytes(n_wide, G + 1, 32) > SMEM_BYTES
            launch_shape(100, 1000, G, n_wide)          # fits
            with pytest.raises(ValueError):
                launch_shape(100, 1000, G + 1, n_wide)

    def test_launch_shape_covers_every_row(self):
        for R, F, G in [(0, 5, 1), (1, 1, 1), (1000, 4097, 64),
                        (512, 902629, 2), (37, 130, 450)]:
            _, S, per = launch_shape(R, F, G, 4)
            assert S >= 1 and S * per >= R and (S - 1) * per < max(R, 1)


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
