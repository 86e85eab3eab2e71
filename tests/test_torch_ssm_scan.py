"""The port's SSD scan (``repro_torch.kernels.ssm_scan``) against the
reference's ``ssd_scan`` (the Pallas kernel in interpret mode, and its
``impl="ref"`` sequential recurrence) and ``ssd_chunked_ref``, on the cases
of ``tests/test_kernels.py``.

On the CPU the op runs the kernel's plain version (the chunked scan from a
zero state); the CUDA kernel is held to it on the card by
``chip_smoke.py``.  Tolerance: the reference suite's 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.ops import ssd_scan as ref_scan  # noqa: E402
from repro.models.ssm import ssd_chunked_ref as ref_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssd_chunked_ref,
    ssd_scan,
    ssd_scan_sequential,
)
from repro_torch.kernels.ssm_scan.kernel import ssd_scan_cuda  # noqa: E402

TOL = 1e-4


def inputs(B, L, H, P, N, seed, lo=0.7):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(B, L, H, P)) * 0.5).astype(np.float32),
            r.uniform(lo, 0.999, (B, L, H)).astype(np.float32),
            (r.normal(size=(B, L, N)) * 0.3).astype(np.float32),
            (r.normal(size=(B, L, N)) * 0.3).astype(np.float32))


def port(arrays, chunk):
    y, s = ssd_scan(*(torch.from_numpy(t) for t in arrays), chunk=chunk)
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 64, 1, 16, 16, 16),
    (2, 128, 2, 32, 16, 64),
    (1, 128, 4, 64, 64, 128),  # mamba2-native dims
    (1, 100, 2, 32, 32, 32),   # padding path
])
def test_matches_reference(B, L, H, P, N, chunk):
    arrays = inputs(B, L, H, P, N, seed=L + P)
    y, s = port(arrays, chunk)
    j = [jnp.asarray(t) for t in arrays]
    for impl in ("pallas", "ref"):
        yr, sr = ref_scan(*j, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y, np.asarray(yr), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s, np.asarray(sr), rtol=TOL, atol=TOL)
    yc, sc = ref_chunked(*j, min(chunk, L))
    np.testing.assert_allclose(y, np.asarray(yc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s, np.asarray(sc), rtol=TOL, atol=TOL)


def test_sequential_oracle_matches_reference():
    B, L, H, P, N = 2, 48, 3, 16, 8
    x, a, Bm, Cm = inputs(B, L, H, P, N, seed=4)
    xs = x.transpose(0, 2, 1, 3).reshape(B * H, L, P)
    as_ = a.transpose(0, 2, 1).reshape(B * H, L)
    Bs = np.broadcast_to(Bm[:, None], (B, H, L, N)).reshape(B * H, L, N)
    Cs = np.broadcast_to(Cm[:, None], (B, H, L, N)).reshape(B * H, L, N)
    y, s = ssd_scan_sequential(*(torch.from_numpy(np.ascontiguousarray(t))
                                 for t in (xs, as_, Bs, Cs)))
    yr, sr = ref_scan(*(jnp.asarray(t) for t in (x, a, Bm, Cm)), impl="ref")
    np.testing.assert_allclose(
        y.numpy().reshape(B, H, L, P).transpose(0, 2, 1, 3), np.asarray(yr),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy().reshape(B, H, P, N), np.asarray(sr),
                               rtol=TOL, atol=TOL)


def test_chunked_ref_from_a_state_matches_reference():
    arrays = inputs(1, 40, 2, 16, 8, seed=9)
    s0 = np.random.default_rng(10).normal(size=(1, 2, 16, 8)).astype(
        np.float32)
    y, s = ssd_chunked_ref(*(torch.from_numpy(t) for t in arrays), 16,
                           torch.from_numpy(s0))
    yr, sr = ref_chunked(*(jnp.asarray(t) for t in arrays), 16,
                         jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=TOL, atol=TOL)


def test_chunk_invariance():
    arrays = inputs(1, 128, 2, 16, 16, seed=11, lo=0.8)
    outs = [port(arrays, c)[0] for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=TOL, atol=TOL)


def test_long_decay_stability():
    """Strong decay over a long sequence: the state must not blow up."""
    B, L, H, P, N = 1, 256, 1, 16, 16
    y, s = port((np.ones((B, L, H, P), np.float32),
                 np.full((B, L, H), 0.5, np.float32),
                 np.full((B, L, N), 0.1, np.float32),
                 np.full((B, L, N), 0.1, np.float32)), 64)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    # geometric series bound: |state| <= inp/(1-a)
    assert float(np.abs(s).max()) < 2 * 0.1 * 1.0 / 0.5
    yr, sr = ref_scan(jnp.ones((B, L, H, P)), jnp.full((B, L, H), 0.5),
                      jnp.full((B, L, N), 0.1), jnp.full((B, L, N), 0.1),
                      chunk=64)
    np.testing.assert_allclose(y, np.asarray(yr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s, np.asarray(sr), rtol=TOL, atol=TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, a, Bm, Cm = (torch.from_numpy(t) for t in inputs(1, 8, 1, 4, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, a, Bm, Cm, 4)
