"""The port's flash-attention op (``repro_torch.kernels.flash_attention``)
against the reference's Pallas kernel (interpret mode) and its
``attention_ref``, on the cases of ``tests/test_kernels.py``.

On the CPU the op runs the kernel's plain version; the CUDA kernel itself
is held to that version on the card by ``chip_smoke.py``.  Tolerances are
the reference suite's: rtol/atol 2e-5 for f32, 2e-2 for bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as ref_flash,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as ref_attention,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)

F32_TOL, BF16_TOL = 2e-5, 2e-2


def inputs(B, H, Hkv, Sq, Skv, D, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, H, Sq, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def both(q, k, v, **kw):
    """The port's op and the reference's Pallas kernel and oracle."""
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), **kw)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    return (got.numpy(), np.asarray(ref_flash(jq, jk, jv, **kw)),
            np.asarray(ref_attention(jq, jk, jv, **kw)))


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D", [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 256, 256, 32),   # MQA
    (1, 4, 2, 96, 96, 64),     # not a multiple of the block
    (2, 4, 4, 64, 256, 128),   # cross / long kv
])
def test_matches_reference(B, H, Hkv, Sq, Skv, D):
    q, k, v = inputs(B, H, Hkv, Sq, Skv, D, seed=Sq + H)
    got, pallas, ref = both(q, k, v, scale=D ** -0.5, causal=Sq == Skv)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("window", [32, 64, 127])
def test_sliding_window(window):
    q, k, v = inputs(1, 2, 2, 256, 256, 64, seed=window)
    got, pallas, ref = both(q, k, v, scale=64 ** -0.5, window=window)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_inputs():
    q, k, v = inputs(1, 2, 2, 128, 128, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, scale=64 ** -0.5)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    for want in (ref_flash(jq, jk, jv, scale=64 ** -0.5),
                 ref_attention(jq, jk, jv, scale=64 ** -0.5)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_model_layout_views_match_contiguous():
    """The model hands the op ``[B,S,H,D]`` activations as ``[B,H,S,D]``
    views; the result must not depend on the strides."""
    q, k, v = inputs(2, 4, 2, 40, 40, 16, seed=7)
    views = [torch.from_numpy(np.ascontiguousarray(t.transpose(0, 2, 1, 3)))
             .transpose(1, 2) for t in (q, k, v)]
    got = flash_attention(*views, scale=0.25)
    want = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                           scale=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in inputs(1, 2, 2, 8, 8, 16, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, 0.25)
