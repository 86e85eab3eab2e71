"""The port's flash-attention op (``repro_torch.kernels.flash_attention``)
against the reference's Pallas kernel (interpret mode) and its
``attention_ref``, on the cases of ``tests/test_kernels.py``.

On the CPU the op runs the kernel's plain version; the CUDA kernel itself
is held to that version on the card by ``chip_smoke.py``.
Here also: which instance a call takes, what TMA can read as it lies, and
a plain emulation of the f32 wgmma instance's split-precision arithmetic
held to the reference, at every head dim.  Tolerances are the reference
suite's: rtol/atol 2e-5 for f32, 2e-2 for bf16; the split emulation at
1e-4 (the card's K2 f32 tolerance).
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
from repro_torch.kernels.flash_attention import kernel as K2  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
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


# ---- which CUDA kernel a call takes, and what TMA can read as it lies ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_dispatch_rule(dtype, D):
    """At every head dim bf16/f16 take the wgmma kernel's 16-bit instance
    and f32 its split-precision instance, the narrow head dims 16 and 32
    included."""
    want = "wgmma_f32" if dtype == torch.float32 else "wgmma"
    assert K2.variant(dtype, D) == want


def test_every_model_head_dim_in_bf16_takes_the_wgmma_kernel():
    from repro_torch.configs import __path__ as cfg_path
    import importlib
    import pkgutil
    dims = set()
    for m in pkgutil.iter_modules(cfg_path):
        cfg = importlib.import_module(f"repro_torch.configs.{m.name}").full()
        dims.add(cfg.head_dim)
    assert dims and all(K2.variant(torch.bfloat16, d) == "wgmma"
                        for d in dims), dims


@pytest.mark.parametrize("reduced", [False, True])
def test_every_config_in_fp32_takes_a_tensor_core_kernel_at_full_size(
        reduced):
    """fp32 at every config's head dim takes the split-precision
    instance: the full configs' (the fp32 checks) and the reduced
    configs' narrow heads alike."""
    from repro_torch.configs import all_configs
    got = {K2.variant(torch.float32, cfg.head_dim)
           for cfg in all_configs(reduced).values()}
    assert got == {"wgmma_f32"}


def bshd_view(B, H, S, D, dtype=torch.bfloat16, pad=0, offset=0):
    """A [B, H, S, D] view of [B, S, H, D + pad] storage, starting
    ``offset`` elements in."""
    flat = torch.zeros(B * S * H * (D + pad) + offset, dtype=dtype)
    t = flat[offset:].view(B, S, H, D + pad)[..., :D]
    return t.transpose(1, 2)


@pytest.mark.parametrize("make,want", [
    # contiguous [B, H, S, D]
    (lambda: torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16),
     (4 * 96 * 64, 96 * 64, 64)),
    # the model's [B, S, H, D] activations as [B, H, S, D] views
    (lambda: bshd_view(2, 4, 96, 64), (96 * 4 * 64, 64, 4 * 64)),
    (lambda: bshd_view(2, 8, 40, 128, torch.float16),
     (40 * 8 * 128, 128, 8 * 128)),
    # size-1 dims: their strides are never stepped, so D stands in
    (lambda: torch.zeros(1, 1, 96, 64, dtype=torch.bfloat16)
     .as_strided((1, 1, 96, 64), (3, 5, 64, 1)), (64, 64, 64)),
    # padded rows, still 16-byte multiples: (64 + 8) * 2 = 144 bytes
    (lambda: bshd_view(2, 1, 24, 64, pad=8), (24 * 72, 64, 72)),
    # rows of (64 + 4) * 2 = 136 bytes: not a multiple of 16
    (lambda: bshd_view(2, 2, 24, 64, pad=4), None),
    # a base 2 bytes off 16-byte alignment
    (lambda: bshd_view(1, 2, 24, 64, offset=1), None),
    # D not unit stride
    (lambda: torch.zeros(1, 2, 64, 24, dtype=torch.bfloat16)
     .transpose(2, 3), None),
    # K/V broadcast over heads: a zero stride
    (lambda: torch.zeros(2, 1, 32, 64, dtype=torch.bfloat16)
     .expand(2, 4, 32, 64), None),
])
def test_tma_strides(make, want):
    assert K2.tma_strides(make()) == want


def test_wgmma_operands_take_the_model_views_as_they_lie():
    q, k, v = (bshd_view(2, h, 40, 64) for h in (8, 2, 2))
    q2, k2, v2, o, strides = K2.wgmma_operands(q, k, v)
    assert q2 is q and k2 is k and v2 is v
    assert o.shape == q.shape and o.stride() == q.stride()
    assert strides == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *q.stride()[:3]]


def test_wgmma_operands_copy_only_what_tma_cannot_read():
    q = bshd_view(2, 4, 40, 64)
    k = bshd_view(2, 2, 40, 64, pad=4)          # 136-byte rows
    v = bshd_view(2, 2, 40, 64, offset=1)       # misaligned base
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape))
    q2, k2, v2, o, strides = K2.wgmma_operands(q, k, v)
    assert q2 is q
    for got, orig in ((k2, k), (v2, v)):
        assert got is not orig and got.is_contiguous()
        assert torch.equal(got, orig)
        assert K2.tma_strides(got) == got.stride()[:3]
    assert strides[3:9] == [*k2.stride()[:3], *v2.stride()[:3]]
    assert o.stride() == q.stride()


def test_wgmma_output_is_contiguous_when_q_has_no_unit_stride_along_d():
    q = torch.zeros(1, 2, 64, 40, dtype=torch.bfloat16).transpose(2, 3)
    k = v = torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16)
    q2, _, _, o, strides = K2.wgmma_operands(q, k, v)
    assert q2.is_contiguous() and o.is_contiguous()
    assert strides[9:] == list(o.stride()[:3])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 16])
def test_each_variant_refuses_cpu_tensors(D, dtype):
    """Each instance, at a head dim of 64 and at the narrow 16."""
    q, k, v = (torch.from_numpy(t).to(dtype)
               for t in inputs(1, 2, 2, 8, 8, D, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, D ** -0.5)


@pytest.mark.parametrize("D", [8, 48, 256])
def test_head_dims_outside_the_instances_are_refused(D):
    with pytest.raises(ValueError, match="head dim"):
        K2.variant(torch.bfloat16, D)


def test_reset_counts():
    K2.flash_attention_cuda.launches = 5
    K2.flash_attention_cuda.by_variant["wgmma"] = 3
    K2.reset_counts()
    assert K2.flash_attention_cuda.launches == 0
    assert K2.flash_attention_cuda.by_variant == {"wgmma": 0, "wgmma_f32": 0}


# ---- the f32 wgmma instance's precision contract, emulated on the CPU ----

F32, BF16 = torch.float32, torch.bfloat16
NEG, LOG2E = -1e30, 1.4426950408889634
SPLIT_TOL = 1e-4


def _split(v):
    """hi = bf16(v), lo = bf16(v - hi), both returned as fp32."""
    hi = v.to(BF16).to(F32)
    return hi, (v - hi).to(BF16).to(F32)


def _split_product(eq, u, v):
    """``einsum(eq, u, v)`` of two fp32 operands as the tensor cores take
    them under the contract: hi.hi + hi.lo + lo.hi, fp32 sums (a product
    of two bf16 values is exact in fp32)."""
    uh, ul = _split(u)
    vh, vl = _split(v)
    return (torch.einsum(eq, uh, vh) + torch.einsum(eq, uh, vl)
            + torch.einsum(eq, ul, vh))


def split_precision_attention(q, k, v, scale, causal=True, window=0,
                              block=64, split_p=True):
    """``flash_attention_wgmma.cu``'s f32 instance, emulated: key blocks of
    ``block``, S = Q.K^T split, the online softmax in the log2 domain with
    the -1e30 mask, P kept fp32 and split for O += P.V; ``split_p=False``
    instead rounds P once to bf16 (what the 16-bit instance does), for the
    contrast.  ``q [B, H, Sq, D]``, ``k, v [B, Hkv, Skv, D]`` fp32."""
    B, H, Sq, D = q.shape
    group = H // k.shape[1]
    k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    m = torch.full((B, H, Sq, 1), NEG)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, k.shape[2], block):
        kb, vb = k[:, :, k0:k0 + block], v[:, :, k0:k0 + block]
        s = _split_product("bhqd,bhkd->bhqk", q, kb) * (scale * LOG2E)
        k_pos = torch.arange(k0, k0 + kb.shape[2])[None, :]
        if causal:
            ok = k_pos <= q_pos
            if window > 0:
                ok = ok & (k_pos > q_pos - window)
            s = torch.where(ok, s, torch.full((), NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        if split_p:
            pv = _split_product("bhqk,bhkd->bhqd", p, vb)
        else:
            vh, vl = _split(vb)
            ph = p.to(BF16).to(F32)
            pv = (torch.einsum("bhqk,bhkd->bhqd", ph, vh)
                  + torch.einsum("bhqk,bhkd->bhqd", ph, vl))
        acc = acc * c + pv
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window", [
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 128, 128, 64, True, 0),       # GQA
    (1, 8, 1, 256, 256, 128, True, 0),      # MQA at D 128
    (1, 4, 2, 96, 96, 64, True, 0),         # not a multiple of the block
    (2, 4, 4, 64, 256, 128, False, 0),      # not causal, Sq != Skv
    (1, 2, 2, 40, 150, 64, False, 0),       # ragged Sq and Skv
    (1, 2, 2, 256, 256, 64, True, 32),      # sliding windows
    (1, 2, 2, 256, 256, 64, True, 64),
    (1, 2, 2, 256, 256, 128, True, 127),
])
def test_split_precision_contract_meets_the_reference(B, H, Hkv, Sq, Skv, D,
                                                      causal, window):
    """The f32 instance's hi/lo bf16 scheme, emulated in plain PyTorch,
    agrees with the reference's Pallas kernel (interpret mode) and its
    ``attention_ref`` within 1e-4."""
    q, k, v = inputs(B, H, Hkv, Sq, Skv, D, seed=Sq + Skv + D + window)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    got = split_precision_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), **kw).numpy()
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    for want in (ref_flash(jq, jk, jv, **kw), ref_attention(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=SPLIT_TOL,
                                   atol=SPLIT_TOL)


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,causal,window", [
    (8, 4, 4, 256, 256, True, 0),           # the reduced configs' call
    (2, 4, 2, 96, 96, True, 0),             # GQA, not a multiple of 64
    (1, 2, 2, 40, 150, False, 0),           # ragged Sq and Skv
    (1, 2, 2, 256, 256, True, 32),          # a sliding window
])
def test_split_precision_contract_at_the_narrow_head_dims(D, B, H, Hkv, Sq,
                                                         Skv, causal,
                                                         window):
    """The f32 instance at head dims 16 and 32 (the reduced configs' 16):
    the same hi/lo scheme, emulated, agrees with the reference's Pallas
    kernel (interpret mode) and its ``attention_ref`` within 1e-4."""
    q, k, v = inputs(B, H, Hkv, Sq, Skv, D, seed=Sq + Skv + D + window)
    kw = dict(scale=D ** -0.5, causal=causal, window=window)
    got = split_precision_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), **kw).numpy()
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    for want in (ref_flash(jq, jk, jv, **kw), ref_attention(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=SPLIT_TOL,
                                   atol=SPLIT_TOL)


def test_the_emulation_splits_p_and_does_not_round_it_once():
    """The split keeps P to about 2^-17: the emulation is within 2^-14 of
    float64 attention (relative to its largest output), while rounding P
    once to bf16, as the 16-bit instance does, leaves about 2^-10."""
    q, k, v = (torch.from_numpy(t)
               for t in inputs(1, 4, 2, 256, 256, 64, seed=3))
    exact = attention_ref(q.double(), k.double(), v.double(), 0.125)
    scale = float(exact.abs().max())

    def err(split_p):
        got = split_precision_attention(q, k, v, 0.125, split_p=split_p)
        return float((got.double() - exact).abs().max()) / scale

    assert err(True) < 2 ** -14 and err(False) > 2 ** -12
