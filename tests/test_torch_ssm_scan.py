"""The port's SSD scan (``repro_torch.kernels.ssm_scan``) against the
reference's ``ssd_scan`` (the Pallas kernel in interpret mode, and its
``impl="ref"`` sequential recurrence) and ``ssd_chunked_ref``, on the cases
of ``tests/test_kernels.py``.

On the CPU the op runs the kernel's plain version (the chunked scan from the
given state, or from zero); the CUDA kernel is held to it on the card by
``chip_smoke.py``.  Here: which instance a call takes, what TMA can read as
it lies, a plain emulation of the wgmma kernel's split-precision arithmetic
held to the reference, and of how it runs narrow dims and small configured
chunks (zero-padded to its 64-wide tiles, at its own chunk tile).
Tolerance: the reference suite's 1e-4.
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
from repro_torch.configs import all_configs  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as K3  # noqa: E402
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


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 40, 2, 16, 8, 16),
    (2, 100, 3, 32, 16, 32),     # padding path
    (1, 256, 2, 64, 64, 128),    # the wgmma kernel's dims
])
def test_scan_from_a_state_matches_reference(B, L, H, P, N, chunk):
    """``ssd_scan(..., init_state=...)`` on the CPU (the CUDA kernels'
    plain version) equals the reference's ``ssd_chunked_ref`` from the same
    state."""
    arrays = inputs(B, L, H, P, N, seed=L + H)
    s0 = np.random.default_rng(L).normal(size=(B, H, P, N)).astype(
        np.float32)
    y, s = ssd_scan(*(torch.from_numpy(t) for t in arrays), chunk=chunk,
                    init_state=torch.from_numpy(s0))
    yr, sr = ref_chunked(*(jnp.asarray(t) for t in arrays), min(chunk, L),
                         jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-5,
                               atol=1e-5)
    # a prompt in two parts, the second from the first's state, is the
    # whole prompt
    half = L // 2
    y1, s1 = ssd_scan(*(torch.from_numpy(t[:, :half]) for t in arrays),
                      chunk=chunk, init_state=torch.from_numpy(s0))
    y2, s2 = ssd_scan(*(torch.from_numpy(t[:, half:]) for t in arrays),
                      chunk=chunk, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=TOL, atol=TOL)


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
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, a, Bm, Cm, 4, init_state=torch.zeros(1, 1, 4, 4))


# ---- which CUDA kernel a call takes, and what TMA can read as it lies ----

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("P", [1, 12, 16, 32, 48, 64])
@pytest.mark.parametrize("N", [1, 12, 16, 32, 48, 64])
@pytest.mark.parametrize("L", [1, 12, 64, 65, 2048])
def test_dispatch_rule(dtype, P, N, L):
    """At every P, N <= 64 (multiples of 8 or not: the wrapper pads the
    others) bf16 B/C take the wgmma kernel's bf16 instance and f32/f16
    B/C its split instance, at the 64-step tile (``"_short"``) for L <= 64
    and the 128-step tile above: the tile follows L alone."""
    want = (("wgmma" if dtype == BF16 else "wgmma_split")
            + ("_short" if L <= 64 else ""))
    assert K3.variant(dtype, P, N, L) == want


@pytest.mark.parametrize("P,N", [(65, 16), (16, 80), (0, 16)])
def test_dims_outside_the_kernel_are_refused(P, N):
    with pytest.raises(ValueError, match="limits"):
        K3.variant(F32, P, N, 12)


@pytest.mark.parametrize("reduced", [False, True])
def test_every_ssm_config_in_its_compute_dtype(reduced):
    """zamba2-1.2b at full size serves on the wgmma kernel at any prompt
    length (bf16 compute, P = N = 64, configured chunk 128: the 64-step
    tile for the serving launcher's 12 tokens, the 128-step one for
    2048), and its fp32 runs on the split instance; its reduced config
    (f32, P = N = 16, chunk 16) on the split instance too, at the tile L
    picks."""
    ssm = {name: cfg for name, cfg in all_configs(reduced).items()
           if cfg.ssm is not None and "ssm" in cfg.layer_kinds()}
    got = {name: {K3.variant(dt, cfg.ssm.head_dim, cfg.ssm.d_state, L)
                  for dt in (cfg.dtype, F32) for L in (12, 2048)}
           for name, cfg in ssm.items()}
    want = ({"wgmma_split", "wgmma_split_short"} if reduced else
            {"wgmma", "wgmma_split", "wgmma_short", "wgmma_split_short"})
    assert got == {"zamba2_1p2b": want}


@pytest.mark.parametrize("L", [12, 200])
def test_the_model_passes_the_configured_chunk(monkeypatch, L):
    """``ssm_full`` hands the scan the configured chunk, also for a prompt
    shorter than one chunk (the serving launcher's 12 tokens), so the
    dispatch sees 128 and the wgmma kernel runs it as one padded chunk;
    the plain version takes ``min(chunk, L)`` itself."""
    import dataclasses
    from repro_torch.configs import zamba2_1p2b
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.params import Init
    cfg = dataclasses.replace(
        zamba2_1p2b.smoke(),
        ssm=dataclasses.replace(zamba2_1p2b.smoke().ssm, chunk=128))
    seen = []
    inner = ssm_mod.ssd_scan

    def spy(x, a, Bm, Cm, chunk, init_state=None):
        seen.append(chunk)
        return inner(x, a, Bm, Cm, chunk, init_state=init_state)

    monkeypatch.setattr(ssm_mod, "ssd_scan", spy)
    gen = torch.Generator().manual_seed(0)
    p = ssm_mod.init_ssm(cfg, Init(gen, "cpu"))
    x = torch.randn(2, L, cfg.d_model, generator=gen)
    out, state = ssm_mod.ssm_full(cfg, p, x)
    assert seen == [128] and out.shape == x.shape
    assert torch.isfinite(state["ssm"]).all()


def xbc_slices(B, L, N, width, dtype=BF16, start=0):
    """B and C as column slices ``[start, start + N)`` and
    ``[start + N, start + 2N)`` of one ``[B, L, width]`` tensor, as the
    model hands them."""
    xbc = torch.zeros(B, L, width, dtype=dtype)
    return xbc[..., start: start + N], xbc[..., start + N: start + 2 * N]


@pytest.mark.parametrize("make,want", [
    # x [B, L, H, P] f32, contiguous, as the model makes it
    (lambda: torch.zeros(2, 40, 3, 64), (40 * 3 * 64, 3 * 64, 64)),
    # x as a view with padded heads: (64 + 4) * 4 = 272 bytes
    (lambda: torch.zeros(2, 40, 3, 68)[..., :64], (40 * 3 * 68, 3 * 68, 68)),
    # zamba2-1.2b's B and C: slices of xBC [B, L, 4096 + 128] bf16, rows of
    # 8,448 bytes, bases 8,192 and 8,320 bytes in
    (lambda: xbc_slices(2, 40, 64, 4096 + 128, start=4096)[0],
     (40 * 4224, 4224)),
    (lambda: xbc_slices(2, 40, 64, 4096 + 128, start=4096)[1],
     (40 * 4224, 4224)),
    # a slice whose base is 4 x 2 = 8 bytes off 16-byte alignment
    (lambda: xbc_slices(2, 40, 64, 4096 + 128, start=4)[0], None),
    # rows of (2 * 64 + 4) * 2 = 264 bytes: not a multiple of 16
    (lambda: xbc_slices(2, 40, 64, 2 * 64 + 4)[0], None),
    # size-1 dims: their strides are never stepped, so the row stands in
    (lambda: torch.zeros(1, 40, 1, 64).as_strided((1, 40, 1, 64),
                                                  (3, 64, 5, 1)),
     (64, 64, 64)),
    (lambda: torch.zeros(1, 40, 64, dtype=BF16).as_strided((1, 40, 64),
                                                           (7, 64, 1)),
     (64, 64)),
    # unit stride missing along P
    (lambda: torch.zeros(2, 40, 64, 3).transpose(2, 3), None),
    # B broadcast over the batch: a zero stride
    (lambda: torch.zeros(1, 40, 64, dtype=BF16).expand(2, 40, 64), None),
])
def test_tma_strides(make, want):
    assert K3.tma_strides(make()) == want


@pytest.mark.parametrize("bc_dtype", [BF16, F32, F16])
@pytest.mark.parametrize("dims,chunk,tile", [
    (64, 128, 128),     # the 128-step tile, called directly
    (16, 16, None),     # the reduced config's dims and chunk
    (64, 128, None),    # as the dispatch picks it
])
def test_each_variant_refuses_cpu_tensors(dims, chunk, tile, bc_dtype):
    x, a, Bm, Cm = (torch.from_numpy(t)
                    for t in inputs(1, 8, 1, dims, dims, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, a, Bm.to(bc_dtype), Cm.to(bc_dtype), chunk,
                      tile=tile)


def test_reset_counts():
    K3.ssd_scan_cuda.launches = 5
    K3.ssd_scan_cuda.by_variant["wgmma"] = 3
    K3.reset_counts()
    assert K3.ssd_scan_cuda.launches == 0
    assert K3.ssd_scan_cuda.by_variant == {
        "wgmma": 0, "wgmma_split": 0, "wgmma_short": 0,
        "wgmma_split_short": 0}


# ---- the wgmma kernel's precision contract, emulated on the CPU ----------

def _split(v):
    """hi = bf16(v), lo = bf16(v - hi), both returned as fp32."""
    hi = v.to(BF16).to(F32)
    return hi, (v - hi).to(BF16).to(F32)


def _product(eq, u, v, u_exact, v_exact):
    """``einsum(eq, u, v)`` as the kernel's tensor cores compute it: an
    operand exact in bf16 enters as it is, an fp32 one as its hi/lo split;
    two fp32 operands give hi.hi + hi.lo + lo.hi; fp32 sums throughout
    (a product of two bf16 values is exact in fp32)."""
    if u_exact and v_exact:
        return torch.einsum(eq, u, v)
    if u_exact or v_exact:
        (e, f), swap = ((u, v), False) if u_exact else ((v, u), True)
        fh, fl = _split(f)
        parts = [(e, fh), (e, fl)]
        if swap:
            parts = [(b, a) for a, b in parts]
        return sum(torch.einsum(eq, a, b) for a, b in parts)
    uh, ul = _split(u)
    vh, vl = _split(v)
    return (torch.einsum(eq, uh, vh) + torch.einsum(eq, uh, vl)
            + torch.einsum(eq, ul, vh))


def split_precision_scan(x, a, Bm, Cm, chunk, bc_exact, init_state=None):
    """The chunked scan with every product under the split contract
    (``ssd_scan_wgmma.cu``'s arithmetic): ``x [B, L, H, P]``, ``a [B, L,
    H]``, ``Bm, Cm [B, L, N]`` fp32 tensors; ``bc_exact`` says that B and C
    hold bf16 values (the bf16 instance; else the split instance, which
    splits them too); ``init_state [B, H, P, N]`` (None: zero) enters the
    first chunk's C.S^T through the same split as every later state.
    Chunks of ``chunk`` steps, as the kernel runs them: a sequence shorter
    than one chunk is one chunk padded with a = 1 and x = B = C = 0.
    -> ``(y, final_state)``, fp32."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    pad = -L % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // Q
    xc = x.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(torch.log(torch.clamp_min(
        a.reshape(Bsz, nc, Q, H), 1e-20)), dim=2)           # [B,nc,Q,H]
    cb = _product("bcin,bcjn->bcij", Cc, Bc, bc_exact, bc_exact)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,i,j,H]
    low = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :,
                                                         None]
    M = torch.where(low, cb[..., None] * torch.exp(
        torch.where(low, seg, torch.zeros(()))), torch.zeros(()))
    S = (torch.zeros(Bsz, H, P, N) if init_state is None
         else init_state.clone())
    ys = []
    for c in range(nc):
        y = (_product("bin,bhpn->bihp", Cc[:, c], S, bc_exact, False)
             * torch.exp(cum[:, c])[..., None])
        y = y + _product("bijh,bjhp->bihp", M[:, c], xc[:, c], False, False)
        dout = torch.exp(cum[:, c, -1:, :] - cum[:, c])      # [B,Q,H]
        xd = xc[:, c] * dout[..., None]
        S = (S * torch.exp(cum[:, c, -1])[:, :, None, None]
             + _product("bjhp,bjn->bhpn", xd, Bc[:, c], False, bc_exact))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :L], S


def _as_bf16_values(t):
    return t.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("B,L,H,P,N,chunk,bc_bf16,lo", [
    # tests/test_kernels.py's SSD cases, B/C in fp32 (all split)
    (1, 64, 1, 16, 16, 16, False, 0.7),
    (2, 128, 2, 32, 16, 64, False, 0.7),
    (1, 128, 4, 64, 64, 128, False, 0.7),   # mamba2-native dims
    (1, 100, 2, 32, 32, 32, False, 0.7),    # padding path
    (1, 128, 2, 16, 16, 32, False, 0.8),    # the chunk-invariance inputs
    (1, 256, 1, 16, 16, 64, False, None),   # long decay: x 1, a 0.5
    # the wgmma kernel's own case: bf16-valued B/C at P = N = 64, Q = 128
    (2, 512, 2, 64, 64, 128, True, 0.7),
    (1, 300, 2, 64, 64, 128, True, 0.7),    # ragged tail chunk
    # shorter than one chunk: the short kernel's one padded chunk
    (2, 12, 2, 64, 64, 128, True, 0.7),
    (1, 64, 2, 64, 64, 128, False, 0.7),
])
def test_split_precision_contract_meets_the_reference(tile, B, L, H, P, N,
                                                      chunk, bc_bf16, lo):
    """The hi/lo bf16 scheme of ``ssd_scan_wgmma.cu``, emulated in plain
    PyTorch at chunks of ``min(chunk, tile)`` steps (the 128-step tile and
    the short kernel's 64-step tile; a sequence shorter than that is one
    padded chunk), agrees with the reference's ``ssd_scan`` (Pallas
    interpret mode and the sequential recurrence, at chunks of
    ``min(chunk, L)``) within 1e-4."""
    if lo is None:
        arrays = (np.ones((B, L, H, P), np.float32),
                  np.full((B, L, H), 0.5, np.float32),
                  np.full((B, L, N), 0.1, np.float32),
                  np.full((B, L, N), 0.1, np.float32))
    else:
        arrays = inputs(B, L, H, P, N, seed=L + P + N, lo=lo)
    if bc_bf16:
        arrays = arrays[:2] + tuple(_as_bf16_values(t).view(np.float32)
                                    for t in arrays[2:])
    y, s = split_precision_scan(*(torch.from_numpy(t) for t in arrays),
                                min(chunk, tile), bc_bf16)
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    j = [jnp.asarray(t) for t in arrays]
    for impl in ("pallas", "ref"):
        yr, sr = ref_scan(*j, chunk=min(chunk, L), impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("B,L,H,P,N,chunk,bc_bf16", [
    (1, 128, 4, 64, 64, 128, False),
    (2, 512, 2, 64, 64, 128, True),
    (1, 300, 2, 64, 64, 128, True),     # ragged tail chunk
])
def test_split_precision_contract_from_a_state(B, L, H, P, N, chunk,
                                              bc_bf16):
    """The split scheme from a random initial state (the wgmma kernel's
    state accumulator loaded from it) agrees with the reference's
    ``ssd_chunked_ref`` from that state within 1e-4."""
    arrays = inputs(B, L, H, P, N, seed=L + 2 * H)
    if bc_bf16:
        arrays = arrays[:2] + tuple(_as_bf16_values(t).view(np.float32)
                                    for t in arrays[2:])
    s0 = np.random.default_rng(L + 1).normal(size=(B, H, P, N)).astype(
        np.float32)
    y, s = split_precision_scan(*(torch.from_numpy(t) for t in arrays),
                                chunk, bc_bf16, torch.from_numpy(s0))
    yr, sr = ref_chunked(*(jnp.asarray(t) for t in arrays), min(chunk, L),
                         jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=TOL, atol=TOL)


def test_the_emulation_splits_and_does_not_round_once():
    """The split keeps what one bf16 rounding loses: on fp32 operands the
    emulation is about 2^-16 from the fp32 product, a single bf16 rounding
    about 2^-8."""
    r = np.random.default_rng(3)
    u = torch.from_numpy(r.normal(size=(64, 128)).astype(np.float32))
    v = torch.from_numpy(r.normal(size=(128, 64)).astype(np.float32))
    exact = (u.double() @ v.double())
    scale = float(exact.abs().max())
    split = float((_product("ik,kj->ij", u, v, False, False).double()
                   - exact).abs().max()) / scale
    once = float(((u.to(BF16).float() @ v.to(BF16).float()).double()
                  - exact).abs().max()) / scale
    assert split < 2 ** -14 and once > 2 ** -10


def test_chunked_ref_runs_in_float64_for_float64_inputs():
    """The plain version is also the float64 oracle ``chip_smoke.py``
    holds both kernels to: given float64 inputs it computes in float64
    (fp32 inputs stay fp32), and agrees with the literal recurrence."""
    B, L, H, P, N = 1, 96, 2, 16, 8
    x, a, Bm, Cm = (torch.from_numpy(t).double()
                    for t in inputs(B, L, H, P, N, seed=12))
    y, s = ssd_chunked_ref(x, a, Bm, Cm, 32)
    assert y.dtype == s.dtype == torch.float64
    yq, sq = ssd_scan_sequential(
        x.permute(0, 2, 1, 3).reshape(B * H, L, P),
        a.permute(0, 2, 1).reshape(B * H, L),
        Bm[:, None].expand(B, H, L, N).reshape(B * H, L, N),
        Cm[:, None].expand(B, H, L, N).reshape(B * H, L, N))
    yq = yq.reshape(B, H, L, P).permute(0, 2, 1, 3)
    assert float((y - yq.double()).abs().max()) < 1e-5
    y32, _ = ssd_chunked_ref(x.float(), a.float(), Bm.float(), Cm.float(), 32)
    assert y32.dtype == torch.float32


@pytest.mark.parametrize("L", [1, 12, 64, 100, 127])
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("bc_bf16", [False, True])
@pytest.mark.parametrize("impl", ["split", "plain"])
def test_one_padded_chunk_meets_the_reference_at_q_equal_l(L, from_state,
                                                          bc_bf16, impl):
    """A sequence shorter than the configured chunk of 128: the wgmma
    kernel's one padded chunk (``split_precision_scan`` at chunk 128, B/C
    fp32 or bf16-valued) and the port's plain version at chunk 128 (which
    takes ``min(chunk, L)`` itself) agree with the reference's
    ``ssd_scan`` at Q = L (Pallas interpret mode and the sequential
    recurrence; from a state, its ``ssd_chunked_ref``) within 1e-4, y and
    the final state."""
    B, H, P, N = 1, 2, 64, 64
    arrays = inputs(B, L, H, P, N, seed=L + 3 * from_state)
    if bc_bf16:
        arrays = arrays[:2] + tuple(_as_bf16_values(t).view(np.float32)
                                    for t in arrays[2:])
    s0 = (np.random.default_rng(L).normal(size=(B, H, P, N)).astype(
        np.float32) if from_state else None)
    ins = [torch.from_numpy(t) for t in arrays]
    init = None if s0 is None else torch.from_numpy(s0)
    if impl == "split":
        y, s = split_precision_scan(*ins, 128, bc_bf16, init)
    else:
        y, s = ssd_chunked_ref(*ins, 128, init)
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    j = [jnp.asarray(t) for t in arrays]
    if from_state:
        wants = [ref_chunked(*j, L, jnp.asarray(s0))]
    else:
        wants = [ref_scan(*j, chunk=L, impl=i) for i in ("pallas", "ref")]
    for yr, sr in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=TOL,
                                   atol=TOL)


def pad_steps(arrays, steps):
    """x, a, B, C (numpy) padded along L to ``steps`` with a = 1 and
    x = B = C = 0: the rows TMA's out-of-bounds fill gives the short
    kernel."""
    x, a, Bm, Cm = arrays
    pad = steps - x.shape[1]
    return (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))),
            np.pad(a, ((0, 0), (0, pad), (0, 0)), constant_values=1.0),
            np.pad(Bm, ((0, 0), (0, pad), (0, 0))),
            np.pad(Cm, ((0, 0), (0, pad), (0, 0))))


@pytest.mark.parametrize("L", [1, 12, 63, 64])
@pytest.mark.parametrize("from_state", [False, True])
def test_the_64_step_padded_chunk_meets_the_reference_at_q_equal_l(
        L, from_state):
    """The short kernel's arithmetic in plain PyTorch: the inputs padded
    to 64 steps (a = 1, x = B = C = 0), the port's ``ssd_chunked_ref`` at
    a chunk of 64, the first L steps of y kept; y and the final state
    agree with the reference's ``ssd_chunked_ref`` at Q = L, from zero
    and from a state, within 1e-4 of max(1, max |y|, max |S|)."""
    B, H, P, N = 2, 3, 64, 64
    arrays = inputs(B, L, H, P, N, seed=100 + L + from_state)
    s0 = (np.random.default_rng(L + 7).normal(size=(B, H, P, N)).astype(
        np.float32) if from_state else None)
    init = None if s0 is None else torch.from_numpy(s0)
    y, s = ssd_chunked_ref(*(torch.from_numpy(t)
                             for t in pad_steps(arrays, 64)), 64, init)
    y = y[:, :L]
    yr, sr = ref_chunked(*(jnp.asarray(t) for t in arrays), L,
                         None if s0 is None else jnp.asarray(s0))
    yr, sr = np.asarray(yr), np.asarray(sr)
    scale = max(1.0, float(np.abs(yr).max()), float(np.abs(sr).max()))
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    assert float(np.abs(y.numpy() - yr).max()) <= TOL * scale
    assert float(np.abs(s.numpy() - sr).max()) <= TOL * scale


@pytest.mark.parametrize("B", [1, 3])
def test_split_launch_reads_the_planes_with_their_own_strides(monkeypatch,
                                                              B):
    """The split instance reads the pre-pass's ``[4, B, L, N]`` planes as
    4 B batches: the launch gets their own batch stride L * N, also at
    B = 1, where ``tma_strides`` would stand the row in for it."""
    L, H, N = 20, 2, 64
    x, a = torch.zeros(B, L, H, 64), torch.zeros(B, L, H)
    Bm, Cm = torch.zeros(B, L, N), torch.zeros(B, L, N)
    seen = {}

    def fake_launch(name, x, a, Bm, Cm, init_state, strides, *rest):
        seen.update(name=name, strides=strides, B=Bm)
        return None, None

    monkeypatch.setattr(K3, "_check", lambda *args: (0, B, L, H, 64, N))
    monkeypatch.setattr(K3, "split_bc", lambda Bm, Cm, strides: torch.zeros(
        4, B, L, N, dtype=BF16))
    monkeypatch.setattr(K3, "_launch", fake_launch)
    monkeypatch.setattr(K3, "_count", lambda name: None)
    K3.ssd_scan_cuda(x, a, Bm, Cm, 128)
    assert seen["name"] == "ssd_scan_split_launch"
    assert seen["strides"][6:] == (L * N, N, L * N, N)
    assert seen["B"].shape == (4, B, L, N)


@pytest.mark.parametrize("L", [1, 12, 64, 65, 200])
@pytest.mark.parametrize("from_state", [False, True])
def test_narrow_dims_at_the_kernels_tile_meet_the_reference_chunk(
        L, from_state):
    """How the wgmma kernel runs the reduced config's scan (P = N = 16, a
    configured chunk of 16), in plain PyTorch: P and N zero-padded to the
    tiles' 64 (x's, B's and C's columns, the initial state's rows and
    columns, as TMA's out-of-bounds fill and the masked state load give
    them), the steps padded to whole tiles (a = 1, x = B = C = 0), the
    port's ``ssd_chunked_ref`` at the tile L picks (64 for L <= 64, else
    128) and the result cut back to L, P and N.  It agrees with the
    reference's ``ssd_chunked_ref`` at the configured chunk of 16 within
    1e-4 of max(1, max |y|, max |S|), from zero and from a state: ignoring
    a small configured chunk keeps the function."""
    B, H, P, N, chunk = 2, 3, 16, 16, 16
    arrays = inputs(B, L, H, P, N, seed=300 + L + from_state)
    s0 = (np.random.default_rng(L + 11).normal(size=(B, H, P, N)).astype(
        np.float32) if from_state else None)
    tile = 64 if L <= 64 else 128
    x, a, Bm, Cm = pad_steps(arrays, -(-L // tile) * tile)
    wide = (np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 64 - P))), a,
            np.pad(Bm, ((0, 0), (0, 0), (0, 64 - N))),
            np.pad(Cm, ((0, 0), (0, 0), (0, 64 - N))))
    init = (None if s0 is None else torch.from_numpy(
        np.pad(s0, ((0, 0), (0, 0), (0, 64 - P), (0, 64 - N)))))
    y, s = ssd_chunked_ref(*(torch.from_numpy(t) for t in wide), tile, init)
    assert not y[:, :, :, P:].any() and not s[:, :, P:].any()
    assert not s[..., N:].any()
    y, s = y[:, :L, :, :P].numpy(), s[:, :, :P, :N].numpy()
    yr, sr = ref_chunked(*(jnp.asarray(t) for t in arrays), chunk,
                         None if s0 is None else jnp.asarray(s0))
    yr, sr = np.asarray(yr), np.asarray(sr)
    scale = max(1.0, float(np.abs(yr).max()), float(np.abs(sr).max()))
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    assert float(np.abs(y - yr).max()) <= TOL * scale
    assert float(np.abs(s - sr).max()) <= TOL * scale


@pytest.mark.parametrize("P,N", [(12, 20), (16, 4), (64, 60)])
@pytest.mark.parametrize("from_state", [False, True])
def test_pad_dims_keeps_the_scan(P, N, from_state):
    """Dims that are not multiples of 8 (a row of N bf16 values TMA
    cannot read) reach the kernel zero-padded by ``pad_dims``: the scan
    of the padded inputs, cut back to P and N, is the scan of the
    originals, and the padded dims are multiples of 8."""
    B, L, H = 2, 40, 2
    x, a, Bm, Cm = (torch.from_numpy(t) for t in inputs(B, L, H, P, N, 5))
    s0 = (torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, H, P, N)).astype(np.float32)) if from_state else None)
    px, pB, pC, ps0 = K3.pad_dims(x, Bm, Cm, s0)
    assert px.shape[-1] % 8 == 0 and pB.shape[-1] % 8 == 0
    assert pB.shape == pC.shape
    assert (ps0 is None) == (s0 is None)
    if (P, N) == (px.shape[-1], pB.shape[-1]):
        assert px is x and pB is Bm and pC is Cm and ps0 is s0
    y, s = ssd_chunked_ref(px, a, pB, pC, 16, ps0)
    yw, sw = ssd_chunked_ref(x, a, Bm, Cm, 16, s0)
    torch.testing.assert_close(y[..., :P], yw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s[..., :P, :N], sw, rtol=1e-6, atol=1e-6)
