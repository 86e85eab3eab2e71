"""The one-pass RMSNorm and RoPE kernels (``kernels/norm_rope``) and how
``models/layers.py`` reaches them.

On the CPU: CPU and meta tensors, and DTensors on them, keep the plain
code (the launchers patched to raise).  With the device check pointed at
the CPU and the forward hooks at the plain versions, the CUDA path runs
here: every call reaches the forward, under autograd through a Function
whose gradients equal the plain code's bit for bit, DTensors on each
rank's local shards (four gloo ranks), and a DTensor handed to the kernel
layer raises, as do dtypes and shapes the kernels do not take.  The
cached inverse frequencies equal ``rope_freqs`` bit for bit; the
kernels' names fall in the benchmark's ``other`` family.  On the card
(marker ``card``, skipped without CUDA): the kernels against the plain
functions, bf16 and f16 within one unit in the last place of the output
dtype, f32 within 2e-6 relative, also under autograd.  Run them on a
card with ``python -m pytest -q -m card tests/test_torch_norm_rope.py``.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.norm_rope import ops as norm_rope  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from torch_port_util import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "norm_rope" / "csrc" / \
    "norm_rope.cu"
THETA = 10_000.0
#: seconds the four-rank case may take once its ranks have joined
TIMEOUT = 120.0


class Launched(Exception):
    pass


def _refuse(*a, **k):
    raise Launched


@pytest.fixture
def no_launch(monkeypatch):
    """Both forward hooks patched to raise :class:`Launched`."""
    monkeypatch.setattr(norm_rope, "NORM_FORWARD", _refuse)
    monkeypatch.setattr(norm_rope, "ROPE_FORWARD", _refuse)


class Forwards:
    """The forward hooks pointed at the plain versions, recording what
    each call got: the CUDA path's dispatch, run on CPU tensors."""

    def __init__(self):
        self.calls = []

    def norm(self, x, w, eps):
        self.calls.append(("norm", x, w))
        return layers.rms_norm_plain(x, w, eps)

    def rope(self, q, k, positions, theta):
        self.calls.append(("rope", q, k, positions))
        return (layers.apply_rope_plain(q, positions, theta),
                None if k is None else layers.apply_rope_plain(
                    k, positions, theta))


@pytest.fixture
def cuda_path(monkeypatch):
    """The device check pointed at the CPU, the forwards at
    :class:`Forwards`."""
    f = Forwards()
    monkeypatch.setattr(norm_rope, "DEVICE", "cpu")
    monkeypatch.setattr(norm_rope, "NORM_FORWARD", f.norm)
    monkeypatch.setattr(norm_rope, "ROPE_FORWARD", f.rope)
    return f


def _inputs(dtype=torch.float32, requires_grad=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(64, generator=g)).to(dtype)
    q = torch.randn(2, 5, 4, 16, generator=g).to(dtype)
    k = torch.randn(2, 5, 2, 16, generator=g).to(dtype)
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    for t in (x, w, q, k):
        t.requires_grad_(requires_grad)
    return x, w, q, k, pos


def _all_plain(x, w, q, k, pos):
    """Each dispatching function against its plain version, bit for bit."""
    torch.testing.assert_close(layers.rms_norm(x, w),
                               layers.rms_norm_plain(x, w), rtol=0, atol=0)
    torch.testing.assert_close(layers.apply_rope(q, pos, THETA),
                               layers.apply_rope_plain(q, pos, THETA),
                               rtol=0, atol=0)
    qo, ko = layers.apply_rope_qk(q, k, pos, THETA)
    torch.testing.assert_close(qo, layers.apply_rope_plain(q, pos, THETA),
                               rtol=0, atol=0)
    torch.testing.assert_close(ko, layers.apply_rope_plain(k, pos, THETA),
                               rtol=0, atol=0)


@pytest.mark.parametrize("requires_grad", [False, True])
def test_cpu_tensors_keep_the_plain_code(no_launch, requires_grad):
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        _all_plain(*_inputs(dt, requires_grad))


def test_meta_tensors_keep_the_plain_code(no_launch):
    x, w, q, k, pos = (t.to("meta") for t in _inputs(torch.bfloat16))
    assert layers.rms_norm(x, w).shape == x.shape
    qo, ko = layers.apply_rope_qk(q, k, pos, THETA)
    assert (qo.shape, ko.shape, qo.dtype) == (q.shape, k.shape, q.dtype)


def _strided(t):
    """t with a last stride of 2 (same values)."""
    return torch.cat([t, t], dim=-1)[..., ::2]


@pytest.mark.parametrize("case", ["no_grad", "x_grad", "weight_grad",
                                  "strided", "no_grad_mode"])
def test_cuda_tensors_always_reach_the_forward(cuda_path, case):
    """Whatever autograd records and however the input lies, a call on
    the CUDA path reaches the forward hook once (norm; RoPE on q and k
    together), with the plain tensors it was given."""
    x, w, q, k, pos = _inputs(requires_grad=case == "x_grad")
    if case == "weight_grad":
        w.requires_grad_(True)
    if case == "strided":
        x, q, k = _strided(x), _strided(q), _strided(k)
    ctx = torch.no_grad() if case == "no_grad_mode" else torch.enable_grad()
    with ctx:
        y = layers.rms_norm(x, w)
        qo, ko = layers.apply_rope_qk(q, k, pos, THETA)
        qa = layers.apply_rope(q, pos, THETA)
    kinds = [c[0] for c in cuda_path.calls]
    assert kinds == ["norm", "rope", "rope"]
    assert cuda_path.calls[0][1] is x and cuda_path.calls[1][2] is k
    assert cuda_path.calls[2][2] is None
    records = case in ("x_grad", "weight_grad")
    assert (y.grad_fn is not None) == records
    assert (qo.grad_fn is not None) == (case == "x_grad")
    torch.testing.assert_close(y, layers.rms_norm_plain(x, w),
                               rtol=0, atol=0)
    for got, t in ((qo, q), (ko, k), (qa, q)):
        torch.testing.assert_close(
            got, layers.apply_rope_plain(t, pos, THETA), rtol=0, atol=0)


def _grads(fn, ins, needs):
    """fn's outputs and the gradients of a fixed random projection of them
    at ``ins`` (those ``needs`` marks)."""
    ins = [t.detach().clone().requires_grad_(n) for t, n in zip(ins, needs)]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, generator=g)).sum()
               for o in outs)
    got = torch.autograd.grad(loss, [t for t, n in zip(ins, needs) if n])
    return [o.detach() for o in outs] + list(got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["norm", "norm_weight_only", "rope_qk",
                                  "rope_q_only", "rope"])
def test_autograd_gradients_equal_the_plain_code(cuda_path, dtype, what):
    """The Functions' backwards recompute the plain code and
    differentiate it: outputs and gradients bit for bit those of autograd
    through the plain code."""
    x, w, q, k, pos = _inputs(dtype)
    norm = lambda x, w: layers.rms_norm(x, w)              # noqa: E731
    norm_p = lambda x, w: layers.rms_norm_plain(x, w)      # noqa: E731
    qk = lambda q, k: layers.apply_rope_qk(q, k, pos, THETA)  # noqa: E731
    qk_p = lambda q, k: (layers.apply_rope_plain(           # noqa: E731
        q, pos, THETA), layers.apply_rope_plain(k, pos, THETA))
    one = lambda q: layers.apply_rope(q, pos, THETA)       # noqa: E731
    one_p = lambda q: layers.apply_rope_plain(q, pos, THETA)  # noqa: E731
    fn, ref, ins, needs = {
        "norm": (norm, norm_p, (x, w), (True, True)),
        "norm_weight_only": (norm, norm_p, (x, w), (False, True)),
        "rope_qk": (qk, qk_p, (q, k), (True, True)),
        "rope_q_only": (qk, qk_p, (q, k), (True, False)),
        "rope": (one, one_p, (q,), (True,)),
    }[what]
    got, want = _grads(fn, ins, needs), _grads(ref, ins, needs)
    assert len(cuda_path.calls) == 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dtensors_keep_the_plain_code_on_the_cpu(no_launch, one_rank_group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from torch.distributed.tensor.experimental import implicit_replication

    mesh = init_device_mesh("cpu", (1,))
    x, w, q, k, pos = _inputs()
    d = [distribute_tensor(t, mesh, [Replicate()]) for t in (x, w, q, k, pos)]
    # as under the model's sharding policy: plain constants join DTensors
    with implicit_replication():
        out = layers.rms_norm(d[0], d[1])
        qo, ko = layers.apply_rope_qk(d[2], d[3], d[4], THETA)
    torch.testing.assert_close(out.full_tensor(), layers.rms_norm_plain(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(qo.full_tensor(),
                               layers.apply_rope_plain(q, pos, THETA),
                               rtol=0, atol=0)
    torch.testing.assert_close(ko.full_tensor(),
                               layers.apply_rope_plain(k, pos, THETA),
                               rtol=0, atol=0)


def test_a_dtensor_at_the_kernel_layer_raises(cuda_path, one_rank_group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = init_device_mesh("cpu", (1,))
    x, w, q, k, pos = _inputs()
    dx, dq = (distribute_tensor(t, mesh, [Replicate()]) for t in (x, q))
    with pytest.raises(TypeError, match="DTensor"):
        norm_rope.rms_norm(dx, w)
    with pytest.raises(TypeError, match="DTensor"):
        norm_rope.rope(dq, None, pos, THETA)
    assert cuda_path.calls == []


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sharded_body(rank):
    """On a ``(data 2, model 2)`` mesh under a policy, the CUDA path (on
    CPU tensors): the norm's rows split over both axes, q's batch over
    ``data`` and heads over ``model``, k's batch only; each forward must
    get a plain tensor with whole rows and its own positions."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.params import sharding_rules
    from repro_torch.models.sharding import ShardingPolicy, use_policy

    f = Forwards()
    norm_rope.DEVICE = "cpu"
    norm_rope.NORM_FORWARD, norm_rope.ROPE_FORWARD = f.norm, f.rope
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 64, generator=g)
    w = 1 + 0.1 * torch.randn(64, generator=g)
    q = torch.randn(4, 6, 8, 16, generator=g)
    k = torch.randn(4, 6, 2, 16, generator=g)
    pos = 100 + torch.arange(24).view(4, 6)
    dist = lambda t, pl: distribute_tensor(t, mesh, pl,  # noqa: E731
                                           src_data_rank=None)
    dx = dist(x, [Shard(0), Shard(2)]).requires_grad_(True)
    dq = dist(q, [Shard(0), Shard(2)])
    dk = dist(k, [Shard(0), Replicate()])
    with use_policy(ShardingPolicy(mesh, sharding_rules())):
        y = layers.rms_norm(dx, w)
        qo, ko = layers.apply_rope_qk(dq, dk, pos, THETA)
        (y * dist(_projection(y.shape), y.placements)).sum().backward()
    seen = [(c[0], tuple(c[1].shape), type(c[1]).__name__,
             None if c[0] == "norm" else c[3].tolist()) for c in f.calls]
    return {"y": y.detach().full_tensor().numpy(),
            "qo": qo.full_tensor().numpy(),
            "ko": ko.full_tensor().numpy(),
            "gx": dx.grad.full_tensor().numpy(), "seen": seen}


def _projection(shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(1))


def test_dtensors_run_the_kernels_on_local_shards(tmp_path):
    out = run_ranks(_sharded_body, 4, tmp_path, TIMEOUT)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 64, generator=g)
    w = 1 + 0.1 * torch.randn(64, generator=g)
    q = torch.randn(4, 6, 8, 16, generator=g)
    k = torch.randn(4, 6, 2, 16, generator=g)
    pos = 100 + torch.arange(24).view(4, 6)
    xs = x.clone().requires_grad_(True)
    y = layers.rms_norm_plain(xs, w)
    (y * _projection(y.shape)).sum().backward()
    for rank, r in out.items():
        torch.testing.assert_close(torch.from_numpy(r["y"]), y.detach(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(torch.from_numpy(r["qo"]),
                                   layers.apply_rope_plain(q, pos, THETA),
                                   rtol=0, atol=0)
        torch.testing.assert_close(torch.from_numpy(r["ko"]),
                                   layers.apply_rope_plain(k, pos, THETA),
                                   rtol=0, atol=0)
        # the gradient's rows are whole on every rank: the same sums
        torch.testing.assert_close(torch.from_numpy(r["gx"]), xs.grad,
                                   rtol=0, atol=0)
        data = rank // 2
        # each rank's own rows, whole; its batch half of the positions
        mine = pos[2 * data:2 * data + 2].tolist()
        assert r["seen"] == [("norm", (2, 6, 64), "Tensor", None),
                             ("rope", (2, 6, 4, 16), "Tensor", mine),
                             ("rope", (2, 6, 2, 16), "Tensor", mine)], r


@pytest.mark.parametrize("call,err", [
    (lambda x, w, q, k, p: layers.rms_norm(x.double(), w), TypeError),
    (lambda x, w, q, k, p: layers.rms_norm(x, w.double()), TypeError),
    (lambda x, w, q, k, p: layers.rms_norm(x, w[:32]), ValueError),
    (lambda x, w, q, k, p: layers.apply_rope(q.double(), p, THETA),
     TypeError),
    (lambda x, w, q, k, p: layers.apply_rope_qk(q, k.half(), p, THETA),
     TypeError),
    (lambda x, w, q, k, p: layers.apply_rope(q, p.float(), THETA),
     TypeError),
    (lambda x, w, q, k, p: layers.apply_rope(q[0], p[0], THETA), ValueError),
    (lambda x, w, q, k, p: layers.apply_rope(q[..., :15], p, THETA),
     ValueError),
    (lambda x, w, q, k, p: layers.apply_rope_qk(q, k[:1], p, THETA),
     ValueError),
    (lambda x, w, q, k, p: layers.apply_rope(q, p[:, :3], THETA),
     ValueError),
])
def test_inputs_the_kernels_do_not_take_raise(monkeypatch, call, err):
    """On the CUDA path (the device check at the CPU, the real
    launchers), what the kernels do not take raises before any build or
    launch; nothing falls back to the plain code."""
    monkeypatch.setattr(norm_rope, "DEVICE", "cpu")
    monkeypatch.setattr(norm_rope, "_launch", _refuse)
    with pytest.raises(err):
        call(*_inputs())


def test_launch_range_only_under_a_profiler():
    """The op-level range the wrappers open around a launch: the shared
    no-op untraced; under the profiler an event of that name holding the
    ops (and so the kernels) launched inside it."""
    from repro_torch import tracing

    assert tracing.launch("rms_norm_launch") is tracing.span("x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("model.norm"):
            with tracing.launch("rms_norm_launch"):
                torch.ones(3).add_(1)
    evts = {e.name: e for e in prof.events()}
    inner = evts["rms_norm_launch"]
    assert inner.cpu_parent.name == "model.norm"
    assert any(c.name == "aten::add_" for c in inner.cpu_children)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (64, 1e6),
                                            (128, 500_000.0)])
def test_cached_inverse_frequencies_equal_rope_freqs(head_dim, theta):
    got = norm_rope.rope_inv_freq(head_dim, theta, torch.device("cpu"))
    want = layers.rope_freqs(head_dim, theta, torch.device("cpu"))
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert norm_rope.rope_inv_freq(head_dim, theta,
                                   torch.device("cpu")) is got


def test_kernel_names_read_other_in_the_benchmark(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    from colobench.lib.kernels import family

    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                       SOURCE.read_text())
    assert sorted(names) == ["rmsnorm_rows_kernel", "rope_qk_kernel"]
    for n in names:
        for args in ("float, float", "__nv_bfloat16, __nv_bfloat16",
                     "__half, float"):
            full = f"void (anonymous namespace)::{n}<{args}>(...)"
            assert family(full) == "other", full


@pytest.mark.parametrize("shape,strides,want", [
    ((7, 64), None, (1, 7, 0, 0, 64)),
    ((2, 3, 64), (576, 192, 1), (1, 6, 0, 0, 192)),        # merges
    ((2, 3, 64), (576, 96, 1), (2, 3, 0, 576, 96)),
    ((4, 2, 3, 8), (1000, 300, 90, 1), (2, 3, 1000, 300, 90)),
    ((2, 2, 2, 2, 8), (900, 300, 90, 20, 1), None),
])
def test_norm_row_layout(shape, strides, want):
    """The leading dimensions as the kernel steps them, merged where they
    step evenly (the MLA ``c_kv`` slice: one stride of 576)."""
    x = (torch.zeros(shape) if strides is None else torch.zeros(
        1 + sum((n - 1) * st for n, st in zip(shape, strides))).as_strided(
            shape, strides))
    assert norm_rope._leading(x) == want


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at |v| (v in f32)."""
    m = MANTISSA[dtype]
    tiny = torch.finfo(dtype).tiny
    _, e = torch.frexp(v.abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(v), e - 1 - m)


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
        return
    gap = (got - want).abs()
    bad = gap > _ulp(torch.maximum(got.abs(), want.abs()), dtype)
    assert not bad.any(), (f"{int(bad.sum())} elements beyond one ulp; "
                           f"worst {float(gap.max())}")


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 7, 7208])
@pytest.mark.parametrize("width", [100, 128, 512, 1536, 2048, 4096, 5120,
                                   7168])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_norm_kernel_matches_plain(cuda, dtype, width, rows):
    g = torch.Generator(device=cuda).manual_seed(width * 10 + rows)
    x = (3 * torch.randn(rows, width, generator=g, device=cuda)).to(dtype)
    w = (1 + 0.2 * torch.randn(width, generator=g, device=cuda))
    for wt in ((w.to(torch.bfloat16), w) if dtype == torch.bfloat16
               else (w.to(dtype), w.to(torch.bfloat16))):
        before = norm_rope.rms_norm_cuda.launches
        got = layers.rms_norm(x, wt)
        assert norm_rope.rms_norm_cuda.launches == before + 1
        _close(got, layers.rms_norm_plain(x, wt), dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_norm_kernel_on_strided_rows(cuda, dtype):
    """Rows as they lie: the MLA ``c_kv`` column slice, qk-norm heads of
    a projection, and a transposed view (three leading strides)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    full = torch.randn(3, 40, 576, generator=g, device=cuda).to(dtype)
    w = torch.randn(512, generator=g, device=cuda).to(dtype)
    heads = torch.randn(3, 40, 8 * 128, generator=g, device=cuda).to(
        dtype).view(3, 40, 8, 128)
    wh = torch.randn(128, generator=g, device=cuda).to(dtype)
    odd = full[..., 1:101]                      # unaligned: scalar loads
    wo = torch.randn(100, generator=g, device=cuda).to(dtype)
    for x, wt in ((full[..., :512], w), (heads, wh),
                  (heads.transpose(1, 2), wh), (odd, wo)):
        before = norm_rope.rms_norm_cuda.launches
        got = layers.rms_norm(x, wt)
        assert norm_rope.rms_norm_cuda.launches == before + 1
        _close(got, layers.rms_norm_plain(x, wt), dtype)


def _rope_case(cuda, dtype, B, S, H, Hk, D, pos):
    g = torch.Generator(device=cuda).manual_seed(B * S + H + D)
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(dtype)
    k = (None if Hk is None else
         torch.randn(B, S, Hk, D, generator=g, device=cuda).to(dtype))
    before = norm_rope.rope_cuda.launches
    if k is None:
        outs = [(layers.apply_rope(q, pos, THETA), q)]
    else:
        qo, ko = layers.apply_rope_qk(q, k, pos, THETA)
        outs = [(qo, q), (ko, k)]
    assert norm_rope.rope_cuda.launches == before + 1
    for got, x in outs:
        _close(got, layers.apply_rope_plain(x, pos, THETA), dtype)


@pytest.mark.card
@pytest.mark.parametrize("heads", [(32, 8), (28, 4), (1, None), (1, 1)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_rope_kernel_matches_plain(cuda, dtype, D, heads):
    H, Hk = heads
    # prefill to 32,767, batch positions shared (stride 0)
    S = 2048
    pos = torch.arange(32768 - S, 32768, dtype=torch.int32,
                       device=cuda)[None].expand(2, S)
    _rope_case(cuda, dtype, 2, S, H, Hk, D, pos)
    # decode: one token a sequence at its own offset, int64
    pos = torch.tensor([0, 7, 4095, 29695, 32767], device=cuda)[:, None]
    _rope_case(cuda, dtype, 5, 1, H, Hk, D, pos)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_kernel_on_the_mla_k_rope_slice(cuda, dtype):
    """MLA's ``k_rope``: a column slice of ``ckv_full`` (row stride 576),
    one head of 64, beside a strided ``q_rope`` view."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, S = 2, 300
    ckv = torch.randn(B, S, 576, generator=g, device=cuda).to(dtype)
    k_rope = ckv[..., 512:][:, :, None, :]
    q_all = torch.randn(B, S, 16, 192, generator=g, device=cuda).to(dtype)
    q_rope = q_all[..., 128:]
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    before = norm_rope.rope_cuda.launches
    qo, ko = layers.apply_rope_qk(q_rope, k_rope, pos, THETA)
    kr = layers.apply_rope(k_rope, pos, THETA)
    assert norm_rope.rope_cuda.launches == before + 2
    _close(qo, layers.apply_rope_plain(q_rope, pos, THETA), dtype)
    _close(ko, layers.apply_rope_plain(k_rope, pos, THETA), dtype)
    _close(kr, layers.apply_rope_plain(k_rope, pos, THETA), dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_kernel_copies_what_it_cannot_step(cuda, dtype):
    """A last stride of 2, and four leading dimensions that do not merge:
    copied, then one launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(64, generator=g, device=cuda).to(dtype)
    wide = torch.randn(3, 5, 128, generator=g, device=cuda).to(dtype)
    big = torch.randn(2, 3, 4, 5, 80, generator=g, device=cuda).to(dtype)
    for x in (wide[..., ::2], big[..., :64].transpose(1, 3)):
        before = norm_rope.rms_norm_cuda.launches
        got = layers.rms_norm(x, w)
        assert norm_rope.rms_norm_cuda.launches == before + 1
        _close(got, layers.rms_norm_plain(x, w), dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_under_autograd(cuda, dtype):
    """Where autograd records, the kernels still run the forward (one
    launch each, outputs within the tolerances above) and the gradients
    are those of autograd through the plain code, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(3, 50, 1024, generator=g, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn(1024, generator=g, device=cuda)).to(dtype)
    q = torch.randn(3, 50, 8, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(3, 50, 2, 128, generator=g, device=cuda).to(dtype)
    pos = torch.arange(1000, 1050, device=cuda)[None]

    def run(norm, rope, ins):
        ins = [t.detach().clone().requires_grad_(True) for t in ins]
        outs = (norm(ins[0], ins[1]), *rope(ins[2], ins[3]))
        r = torch.Generator(device=cuda).manual_seed(7)
        loss = sum((o.float() * torch.randn(o.shape, generator=r,
                                            device=cuda)).sum()
                   for o in outs)
        return outs, torch.autograd.grad(loss, ins)

    n0, r0 = norm_rope.rms_norm_cuda.launches, norm_rope.rope_cuda.launches
    got, ggot = run(layers.rms_norm,
                    lambda q, k: layers.apply_rope_qk(q, k, pos, THETA),
                    (x, w, q, k))
    assert (norm_rope.rms_norm_cuda.launches,
            norm_rope.rope_cuda.launches) == (n0 + 1, r0 + 1)
    assert all(o.grad_fn is not None for o in got)
    want, gwant = run(layers.rms_norm_plain, lambda q, k: (
        layers.apply_rope_plain(q, pos, THETA),
        layers.apply_rope_plain(k, pos, THETA)), (x, w, q, k))
    for a, b in zip(got, want):
        _close(a.detach(), b.detach(), dtype)
    for a, b in zip(ggot, gwant):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
