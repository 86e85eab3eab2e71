"""The port's optimizer, schedules, compression, token pipeline,
checkpoints, training loop and kernel autograd against the reference's,
on the CPU.

- AdamW: two steps' params, m, v and grad_norm against ``adamw_update``
  (clipping on, decayed and undecayed leaves, a bf16 leaf) within 1e-6
  relative (fp32 elementwise arithmetic in other orders); the decay mask
  leaf by leaf on zamba2's and llama3.2-1b's smoke trees, exactly.
- The schedules and int8 compression (against the jitted reference, the
  form its step runs), exactly (bit for bit).
- ``cross_entropy`` and masked ``lm_loss`` within 1e-6 relative.
- ``ColocatedTokenDataset`` and ``GridSession.token_dataset`` batches
  equal to the reference's in the same process.
- Checkpoints: the reference suite's round trip, retention, async,
  shape-mismatch and tmp-directory cases, and checkpoints crossing
  between the packages in both directions, every leaf equal.
- The reference's ``TestTrainIntegration`` cases with the port's API.
- K2's and K3's ``autograd.Function``s with their forward hook pointed at
  the plain version (so their own backward runs here) against autograd of
  the plain version (1e-5 relative to the gradient's scale; bf16 inputs
  get bf16 gradients), a float64 ``gradcheck``, and raising when the
  kernel fails.
- Remat "dots" and "full" give "none"'s gradients (1e-6 relative to each
  leaf's scale) and recompute what they should.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.ckpt import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.grid import GridSession as RefGridSession  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import schedule as ref_sched  # noqa: E402
from repro.train import loss as ref_loss  # noqa: E402
from repro.utils import make_mesh  # noqa: E402
from repro_torch.ckpt.checkpoint import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    ColocatedTokenDataset,
    synthetic_token_table,
)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
)
from repro_torch.kernels.ssm_scan import ops as ss_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    _decay_mask,
    adamw_init,
    adamw_update,
    decay_names,
)
from repro_torch.optim.compression import (  # noqa: E402
    int8_compress,
    int8_decompress,
)
from repro_torch.optim.schedule import (  # noqa: E402
    cosine_schedule,
    linear_warmup_cosine,
)
from repro_torch.train.loss import cross_entropy, lm_loss  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainStepConfig,
    make_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_models import by_path  # noqa: E402
from test_torch_train_families import value_and_grad  # noqa: E402
from torch_port_util import port_model_config  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


# ----------------------------------------------------------------------
# AdamW, schedules, compression
# ----------------------------------------------------------------------

#: a tree with a decayed leaf ("w"), masked ones ("norm", list entries
#: under "runs", whose name holds "u") and a bf16 leaf
ADAM_SHAPES = {"w": (5, 3), "norm": (3,), "emb": (7, 2)}


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_two_steps_match_reference(clip):
    params = np_tree(0, ADAM_SHAPES)
    grads = [np_tree(s, ADAM_SHAPES) for s in (1, 2)]
    bf16 = np.random.default_rng(3).normal(size=(4,)).astype(np.float32)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip_norm=clip)

    def ref_tree(t, extra):
        out = {k: jnp.asarray(v) for k, v in t.items()}
        out["runs"] = [{"x": jnp.asarray(extra, jnp.bfloat16)}]
        return out

    def port_tree(t, extra):
        out = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
        out["runs"] = [{"x": torch.from_numpy(extra).to(torch.bfloat16)}]
        return out

    rcfg, cfg = ref_adamw.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    rp, p = ref_tree(params, bf16), port_tree(params, bf16)
    rs, s = ref_adamw.adamw_init(rp), adamw_init(p)
    for i, g in enumerate(grads):
        gb = bf16 * (i + 1)
        rp, rs, rn = ref_adamw.adamw_update(rcfg, rp, ref_tree(g, gb), rs,
                                            0.5)
        p, s, n = adamw_update(cfg, p, port_tree(g, gb), s, 0.5)
        np.testing.assert_allclose(float(n), float(rn), rtol=1e-6)
    assert int(s["step"]) == int(rs["step"]) == 2
    assert s["step"].dtype == torch.int32
    for got, want in ((p, rp), (s["m"], rs["m"]), (s["v"], rs["v"])):
        g, w = by_path(got), by_path(want)
        assert list(g) == list(w)
        for path in w:
            np.testing.assert_allclose(g[path], w[path], rtol=1e-6,
                                       atol=1e-9, err_msg=path)
    assert p["runs"][0]["x"].dtype == torch.bfloat16
    assert s["m"]["runs"][0]["x"].dtype == torch.float32


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3)}
    s = adamw_init(p)
    w, m = p["w"], s["m"]["w"]
    p2, s2, _ = adamw_update(AdamWConfig(), p, {"w": torch.ones(3)}, s)
    assert p2["w"] is w and s2["m"]["w"] is m
    assert float(w[0]) < 1.0


@pytest.mark.parametrize("arch,decayed", [
    ("zamba2_1p2b", {"/embed/table", "/lm_head/w", "/shared_block/attn/wq",
                     "/shared_block/attn/wk", "/shared_block/attn/wv",
                     "/shared_block/attn/wo", "/shared_block/mlp/gate",
                     "/shared_block/mlp/down"}),
    ("llama3p2_1b", {"/embed/table"}),
])
def test_decay_mask_leaf_by_leaf(arch, decayed):
    """The reference's mask, quirk included: "u" matches every leaf under
    runs/ and every mlp/up, so those skip weight decay too."""
    rcfg = ref_get_config(arch, reduced=True)
    rparams = jax.jit(ref_build(rcfg).init)(jax.random.key(0))
    want = jax.tree.leaves(ref_adamw._decay_mask(rparams,
                                                 ref_adamw.AdamWConfig()))
    params = build_model(get_config(arch, reduced=True)).init(device="meta")
    got = _decay_mask(params, AdamWConfig())
    assert got == want
    paths = list(by_path(jax.tree.map(np.asarray, rparams)))
    assert {p for p, d in zip(paths, got) if d} == decayed
    assert decay_names(params)[paths.index("/runs[0]/ln1/scale")] == \
        "runs/[0]/ln1/scale"


def test_schedules_match_reference_exactly():
    for s in (0, 1, 3, 10, 57, 100, 140):
        for got, want in (
                (cosine_schedule(s, 100), ref_sched.cosine_schedule(
                    jnp.asarray(s), 100)),
                (linear_warmup_cosine(torch.tensor(s), 10, 100),
                 ref_sched.linear_warmup_cosine(jnp.asarray(s), 10, 100)),
                (linear_warmup_cosine(s, 1, 4, 0.2),
                 ref_sched.linear_warmup_cosine(jnp.asarray(s), 1, 4, 0.2))):
            assert got.dtype == torch.float32
            assert np.float32(got) == np.asarray(want), s


def test_int8_compression_bit_for_bit():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(64, 64)).astype(np.float32),
            "b": [(rng.normal(size=(7,)) * 10).astype(np.float32)],
            "c": np.array([0.5, -1.5, 2.5, 127.0], np.float32)}
    q, s = int8_compress(tree_map(torch.from_numpy, tree))
    out = int8_decompress(q, s)
    # the reference compresses inside its jitted step: hold the port to
    # the compiled form
    rq, rs = jax.jit(ref_comp.int8_compress)(jax.tree.map(jnp.asarray, tree))
    rout = jax.jit(ref_comp.int8_decompress)(rq, rs)
    for got, want in ((q, rq), (s, rs), (out, rout)):
        g, w = jax.tree.leaves(jax.tree.map(np.asarray, got)), \
            jax.tree.leaves(jax.tree.map(np.asarray, want))
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert q["a"].dtype == torch.int8


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 5, 11)) * 4).astype(np.float32)
    tgt = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32)
    for m in (None, mask):
        want = ref_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                      None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "deepseek_v3_671b"])
def test_masked_lm_loss_matches_reference(arch):
    rcfg = ref_get_config(arch, reduced=True)
    cfg = port_model_config(rcfg)
    rmodel = ref_build(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.key(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    want, wm = jax.jit(lambda p, t, m: ref_loss.lm_loss(
        rcfg, rmodel, p, t, m))(rparams, tokens, mask)
    got, gm = lm_loss(cfg, build_model(cfg), params,
                      torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6,
                                   atol=1e-8, err_msg=k)


# ----------------------------------------------------------------------
# the token pipeline
# ----------------------------------------------------------------------

def test_token_table_and_batches_match_reference():
    rtable = ref_pipeline.synthetic_token_table(n_rows=64, seq_len=32,
                                                vocab=100, seed=3)
    table = synthetic_token_table(n_rows=64, seq_len=32, vocab=100, seed=3)
    np.testing.assert_array_equal(table.column("tok", "ids"),
                                  rtable.column("tok", "ids"))
    assert [r.rid for r in table.regions] == [r.rid for r in rtable.regions]
    mesh = make_mesh((jax.device_count(),), ("data",))
    rds = ref_pipeline.ColocatedTokenDataset(rtable, mesh, global_batch=8)
    ds = ColocatedTokenDataset(table, ["cpu"] * jax.device_count(),
                               global_batch=8)
    for step in (0, 1, 5):
        b = ds.next_batch(step)
        assert b.dtype == torch.int32 and b.device == CPU
        np.testing.assert_array_equal(b.numpy(),
                                      np.asarray(rds.next_batch(step)))
    assert not np.array_equal(ds.next_batch(0), ds.next_batch(1))


def test_session_token_dataset_matches_reference():
    rtable = ref_pipeline.synthetic_token_table(n_rows=48, seq_len=17,
                                                vocab=64, region_bytes=1024)
    table = synthetic_token_table(n_rows=48, seq_len=17, vocab=64,
                                  region_bytes=1024)
    kw = dict(payload_family="tok", payload_qualifier="ids")
    rds = RefGridSession(rtable, **kw).token_dataset(4, seed=0)
    ds = GridSession(table, devices=["cpu"], **kw).token_dataset(4, seed=0)
    for step in range(3):
        np.testing.assert_array_equal(ds.next_batch(step).numpy(),
                                      np.asarray(rds.next_batch(step)))


def test_each_owner_draws_from_its_own_regions():
    table = synthetic_token_table(n_rows=96, seq_len=9, vocab=50,
                                  region_bytes=512)
    s = GridSession(table, devices=["cpu"] * 4, payload_family="tok",
                    payload_qualifier="ids")
    ds = s.token_dataset(8)
    ids = table.column("tok", "ids")
    batch = ds.next_batch(2).numpy().reshape(4, 2, 9)
    for d in range(4):
        pool = ids[s.placement.rows_for_node(d)]
        for row in batch[d]:
            assert (pool == row).all(axis=1).any()
    with pytest.raises(ValueError):
        s.token_dataset(6)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep_last=2)
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(
        2, 3)}, "opt": {"m": torch.zeros((2, 3))}}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, metadata={"next_step": step}, async_=False)
    assert mgr.latest_step() == 4
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    template = {"params": {"w": torch.zeros(2, 3)},
                "opt": {"m": torch.zeros(2, 3)}}
    restored, meta = mgr.restore(template)
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert meta["next_step"] == 4


def test_checkpoint_async_save_snapshots_at_save(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    w = torch.ones(3)
    mgr.save(7, {"w": w}, async_=True)
    w.add_(5.0)          # an in-place update right after save
    mgr.wait()
    assert latest_step(d) == 7
    assert torch.equal(mgr.restore({"w": torch.zeros(3)})[0]["w"],
                       torch.ones(3))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    mgr.save(1, {"w": torch.ones(3)}, async_=False)
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones(4)})


def test_checkpoint_tmp_dirs_never_restored(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    mgr.save(1, {"w": torch.ones(3)}, async_=False)
    os.makedirs(os.path.join(d, "step_000000009.tmp"))
    assert latest_step(d) == 1


@pytest.fixture(scope="module")
def train_state():
    """zamba2's smoke train state in both packages: fp32 params, fp32
    moments, an int32 step; plus a bf16 leaf."""
    rcfg = ref_get_config("zamba2_1p2b", reduced=True)
    rparams = jax.jit(ref_build(rcfg).init)(jax.random.key(0))
    ropt = ref_adamw.adamw_init(rparams)
    ropt = {"m": jax.tree.map(lambda x: x + 0.5, ropt["m"]),
            "v": ropt["v"], "step": jnp.asarray(3, jnp.int32)}
    cfg = port_model_config(rcfg)
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                device="cpu")
    opt = adamw_init(params)
    opt["m"] = tree_map(lambda x: x + 0.5, opt["m"])
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    return {"params": rparams, "opt": ropt}, {"params": params, "opt": opt}


def test_checkpoints_cross_between_packages(tmp_path, train_state):
    rtree, tree = train_state
    ref_ckpt.save_checkpoint(str(tmp_path / "r"), 5, rtree, {"next_step": 5})
    got, meta = restore_checkpoint(str(tmp_path / "r"),
                                   tree_map(torch.zeros_like, tree))
    assert meta == {"next_step": 5}
    save_checkpoint(str(tmp_path / "p"), 5, tree, {"next_step": 5})
    rgot, rmeta = ref_ckpt.restore_checkpoint(
        str(tmp_path / "p"), jax.tree.map(jnp.zeros_like, rtree))
    assert rmeta == {"next_step": 5}
    want = by_path(jax.tree.map(np.asarray, rtree))
    for restored in (by_path(got), by_path(rgot)):
        assert list(restored) == list(want)
        for path in want:
            assert restored[path].shape == want[path].shape, path
            np.testing.assert_array_equal(restored[path], want[path], path)
    assert got["opt"]["step"].dtype == torch.int32
    for name in ("manifest.json",):
        assert os.path.exists(tmp_path / "p" / "step_000000005" / name)


def test_bf16_checkpoint_leaves(tmp_path):
    """bf16 leaves are written as the reference writes them (raw ``V2``
    bytes in the npz); the port restores the reference's and its own
    (the reference cannot cast ``V2`` back: a deviation of its own)."""
    x = np.random.default_rng(0).normal(size=(5,)).astype(np.float32)
    ref_ckpt.save_checkpoint(str(tmp_path / "r"), 1,
                             {"w": jnp.asarray(x, jnp.bfloat16)})
    t = torch.from_numpy(x).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "p"), 1, {"w": t})
    for d in ("r", "p"):
        got, _ = restore_checkpoint(
            str(tmp_path / d), {"w": torch.zeros(5, dtype=torch.bfloat16)})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], t), d
    ra = np.load(tmp_path / "r" / "step_000000001" / "arrays.npz")["w"]
    pa = np.load(tmp_path / "p" / "step_000000001" / "arrays.npz")["w"]
    assert ra.dtype == pa.dtype and ra.tobytes() == pa.tobytes()


# ----------------------------------------------------------------------
# the reference's TestTrainIntegration cases, with the port's API
# ----------------------------------------------------------------------

def test_loss_decreases_tiny_lm():
    cfg = ModelConfig(
        name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32)
    model = build_model(cfg)
    params, opt_state = make_train_state(
        cfg, model, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, model, AdamWConfig(lr=1e-3),
                           TrainStepConfig(num_microbatches=2))
    table = synthetic_token_table(n_rows=128, seq_len=33, vocab=128)
    ds = ColocatedTokenDataset(table, ["cpu"], global_batch=8)
    losses = []
    for i in range(30):
        params, opt_state, metrics = step(params, opt_state,
                                          ds.next_batch(i), i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]
    assert np.isfinite(losses).all()


def test_resume_from_checkpoint(tmp_path):
    cfg = ModelConfig(
        name="tiny", family="dense", n_layers=1, d_model=32, n_heads=2,
        n_kv_heads=1, d_ff=64, vocab=64, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params, opt_state = make_train_state(cfg, model, gen, device="cpu")
    init = {"params": params, "opt": opt_state}
    step = make_train_step(cfg, model, AdamWConfig(lr=1e-3))
    table = synthetic_token_table(n_rows=32, seq_len=17, vocab=64)
    ds = ColocatedTokenDataset(table, ["cpu"], global_batch=4)
    tc = TrainerConfig(total_steps=6, log_every=100, checkpoint_every=3,
                       checkpoint_dir=str(tmp_path / "ck"))
    fresh = lambda: [tree_map(torch.clone, init[k])  # noqa: E731
                     for k in ("params", "opt")]
    p1, o1, _ = Trainer(step, ds, tc).run(*fresh())
    # resume: a fresh trainer must pick up at step 6 (no-op run)
    p2, o2, hist = Trainer(step, ds, tc).run(*fresh())
    assert hist == []
    assert int(o2["step"]) == 6
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))):
        assert torch.equal(a, b)
    assert not torch.equal(p1["embed"]["table"], params["embed"]["table"])


def test_launcher_needs_cuda_unless_asked_for_cpu(capsys):
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "zamba2_1p2b", "--reduced"])
    for arch in ("whisper_large_v3", "qwen2_vl_7b"):
        with pytest.raises(SystemExit):
            train.main(["--arch", arch, "--reduced", "--device", "cpu"])
    hist = train.main(["--arch", "llama3p2_1b", "--reduced", "--device",
                       "cpu", "--steps", "3", "--seq", "16",
                       "--microbatches", "2"])
    assert [h["step"] for h in hist] == [0]
    assert "done: loss" in capsys.readouterr().out


# ----------------------------------------------------------------------
# the kernels' autograd Functions
# ----------------------------------------------------------------------

def plain_ssd(x, a, Bm, Cm, chunk, init_state=None):
    return ssd_chunked_ref(x, a, Bm, Cm, min(chunk, x.shape[1]), init_state)


@pytest.fixture
def plain_forward(monkeypatch):
    """Both Functions' forward hook at the plain versions (the Function
    runs its forward without autograd)."""
    monkeypatch.setattr(fa_ops, "FORWARD", attention_ref)
    monkeypatch.setattr(ss_ops, "FORWARD", plain_ssd)


def attn_inputs(seed, B, H, Hkv, Sq, Skv, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      (B, H, Sq, D))]


def scale_close(got, want, what):
    got, want = got.double(), want.double()
    gap = float((got - want).abs().max())
    assert gap <= 1e-5 * float(want.abs().max()) + 1e-7, (what, gap)


@pytest.mark.parametrize("shape,causal,window,dtype", [
    ((2, 4, 2, 9, 9, 16), True, 0, torch.float32),     # GQA, causal
    ((3, 4, 4, 12, 12, 8), True, 5, torch.float32),    # sliding window
    ((2, 4, 4, 6, 15, 16), False, 0, torch.float32),   # cross-attention
    ((2, 4, 2, 9, 9, 16), True, 0, torch.bfloat16),
])
def test_flash_function_matches_plain_autograd(plain_forward, shape, causal,
                                               window, dtype):
    q, k, v, do = attn_inputs(0, *shape, dtype)
    scale = shape[-1] ** -0.5
    grads = []
    for fn in (fa_ops.FlashAttention.apply, attention_ref):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins, scale, causal, window)
        o.backward(do)
        grads.append((o.detach(), [t.grad for t in ins]))
    (o1, g1), (o2, g2) = grads
    assert torch.equal(o1, o2)
    for a, b, name in zip(g1, g2, "qkv"):
        assert a.dtype == dtype, name
        scale_close(a, b, f"d{name}")


@pytest.mark.parametrize("L,chunk,with_state,bc_dtype", [
    (24, 8, False, torch.float32),
    (21, 8, True, torch.float32),      # ragged tail, from a state
    (16, 16, True, torch.bfloat16),
])
def test_ssd_function_matches_plain_autograd(plain_forward, L, chunk,
                                             with_state, bc_dtype):
    rng = np.random.default_rng(L)
    B, H, P, N = 2, 3, 4, 5
    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    x, Bm, Cm = f(B, L, H, P), f(B, L, N).to(bc_dtype), f(B, L, N).to(
        bc_dtype)
    a = torch.from_numpy(rng.uniform(0.6, 0.99, (B, L, H)).astype(np.float32))
    s0 = f(B, H, P, N) if with_state else None
    dy, dfin = f(B, L, H, P), f(B, H, P, N)
    grads = []
    for fn in (ss_ops.SSDScan.apply, plain_ssd):
        ins = [t.clone().requires_grad_() for t in (x, a, Bm, Cm)]
        st = None if s0 is None else s0.clone().requires_grad_()
        y, fin = fn(*ins, chunk, st)
        torch.autograd.backward([y, fin], [dy, dfin])
        grads.append([t.grad for t in ins] + ([] if st is None
                                               else [st.grad]))
    for a_, b_, name in zip(*grads, ("x", "a", "B", "C", "state")):
        assert a_.dtype == b_.dtype
        scale_close(a_, b_, f"d{name}")
    assert grads[0][2].dtype == bc_dtype


def test_ssd_function_final_state_alone_has_no_grad_for_c(plain_forward):
    x = torch.randn(1, 8, 2, 3, requires_grad=True)
    a = torch.full((1, 8, 2), 0.9, requires_grad=True)
    Bm = torch.randn(1, 8, 4, requires_grad=True)
    Cm = torch.randn(1, 8, 4, requires_grad=True)
    _, fin = ss_ops.SSDScan.apply(x, a, Bm, Cm, 4, None)
    fin.sum().backward()
    assert torch.equal(Cm.grad, torch.zeros_like(Cm))
    assert float(x.grad.abs().sum()) > 0


def test_functions_pass_float64_gradcheck(plain_forward):
    g = torch.Generator().manual_seed(0)
    d = dict(dtype=torch.float64, generator=g)
    q, k, v = (torch.randn(2, 2, 5, 4, **d) for _ in range(3))
    k, v = k[:, :1], v[:, :1]                            # GQA
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa_ops.FlashAttention.apply(q, k, v, 0.5, True, 3),
        ins)
    x = torch.randn(1, 7, 2, 3, **d)
    a = torch.rand(1, 7, 2, **d) * 0.5 + 0.4
    Bm, Cm = torch.randn(1, 7, 4, **d), torch.randn(1, 7, 4, **d)
    s0 = torch.randn(1, 2, 3, 4, **d)
    ins = [t.clone().requires_grad_() for t in (x, a, Bm, Cm, s0)]
    assert torch.autograd.gradcheck(
        lambda x, a, Bm, Cm, s0: ss_ops.SSDScan.apply(x, a, Bm, Cm, 3, s0),
        ins)


def test_functions_raise_when_the_kernel_fails():
    """With the hooks at the CUDA kernels, CPU tensors reach the kernel's
    own checks and raise: nothing falls back to the plain forward."""
    q = torch.randn(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.FlashAttention.apply(q, q, q, 0.25, True, 0)
    x, a = torch.randn(1, 4, 2, 8), torch.rand(1, 4, 2)
    Bm = torch.randn(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ss_ops.SSDScan.apply(x, a, Bm, Bm, 4, None)


def test_model_gradients_through_the_functions(plain_forward, monkeypatch):
    """zamba2's smoke config with attention_full and ssm_full routed
    through the Functions (as CUDA tensors are): the loss and every
    gradient equal autograd of the plain versions, and q/k/v and in_proj
    get nonzero gradients."""
    rcfg = ref_get_config("zamba2_1p2b", reduced=True)
    cfg = port_model_config(rcfg)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    loss_fn = lambda p, t: lm_loss(cfg, model, p, t)  # noqa: E731
    want_loss, _, want = value_and_grad(loss_fn, params, tokens)
    monkeypatch.setattr(
        attention_mod, "flash_attention",
        lambda q, k, v, scale, causal=True, window=0:
        fa_ops.FlashAttention.apply(q, k, v, scale, causal, window))
    monkeypatch.setattr(
        ssm_mod, "ssd_scan",
        lambda x, a, Bm, Cm, chunk=128, init_state=None:
        ss_ops.SSDScan.apply(x, a, Bm, Cm, chunk, init_state))
    got_loss, _, got = value_and_grad(loss_fn, params, tokens)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-6)
    g, w = by_path(got), by_path(want)
    for path in w:
        scale_close(torch.from_numpy(g[path]), torch.from_numpy(w[path]),
                    path)
    for path in ("/shared_block/attn/wq", "/shared_block/attn/wk",
                 "/shared_block/attn/wv", "/runs[0]/ssm/in_proj"):
        assert np.abs(g[path]).max() > 0, path


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------

class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "mixtral_8x7b",
                                  "deepseek_v3_671b", "rwkv6_3b"])
def test_remat_policies_give_the_same_gradients(arch):
    import dataclasses
    base = get_config(arch, reduced=True)
    params = build_model(base).init(torch.Generator().manual_seed(1),
                                    device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab, (2, 13)).astype(np.int32))
    out = {}
    for policy in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        model = build_model(cfg)
        with OpCounter() as ops:
            loss, _, grads = value_and_grad(
                lambda p, t: lm_loss(cfg, model, p, t), params, tokens)
        out[policy] = (float(loss), by_path(grads), ops.counts)
    loss0, g0, c0 = out["none"]
    for policy in ("dots", "full"):
        loss, g, _ = out[policy]
        assert loss == loss0
        for path in g0:
            scale = float(np.abs(g0[path]).max())
            assert float(np.abs(g[path] - g0[path]).max()) <= \
                1e-6 * scale + 1e-9, (policy, path)
    # "dots" keeps every aten.mm output and recomputes the rest; "full"
    # recomputes the products as well
    cd, cf = out["dots"][2], out["full"][2]
    assert cd["mm"] == c0["mm"] < cf["mm"]
    assert cd["mul"] > c0["mul"]
