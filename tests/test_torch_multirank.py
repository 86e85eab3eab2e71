"""The sharded step on four CPU ranks (gloo) against one process.

Each test spawns four ranks (``torch_port_util.run_ranks``: a
``FileStore`` under ``tmp_path``, one intra-op thread a rank, a limit on
joining the group and, from the rendezvous on, one on the run) and holds
them to a single-process run of the same code or to the reference:

- a smoke config's ``CellBuilder`` train step on a ``(data 2, model 2)``
  mesh against ``make_train_step``: loss within 1e-6 relative, every
  gradient within 1e-5 of its leaf's largest magnitude (zamba2: 5e-5,
  its fp32 noise floor; see ``GRAD_BOUND``);
- ``make_compressed_train_step`` on ``(pod 2, data 2, model 1)`` against
  the plain step, with the reference test's bounds (loss 5e-2,
  parameters 5e-3 at lr 1e-3), and against the reference's compressed
  step (an 8-device JAX subprocess): every gradient, read from m, within
  one int8 quantum, v from the same gradient, the update leaf by leaf;
- the MoE's shard-local dispatch against the reference's ``moe_apply``
  on each data shard's tokens (capacity per shard, aux averaged);
- a checkpoint restored into DTensor templates.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_util import run_ranks

#: seconds a run of four ranks may take once all have joined the group
#: (``run_ranks`` gives the start-up its own limit).  zamba2's case, the
#: slowest, took 28.8 s of a 50 s limit counted from the spawn in one run
#: of the whole suite on 8 cores, and outlasted it in another
TIMEOUT = 180.0


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ----------------------------------------------------------------------
# the CellBuilder train step
# ----------------------------------------------------------------------

def _train_body(rank, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import CellBuilder
    from repro_torch.models.sharding import use_policy
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import (
        TrainStepConfig,
        _accumulated_grads,
        make_train_step,
    )
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config(arch, reduced=True)
    mesh = _mesh((2, 2), ("data", "model"))
    builder = CellBuilder(cfg, mesh, "train")
    model = builder.model
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (8, 17), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    fn, _, pls, _ = builder.build({"tokens": tokens})

    def loss_fn(p, t):
        return lm_loss(cfg, model, p, t)

    # gradients: one process, then the policy's layout on four ranks
    g1, m1 = _accumulated_grads(loss_fn, params, tokens, 2)
    dp = builder.place_params(tree_map(torch.clone, params))
    dtok = builder.place(tokens, pls[2])
    with use_policy(builder.policy):
        g4, m4 = _accumulated_grads(loss_fn, dp, dtok, 2)
    gaps = [float((b.full_tensor() - a).abs().max()
                  / max(float(a.abs().max()), 1e-30))
            for a, b in zip(tree_leaves(g1), tree_leaves(g4))]
    # the whole step: CellBuilder's against make_train_step's
    step_cfg = TrainStepConfig(num_microbatches=cfg.train_microbatches)
    p1 = tree_map(torch.clone, params)       # the step updates in place
    _, _, s1 = make_train_step(cfg, model, AdamWConfig(), step_cfg)(
        p1, adamw_init(p1), tokens, 0)
    dp = builder.place_params(tree_map(torch.clone, params))
    _, _, s4 = fn(dp, adamw_init(dp), dtok, 0)
    placements = sorted({str(tuple(x.placements))
                         for x in tree_leaves(dp)})
    return {"loss": (float(m1["loss"]), float(m4["loss"])),
            "step_loss": (float(s1["loss"]), float(s4["loss"])),
            "worst_grad": max(gaps), "placements": placements}


#: the gradient bound, relative to each leaf's largest magnitude.  zamba2's
#: is wider: its fp32 gradients sit 1.1e-5 to 2.1e-5 from a float64 run
#: of the same step in one process (embed, in_proj, out_proj, the SSM
#: norm), so two fp32 runs that sum in other orders differ by as much
#: (1.7e-5 measured); the others' floor is below 1e-5.
GRAD_BOUND = {"llama3p2_1b": 1e-5, "zamba2_1p2b": 5e-5, "mixtral_8x7b": 1e-5,
              "rwkv6_3b": 1e-5}


@pytest.mark.parametrize("arch", list(GRAD_BOUND))
def test_cell_builder_train_step_matches_one_process(arch, tmp_path):
    out = run_ranks(_train_body, 4, tmp_path, TIMEOUT, arch)
    for rank, r in out.items():
        for one, four in (r["loss"], r["step_loss"]):
            assert abs(four - one) <= 1e-6 * abs(one), (rank, one, four)
        assert r["worst_grad"] <= GRAD_BOUND[arch], (rank, r["worst_grad"])
    # the layout really splits over both axes
    joined = " ".join(out[0]["placements"])
    assert "Shard" in joined and joined.count("Shard") >= 2


# ----------------------------------------------------------------------
# the int8 pod-compressed step
# ----------------------------------------------------------------------

def _tiny_cfg():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                       remat_policy="none", dtype=torch.float32,
                       param_dtype=torch.float32)


#: the reference's compressed step on its 8-device test mesh (2 pod x 2
#: data x 2 model; the step is manual over ``pod`` only, so the inner
#: split changes no number), from ``key(0)``'s parameters and seed 1's
#: tokens; also each leaf's int8 quantum, the larger of the two pods'
#: scales, from the reference's own per-pod gradients
_JAX_COMPRESSED = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.models.config import ModelConfig
from repro.models.model import build_model
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.optim.compression import int8_compress
from repro.train.loss import lm_loss
from repro.train.step import _accumulated_grads, make_compressed_train_step
from repro.utils import make_mesh

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab=64,
                  remat_policy="none", dtype=jnp.float32,
                  param_dtype=jnp.float32)
model = build_model(cfg)
params = model.init(jax.random.key(0))
tokens = np.random.default_rng(1).integers(0, 64, (8, 17)).astype(np.int32)
loss_fn = lambda p, t: lm_loss(cfg, model, p, t)
scales = [int8_compress(_accumulated_grads(loss_fn, params,
                                           jnp.asarray(t), 1)[0])[1]
          for t in (tokens[:4], tokens[4:])]
quantum = jax.tree.map(jnp.maximum, *scales)
comp = jax.jit(make_compressed_train_step(cfg, model, AdamWConfig(lr=1e-3),
                                          mesh))
with mesh:
    p, o, m = comp(params, adamw_init(params), jnp.asarray(tokens),
                   jnp.zeros((), jnp.int32))
out = jax.tree.map(np.asarray, {
    "params": params, "p": p, "m": o["m"], "v": o["v"],
    "loss": m["loss"], "grad_norm": m["grad_norm"], "quantum": quantum})
out["tokens"] = tokens
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _reference_compressed_step(tmp_path):
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    path = tmp_path / "ref_compressed.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _JAX_COMPRESSED, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _by_path(tree, prefix=""):
    """``{path: float32 numpy leaf}`` of a tree of tensors, DTensors or
    arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, f"{prefix}[{i}]"))
        return out
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().to(torch.float32).numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _compressed_body(rank, ref_params, tokens):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.models.params import distribute_tree, sharding_rules
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import (
        make_compressed_train_step,
        make_train_step,
    )
    from repro_torch.utils import tree_map

    cfg = _tiny_cfg()
    model = build_model(cfg)
    params = lm_params_from_jax(cfg, ref_params, device="cpu")
    tokens = torch.from_numpy(tokens)
    plain = make_train_step(cfg, model, AdamWConfig(lr=1e-3))
    p1, _, m1 = plain(tree_map(torch.clone, params),
                      adamw_init(params), tokens, 0)

    mesh = _mesh((2, 2, 1), ("pod", "data", "model"))
    dp = distribute_tree(tree_map(torch.clone, params),
                         model.logical_axes(), sharding_rules(), mesh)
    comp = make_compressed_train_step(cfg, model, AdamWConfig(lr=1e-3), mesh)
    p2, o2, m2 = comp(dp, adamw_init(dp), tokens, 0)
    return {"l1": float(m1["loss"]), "l2": float(m2["loss"]),
            "grad_norm": float(m2["grad_norm"]), "step": int(o2["step"]),
            "p0": _by_path(params), "plain_p": _by_path(p1),
            "p": _by_path(p2), "m": _by_path(o2["m"]),
            "v": _by_path(o2["v"])}


#: fp32 noise of a gradient, relative to its leaf's largest magnitude,
#: and absolute (``tests/test_torch_train_families.py``'s bounds)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
#: the share of a leaf whose int8 rounding may differ from the reference's
FLIPPED_SHARE = 0.01


def test_compressed_step_matches_plain_step(tmp_path):
    """``make_compressed_train_step`` on a (pod 2, data 2, model 1) mesh,
    held to the plain step with the reference test's bounds and, leaf by
    leaf, to the reference's compressed step on the same parameters and
    tokens.  A first AdamW step moves every element by about ±lr whatever
    its gradient's size, so the parameters alone cannot show a gradient of
    the wrong scale: the gradients are read from m = (1 - b1)·clip·g.
    Each pod rounds its own gradient to int8, so the port's synced
    gradient may differ from the reference's by one quantum (the larger
    pod scale, over 2 pods summed and halved) where a value lies within
    fp32 noise of a rounding edge, and only there."""
    from repro_torch.optim.adamw import AdamWConfig

    ref = _reference_compressed_step(tmp_path)
    out = run_ranks(_compressed_body, 4, tmp_path, TIMEOUT,
                    ref["params"], ref["tokens"])
    opt = AdamWConfig(lr=1e-3)

    def grads(m, gnorm):
        clip = min(1.0, opt.grad_clip_norm / (gnorm + 1e-9))
        return {k: v / ((1 - opt.b1) * clip) for k, v in m.items()}

    want_g = grads(_by_path(ref["m"]), float(ref["grad_norm"]))
    quantum = _by_path(ref["quantum"])
    want_p = _by_path(ref["p"])
    for rank, r in out.items():
        # the reference test's bounds against the plain step
        assert abs(r["l1"] - r["l2"]) < 5e-2, (rank, r["l1"], r["l2"])
        worst = max(float(np.abs(r["p"][k] - r["plain_p"][k]).max())
                    for k in r["p"])
        assert worst < 5e-3 and r["step"] == 1, (rank, worst)
        # the reference's compressed step: loss, grad norm, gradients
        assert abs(r["l2"] - float(ref["loss"])) <= 1e-5 * abs(r["l2"])
        assert abs(r["grad_norm"] - float(ref["grad_norm"])) <= \
            1e-3 * float(ref["grad_norm"]), (rank, r["grad_norm"])
        got_g = grads(r["m"], r["grad_norm"])
        assert list(got_g) == list(want_g)
        undecided = {}
        for k, w in want_g.items():
            tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
            gap = np.abs(got_g[k] - w)
            assert (gap <= float(quantum[k]) * (1 + GRAD_RTOL) + tol).all(), (
                rank, k, float(gap.max()), float(quantum[k]))
            flipped = int((gap > tol).sum())
            assert flipped <= max(1, FLIPPED_SHARE * gap.size), (
                rank, k, flipped, gap.size)
            undecided[k] = np.abs(w) <= float(quantum[k]) + tol
            # v from the same gradient as m: (1 - b2)·(clip·g)^2
            np.testing.assert_allclose(
                r["v"][k], (1 - opt.b2) * (r["m"][k] / (1 - opt.b1)) ** 2,
                rtol=1e-5, atol=1e-30, err_msg=k)
        # the update: where the gradient's sign is settled, the same
        # parameter as the reference's; elsewhere within 2·lr
        for k, w in want_p.items():
            gap = np.abs(r["p"][k] - w)
            band = undecided[k]
            assert (gap <= np.where(band, 2 * opt.lr + PARAM_ATOL,
                                    PARAM_ATOL)).all(), (
                rank, k, float(gap.max()))
        moved = max(float(np.abs(r["p"][k] - r["p0"][k]).max())
                    for k in r["p"])
        assert moved > 1e-4, (rank, moved)
    assert len({round(r["l2"], 7) for r in out.values()}) == 1


# ----------------------------------------------------------------------
# the MoE's shard-local dispatch
# ----------------------------------------------------------------------

def _moe_cfg():
    from repro_torch.configs import get_config
    cfg = get_config("mixtral_8x7b", reduced=True)
    # little capacity, so that per-shard capacity drops slots
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_groups=-1, capacity_factor=0.5))


def _moe_body(rank, weights, x):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import distribute_tree, sharding_rules
    from repro_torch.models.sharding import ShardingPolicy, use_policy

    cfg = _moe_cfg()
    mesh = _mesh((2, 2), ("data", "model"))
    p = {k: torch.from_numpy(v) for k, v in weights.items()}
    dp = distribute_tree(p, moe_mod.moe_axes(cfg), sharding_rules(), mesh)
    dx = distribute_tensor(torch.from_numpy(x), mesh, [Shard(0), Replicate()],
                           src_data_rank=None)
    with use_policy(ShardingPolicy(mesh, sharding_rules())):
        y, aux = moe_mod.moe_apply(cfg, dp, dx, torch.float32)
    return {"y": y.full_tensor().numpy(), "aux": float(aux.full_tensor()),
            "experts": str(tuple(dp["gate"].placements))}


def test_moe_shard_local_dispatch_matches_reference_per_shard(tmp_path):
    import jax.numpy as jnp

    from repro.models import moe as ref_moe
    from torch_port_util import port_model_config  # noqa: F401

    cfg = _moe_cfg()
    rng = np.random.default_rng(0)
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    weights = {"router": rng.standard_normal((D, E), np.float32),
               "gate": rng.standard_normal((E, D, F), np.float32) * 0.1,
               "up": rng.standard_normal((E, D, F), np.float32) * 0.1,
               "down": rng.standard_normal((E, F, D), np.float32) * 0.1}
    x = rng.standard_normal((4, 16, D), np.float32)
    out = run_ranks(_moe_body, 4, tmp_path, TIMEOUT, weights, x)

    # the reference's semantics: one group per data shard, aux averaged
    from repro.configs import mixtral_8x7b as ref_mixtral
    rcfg = ref_mixtral.smoke()
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, n_groups=1, capacity_factor=0.5))
    rp = {k: jnp.asarray(v) for k, v in weights.items()}
    ys, auxes = [], []
    for shard in (x[:2], x[2:]):
        y, aux = ref_moe.moe_apply(rcfg, rp, jnp.asarray(shard), jnp.float32)
        ys.append(np.asarray(y))
        auxes.append(float(aux))
    whole, _ = ref_moe.moe_apply(rcfg, rp, jnp.asarray(x), jnp.float32)
    want = np.concatenate(ys)
    assert not np.allclose(np.asarray(whole), want, atol=1e-3), \
        "capacity is not binding: per-shard and global groups agree"
    for r in out.values():
        np.testing.assert_allclose(r["y"], want, rtol=1e-5, atol=1e-5)
        assert abs(r["aux"] - np.mean(auxes)) <= 1e-6 * abs(np.mean(auxes))
        assert "Shard(dim=0)" in r["experts"]     # experts split over model


# ----------------------------------------------------------------------
# checkpoints into DTensor templates
# ----------------------------------------------------------------------

def _ckpt_body(rank, directory):
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import distribute_tree, sharding_rules
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config("qwen3_8b", reduced=True)
    model = build_model(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    dp = distribute_tree(params, model.logical_axes(), sharding_rules(), mesh)
    save_checkpoint(directory, 7, {"params": dp}, metadata={"k": 1})
    dist.barrier()
    template = {"params": tree_map(torch.zeros_like, dp)}
    back, meta = restore_checkpoint(directory, template)
    same_layout = all(
        tuple(a.placements) == tuple(b.placements)
        and a.device_mesh == b.device_mesh
        for a, b in zip(tree_leaves(template), tree_leaves(back)))
    equal = all(torch.equal(a, b.full_tensor())
                for a, b in zip(tree_leaves(params), tree_leaves(back)))
    split = sum(any(p.is_shard() for p in x.placements)
                for x in tree_leaves(back))
    return {"same_layout": same_layout, "equal": equal, "split": split,
            "meta": meta}


def test_checkpoint_restores_into_dtensor_templates(tmp_path):
    out = run_ranks(_ckpt_body, 4, tmp_path, TIMEOUT, str(tmp_path / "ck"))
    for rank, r in out.items():
        assert r["same_layout"] and r["equal"], (rank, r)
        assert r["split"] > 0 and r["meta"] == {"k": 1}
