"""The port's sharding layer against the reference's.

- ``resolve_spec`` on the reference's own cases;
- every parameter and cache leaf of the ten full configs, on both
  production meshes, resolved to the reference's ``PartitionSpec``
  (port shapes from the ``meta`` device, the reference's from
  ``jax.eval_shape``): 0 mismatches;
- DTensor local shard offsets equal ``NamedSharding.devices_indices_map``
  on the same spec (an 8-device JAX mesh in a subprocess);
- ``constrain`` and ``compute_view`` are the identity outside a policy;
- ``_sdpa_chunked`` and the ``attention_impl="chunked"`` attention against
  the reference's at ragged lengths, GQA and a sliding window.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import model as ref_model_lib
from repro.models import params as ref_params
from repro.models.config import ModelConfig as RefConfig

from repro_torch.configs import get_config
from repro_torch.launch import steps as port_steps
from repro_torch.models import attention as port_attn
from repro_torch.models import params as port_params
from repro_torch.models.model import build_model
from repro_torch.models.sharding import compute_view, constrain
from torch_port_util import port_model_config

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# resolve_spec: the reference's TestResolveSpec cases
# ----------------------------------------------------------------------

class TestResolveSpec:
    MESH = {"pod": 2, "data": 16, "model": 16}

    def test_divisible_dims_shard(self):
        spec = port_params.resolve_spec((16384, 53248), ("embed", "mlp"),
                                        port_params.sharding_rules(),
                                        self.MESH)
        assert spec == tuple(P("data", "model"))

    def test_non_divisible_dim_replicates(self):
        spec = port_params.resolve_spec((8, 128), ("kv_heads", None),
                                        port_params.sharding_rules(),
                                        self.MESH)
        assert spec == tuple(P())

    def test_batch_one_replicates(self):
        rules = port_params.sharding_rules()
        assert port_params.resolve_spec((1,), ("batch",), rules,
                                        self.MESH) == tuple(P())
        spec = port_params.resolve_spec((128,), ("batch",), rules, self.MESH)
        assert spec == tuple(P(("pod", "data")))

    def test_axis_never_reused(self):
        rules = {"a": ("model",), "b": ("model",)}
        spec = port_params.resolve_spec((16, 16), ("a", "b"), rules,
                                        self.MESH)
        assert spec == tuple(P("model"))

    def test_size_one_axis_skipped(self):
        spec = port_params.resolve_spec((64,), ("batch",),
                                        port_params.sharding_rules(),
                                        {"pod": 1, "data": 8, "model": 2})
        assert spec == tuple(P("data"))

    def test_rules_match_reference(self):
        for fsdp in (True, False):
            assert port_params.sharding_rules(fsdp) == \
                ref_params.sharding_rules(fsdp)
        for kind in ("train", "prefill", "decode"):
            assert port_steps.rules_for(kind) == ref_steps.rules_for(kind)

    def test_tree_structure_mismatch_raises(self):
        tree = {"a": torch.empty(2, 3), "b": torch.empty(4)}
        with pytest.raises(ValueError):
            port_params.resolve_tree(tree, {"a": (None, None)},
                                     port_params.sharding_rules(),
                                     MESHES["single"])


# ----------------------------------------------------------------------
# spec parity over the ten full configs
# ----------------------------------------------------------------------

def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in leaves}


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], (dict, list))):
        out = {}
        for i, t in enumerate(tree):
            out.update(_port_flat(t, path + (i,)))
        return out
    return {path: tree}


def _ref_cache_axes(cfg, model):
    if cfg.is_encdec:
        kv = ("layers", "batch", None, "kv_heads", None)
        return (ref_model_lib._attn_cache_axes(cfg, stacked=True),
                {"k": kv, "v": kv})
    return model.cache_axes()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_parity_full_configs(arch, mesh_name):
    shape = MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=shape)
    rcfg = ref_get_config(arch)
    rmodel = ref_model_lib.build_model(rcfg)
    cfg = get_config(arch)
    model = build_model(cfg)
    rshapes = jax.eval_shape(rmodel.init, jax.random.key(0))
    pshapes = model.init(device="meta")
    B, T = 128, 32768
    rcache = jax.eval_shape(lambda: rmodel.init_cache(B, T))
    pcache = model.init_cache(B, T, device="meta")

    mismatches = []
    n = 0
    for kind in ("train", "decode"):
        rules = ref_steps.rules_for(kind)
        want = _ref_flat(ref_params.resolve_tree(
            rshapes, rmodel.logical_axes(), rules, mesh))
        got = _port_flat(port_params.resolve_tree(
            pshapes, model.logical_axes(), port_steps.rules_for(kind), shape))
        assert set(want) == set(got), (kind, set(want) ^ set(got))
        mismatches += [(kind, k, want[k], got[k]) for k in want
                       if want[k] != got[k]]
        n += len(want)
    rules = ref_steps.rules_for("decode")
    want = _ref_flat(ref_steps.tree_specs(
        rcache, _ref_cache_axes(rcfg, rmodel), rules, mesh))
    got = _port_flat(port_steps.tree_specs(
        pcache, model.cache_axes(), port_steps.rules_for("decode"), shape))
    assert set(want) == set(got), set(want) ^ set(got)
    mismatches += [("cache", k, want[k], got[k]) for k in want
                   if want[k] != got[k]]
    n += len(want)
    assert n > 0 and mismatches == [], mismatches[:5]


def test_cell_builder_specs_match_reference_input_specs():
    """The port's ``CellBuilder`` resolves its parameter specs exactly as
    ``tree_specs`` does, and the batch spec names the batch axes."""
    from repro_torch.launch.shapes import input_specs

    fake = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert port_steps.batch_spec(fake) == tuple(ref_steps.batch_spec(
        types.SimpleNamespace(shape=MESHES["multi"])))
    specs = input_specs(get_config("llama3p2_1b"), "decode_32k")
    assert tuple(specs["token"].shape) == (128,)
    assert specs["token"].device.type == "meta"


# ----------------------------------------------------------------------
# local shard offsets against NamedSharding.devices_indices_map
# ----------------------------------------------------------------------

OFFSET_CASES = [
    ((8, 4), (("pod", "data"),)),
    ((4, 8), ("data", "model")),
    ((2, 8, 4), (None, ("pod", "data"), "model")),
    ((16,), ("model",)),
    ((4, 6), ("pod",)),
]

_JAX_INDICES = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
devs = np.array(jax.devices()[:8]).reshape(2, 2, 2)
mesh = Mesh(devs, ("pod", "data", "model"))
out = []
for shape, spec in cases:
    spec = P(*[tuple(s) if isinstance(s, list) else s for s in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    rows = {}
    for coord in np.ndindex(2, 2, 2):
        d = devs[coord]
        rows[str(list(coord))] = [[s.start or 0, s.stop if s.stop is not None
                                   else shape[i]]
                                  for i, s in enumerate(idx[d])]
    out.append(rows)
print(json.dumps(out))
"""


def test_local_shard_offsets_match_devices_indices_map():
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_INDICES, json.dumps(OFFSET_CASES)],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    for (shape, spec), rows in zip(OFFSET_CASES, want):
        pl = port_params.placements(spec, mesh)
        for coord in np.ndindex(2, 2, 2):
            local, off = _compute_local_shape_and_global_offset(
                shape, (2, 2, 2), list(coord), pl)
            got = [[o, o + n] for o, n in zip(off, local)]
            assert got == rows[str(list(coord))], (shape, spec, coord)


# ----------------------------------------------------------------------
# the identity outside a policy
# ----------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recompute_sees_the_policy(remat):
    """The remat recompute runs on autograd's device thread (here: the
    backward is started on another thread), where the policy's context
    variable is unset; ``_remat`` carries the policy into it."""
    import dataclasses
    import threading

    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import current_policy, use_policy
    from repro_torch.models.transformer import _remat

    cfg = dataclasses.replace(get_config("llama3p2_1b", reduced=True),
                              remat_policy=remat)
    seen = []

    def block(x):
        seen.append(current_policy())
        return torch.sin(x @ x.T)

    x = torch.randn(4, 4, requires_grad=True)
    policy = object()
    with use_policy(policy):
        y = _remat(cfg, block)(x)
        t = threading.Thread(target=lambda: y.sum().backward())
        t.start()
        t.join()
        # the recompute's policy leaves the step's implicit replication on
        assert DTensor._op_dispatcher._allow_implicit_replication
    assert not DTensor._op_dispatcher._allow_implicit_replication
    assert x.grad is not None and seen == [policy, policy]


def test_constrain_and_compute_view_identity_without_policy():
    x = torch.randn(4, 8, 16)
    assert constrain(x, ("batch", "seq", "embed_act")) is x
    p = {"w": torch.randn(16, 32), "n": {"scale": torch.ones(16)}}
    out = compute_view(p, {"w": ("embed", "mlp"),
                           "n": {"scale": ("embed",)}})
    assert out is p


# ----------------------------------------------------------------------
# the blockwise online softmax
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,S,block", [
    (True, None, 37, 8),        # ragged: 37 keys in blocks of 8
    (True, 5, 37, 8),           # sliding window
    (False, None, 29, 16),      # not causal (the encoder)
    (True, None, 16, 1024),     # one block
])
def test_sdpa_chunked_matches_reference(causal, window, S, block):
    rng = np.random.default_rng(S + block)
    B, H, Hkv, D = 2, 4, 2, 16            # GQA: two queries per KV head
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    want = np.asarray(ref_attn._sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5, causal,
        window, block))
    got = port_attn._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), D ** -0.5, causal,
                                  window, block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_impl_matches_reference():
    """``attention_full`` and ``mla_full`` with ``attention_impl="chunked"``
    on the CPU against the reference's, on the same weights."""
    from repro.configs import deepseek_v3_671b as ref_ds

    for rcfg in (RefConfig(name="t", family="dense", n_layers=1, d_model=64,
                           n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                           head_dim=16, sliding_window=6,
                           attention_impl="chunked", attention_block=8,
                           dtype=jnp.float32, param_dtype=jnp.float32),
                 ref_ds.smoke()):
        import dataclasses
        rcfg = dataclasses.replace(rcfg, attention_impl="chunked",
                                   attention_block=8)
        cfg = port_model_config(rcfg)
        init = ref_attn.init_mla if rcfg.mla else ref_attn.init_attention
        rp = init(rcfg, ref_params.KeyGen(jax.random.key(3)))
        p = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in rp.items()}
        x = np.random.default_rng(1).standard_normal(
            (2, 21, rcfg.d_model), dtype=np.float32)
        pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21))
        rfull = ref_attn.mla_full if rcfg.mla else ref_attn.attention_full
        pfull = port_attn.mla_full if cfg.mla else port_attn.attention_full
        want, _ = rfull(rcfg, rp, jnp.asarray(x), jnp.asarray(pos))
        got, _ = pfull(cfg, p, torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
