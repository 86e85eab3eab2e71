"""The port's launch layer against the reference's.

- ``SHAPES``, ``cell_applicable`` and ``input_specs`` (the reference's
  ``TestShapes``; input shapes and dtypes equal to the reference's);
- the roofline terms with H100 constants (the reference's
  ``TestRooflineTerms``) and ``model_flops`` equal to the reference's;
- probe-corrected totals equal to the full-depth count at a 6-layer
  config (the reference's ``TestProbeCorrection``);
- ``RankCounter``'s per-rank FLOPs, bytes and wire bytes on a small
  ``fake`` mesh against counts made by hand;
- rwkv6-3b's reduced train cell on a fake mesh with a ``pod`` axis;
- a dense production cell's ``useful_flops_ratio`` within the band that
  one rank's share of the work allows (no op replicated across ranks);
- the dry run's records under ``artifacts/dryrun_torch/`` (skipped when
  absent, as on a fresh checkout).

The dry-run counts run in a subprocess: a ``fake`` default process group
must not outlive the test in the worker's process.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch import probes as ref_probes
from repro.launch import roofline as ref_roofline
from repro.launch import shapes as ref_shapes

from repro_torch.configs import get_config
from repro_torch.launch import probes, roofline
from repro_torch.launch.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.utils import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "dryrun_torch")


def run_snippet(code: str, timeout: float = 120.0) -> dict:
    """``code`` in a fresh interpreter (the port on its path); its last
    line of output, read as JSON."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------
# shapes
# ----------------------------------------------------------------------

class TestShapes:
    def test_all_cells_defined(self):
        assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                               "long_500k"}
        for name, spec in SHAPES.items():
            ref = ref_shapes.SHAPES[name]
            assert (spec.seq_len, spec.global_batch, spec.kind) == (
                ref.seq_len, ref.global_batch, ref.kind)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_input_specs_match_reference_without_allocation(self, arch):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for shape in SHAPES:
            ok, _ = cell_applicable(cfg, shape)
            assert ok == ref_shapes.cell_applicable(rcfg, shape)[0]
            if not ok:
                continue
            specs = input_specs(cfg, shape)
            want = ref_shapes.input_specs(rcfg, shape)
            got_leaves, want_leaves = tree_leaves(specs), jax.tree.leaves(
                want)
            assert len(got_leaves) == len(want_leaves), (arch, shape)
            for g, w in zip(got_leaves, want_leaves):
                assert g.device.type == "meta", (arch, shape)
                assert tuple(g.shape) == tuple(w.shape), (arch, shape)
                assert str(g.dtype).split(".")[-1] == str(
                    np.dtype(w.dtype)), (arch, shape, g.dtype, w.dtype)

    def test_long_context_skips(self):
        skips = [a for a in ARCH_IDS
                 if not cell_applicable(get_config(a), "long_500k")[0]]
        assert len(skips) == 7

    def test_decode_specs_have_caches(self):
        specs = input_specs(get_config("llama3p2_1b"), "decode_32k")
        assert "caches" in specs and "token" in specs and "pos" in specs
        assert 32768 in tree_leaves(specs["caches"])[0].shape


# ----------------------------------------------------------------------
# roofline terms
# ----------------------------------------------------------------------

class TestRooflineTerms:
    def test_dominant_selection(self):
        t = roofline.derive_terms(flops=989e12, bytes_accessed=1.0,
                                  wire_bytes=1.0)
        assert t.dominant == "compute"
        assert t.compute_s == pytest.approx(1.0)
        t = roofline.derive_terms(flops=1.0, bytes_accessed=3.35e12,
                                  wire_bytes=1.0)
        assert t.dominant == "memory" and t.memory_s == pytest.approx(1.0)
        t = roofline.derive_terms(flops=1.0, bytes_accessed=1.0,
                                  wire_bytes=450e9)
        assert t.dominant == "collective"
        assert t.collective_s == pytest.approx(1.0)
        assert 0 < t.compute_fraction() <= 1.0

    def test_cross_node_bytes_move_at_infiniband_rate(self):
        t = roofline.derive_terms(1.0, 1.0, wire_bytes=100e9,
                                  cross_node_bytes=50e9)
        assert t.collective_s == pytest.approx(50e9 / 450e9 + 50e9 / 50e9)
        assert roofline.crosses_nodes([0, 8]) and not roofline.crosses_nodes(
            range(8))

    def test_ring_factors_match_reference(self):
        ref = {k.replace("-", "_"): v
               for k, v in ref_roofline._COLLECTIVE_FACTOR.items()
               if k != "collective-permute"}
        assert roofline.COLLECTIVE_FACTOR == ref

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_model_flops_match_reference(self, arch):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for shape in SHAPES:
            assert roofline.model_flops(cfg, SHAPES[shape]) == \
                ref_roofline.model_flops(rcfg, ref_shapes.SHAPES[shape])


# ----------------------------------------------------------------------
# probes
# ----------------------------------------------------------------------

def test_perf_overrides_match_reference():
    from repro.launch.perf import apply_overrides as ref_apply
    from repro_torch.launch.perf import apply_overrides

    sets = {"n_groups": "-1", "attention_impl": "chunked",
            "capacity_factor": "1.5", "scan_layers": "false"}
    got = apply_overrides(get_config("mixtral_8x7b"), sets)
    want = ref_apply(ref_get_config("mixtral_8x7b"), sets)
    assert (got.moe.n_groups, got.moe.capacity_factor, got.attention_impl,
            got.scan_layers) == (want.moe.n_groups, want.moe.capacity_factor,
                                 want.attention_impl, want.scan_layers)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_plans_match_reference(arch):
    a, bs = probes.make_probe_plan(get_config(arch))
    ra, rbs = ref_probes.make_probe_plan(ref_get_config(arch))
    assert a.n_layers == ra.n_layers and a.block_pattern == ra.block_pattern
    assert [(b.label, b.n_full, b.n_in_a, b.cfg.n_layers) for b in bs] == \
        [(b.label, b.n_full, b.n_in_a, b.cfg.n_layers) for b in rbs]


class TestProbeCorrection:
    """Probe-corrected totals equal the full-depth count."""

    def test_corrected_matches_full_depth(self):
        out = run_snippet("""
            import dataclasses, json, torch
            from repro_torch.launch.dryrun import compile_cell
            from repro_torch.launch.mesh import (fake_process_group,
                                                 make_host_mesh)
            from repro_torch.launch.probes import corrected, make_probe_plan
            from repro_torch.launch.shapes import ShapeSpec
            from repro_torch.models.config import ModelConfig
            cfg = ModelConfig(
                name="probecheck", family="dense", n_layers=6, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                remat_policy="none", dtype=torch.float32,
                param_dtype=torch.float32)
            fake_process_group(1)
            mesh = make_host_mesh(device_type="cpu")
            spec = ShapeSpec("tiny_train", 32, 4, "train")
            full = compile_cell(cfg, spec, mesh, "train")
            a_cfg, plan = make_probe_plan(cfg)
            a = compile_cell(a_cfg, spec, mesh, "train")
            bs = [(pb, compile_cell(pb.cfg, spec, mesh, "train"))
                  for pb in plan]
            corr = corrected(a, bs)
            print(json.dumps({k: [full[k], corr[k], a[k]]
                              for k in ("flops", "bytes")}))
        """)
        for key, (full, corr, a) in out.items():
            assert a < full, key
            assert corr == pytest.approx(full, rel=1e-9), key


class TestSequenceProbes:
    """RWKV cells are counted from their layer probes at two short
    sequences, extrapolated in the sequence length: held to the direct
    count of a 4-layer stack at 512 tokens from probes at 128 and 256.
    The time loop's FLOPs and bytes are affine in the length but for a
    few per-block terms (0.07% of the FLOPs and 0.8% of the bytes at this
    size); the peak memory is an estimate and is not held here."""

    def test_extrapolated_counts_match_direct(self):
        out = run_snippet("""
            import dataclasses, json
            from repro_torch.configs import get_config
            from repro_torch.launch import dryrun as D
            from repro_torch.launch.mesh import (fake_process_group,
                                                 make_host_mesh)
            from repro_torch.launch.shapes import ShapeSpec
            D.SEQ_PROBES = (128, 256)
            cfg = dataclasses.replace(get_config("rwkv6_3b", reduced=True),
                                      n_layers=4)
            fake_process_group(1)
            mesh = make_host_mesh(device_type="cpu")
            out = {}
            for kind in ("train", "prefill"):
                spec = ShapeSpec("t", 512, 1, kind)
                assert D.seq_probed(cfg, spec)
                full = D._flat_counts(D.compile_cell(cfg, spec, mesh, kind))
                ext = D._flat_counts(D.seq_probed_cell(cfg, spec, mesh))
                out[kind] = {k: [full[k], ext[k]] for k in D._COUNTS}
            print(json.dumps(out))
        """, timeout=300)
        for kind, counts in out.items():
            full, ext = counts["flops"]
            assert ext == pytest.approx(full, rel=5e-3), kind
            full, ext = counts["bytes"]
            assert ext == pytest.approx(full, rel=2e-2), kind
            full, ext = counts["argument_bytes"]
            assert ext == full, kind


# ----------------------------------------------------------------------
# per-rank counts on a small fake mesh, by hand
# ----------------------------------------------------------------------

def test_rank_counts_match_hand_counts():
    """A (data 2, model 8) mesh of 16 fake ranks: rank 0's data group
    {0, 8} spans two 8-GPU nodes, its model group {0..7} one."""
    out = run_snippet("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Replicate, Shard)
        from repro_torch.launch.dryrun import RankCounter
        from repro_torch.launch.mesh import fake_process_group
        fake_process_group(16)
        mesh = init_device_mesh("cpu", (2, 8),
                                mesh_dim_names=("data", "model"))
        res = {}
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = DTensor.from_local(torch.empty(4, 16), mesh,
                                   [Shard(0), Replicate()], shape=(8, 16),
                                   stride=(16, 1))
            w = DTensor.from_local(torch.empty(16, 4), mesh,
                                   [Replicate(), Shard(1)], shape=(16, 32),
                                   stride=(32, 1))
            c = RankCounter()
            with c, c.skipping_shape_propagation():
                y = x @ w
            res["mm"] = [c.flops, c.bytes, c.coll_by_op, y.to_local().shape[1]]
            c = RankCounter()
            with c, c.skipping_shape_propagation():
                y = y.redistribute(mesh, [Shard(0), Replicate()])
            res["gather"] = [c.coll_by_op, c.cross_node_bytes, c.coll_count]
            c = RankCounter()
            with c, c.skipping_shape_propagation():
                s = y.sum().full_tensor()
            res["reduce"] = [c.coll_by_op, c.cross_node_bytes]
        print(json.dumps(res))
    """)
    flops, nbytes, coll, width = out["mm"]
    assert width == 4                          # 32 columns over 8 ranks
    assert flops == 2 * 4 * 16 * 4             # [4,16] @ [16,4]
    assert nbytes == (4 * 16 + 16 * 4 + 4 * 4) * 4
    assert coll == {}
    gathered, cross, n = out["gather"]
    assert gathered == {"all_gather": 4 * 32 * 4.0} and cross == 0 and n == 1
    reduced, cross = out["reduce"]
    assert reduced == {"all_reduce": 4 * 2.0}  # one fp32 scalar, ring 2
    assert cross == 8.0                        # data group {0, 8}


def test_rwkv_train_cell_runs_on_a_mesh_with_a_pod_axis():
    """rwkv6-3b's reduced train cell through ``CellBuilder`` on a
    ``(pod 2, data 1, model 2)`` fake mesh, batch 2 of 4 tokens: the
    smallest cell that meets the batch flattened over (pod, data) while
    the model axis splits the tokens.  Without the batch-only constraint
    on the token-shift mix (``models/rwkv.py::_ddlerp``) its step fails:
    "Sharding propagation failed for aten.mm.default"."""
    out = run_snippet("""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import compile_cell
        from repro_torch.launch.mesh import fake_process_group
        from repro_torch.launch.shapes import ShapeSpec
        fake_process_group(4)
        mesh = init_device_mesh("cpu", (2, 1, 2),
                                mesh_dim_names=("pod", "data", "model"))
        rec = compile_cell(get_config("rwkv6_3b", reduced=True),
                           ShapeSpec("pod_train", 4, 2, "train"), mesh,
                           "train")
        print(json.dumps({"flops": rec["flops"]}))
    """, timeout=300)
    assert out["flops"] > 0


def test_dense_cell_counts_one_ranks_share_of_the_model():
    """llama3.2-1b train_4k on the 16 x 16 mesh, as the dry run records it
    (probes included): ``model_flops / 256`` over the rank's count.  The
    rank's weight matmuls are 6·N·D / 256 (its remat policy is "none":
    nothing is recomputed); the materialised attention scores (QK^T and
    PV, forward and backward) add 29% and the elementwise ops under 1%,
    so the ratio is
    1 / 1.30 = 0.77.  An op replicated over either 16-wide axis adds 15x
    its share: any such op above 0.7% of the work takes the ratio under
    0.70; a weight's backward left out takes it over 0.85."""
    rec = run_snippet("""
        import json, tempfile
        from repro_torch.launch.dryrun import run_cell
        with tempfile.TemporaryDirectory() as d:
            rec = run_cell("llama3p2_1b", "train_4k", "single", d)
        print(json.dumps(rec))
    """, timeout=300)
    assert rec["status"] == "ok", rec.get("error")
    ratio = rec["roofline"]["useful_flops_ratio"]
    assert 0.70 <= ratio <= 0.85, ratio
    assert rec["corrected"]["flops"] == pytest.approx(rec["raw"]["flops"],
                                                      rel=1e-9)


# ----------------------------------------------------------------------
# the dry run's records
# ----------------------------------------------------------------------

def _load(mesh):
    return [json.load(open(f)) for f in sorted(
        glob.glob(os.path.join(ART, f"*__{mesh}.json")))]


@pytest.fixture(scope="module")
def cells():
    single = _load("single")
    if len(single) < 40:
        pytest.skip("dry-run records incomplete: run "
                    "repro_torch.launch.dryrun")
    return {"single": single, "multi": _load("multi")}


def test_dryrun_records(cells):
    single = cells["single"]
    assert len(single) == 40
    errors = [(c["arch"], c["shape"], c["error"]) for c in single
              if c["status"] == "error"]
    assert not errors, errors
    skipped = [c for c in single if c["status"] == "skipped"]
    assert len(skipped) == 7 and all(c["shape"] == "long_500k"
                                     for c in skipped)
    for c in single:
        if c["status"] != "ok":
            continue
        r = c["roofline"]
        assert c["devices"] == 256
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["compute_s"] > 0 and r["memory_s"] > 0
        assert 0 < r["compute_fraction"] <= 1.0
        # a rank does at least its share of the model's FLOPs
        assert 0 < r["useful_flops_ratio"] <= 1.0, (c["arch"], c["shape"])
        assert c["raw"]["memory"]["peak_live_bytes"] >= \
            c["raw"]["memory"]["argument_bytes"] > 0
    multi = {(c["arch"], c["shape"]): c for c in cells["multi"]}
    for arch in ("llama3_405b", "deepseek_v3_671b"):
        for shape in SHAPES:
            assert multi[arch, shape]["status"] in ("ok", "skipped")
    errors = {k for k, c in multi.items() if c["status"] == "error"}
    assert not errors, errors
    for c in multi.values():
        if c["status"] == "ok":
            assert c["devices"] == 512
