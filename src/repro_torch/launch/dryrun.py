"""Multi-pod dry run: run every (arch x shape x mesh) cell on fake tensors.

Port of ``src/repro/launch/dryrun.py``.  Proves the distribution layout
is coherent without the cluster: for the production meshes (16 x 16
single-pod, 2 x 16 x 16 multi-pod) each cell's step runs once under
``FakeTensorMode`` on a ``fake`` process group of 256 or 512 ranks, this
process being rank 0.  No memory is allocated and no data moves, but
every op that rank would run on its local shards is dispatched, and
:class:`RankCounter` records:

- FLOPs and bytes of those local ops (one rank's work, by the rule of
  ``core/mapreduce.py``'s ``_CostCounter``: matmuls at 2·m·k·n, other
  ops at their largest operand, bytes as each op's inputs and outputs);
- the collectives the rank issues, by kind, with their output bytes
  times the ring factors of ``launch/roofline.py``, and the part whose
  group spans more than one 8-GPU node;
- per-rank argument bytes and the peak of live tensor bytes.

Attention runs K2's plain version here (fake tensors lie on the CPU), so
its scores count as materialised, as the reference's XLA einsums do;
``attention_impl=chunked`` (``launch/perf.py --set``) counts the
blockwise form.

Single-pod cells also run the shallow probe variants of
``launch/probes.py`` and report probe-corrected totals beside the
full-depth count.  Records are JSON files under ``artifacts/dryrun_torch/``,
one per cell; reruns are incremental.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch all|<id,...>] [--shape all|<name,...>] \\
        [--mesh single,multi] [--force] [--no-probes] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.launch.probes import corrected, make_probe_plan
from repro_torch.launch.roofline import (
    COLLECTIVE_FACTOR,
    HBM_BYTES,
    crosses_nodes,
    derive_terms,
    model_flops,
)
from repro_torch.launch.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.launch.steps import CellBuilder
from repro_torch.utils import tree_leaves

_aten = torch.ops.aten
_MATMULS = (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm)
_NO_TRAFFIC = (_aten.empty, _aten.empty_like, _aten.empty_strided)


def _collective_kind(func) -> str:
    """The collective an op is, by the roofline's names, or ``""``."""
    name = func.overloadpacket.__name__
    if func.namespace not in ("_c10d_functional", "c10d"):
        return ""
    for kind, keys in (("all_reduce", ("all_reduce", "allreduce")),
                       ("all_gather", ("all_gather", "allgather")),
                       ("reduce_scatter", ("reduce_scatter",)),
                       ("all_to_all", ("all_to_all", "alltoall"))):
        if any(name.startswith(k) for k in keys):
            return kind
    return ""


def _group_ranks(args) -> list:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (RuntimeError, ValueError, KeyError):
                continue
    return []


class RankCounter(TorchDispatchMode):
    """Counts the local ops of one rank: FLOPs, bytes, collectives and the
    peak of live tensor bytes.  A DTensor-level op is handed on to DTensor
    (``NotImplemented``), whose local ops come back here; so the counts
    are of local shards, not of the global ops.  DTensor also runs each
    new op once on fake tensors of the global shapes to learn its output's
    shape, which no rank runs: :meth:`skipping_shape_propagation` keeps
    those out."""

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self._skip = 0
        self.flops = 0
        self.bytes = 0
        self.coll_by_op: Dict[str, float] = {}
        self.cross_node_bytes = 0.0
        self.coll_count = 0
        self.live = base_bytes
        self.peak = base_bytes
        self._seen = WeakIdKeyDictionary()

    @contextlib.contextmanager
    def skipping_shape_propagation(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def wrapped(prop, op_schema):
            counter._skip += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        try:
            yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def hold(self, tensors) -> None:
        """Storages live before the run (its arguments, counted in
        ``base_bytes``): never counted again."""
        for t in tensors:
            self._seen[t.untyped_storage()] = 0

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_leaves((list(args), kwargs))
        if any(isinstance(x, DTensor) for x in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if self._skip or func.namespace != "aten" and not kind:
            return out
        if kind:
            b = sum(x.numel() * x.element_size() for x in outs)
            b *= COLLECTIVE_FACTOR[kind]
            self.coll_by_op[kind] = self.coll_by_op.get(kind, 0.0) + b
            self.coll_count += 1
            if crosses_nodes(_group_ranks(list(args) + list(kwargs.values()))):
                self.cross_node_bytes += b
            return out
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        if not func._schema.is_mutable:     # in place: no new storage
            for x in outs:
                self._track(x)
        if func.namespace == "_c10d_functional":      # wait_tensor and kin
            return out
        ins = [x for x in flat if isinstance(x, torch.Tensor)]
        if func.overloadpacket in _MATMULS:
            a, b = ins[-2], ins[-1]          # addmm/baddbmm: bias first
            m, k = a.shape[-2], a.shape[-1]
            self.flops += 2 * (a.numel() // max(m * k, 1)) * m * k \
                * b.shape[-1]
        else:
            self.flops += max([x.numel() for x in ins + outs] or [0])
        self.bytes += sum(x.numel() * x.element_size() for x in ins + outs)
        return out


def _fake_dtensors(args, pls, mesh):
    """Every ``meta`` stand-in as a DTensor whose local shard is a fake
    tensor of the local shape (nothing global is ever made)."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        local = list(t.shape)       # the rules shard evenly, or not at all
        for j, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(j)
        x = torch.empty(local, dtype=t.dtype, device=mesh.device_type)
        return DTensor.from_local(x, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(a, pl):
        if isinstance(a, dict):
            return {k: walk(a[k], pl[k]) for k in a}
        if isinstance(a, (list, tuple)) and not (
                isinstance(pl, tuple) and pl and not isinstance(
                    pl[0], (dict, list, tuple))):
            out = [walk(x, p) for x, p in zip(a, pl)]
            return tuple(out) if isinstance(a, tuple) else out
        return one(a, pl) if isinstance(a, torch.Tensor) else a

    return walk(args, pls)


def _local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size()
               for x in tree_leaves(tree) if hasattr(x, "to_local"))


MESH_RANKS = {"single": 256, "multi": 512}


def make_mesh(mesh_name: str):
    """The named production mesh over a ``fake`` group of its size."""
    fake_process_group(MESH_RANKS[mesh_name])
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device_type="cpu")


def compile_cell(cfg, shape, mesh, kind: str) -> Dict[str, Any]:
    """Run one cell (``shape``: a name of ``SHAPES`` or a ``ShapeSpec``) on
    fake tensors; return one rank's counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.perf_counter()
    builder = CellBuilder(cfg, mesh, kind)
    specs = input_specs(cfg, shape)
    fn, args, pls, _ = builder.build(specs)
    with FakeTensorMode(allow_non_fake_inputs=True):
        dargs = _fake_dtensors(args, pls, mesh)
        arg_bytes = _local_bytes(dargs)
        t_build = time.perf_counter() - t0
        comm = CommDebugMode()
        counter = RankCounter(base_bytes=arg_bytes)
        counter.hold(x.to_local() for x in tree_leaves(dargs)
                     if hasattr(x, "to_local"))
        with comm, counter, counter.skipping_shape_propagation():
            fn(*dargs)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "wire_bytes": float(sum(counter.coll_by_op.values())),
        "cross_node_bytes": float(counter.cross_node_bytes),
        "coll_by_op": counter.coll_by_op,
        "coll_count": counter.coll_count,
        "comm_debug_counts": counts,
        "memory": {"argument_bytes": arg_bytes,
                   "peak_live_bytes": counter.peak},
        "build_s": round(t_build, 2),
        "run_s": round(time.perf_counter() - t0 - t_build, 2),
    }


#: sequence lengths of the time-loop probes (:func:`seq_probed_cell`)
SEQ_PROBES = (512, 1024)
_COUNTS = ("flops", "bytes", "wire_bytes", "cross_node_bytes",
           "argument_bytes", "peak_live_bytes")


def _flat_counts(rec: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(rec[k] if k in rec else rec["memory"][k])
            for k in _COUNTS}


def seq_probed(cfg, spec) -> bool:
    """Whether a cell is counted by :func:`seq_probed_cell`: an
    attention-free stack (RWKV) over a long sequence."""
    return (cfg.attention_free and spec.kind != "decode"
            and spec.seq_len > SEQ_PROBES[-1])


def seq_probed_cell(cfg, spec, mesh) -> Dict[str, Any]:
    """An attention-free stack's cell from its layer probes at two short
    sequences.  RWKV's time loop dispatches its ops one step at a time
    (millions of fake ops at 32k tokens), but no op spans more than one
    step, so every count is affine in the sequence length, as it is
    additive in layers: the probes' depth-corrected counts at
    ``SEQ_PROBES`` extrapolate to ``spec.seq_len``.  The peak memory is
    extrapolated the same way, an estimate."""
    import dataclasses as dc

    probe_a, probe_bs = make_probe_plan(cfg)
    at = {}
    for L in SEQ_PROBES:
        s = dc.replace(spec, seq_len=L)
        a = _flat_counts(compile_cell(probe_a, s, mesh, spec.kind))
        bs = [(pb, _flat_counts(compile_cell(pb.cfg, s, mesh, spec.kind)))
              for pb in probe_bs]
        at[L] = corrected(a, bs, _COUNTS)
    (l1, c1), (l2, c2) = sorted(at.items())
    f = (spec.seq_len - l1) / (l2 - l1)
    out = {k: c1[k] + (c2[k] - c1[k]) * f for k in _COUNTS}
    return {
        **{k: out[k] for k in _COUNTS[:4]},
        "coll_by_op": {}, "coll_count": None,
        "memory": {"argument_bytes": int(out["argument_bytes"]),
                   "peak_live_bytes": int(out["peak_live_bytes"])},
        "seq_probe": {"lengths": list(SEQ_PROBES), "at": at},
    }


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str,
             force: bool = False, probes: bool = True) -> Dict:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    ok, reason = cell_applicable(cfg, shape)
    record: Dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                    "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not ok:
        record.update(status="skipped", reason=reason)
        _write(path, record)
        return record

    t0 = time.perf_counter()
    mesh = make_mesh(mesh_name)
    spec = SHAPES[shape]
    record["spec"] = dataclasses.asdict(spec)
    try:
        probed = seq_probed(cfg, spec)
        main = (seq_probed_cell(cfg, spec, mesh) if probed
                else compile_cell(cfg, shape, mesh, spec.kind))
        per_dev = main["memory"]["peak_live_bytes"]
        record.update(status="ok", devices=mesh.size(), raw=main,
                      microbatches=cfg.train_microbatches,
                      per_device_bytes=per_dev,
                      fits_h100=bool(per_dev < HBM_BYTES))
        totals = main
        if probes and mesh_name == "single" and not probed:
            probe_a, probe_bs = make_probe_plan(cfg)
            a = compile_cell(probe_a, shape, mesh, spec.kind)
            bs = [(pb, compile_cell(pb.cfg, shape, mesh, spec.kind))
                  for pb in probe_bs]
            keys = ("flops", "bytes", "wire_bytes", "cross_node_bytes")
            totals = corrected(a, bs, keys)
            record.update(
                probes={
                    "a": {k: a[k] for k in keys + ("run_s",)},
                    "bodies": {pb.label: dict(
                        {k: m[k] - a[k] for k in keys}, n_full=pb.n_full)
                        for pb, m in bs},
                },
                corrected={k: totals[k] for k in keys})
        terms = derive_terms(totals["flops"], totals["bytes"],
                             totals["wire_bytes"], totals["cross_node_bytes"])
        mf = model_flops(cfg, spec)
        record["roofline"] = {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "compute_fraction": terms.compute_fraction(),
            "model_flops_total": mf,
            "model_flops_per_device": mf / mesh.size(),
            "useful_flops_ratio":
                (mf / mesh.size()) / max(totals["flops"], 1e-30),
        }
    except Exception as e:  # a failing cell is a bug: record it loudly
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    record["wall_s"] = round(time.perf_counter() - t0, 2)
    _write(path, record)
    return record


def _write(path, record):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in args.mesh.split(","):
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mesh_name, args.out,
                               force=args.force, probes=not args.no_probes)
                dt = time.perf_counter() - t0
                status = rec["status"]
                if status == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    extra = (f"dom={r['dominant']:10s} "
                             f"frac={r['compute_fraction']:.3f} "
                             f"mem={rec['per_device_bytes'] / 1e9:7.2f}GB")
                elif status == "skipped":
                    n_skip += 1
                    extra = rec["reason"][:60]
                else:
                    n_err += 1
                    extra = rec["error"][:140]
                print(f"[{status:7s}] {arch:18s} {shape:12s} {mesh_name:6s} "
                      f"({dt:6.1f}s) {extra}", flush=True)
    print(f"\nDRYRUN SUMMARY: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
