#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit.
2. Builds the fused fold CUDA kernel from ``src/repro_torch/kernels/
   fused_fold/csrc/fused_fold.cu`` (nvcc, sm_90a).
3. Holds the kernel against its plain PyTorch version and the float64 NumPy
   oracle over bf16/f32/i32/bool payloads, G in {1, 7, 64, the kernel's
   limit}, ragged shapes and NaN/Inf in masked-off rows; two launches must
   give identical bits.
4. Drives the main path at full size: the paper's 4,490-subject population
   (Table 3), one float32 91x109x91 MNI152 2 mm volume per subject, on
   ``GridSession(devices=["cuda:0"] * 4)`` with the paper's two node types
   — a cold grouped two-column Moments+Mean query, a warm repeat, an upload,
   a remove, a rebalance and ``run(MeanProgram(), impl="kernel")`` — and
   checks it against a float64 oracle on a voxel subset and against a second
   session that folds with plain PyTorch.
5. Prints one JSON line of kernel measurements, the card line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import grid as grid_mod  # noqa: E402
from repro_torch.core.balancer import NodeSpec  # noqa: E402
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.core.mapreduce import MapReduceEngine  # noqa: E402
from repro_torch.core.query import age_sex_predicate  # noqa: E402
from repro_torch.core.stats import MeanProgram, MomentsProgram  # noqa: E402
from repro_torch.core.table import TensorTable  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    image_population_table,
    population_covariates,
)
from repro_torch.kernels.fused_fold import kernel as K  # noqa: E402
from repro_torch.kernels.fused_fold.ops import (  # noqa: E402
    fused_fold,
    kernel_hbm_bytes,
    max_groups_for_smem,
)
from repro_torch.kernels.fused_fold.ref import fused_fold_numpy  # noqa: E402

VOLUME = (91, 109, 91)          # MNI152 2 mm grid
SCALE = 1.0                     # 4,490 subjects (the paper's Table 3)
HBM_BPS = 3.35e12               # H100 SXM data sheet
FP32_FLOPS = 67e12              # H100 SXM data sheet, fp32 outside tensor cores
NAMES = ("count", "s1", "s2", "s3", "s4")
NODES = [NodeSpec(0, cores=12, mips=1.0), NodeSpec(1, cores=12, mips=1.0),
         NodeSpec(2, cores=32, mips=1.6), NodeSpec(3, cores=32, mips=1.6)]


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------
# phase 3: kernel vs plain version vs float64 oracle
# ----------------------------------------------------------------------

def sweep_inputs(kind, R, F, G, rng):
    if kind == "i32":
        x = torch.from_numpy(rng.integers(-9, 10, (R, F)).astype(np.int32))
    elif kind == "bool":
        x = torch.from_numpy(rng.random((R, F)) > 0.5)
    else:
        x = torch.from_numpy(rng.normal(size=(R, F)).astype(np.float32))
    m = rng.random(R) > 0.3
    if kind in ("f32", "bf16"):
        bad = np.nonzero(~m)[0]
        x[bad[0::2]] = float("nan")
        x[bad[1::2]] = float("inf")
    if kind == "bf16":
        x = x.to(torch.bfloat16)
    g = rng.integers(0, G, R).astype(np.int32)
    return x, m, g


def kernel_sweep():
    rng = np.random.default_rng(0)
    worst = 0.0
    cases = 0
    gmax = max_groups_for_smem(NAMES)
    for kind in ("f32", "bf16", "i32", "bool"):
        for G in (1, 7, 64, gmax):
            for R, F in ((1, 1), (37, 130), (1000, 4097)):
                x, m, g = sweep_inputs(kind, R, F, G, rng)
                xd, md, gd = x.cuda(), torch.from_numpy(m).cuda(), \
                    torch.from_numpy(g).cuda()
                got = fused_fold(xd, md, gd, G)
                again = fused_fold(xd, md, gd, G)
                plain = K.fused_fold_torch(xd, gd, md.float(), G, NAMES)
                torch.cuda.synchronize()
                oracle = fused_fold_numpy(x.float().numpy(), m, g,
                                          num_groups=G)
                if kind in ("i32", "bool"):
                    rtol = atol = 0.0
                elif kind == "bf16":
                    rtol, atol = 5e-2, 2e-1
                elif R * F > 10_000:
                    rtol, atol = 1e-3, 1e-2
                else:
                    rtol, atol = 1e-4, 1e-3
                for n in NAMES:
                    a = got[n].cpu()
                    check(torch.equal(got[n], again[n]),
                          f"re-launch differs: {kind} G={G} R={R} F={F} {n}")
                    check(bool(torch.isfinite(a).all()),
                          f"non-finite {n}: {kind} G={G} R={R} F={F}")
                    for want, label in ((plain[n].cpu(), "plain"),
                                        (torch.from_numpy(oracle[n]), "f64")):
                        want = want.to(torch.float64).reshape(a.shape)
                        tol = 0.0 if n == "count" else rtol
                        ok = torch.allclose(a.double(), want, rtol=tol,
                                            atol=0.0 if n == "count" else atol)
                        check(ok, f"kernel vs {label}: {kind} G={G} R={R} "
                                  f"F={F} {n} max err "
                                  f"{(a.double() - want).abs().max():.3g}")
                    worst = max(worst, float(
                        (a.double() - plain[n].cpu().double()).abs().max()))
                cases += 1
    return cases, worst


# ----------------------------------------------------------------------
# phase 4: the main path at full size
# ----------------------------------------------------------------------

def build_population(scale, seed=0, chunk=256):
    """The Table-3 population in one Upload: volumes drawn in float32,
    chunk by chunk, straight into one array (no float64 copy of the
    16 GB payload).  Returns the table and the seconds spent drawing and
    uploading."""
    rng = np.random.default_rng(seed)
    ages, sexes = population_covariates(rng, scale)
    n = len(ages)
    table = image_population_table(VOLUME)
    t0 = time.perf_counter()
    data = np.empty((n,) + VOLUME, np.float32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        rng.standard_normal(out=data[lo:hi], dtype=np.float32)
        data[lo:hi] += ages[lo:hi, None, None, None] / 100.0
    sizes = rng.integers(6_000_000, 20_000_001, n)
    t1 = time.perf_counter()
    table.upload([f"sub{i:06d}" for i in range(n)],
                 {"img": {"data": data},
                  "idx": {"size": sizes, "age": ages, "sex": sexes}})
    table.split_log.clear()
    return table, t1 - t0, time.perf_counter() - t1


def grouped_query(s):
    return (s.scan().select(["img:data", "idx:age"])
            .where(age_sex_predicate(20.0, 60.0), ["age"])
            .group_by("idx:sex").map(MomentsProgram()).map(MeanProgram())
            .reduce().collect())


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if hasattr(tree, "keys") and hasattr(tree, "values"):
        return (np.asarray(tree.keys), to_cpu(tree.values))
    return tree


def oracle_check(table, res, n_vox=4096):
    """The grouped Moments+Mean against float64 numpy on the first
    ``n_vox`` voxels (and the whole scalar age column)."""
    age = table.column("idx", "age")
    sex = table.column("idx", "sex")
    sel = (age >= 20.0) & (age < 60.0)
    vox = table.column("img", "data").reshape(table.num_rows, -1)[:, :n_vox]
    keys, (moments, mean) = res["img:data"]
    akeys, (amom, amean) = res["idx:age"]
    check(list(keys) == [0, 1] and list(akeys) == [0, 1], "group keys")
    for gi, key in enumerate(keys):
        rows = sel & (sex == key)
        x = vox[rows].astype(np.float64)
        check(int(moments["count"][gi]) == int(rows.sum()), "group count")
        for got, want in ((mean[gi].reshape(-1)[:n_vox], x.mean(0)),
                          (moments["mean"][gi].reshape(-1)[:n_vox], x.mean(0)),
                          (moments["var"][gi].reshape(-1)[:n_vox], x.var(0))):
            check(np.allclose(got.numpy(), want, rtol=1e-4, atol=1e-3),
                  f"oracle mismatch group {key}: max err "
                  f"{np.abs(got.numpy() - want).max():.3g}")
        a = age[rows].astype(np.float64)
        check(np.allclose(float(amean[gi]), a.mean(), rtol=1e-4, atol=1e-3),
              "age mean")
        check(np.allclose(float(amom["var"][gi]), a.var(), rtol=1e-4,
                          atol=1e-3), "age var")


def assert_trees_close(a, b, what):
    if isinstance(a, dict):
        for k in a:
            assert_trees_close(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_close(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        check(np.array_equal(a, b), f"{what} differs")
    else:
        ok = torch.allclose(a.double(), b.double(), rtol=1e-4, atol=1e-3)
        check(ok, f"{what}: max err {(a.double() - b.double()).abs().max()}")


def main_path(table):
    """Phases (a)-(f); returns the report lines and the measurements."""
    out = {}
    s = GridSession(table, devices=["cuda:0"] * 4, nodes=NODES)
    regions = list(table.regions)
    rows = [r.num_rows(table.keys) for r in regions]
    log(f"regions {len(regions)} rows/region min {min(rows)} max {max(rows)}"
        f" owners {sorted(set(s.placement.alloc.values()))}")
    K.fused_fold_cuda.launches = 0
    (res, rep), t_cold = timed(lambda: grouped_query(s))
    q = rep.query
    check(q.rows_folded > 0 and q.merge_path == "tree", "cold fold")
    out["cold_s"] = t_cold
    out["h2d_bytes"] = q.payload_bytes_transferred
    cold = to_cpu(res)
    oracle_check(table, cold)
    (res2, rep2), t_warm = timed(lambda: grouped_query(s))
    check(rep2.query.rows_folded == 0 and rep2.query.gather_count == 0,
          "warm repeat folded rows")
    out["warm_s"] = t_warm

    rng = np.random.default_rng(1)
    n = table.num_rows
    up = [f"sub{i:06d}x" for i in (5, n // 3, 2 * n // 3)]
    ages = np.array([25.0, 35.0, 45.0], np.float32)
    s.upload(up, {"img": {"data": rng.standard_normal(
        (3,) + VOLUME, dtype=np.float32)},
        "idx": {"size": np.full(3, 10_000_000), "age": ages,
                "sex": np.array([0, 1, 0], np.int8)}})
    (_, rep3), t_up = timed(lambda: grouped_query(s))
    refold = rep3.query.partials_total - rep3.query.partials_reused
    check(0 < refold < rep3.query.partials_total, "upload re-fold set")
    out["dirty_upload_s"] = t_up
    out["h2d_bytes"] += rep3.query.payload_bytes_transferred
    check(s.remove(start=f"sub{n // 2:06d}", stop=f"sub{n // 2 + 4:06d}")
          == 4, "remove")
    (_, rep4), t_rm = timed(lambda: grouped_query(s))
    refold4 = rep4.query.partials_total - rep4.query.partials_reused
    check(0 < refold4 < rep4.query.partials_total, "remove re-fold set")
    out["dirty_remove_s"] = t_rm
    out["h2d_bytes"] += rep4.query.payload_bytes_transferred
    moved = s.rebalance(nodes=[NodeSpec(n.node_id, cores=n.cores, mips=m)
                               for n, m in zip(NODES, (1.6, 1.6, 1.0, 1.0))])
    check(len(moved) > 0, "rebalance moved nothing")
    (res5, rep5), t_rb = timed(lambda: grouped_query(s))
    check(rep5.query.rows_folded == 0, "rebalance re-folded rows")
    out["rebalance_s"] = t_rb
    check(s.engine.fold_path_counts["torch"] == 0, "pool fold left the kernel")
    final = to_cpu(res5)
    (mres, mrep), t_run = timed(lambda: s.run(MeanProgram(), impl="kernel"))
    out["run_kernel_s"] = t_run
    out["h2d_bytes"] += mrep.query.payload_bytes_transferred
    data = table.column("img", "data").reshape(table.num_rows, -1)[:, :4096]
    check(np.allclose(mres.reshape(-1)[:4096].cpu().numpy(),
                      data.astype(np.float64).mean(0), rtol=1e-4, atol=1e-3),
          "run(impl=kernel) mean")
    out["launches"] = K.fused_fold_cuda.launches
    check(out["launches"] > 0, "kernel never launched on the main path")
    out["fold_path_counts"] = dict(s.engine.fold_path_counts)
    out["regions"] = len(regions)
    out["moved"] = len(moved)
    out["refold_upload"] = refold
    out["refold_remove"] = refold4
    s.close()
    del s, res, res2, res5, mres
    gc.collect()
    torch.cuda.empty_cache()
    return final, out


def plain_session(table, final):
    """The same query on a session that folds with plain PyTorch."""
    s = GridSession(table, devices=["cuda:0"] * 4, nodes=NODES,
                    fold_impl="torch")
    s.rebalance(nodes=[NodeSpec(n.node_id, cores=n.cores, mips=m)
                       for n, m in zip(NODES, (1.6, 1.6, 1.0, 1.0))])
    launches = K.fused_fold_cuda.launches
    (res, rep), t = timed(lambda: grouped_query(s))
    check(K.fused_fold_cuda.launches == launches, "plain session launched K1")
    check(s.engine.fold_path_counts["kernel"] == 0, "plain session path")
    assert_trees_close(final, to_cpu(res), "kernel vs plain session")
    s.close()
    del s, res
    gc.collect()
    torch.cuda.empty_cache()
    return t


@contextlib.contextmanager
def layer_spans():
    """Host-clock spans around the layers a cold query crosses: the table
    gather (``TensorTable.region_column``), the commit to the owner device
    (``grid._to_owner``: pinned staging + copy), the block fold
    (``MapReduceEngine.fold_block``) and the merge (``merge_finalize``).
    Each span synchronises the card before it ends, so device work is
    charged to the layer that queued it.  Patches are undone on exit."""
    spans = {k: [0.0, 0] for k in ("gather", "commit", "fold", "merge")}
    targets = [(TensorTable, "region_column", "gather"),
               (grid_mod, "_to_owner", "commit"),
               (MapReduceEngine, "fold_block", "fold"),
               (MapReduceEngine, "merge_finalize", "merge")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]

    def wrap(fn, name):
        def timed_call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[name][0] += time.perf_counter() - t0
            spans[name][1] += 1
            return out
        return timed_call

    for (obj, attr, name), (_, _, fn) in zip(targets, saved):
        setattr(obj, attr, wrap(fn, name))
    try:
        yield spans
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def traced_cold(table):
    """A separate cold grouped query on a fresh kernel session, with layer
    spans and the profiler's device time; returns the breakdown."""
    s = GridSession(table, devices=["cuda:0"] * 4, nodes=NODES)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with layer_spans() as spans, torch.profiler.profile(activities=acts) \
            as prof:
        _, wall = timed(lambda: grouped_query(s))
    device_us = {"kernel": 0.0, "memcpy": 0.0}
    by_name = {}
    for evt in prof.events():         # device-side events only: one stream
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = "memcpy" if "memcpy" in evt.name.lower() else "kernel"
        us = evt.time_range.elapsed_us()
        device_us[kind] += us
        t, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (t + us, n + 1)
    s.close()
    del s
    gc.collect()
    torch.cuda.empty_cache()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return wall, spans, device_us, top


# ----------------------------------------------------------------------
# kernel measurement at the main path's largest block
# ----------------------------------------------------------------------

def event_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def measure_block(table):
    region = max(table.regions, key=lambda r: r.num_rows(table.keys))
    host = table.region_column(region, "img", "data")
    rows = len(host)
    bucket = 1 << max(0, rows - 1).bit_length()
    x = torch.zeros((bucket,) + VOLUME, dtype=torch.float32)
    x[:rows] = torch.from_numpy(host)
    x = x.reshape(bucket, -1).cuda()
    sl = region.row_slice(table.keys)
    age = table.column("idx", "age")[sl]
    m = np.zeros(bucket, bool)
    m[:rows] = (age >= 20.0) & (age < 60.0)
    g = np.zeros(bucket, np.int32)
    g[:rows] = table.column("idx", "sex")[sl]
    md, gd = torch.from_numpy(m).cuda(), torch.from_numpy(g).cuda()
    mf = md.float()
    G, F = 2, x.shape[1]

    before = K.fused_fold_cuda.launches
    got = K.fused_fold_cuda(x, gd, mf, G, NAMES)
    plain = K.fused_fold_torch(x, gd, mf, G, NAMES)
    torch.cuda.synchronize()
    err = max(float((got[n] - plain[n]).abs().max()) for n in NAMES)
    for n in NAMES:
        check(torch.allclose(got[n], plain[n], rtol=1e-4, atol=1e-3),
              f"main-path block kernel vs plain {n}")
    ms = event_ms(lambda: K.fused_fold_cuda(x, gd, mf, G, NAMES))
    plain_ms = event_ms(lambda: K.fused_fold_torch(x, gd, mf, G, NAMES), 5)
    # yardstick: one index_add_ of the selected rows' payload (Σx only)
    dump = torch.where(md, gd.long(), torch.full_like(gd.long(), G))
    acc = torch.zeros((G + 1, F), dtype=torch.float32, device="cuda")
    library_ms = event_ms(lambda: acc.index_add_(0, dump, x), 5)
    K.fused_fold_cuda.launches = before       # comparison launches

    sel = int(m.sum())
    need_bytes = sel * F * 4 + bucket * 8 + (4 * G * F + G) * 4
    ops = sel * F * 11 + sel
    bound_bytes_ms = need_bytes / HBM_BPS * 1e3
    bound_ops_ms = ops / FP32_FLOPS * 1e3
    hbm = kernel_hbm_bytes(bucket, F, 4, NAMES, G)
    return {
        "rows": rows, "bucket": bucket, "selected": sel, "F": F,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "kernel_hbm_gbps": hbm / ms / 1e6,
        "need_gbps": need_bytes / ms / 1e6,
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K.LIBRARY.get()
    log(f"built fused_fold in {time.perf_counter() - t0:.1f} s "
        f"({K.LIBRARY.path.name})")
    for line in K.LIBRARY.build_log.splitlines():
        if "registers" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    cases, worst = kernel_sweep()
    log(f"kernel sweep: {cases} cases vs plain and float64, "
        f"max |kernel-plain| {worst:.3g}, {time.perf_counter() - t0:.1f} s")

    table, t_draw, t_upload = build_population(SCALE)
    log(f"population: {table.num_rows} subjects x {VOLUME} float32 = "
        f"{table.column('img', 'data').nbytes / 1e9:.2f} GB; drawn in "
        f"{t_draw:.1f} s, uploaded in {t_upload:.1f} s")
    final, m = main_path(table)
    log(f"main path on {card}: cold {m['cold_s']:.3f} s, warm "
        f"{m['warm_s']:.4f} s, dirty upload {m['dirty_upload_s']:.3f} s "
        f"({m['refold_upload']} partials re-folded), dirty remove "
        f"{m['dirty_remove_s']:.3f} s ({m['refold_remove']}), rebalance "
        f"{m['rebalance_s']:.4f} s ({m['moved']} regions moved), "
        f"run(impl=kernel) {m['run_kernel_s']:.3f} s; "
        f"host->device {m['h2d_bytes'] / 1e9:.2f} GB; "
        f"K1 launches {m['launches']}; fold paths {m['fold_path_counts']}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    t_plain = plain_session(table, final)
    log(f"plain-PyTorch fold session, cold query on {card}: {t_plain:.3f} s "
        f"(kernel session {m['cold_s']:.3f} s); results agree")
    wall, spans, dev, top = traced_cold(table)
    named = sum(v[0] for v in spans.values())
    log(f"traced cold query on {card}: wall {wall:.3f} s = " + ", ".join(
        f"{k} {v[0]:.3f} s/{v[1]} calls" for k, v in spans.items())
        + f", other host {wall - named:.3f} s; device busy "
        f"{(dev['kernel'] + dev['memcpy']) / 1e6:.3f} s (kernels "
        f"{dev['kernel'] / 1e6:.3f} s, copies {dev['memcpy'] / 1e6:.3f} s),"
        f" idle share {1 - (dev['kernel'] + dev['memcpy']) / 1e6 / wall:.3f}")
    for evt_name, (us, calls) in top:
        log(f"  device time {us / 1e6:.3f} s in {calls} calls: "
            f"{evt_name[:100]}")
    b = measure_block(table)
    log(f"K1 at the largest main-path block [{b['bucket']} x {b['F']}] f32 "
        f"({b['rows']} rows, {b['selected']} selected), G=2, on {card}: "
        f"{b['ms']:.3f} ms/block, {b['kernel_hbm_gbps']:.0f} GB/s by "
        f"kernel_hbm_bytes, {b['need_gbps']:.0f} GB/s of needed bytes; "
        f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}); plain "
        f"{b['plain_ms']:.3f} ms; index_add_ {b['library_ms']:.3f} ms")
    print(json.dumps({"kernels": [{
        "name": "fused_fold",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_fold/csrc/fused_fold.cu",
        "replaces": "src/repro/kernels/fused_fold/kernel.py:49",
        "launches": m["launches"],
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        "library_ms": b["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
