#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-short    # K3 alone: build, sweeps, timings
    python3 chip_smoke.py --norm-rope   # the norm and RoPE kernels, timed

1. Prints the card's name and power limit.
2. Builds the four CUDA libraries side by side (one nvcc each, sm_90a):
   K1 fused fold (register-path kernels for G <= 8, a shared-memory one
   for larger G), K2 flash attention in its two variants (at head dims
   16, 32, 64 and 128 ``wgmma`` for bf16/f16 and ``wgmma_f32`` for f32,
   the split-precision instance), K3 SSD scan in its four variants (at
   any P, N <= 64 and any configured chunk, ``wgmma`` for bf16 B/C and
   ``wgmma_split`` for f32/f16 B/C, and below 65 steps the short
   kernel's 64-step tile, ``wgmma_short`` and ``wgmma_split_short``),
   the one-pass RMSNorm and RoPE kernels, logs each kernel's registers
   and spills, and how many CTAs of each K3 wgmma tile fit an SM (the
   short kernel must fit two).
3. Holds K1 against its plain PyTorch version and the float64 NumPy oracle
   over bf16/f32/i32/bool payloads, G in {1, 2, 7, 64, the kernel's
   limit}, ragged and one-column shapes and NaN/Inf in masked-off rows,
   blocks longer than a row-list chunk, wholly masked blocks and row
   weights -1/0.5/1/0; two launches must give identical bits.
   NaN/Inf/1e20 in valid rows (gids in and out of range) must give the
   plain version's NaN/Inf positions and finite values.
4. Holds K2 and K3 against their plain versions (and K3 against the literal
   recurrence) on the reference kernel tests' shapes and at the serving
   shapes; K2 in f32, bf16 and f16 at head dims 64 and 128 (and qwen3-8b's
   GQA heads at D 128, and phase (i)'s calls in bf16 and f32: mixtral's
   window of 4096 over 6144 tokens, qwen2-vl's 28 over 4 heads, whisper's
   encoder over 1500 frames, its cross-attention and its decoder) and at
   head dims 16 and 32 in f32, bf16 and f16 (the reduced configs' calls,
   and B 8, H 32, S 2048), K3 with f32, f16 and bf16 B/C at P = N = 64
   (incl. L = 1, 12, 64 on the short kernel, with the 128-step tile called
   directly beside it from a state, and L = 100, shorter than a chunk) and
   at the narrower dims and chunks (P = N = 16 at a configured chunk of
   16 for L from 1 to 2048, dims the wrapper pads), from a zero and from
   a random initial state, checking which variant ran.  Then one Mamba2 layer of
   zamba2-1.2b at full width runs ``ssm_full`` over the serving prompt and
   over its two halves, the second from the first's returned state, in bf16
   (wgmma) and fp32 (wgmma_split): the chained scans must equal one scan
   over the same steps.
5. Drives the population path at full size: the paper's 4,490-subject
   population (Table 3), one float32 91x109x91 MNI152 2 mm volume per
   subject, on ``GridSession(devices=["cuda:0"] * 4)`` with the paper's two
   node types — a cold grouped two-column Moments+Mean query, a warm
   repeat, an upload, a remove, a rebalance and
   ``run(MeanProgram(), impl="kernel")`` — and checks it against a float64
   oracle on a voxel subset and against a second session that folds with
   plain PyTorch.  Counts K1's launches by block.  On the same session,
   its blocks still resident: (g) four sketch queries over ``img:data``
   aged 20-60 by sex (count-min, HyperLogLog, the quantile sketch dense
   and count-min), each with its wall, rows, fold paths (no K1) and memory
   above the blocks, their exact invariants, one region's block folded
   through all four on the card and the CPU with every int32 leaf equal,
   and ``fmix32`` equal on both; (h) ``GridFrontend(workers=8,
   tick_ms=2.0)``: eight clients coalescing onto one execution whose K1
   launches and bits equal a direct re-fold, three plans fused in one
   tick (one K1 launch a block), an upload under eight queries (each
   answer one epoch's direct result) and 64 mixed submissions for
   queries/s and p50/p99.  Then times K1 at three of its blocks: the
   grouped query's largest ``img:data`` block, the Mean run's block and
   the ``idx:age`` block.
6. Serves zamba2-1.2b at full width and depth (38 layers, random weights from
   a seed) through ``ServeEngine(device="cuda")``: 8 requests, 2048 prompt
   tokens, 64 new tokens, greedy; counts K2/K3 launches per prefill by
   wrapper, by variant and by the profiler's kernel names, and the norm
   and RoPE launches of the generate call and of one prefill (each call
   one launch; the profiler's records of the two kernels equal to the
   launches), and holds the prefill and every decode step's logits
   against the same model run with the kernels' plain versions
   (``plain_kernels()``: K2, K3, the norm and RoPE, none of whose kernels
   may launch) on the same token stream (bf16 activations: the wgmma
   variants of K2 and K3; fp32: wgmma_f32 and wgmma_split).  A
   12-token prefill (the serving launcher's default prompt, shorter than
   one chunk) through the same engine in bf16 takes
   K3's short kernel (``wgmma_short``) 32 times and no other K3 variant,
   and its logits and those of an fp32 12-token prefill
   (``wgmma_split_short``, 32) are held to the plain kernels'.
   zamba2-1.2b's reduced config (head dims 16, SSM P = N = 16, chunk
   16, fp32) serves through its own engine: K2's wgmma_f32 and K3's
   wgmma_split_short once a layer, logits held to the plain kernels'.
   (i) Then serves the other families at full width, each freed from the
   card before the next: mixtral-8x7b (8 of 32 layers, bf16 parameters;
   4 x 6144 prompt tokens, past its 4096-token window, 32 new),
   deepseek-v3-671b (4 of 61 layers, 3 dense + 1 MoE, no MTP block, bf16
   parameters; 2 x 1024, 8 new), rwkv6-3b (4 x 512, 16 new), qwen2-vl-7b
   (4 x 2048, 16 new) through ``ServeEngine(device="cuda")``, and
   whisper-large-v3 (4 x 1500 stub frames, a 64-token prompt, 16 new)
   through ``EncDecModel.prefill`` and ``decode_step``.  For each: init
   seconds and peak, prefill seconds, decode tokens/s, peak memory, K2's
   launches by variant per prefill (8, 0, 0, 28 and 96 wgmma), a profiler
   trace of one prefill, finite logits; for mixtral, qwen2-vl and whisper
   also 2 layers of full width in fp32, one request, logits at every
   prompt position on the kernels against ``plain_kernels()``.
   (j) Then trains zamba2-1.2b through the port's training path, where
   K2 and K3 run as the forwards of autograd Functions whose backward is
   the plain version recomputed: (j1) at full width and 6 layers, one
   2048-token sequence, ``lm_loss`` and every gradient on the kernels
   against ``plain_kernels()`` in fp32 (worst leaf within 1e-3 of its
   scale) and in bf16 (each leaf's distance to the fp32 gradients
   against the plain bf16 run's: within 1.10x on the mean over leaves,
   1.25x on the worst), every leaf's gradient nonzero (q/k/v, each
   layer's in_proj); (j2) at full width and depth, fp32 params, bf16 compute,
   remat "dots", 4 AdamW steps of 8 x 2048 tokens in 2 microbatches
   through ``Trainer`` over ``GridSession.token_dataset``: per step the
   loss, grad norm, seconds, tokens/s, K2 and K3 launches by variant
   (12 and 128 wgmma) and peak memory, the loss on step 0's batch
   before and after, and a profiler breakdown of one more step with the
   plain backwards' device time; (j3) ``Trainer`` resuming from its
   checkpoints on the card with every tensor equal.
   (k) Then the distributed layer on a one-rank NCCL process group: (k1)
   ``CellBuilder(zamba2-1.2b full, make_host_mesh(), "train")`` at
   phase (j)'s batch shape, batches from ``ColocatedTokenDataset`` over
   the mesh, two sharded steps against one mesh-less ``make_train_step``
   from the same state (loss within 1e-3 and grad norm within 1e-2
   relative, K2 12 and K3 128 wgmma launches a step), with the step
   seconds beside phase (j)'s: DTensor's host cost; then in fp32 at 6
   layers of full width, every leaf's gradient (read from AdamW's m
   after one step) against a mesh-less step's: (k1) ``CellBuilder``'s
   within the fp32 bound, (k2) ``make_compressed_train_step``'s on a
   (1, 1, 1) pod/data/model mesh within it plus half an int8 quantum
   (and the reference test's bounds: loss 5e-2, parameters 5e-3); (k3)
   prefill and one decode step through ``CellBuilder`` at the serving
   shape against the engine's (serving's bf16 rule against an fp32
   prefill; next tokens); (k4) the dry run of zamba2's train_4k cell on
   256 fake ranks and one rank's counts at phase (j)'s shape, in
   subprocesses, and MFU of phase (j)'s step, all labelled "(dry-run,
   H100 constants)".
7. Times K2's wgmma kernel, SDPA and the plain version in turns at the
   serving call, at qwen3-8b's D=128 GQA shape and at the reduced
   configs' head dims 16 and 32 (B 8, H 32, S 2048), each in bf16 and in
   fp32 (the wgmma_f32 instance), by loop time and, at D 16 and 32, the
   profiler's device time too; and K3's kernels and the plain version in
   turns at its serving call (bf16 B/C; f32 B/C for wgmma_split), below
   one chunk, at L = 1, 12 and 64 with B 8 and B 4 and bf16 and f32 B/C
   (the short kernel, the 128-step tile called directly), and at the
   reduced config's dims (P = N = 16, a configured chunk of 16, L 2048
   and 12 at B 8, bf16 and f32 B/C), each with its loop time, its device
   time from the profiler and its host time a call (the wrapper, and the
   C launchers inside it), and its distance to a float64 run of the plain
   version; K3 and K2's device-timed calls are timed right after the
   sweeps, in a process of its own (``--measure-apart``), whose profiler
   keeps every kernel record.  Then the norm and RoPE kernels at the long
   benchmark cell's mean request (norm ``[7208, 4096]``, RoPE q ``[1,
   7208, 32, 128]`` and k ``[1, 7208, 8, 128]``, bf16) beside the plain
   functions and, for the norm, ``F.rms_norm``: each kernel within one
   bf16 unit in the last place of the plain function.
8. Prints one JSON line of kernel measurements, the card line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.core import grid as grid_mod  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.core.balancer import NodeSpec  # noqa: E402
from repro_torch.core.frontend import GridFrontend  # noqa: E402
from repro_torch.core.grid import GridSession  # noqa: E402
from repro_torch.core.mapreduce import MapReduceEngine  # noqa: E402
from repro_torch.core.query import age_sex_predicate  # noqa: E402
from repro_torch.core.stats import (  # noqa: E402
    CountMinProgram,
    CountProgram,
    HyperLogLogProgram,
    MeanProgram,
    MomentsProgram,
    QuantileSketchProgram,
    VarianceProgram,
)
from repro_torch.core.table import TensorTable  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    ColocatedTokenDataset,
    image_population_table,
    population_covariates,
    synthetic_token_table,
)
from repro_torch.kernels.fused_fold import kernel as K  # noqa: E402
from repro_torch.kernels.fused_fold import ops as K_ops  # noqa: E402
from repro_torch.kernels.fused_fold.ops import (  # noqa: E402
    fused_fold,
    kernel_hbm_bytes,
    max_groups_for_smem,
)
from repro_torch.kernels.fused_fold.ref import fused_fold_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K2  # noqa: E402
from repro_torch.kernels.flash_attention import ops as K2_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
)
from repro_torch.kernels.norm_rope import ops as NR  # noqa: E402
from repro_torch.kernels.norm_rope.ref import (  # noqa: E402
    rms_norm_plain,
    rope_qk_plain,
)
from repro_torch.kernels.ssm_scan import kernel as K3  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as K3_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    ssd_chunked_ref,
    ssd_scan_sequential,
)
from repro_torch.configs import get_config, zamba2_1p2b  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    _pad_attn_cache,
    build_model,
    cast_for_compute,
    pad_caches,
)
from repro_torch.launch.mesh import (  # noqa: E402
    ensure_process_group,
    make_host_mesh,
)
from repro_torch.launch.roofline import model_flops  # noqa: E402
from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch.steps import CellBuilder  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    Init,
    distribute_tree,
    sharding_rules,
)
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainStepConfig,
    make_compressed_train_step,
    make_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
)

VOLUME = (91, 109, 91)          # MNI152 2 mm grid
SCALE = 1.0                     # 4,490 subjects (the paper's Table 3)
HBM_BPS = 3.35e12               # H100 SXM data sheet
FP32_FLOPS = 67e12              # H100 SXM data sheet, fp32 outside tensor cores
BF16_FLOPS = 989e12             # H100 SXM data sheet, bf16 dense tensor cores
DEV = "cuda"
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
        for G in (1, 2, 7, 64, gmax):
            for R, F in ((1, 1), (37, 130), (256, 1), (1000, 4097)):
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


def nonfinite_sweep():
    """NaN, Inf and 1e20 (whose square overflows f32) in VALID rows, with
    gids in and out of range: the kernel must give its plain version's
    NaN/Inf positions (the reference's: every other group's power sum is
    poisoned) and, where finite, its values; a re-launch the same bits."""
    rng = np.random.default_rng(2)
    cases = 0
    for G in (1, 2, 7, 64):
        for R, F in ((37, 130), (1000, 4097)):
            for bad in (np.inf, -np.inf, np.nan, 1e20):
                x = rng.normal(size=(R, F)).astype(np.float32)
                m = rng.random(R) > 0.3
                g = rng.integers(-1, G + 1, R).astype(np.int32)
                valid = np.nonzero(m)[0]
                for r in valid[:4]:
                    x[r, rng.integers(0, F, 3)] = bad
                x[np.nonzero(~m)[0][:2], :5] = bad
                xd = torch.from_numpy(x).cuda()
                md = torch.from_numpy(m).cuda()
                gd = torch.from_numpy(g).cuda()
                got = fused_fold(xd, md, gd, G)
                again = fused_fold(xd, md, gd, G)
                plain = K.fused_fold_torch(xd, gd, md.float(), G, NAMES)
                torch.cuda.synchronize()
                rtol, atol = (1e-3, 1e-2) if R * F > 10_000 else (1e-4, 1e-3)
                where = f"G={G} R={R} F={F} bad={bad}"
                poisoned = 0
                for n in NAMES:
                    a, b = got[n].cpu(), plain[n].cpu()
                    check(torch.equal(a.view(torch.int32),
                                      again[n].cpu().view(torch.int32)),
                          f"re-launch bits differ: {where} {n}")
                    for what in (torch.isnan, torch.isposinf,
                                 torch.isneginf):
                        check(torch.equal(what(a), what(b)),
                              f"{what.__name__} positions: {where} {n}")
                    fin = torch.isfinite(b)
                    check(torch.allclose(a[fin].double(), b[fin].double(),
                                         rtol=rtol, atol=atol),
                          f"finite values: {where} {n}")
                    poisoned += int((~fin).sum())
                check(poisoned > 0 and bool(torch.isfinite(got["count"])
                                            .all()),
                      f"no poisoned sums, or a poisoned count: {where}")
                cases += 1
    return cases


def weighted_oracle(x, m, g, G):
    """The fold in float64 NumPy for any row weights: count[g] sums m over
    rows with m != 0 and gid g; s_k[g] sums m * x^k over rows with m > 0
    and gid g (gids outside [0, G) add nothing)."""
    x = x.astype(np.float64)
    keep = (m != 0) & (g >= 0) & (g < G)
    pos = keep & (m > 0)
    out = {"count": np.zeros(G)}
    np.add.at(out["count"], g[keep], m[keep].astype(np.float64))
    for k in range(1, 5):
        acc = np.zeros((G, x.shape[1]))
        np.add.at(acc, g[pos], m[pos, None] * x[pos] ** k)
        out[f"s{k}"] = acc
    return out


def k1_edge_sweep():
    """Blocks the main sweep does not reach: longer than one row-list chunk
    (``LIST_ROWS`` rows), wholly masked (zeros and a zero count), and row
    weights -1, 0.5, 1, 0 with gids outside [0, G), straight through
    ``fused_fold_cuda``; on the register (G <= 8) and shared-memory paths.
    Each against the plain version and the float64 oracle; a re-launch
    gives the same bits."""
    rng = np.random.default_rng(3)
    cases = 0
    long_rows = 2 * K.LIST_ROWS + 808
    for what, R, F in (("long", long_rows, 257), ("masked", 300, 1000),
                       ("weights", 300, 1000), ("weights", 256, 1),
                       ("weights", long_rows, 33)):
        for G in (1, 2, 7, 64):
            x = rng.normal(size=(R, F)).astype(np.float32)
            g = rng.integers(-1, G + 1, R).astype(np.int32)
            if what == "long":
                m = (rng.random(R) > 0.3).astype(np.float32)
            elif what == "masked":
                m = np.zeros(R, np.float32)
            else:
                m = rng.choice(np.array([-1, 0.5, 1, 0], np.float32), R)
            x[m <= 0] = np.nan          # never read: zeroed before powers
            xd, md, gd = (torch.from_numpy(t).cuda() for t in (x, m, g))
            got = K.fused_fold_cuda(xd, gd, md, G, NAMES)
            again = K.fused_fold_cuda(xd, gd, md, G, NAMES)
            plain = K.fused_fold_torch(xd, gd, md, G, NAMES)
            torch.cuda.synchronize()
            oracle = weighted_oracle(x, m, g, G)
            where = f"{what} G={G} R={R} F={F}"
            for n in NAMES:
                a = got[n].cpu()
                check(torch.equal(a.view(torch.int32),
                                  again[n].cpu().view(torch.int32)),
                      f"re-launch bits differ: {where} {n}")
                for want, label in ((plain[n].cpu(), "plain"),
                                    (torch.from_numpy(oracle[n]), "f64")):
                    want = want.to(torch.float64)
                    tol = 0.0 if n == "count" else 1e-3
                    check(torch.allclose(a.double(), want, rtol=tol,
                                         atol=0.0 if n == "count" else 1e-2),
                          f"K1 vs {label}: {where} {n} max err "
                          f"{(a.double() - want).abs().max():.3g}")
                if what == "masked":
                    check(bool((a == 0).all()), f"masked block {n} not 0")
            cases += 1
    return cases


# ----------------------------------------------------------------------
# phase 4: K2 and K3 against their plain versions
# ----------------------------------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
#: (B, H, Hkv, Sq, Skv, D, causal, window, dtype): tests/test_kernels.py's
#: flash cases (GQA, MQA, ragged S, long KV, windows, bf16) and the
#: serving shape, which runs on [B, S, H, D] views as the model passes it
K2_BASE_CASES = [
    (1, 2, 2, 128, 128, 64, True, 0, F32),
    (2, 4, 2, 128, 128, 64, True, 0, F32),
    (1, 8, 1, 256, 256, 32, True, 0, F32),
    (1, 4, 2, 96, 96, 64, True, 0, F32),
    (2, 4, 4, 64, 256, 128, False, 0, F32),
    (1, 2, 2, 256, 256, 64, True, 32, F32),
    (1, 2, 2, 256, 256, 64, True, 64, F32),
    (1, 2, 2, 256, 256, 64, True, 127, F32),
    (1, 2, 2, 128, 128, 64, True, 0, BF16),
    (2, 4, 2, 96, 96, 64, True, 64, BF16),
    (8, 32, 32, 2048, 2048, 64, True, 0, BF16),
]
#: every geometry above but the serving shape, in bf16 and f16 (the wgmma
#: variant) and in f32 (wgmma_f32) at head dims 64 and 128, then qwen3-8b's
#: GQA heads at the serving batch and prompt: 32 query heads over 8 KV
#: heads of 128; then phase (i)'s calls in bf16 and f32; then every
#: geometry at head dims 16 and 32 in f32, bf16 and f16; then the reduced
#: zamba2 config's call (B 8, 4 heads of 16 over 64 tokens, fp32) and the
#: timed narrow calls (B 8, H 32, S 2048, D 16 and 32) in bf16 and f32
K2_GEOMETRIES = list(dict.fromkeys(
    (B, H, Hkv, Sq, Skv, causal, window)
    for B, H, Hkv, Sq, Skv, _, causal, window, _ in K2_BASE_CASES[:-1]))
#: phase (i)'s serving calls (B, H, Hkv, Sq, Skv, D, causal, window), at
#: batch 1 where the plain version's [B, H, Sq, Skv] fp32 scores would
#: not fit: mixtral (window 4096 past a 6144-token prompt), qwen2-vl,
#: whisper's encoder, cross-attention (Sq != Skv, not causal) and decoder
K2_FAMILY_CALLS = [
    (1, 32, 8, 6144, 6144, 128, True, 4096),
    (4, 28, 4, 2048, 2048, 128, True, 0),
    (4, 20, 20, 1500, 1500, 64, False, 0),
    (4, 20, 20, 64, 1500, 64, False, 0),
    (4, 20, 20, 64, 64, 64, True, 0),
]
K2_CASES = list(dict.fromkeys(K2_BASE_CASES + [
    (B, H, Hkv, Sq, Skv, D, causal, window, dt)
    for B, H, Hkv, Sq, Skv, causal, window in K2_GEOMETRIES
    for dt in (BF16, F16, F32) for D in (64, 128)
] + [(8, 32, 8, 2048, 2048, 128, True, 0, BF16)] + [
    (*call, dt) for dt in (BF16, F32) for call in K2_FAMILY_CALLS
] + [
    (B, H, Hkv, Sq, Skv, D, causal, window, dt)
    for B, H, Hkv, Sq, Skv, causal, window in K2_GEOMETRIES
    for dt in (F32, BF16, F16) for D in (16, 32)
] + [(8, 4, 4, 64, 64, 16, True, 0, F32)] + [
    (8, 32, 32, 2048, 2048, D, True, 0, dt)
    for D in (16, 32) for dt in (BF16, F32)
]))
#: f32 at the reference tests' 2e-5, scaled by 5 for the card's exp and
#: summation order; bf16 outputs at the reference's 2e-2, which also
#: covers P rounded to bf16 (2^-9 relative) before the second product;
#: f16 at 1e-2 (P rounded to 2^-12)
K2_TOL = {F32: 1e-4, BF16: 2e-2, F16: 1e-2}


def k2_sweep(gen):
    worst = {}
    for B, H, Hkv, Sq, Skv, D, causal, window, dt in K2_CASES:
        q = torch.randn(B, Sq, H, D, generator=gen, device=DEV).to(dt)
        k = torch.randn(B, Skv, Hkv, D, generator=gen, device=DEV).to(dt)
        v = torch.randn(B, Skv, Hkv, D, generator=gen, device=DEV).to(dt)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        where = (B, H, Hkv, Sq, Skv, D, causal, window, dt)
        ran = K2.variant(dt, D)
        before = K2.flash_attention_cuda.by_variant[ran]
        got = K2.flash_attention_cuda(q, k, v, D ** -0.5, causal, window)
        check(K2.flash_attention_cuda.by_variant[ran] == before + 1,
              f"K2 {where} did not run the {ran} variant")
        want = attention_ref(q, k, v, D ** -0.5, causal, window)
        torch.cuda.synchronize()
        check(got.dtype == dt and got.shape == want.shape, "K2 output")
        err = float((got.float() - want.float()).abs().max())
        tol = K2_TOL[dt]
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"K2 ({ran}) vs plain {where}: max err {err:.3g}")
        key = (ran, str(dt).replace("torch.", ""))
        n, w = worst.get(key, (0, 0.0))
        worst[key] = (n + 1, max(w, err))
    return len(K2_CASES), worst


#: (B, L, H, P, N, chunk, B/C dtype, decay low end): tests/test_kernels.py's
#: SSD cases (incl. L=100 padding), chunk invariance, the long strong-decay
#: case (x = 1, a = 0.5), with f32 B/C at the narrower dims and at P = N =
#: 64; at P = N = 64 and a configured chunk of 64; then each B/C dtype at
#: P = N = 64 and chunk 128 (bf16: wgmma, f32/f16: wgmma_split): one
#: chunk, a ragged L = 300, the long-decay case, sequences shorter than
#: one chunk (L = 1, 12, 64: the short kernel's one chunk padded to 64,
#: wgmma_short / wgmma_split_short; L = 100: one chunk padded to 128) and
#: the serving shape; then each B/C dtype at the reduced config's dims (P
#: = N = 16, chunk 16) for L from 1 to 2048 (its own call: B 8, L 64, 8
#: heads), and dims the wrapper zero-pads to multiples of 8 (P 12, N 20)
K3_CASES = [
    (1, 64, 1, 16, 16, 16, F32, 0.7),
    (2, 128, 2, 32, 16, 64, F32, 0.7),
    (1, 128, 4, 64, 64, 128, F32, 0.7),
    (1, 100, 2, 32, 32, 32, F32, 0.7),
    (1, 128, 2, 16, 16, 16, F32, 0.8),
    (1, 128, 2, 16, 16, 128, F32, 0.8),
    (1, 256, 1, 16, 16, 64, F32, None),
    (1, 256, 2, 64, 64, 64, F32, 0.7),
    (1, 256, 2, 64, 64, 64, BF16, 0.7),
] + [
    case for dt in (BF16, F32, F16) for case in (
        (1, 128, 4, 64, 64, 128, dt, 0.7),
        (2, 300, 3, 64, 64, 128, dt, 0.7),
        (1, 512, 2, 64, 64, 128, dt, None),
        (2, 1, 3, 64, 64, 128, dt, 0.7),
        (2, 12, 3, 64, 64, 128, dt, 0.7),
        (2, 64, 3, 64, 64, 128, dt, 0.7),
        (2, 100, 3, 64, 64, 128, dt, 0.7),
        (8, 2048, 64, 64, 64, 128, dt, 0.7),
    )
] + [
    case for dt in (BF16, F32, F16) for case in (
        (2, 1, 3, 16, 16, 16, dt, 0.7),
        (2, 12, 3, 16, 16, 16, dt, 0.7),
        (8, 64, 8, 16, 16, 16, dt, 0.7),
        (2, 65, 3, 16, 16, 16, dt, 0.7),
        (2, 200, 3, 16, 16, 16, dt, 0.7),
        (1, 256, 2, 16, 16, 16, dt, None),
        (8, 2048, 64, 16, 16, 16, dt, 0.7),
        (2, 40, 3, 12, 20, 16, dt, 0.7),
    )
]
K3_TOL = 1e-4          # the reference suite's; relative on the serving shape


def k3_inputs(gen, B, L, H, P, N, bdt, lo):
    if lo is None:     # long-decay stability case
        return (torch.ones(B, L, H, P, device=DEV),
                torch.full((B, L, H), 0.5, device=DEV),
                torch.full((B, L, N), 0.1, device=DEV).to(bdt),
                torch.full((B, L, N), 0.1, device=DEV).to(bdt))
    x = torch.randn(B, L, H, P, generator=gen, device=DEV) * 0.5
    a = lo + (0.999 - lo) * torch.rand(B, L, H, generator=gen, device=DEV)
    # B and C as column slices of one wider tensor, as the model hands them
    xbc = (torch.randn(B, L, 2 * N + 8, generator=gen, device=DEV)
           * 0.3).to(bdt)
    return x, a, xbc[..., :N], xbc[..., N:2 * N]


def k3_sweep(gen):
    worst = {}
    for B, L, H, P, N, chunk, bdt, lo in K3_CASES:
        x, a, Bm, Cm = k3_inputs(gen, B, L, H, P, N, bdt, lo)
        where = (B, L, H, P, N, chunk, bdt, lo)
        ran = K3.variant(bdt, P, N, L)
        before = K3.ssd_scan_cuda.by_variant[ran]
        y, s = K3.ssd_scan_cuda(x, a, Bm, Cm, chunk)
        check(K3.ssd_scan_cuda.by_variant[ran] == before + 1,
              f"K3 {where} did not run the {ran} variant")
        yp, sp = ssd_chunked_ref(x, a, Bm, Cm, min(chunk, L))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"K3 non-finite {where}")
        scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
        n, w = worst.get(ran, (0, 0.0))
        for got, want, what in ((y, yp, "y"), (s, sp, "state")):
            err = float((got - want).abs().max())
            check(err <= K3_TOL * scale,
                  f"K3 ({ran}) {what} vs plain {where}: max err {err:.3g} "
                  f"(scale {scale:.3g})")
            w = max(w, err)
        worst[ran] = (n + 1, w)
        if B * H * L <= 2048:          # the literal recurrence, small cases
            xs = x.permute(0, 2, 1, 3).reshape(B * H, L, P)
            as_ = a.permute(0, 2, 1).reshape(B * H, L)
            Bs = Bm[:, None].expand(B, H, L, N).reshape(B * H, L, N)
            Cs = Cm[:, None].expand(B, H, L, N).reshape(B * H, L, N)
            yq, sq = ssd_scan_sequential(xs, as_, Bs, Cs)
            yq = yq.reshape(B, H, L, P).permute(0, 2, 1, 3)
            check(torch.allclose(y, yq, rtol=K3_TOL, atol=K3_TOL * scale)
                  and torch.allclose(s, sq.reshape(B, H, P, N),
                                     rtol=K3_TOL, atol=K3_TOL * scale),
                  f"K3 ({ran}) vs the sequential recurrence {where}")
        if lo is None:                 # geometric series bound
            check(float(s.abs().max()) < 2 * 0.1 / 0.5, "K3 long decay")
    return len(K3_CASES), worst


#: K3 from a random initial state: f32 B/C at the narrower dims and at a
#: chunk of 64; each B/C dtype at P = N = 64 and chunk 128 (the instance
#: as serving picks it; below 65 steps also the 128-step tile called
#: directly), incl. a ragged L, L = 1, 12, 64 (the short kernel, bf16 and
#: f32 B/C), 100 (one padded chunk) and the serving shape; then bf16 and
#: f32 B/C at the reduced config's dims (P = N = 16, chunk 16) for L from 1
#: to 2048, and padded dims (P 12, N 20)
K3_STATE_CASES = [
    (1, 64, 1, 16, 16, 16, F32),
    (1, 100, 2, 32, 32, 32, F32),
    (1, 256, 2, 64, 64, 64, F32),
] + [
    case for dt in (BF16, F32, F16) for case in (
        (1, 128, 4, 64, 64, 128, dt),
        (2, 300, 3, 64, 64, 128, dt),
        (8, 2048, 64, 64, 64, 128, dt),
    )
] + [(2, L, 3, 64, 64, 128, dt) for dt in (BF16, F32)
      for L in (1, 12, 64, 100)] + [
    (B, L, H, 16, 16, 16, dt) for dt in (BF16, F32)
    for B, L, H in ((2, 1, 3), (2, 12, 3), (8, 64, 8), (2, 65, 3),
                    (2, 200, 3), (8, 2048, 64))
] + [(2, 40, 3, 12, 20, 16, dt) for dt in (BF16, F32)]


def k3_state_sweep(gen):
    """Each kernel from a random initial state against ``ssd_chunked_ref``
    from that state, within the K3 check's 1e-4 x max(1, max|y|, max|S|);
    -> ({variant: (cases, worst error)}."""
    worst = {}
    for B, L, H, P, N, chunk, bdt in K3_STATE_CASES:
        x, a, Bm, Cm = k3_inputs(gen, B, L, H, P, N, bdt, 0.7)
        s0 = torch.randn(B, H, P, N, generator=gen, device=DEV)
        yp, sp = ssd_chunked_ref(x, a, Bm, Cm, min(chunk, L), s0)
        scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
        ran = K3.variant(bdt, P, N, L)
        runs = [(ran, K3.ssd_scan_cuda)]
        if ran.endswith("_short"):         # the 128-step tile, directly
            runs.append((ran.removesuffix("_short"),
                         functools.partial(K3.ssd_scan_cuda, tile=128)))
        for ran, fn in runs:
            y, s = fn(x, a, Bm, Cm, chunk, init_state=s0)
            torch.cuda.synchronize()
            err = max(float((y - yp).abs().max()),
                      float((s - sp).abs().max()))
            check(err <= K3_TOL * scale,
                  f"K3 ({ran}) from a state {(B, L, H, P, N, chunk, bdt)}: "
                  f"max err {err:.3g} (scale {scale:.3g})")
            n, w = worst.get(ran, (0, 0.0))
            worst[ran] = (n + 1, max(w, err / scale))
    return worst


def continuity_check(gen):
    """One Mamba2 layer of zamba2-1.2b at full width (d_model 2048, 64
    heads of P 64, N 64, chunk 128), random weights: ``ssm_full`` over the
    serving prompt (8 x 2048 tokens) against 1024 tokens and then 1024 from
    the returned conv and SSM state, with bf16 activations (the wgmma
    kernel, as serving runs it) and fp32 (its split instance).  The scan
    calls are captured: the chained scans (the second from the first's
    state) must equal one scan over the same 2048 steps within the K3
    check's 1e-4 x max(1, max|y|, max|S|); their inputs and the conv state
    are compared with the whole prompt's.  -> {dtype: measurements}."""
    base = zamba2_1p2b.full()
    p = ssm_mod.init_ssm(base, Init(gen, DEV))
    out = {}
    for dt in (BF16, F32):
        cfg = dataclasses.replace(base, dtype=dt)
        x = torch.randn(SERVE_B, SERVE_PROMPT, cfg.d_model, generator=gen,
                        device=DEV).to(dt)
        calls = []
        inner = ssm_mod.ssd_scan

        def capture(*args, **kw):
            y, s = inner(*args, **kw)
            calls.append((args[:4], y, s))
            return y, s

        before = dict(K3.ssd_scan_cuda.by_variant)
        ssm_mod.ssd_scan = capture
        try:
            _, whole = ssm_mod.ssm_full(cfg, p, x)
            h = SERVE_PROMPT // 2
            _, mid = ssm_mod.ssm_full(cfg, p, x[:, :h])
            _, end = ssm_mod.ssm_full(cfg, p, x[:, h:], mid)
        finally:
            ssm_mod.ssd_scan = inner
        ran = "wgmma" if dt == BF16 else "wgmma_split"
        check(K3.ssd_scan_cuda.by_variant[ran] == before[ran] + 3,
              f"continuity ({dt}): the three scans did not all take {ran}")
        (in_w, y_w, s_w), (in_1, y_1, _), (in_2, y_2, s_2) = calls
        joined = [torch.cat([u, v], 1) for u, v in zip(in_1, in_2)]
        y_one, s_one = K3.ssd_scan_cuda(*joined, base.ssm.chunk)
        torch.cuda.synchronize()
        y_cat = torch.cat([y_1, y_2], 1)
        scale = max(1.0, float(y_one.abs().max()), float(s_one.abs().max()))
        err = max(float((y_cat - y_one).abs().max()),
                  float((s_2 - s_one).abs().max()))
        check(err <= K3_TOL * scale,
              f"continuity ({dt}): 1024 + 1024 from the state vs one scan:"
              f" max err {err:.3g} (scale {scale:.3g})")
        check(torch.equal(end["ssm"], s_2), "continuity: returned state")
        out[str(dt).replace("torch.", "")] = {
            "variant": ran, "err": err, "scale": scale,
            "input_gap": max(float((u.float() - v.float()).abs().max())
                             for u, v in zip(joined, in_w)),
            "vs_whole": max(float((y_cat - y_w).abs().max()),
                            float((s_2 - s_w).abs().max())),
            "conv_gap": float((end["conv"].float()
                               - whole["conv"].float()).abs().max()),
        }
        del calls, y_one, s_one, y_cat, joined
    # the comparison launches are not the main path's
    K3.reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 5: the population path at full size
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


@contextlib.contextmanager
def k1_shapes():
    """Count the fused folds by block: ``{(R, F, G, names): calls}``,
    through the op's one call site of the kernel wrapper (no sync)."""
    shapes = {}
    inner = K_ops.fused_fold_block

    def record(x, gids, mask, num_groups, names):
        key = (int(x.shape[0]), int(x.shape[1]), int(num_groups),
               tuple(names))
        shapes[key] = shapes.get(key, 0) + 1
        return inner(x, gids, mask, num_groups, names)

    K_ops.fused_fold_block = record
    try:
        yield shapes
    finally:
        K_ops.fused_fold_block = inner


def main_path(table):
    """Phases (a)-(f); returns the final grouped result, the measurements
    and the session, still open with its blocks resident."""
    with k1_shapes() as shapes:
        final, out, s = _main_path(table)
    out["k1_shapes"] = shapes
    check(sum(shapes.values()) == out["launches"],
          f"K1 launches {out['launches']} != folds by shape {shapes}")
    return final, out, s


def _main_path(table):
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
    del res, res2, res5, mres
    return final, out, s


def close_session(s):
    s.close()
    gc.collect()
    torch.cuda.empty_cache()


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
# phases (g) and (h): sketches and the frontend on the main path's session
# ----------------------------------------------------------------------

SKETCH_PROGRAMS = (
    ("count-min", CountMinProgram(depth=4, width=1024)),
    ("HyperLogLog", HyperLogLogProgram(p=12)),
    # U = 4096 <= depth x width: exact bucket counts
    ("quantile dense", QuantileSketchProgram(lo=-6.0, hi=7.0)),
    ("quantile count-min", QuantileSketchProgram(
        lo=-6.0, hi=7.0, log2_universe=16, depth=4, width=2048)),
)
WAIT_S = 600.0         # the bound on every wait of the frontend phase


def aged(q):
    return q.where(age_sex_predicate(20.0, 60.0), ["age"])


def sketch_invariants(table, program, res):
    """What a sketch over the selected voxels must hold exactly: ``n`` is
    each group's voxel count, every count-min lane sums to it, registers
    and quantiles lie in range."""
    age = table.column("idx", "age")
    sex = table.column("idx", "sex")
    sel = (age >= 20.0) & (age < 60.0)
    F = int(np.prod(VOLUME))
    check(list(res.keys) == [0, 1], "sketch group keys")
    v = res.values
    for gi, key in enumerate(res.keys):
        n = int((sel & (sex == key)).sum()) * F
        if isinstance(program, HyperLogLogProgram):
            regs = v["registers"][gi]
            check(int(regs.min()) >= 0
                  and int(regs.max()) <= 33 - program.p, "HLL registers")
            est = float(v["estimate"][gi])
            check(np.isfinite(est)
                  and 0 < est <= n * (1 + 4 * program.std_error()),
                  f"HLL estimate {est} for {n} items")
            continue
        check(int(v["n"][gi]) == n, f"sketch n {int(v['n'][gi])} != {n}")
        cm = v["cm"][gi].long()           # [U] dense, else [..., width]
        lanes = cm.sum(-1).reshape(-1)
        check(bool((lanes == n).all()), "a count-min lane lost items")
        if isinstance(program, QuantileSketchProgram):
            q = v["quantiles"][gi]
            check(bool(((q >= program.lo) & (q <= program.hi)).all()),
                  f"quantiles {q} out of range")


def fmix_card_vs_cpu(dev):
    """``_fmix32`` on the card and the CPU (and NumPy's uint32) at the
    edges and 10^6 random values."""
    rng = np.random.default_rng(5)
    h = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32),
        rng.integers(0, 2**32, 10**6, dtype=np.uint64).astype(np.uint32)])
    t = torch.from_numpy(h.astype(np.int64))
    cpu = stats_mod._fmix32(t)
    card = stats_mod._fmix32(t.to(dev)).cpu()
    check(torch.equal(card, cpu), "fmix32 differs between card and CPU")
    check(np.array_equal(cpu.numpy(), stats_mod._host_fmix32(h)),
          "fmix32 differs from uint32 arithmetic")
    return len(h)


def sketch_card_vs_cpu(table, dev):
    """One region's block at full width, age-masked, through every sketch
    program on the card and on the CPU: every int32 leaf the same bits."""
    region = next(iter(table.regions))
    sl = table.region_rows(region)
    block = np.array(table.column("img", "data")[sl])
    age = table.column("idx", "age")[sl]
    mask = (age >= 20.0) & (age < 60.0)
    where = {"card": dev, "cpu": torch.device("cpu")}
    engines = {k: MapReduceEngine(devices=[d], block_pad="none")
               for k, d in where.items()}
    secs = {k: 0.0 for k in where}
    leaves = 0
    for _, program in SKETCH_PROGRAMS:
        parts = {}
        for k, eng in engines.items():
            x = torch.from_numpy(block).to(where[k])
            p, t = timed(lambda: eng.fold_block(
                program, x, mask, 16, VOLUME, np.float32))
            secs[k] += t
            parts[k] = tree_leaves(p)
        for a, b in zip(parts["card"], parts["cpu"]):
            check(a.dtype == torch.int32 and torch.equal(a.cpu(), b),
                  f"{type(program).__name__}: card and CPU partials differ")
            leaves += 1
    return {"rows": block.shape[0], "items": block.size, "leaves": leaves,
            "card_s": secs["card"], "cpu_s": secs["cpu"],
            "rid": region.rid}


def sketch_phase(s, table):
    """Phase (g): the four sketch queries on the card over the resident
    blocks, each with its wall, rows, fold paths and memory above the
    blocks; then card against CPU bit for bit."""
    out = {}
    K.fused_fold_cuda.launches = 0
    for name, program in SKETCH_PROGRAMS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        paths0 = dict(s.engine.fold_path_counts)
        (res, rep), wall = timed(lambda: aged(
            s.scan().select("img:data")).group_by("idx:sex")
            .map(program).reduce().collect())
        paths = {k: v - paths0[k] for k, v in s.engine.fold_path_counts.items()}
        check(paths["kernel"] == 0 and paths["torch"] > 0,
              f"sketch fold paths {paths}")
        sketch_invariants(table, program, res)
        out[name] = {"wall": wall, "rows": rep.query.rows_folded,
                     "paths": paths, "n": [int(x) for x in
                                           res.values.get("n", [])],
                     "peak": torch.cuda.max_memory_allocated() - base,
                     "res": res}
    launches = K.fused_fold_cuda.launches
    check(launches == 0, f"sketch queries launched K1 {launches} times")
    qd = out["quantile dense"]["res"].values["quantiles"]
    qc = out["quantile count-min"]["res"].values["quantiles"]
    out["median_gap"] = float((qd - qc).abs().max())
    check(out["median_gap"] < 0.1, "dense and count-min medians disagree")
    for v in out.values():
        if isinstance(v, dict):
            v.pop("res")
    out["fmix_values"] = fmix_card_vs_cpu(s.devices[0])
    out["card_vs_cpu"] = sketch_card_vs_cpu(table, s.devices[0])
    return out


def fanout(n, fn):
    """``fn(i)`` on ``n`` client threads released by one barrier."""
    barrier = threading.Barrier(n, timeout=WAIT_S)
    errors = []

    def run(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        check(not t.is_alive(), "a frontend client hung")
    if errors:
        raise errors[0]


def result_leaves(x):
    if hasattr(x, "keys") and hasattr(x, "values") and not isinstance(x, dict):
        return [torch.as_tensor(np.asarray(x.keys))] + result_leaves(x.values)
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in result_leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in result_leaves(item)]
    return [x]


def same_bits(a, b):
    la, lb = result_leaves(a), result_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def max_gap(a, b):
    gap = 0.0
    for x, y in zip(result_leaves(a), result_leaves(b)):
        x, y = x.double().cpu(), y.double().cpu()
        check(torch.allclose(x, y, rtol=1e-4, atol=1e-3),
              "frontend result differs from its direct run")
        gap = max(gap, float((x - y).abs().max()))
    return gap


def fe_single_flight(s, fe):
    """Eight clients, one cold grouped Variance plan: one execution."""
    plan = aged(s.scan().select(["img:data"])).group_by(
        "idx:sex").map(VarianceProgram()).reduce()
    futs = [None] * 8
    hits0, scans0 = fe.stats.coalesce_hits, s.metrics.scans
    l0 = K.fused_fold_cuda.launches
    fanout(8, lambda i: futs.__setitem__(i, fe.submit(plan)))
    res = [f.result(timeout=WAIT_S)[0] for f in futs]
    launches = K.fused_fold_cuda.launches - l0
    out = {"hits": fe.stats.coalesce_hits - hits0,
           "executions": s.metrics.scans - scans0, "launches": launches}
    check(out["hits"] == 7 and out["executions"] == 1,
          f"single flight: {out}")
    check(all(same_bits(r, res[0]) for r in res), "clients got other bits")
    # a direct re-fold: drop the cached partials and finalized results
    s.blocks.clear_partials()
    s._results.clear()
    l1 = K.fused_fold_cuda.launches
    direct, _ = plan.collect()
    out["direct_launches"] = K.fused_fold_cuda.launches - l1
    check(launches > 0 and launches == out["direct_launches"],
          f"K1 launches: frontend {launches}, direct "
          f"{out['direct_launches']}")
    check(same_bits(direct, res[0]), "frontend bits differ from a re-fold")
    return out


def key_prefixes(s, n):
    """The first ``n`` thousand-row key prefixes (``sub001`` holds
    ``sub001000``-``sub001999``: seven or eight regions)."""
    return sorted({bytes(k)[:6].decode() for k in s.table.keys})[:n]


def fe_batched_tick(s, fe):
    """Mean, Variance and Moments over one cold key range, submitted
    together: one fused pass, one K1 launch per block."""
    programs = (MeanProgram, VarianceProgram, MomentsProgram)
    for prefix in key_prefixes(s, 3):
        plan = lambda P, p=prefix: s.scan(prefix=p).select(  # noqa: E731
            ["img:data"]).map(P()).reduce()
        merges0 = fe.stats.batch_merges
        l0 = K.fused_fold_cuda.launches
        futs = [None] * 3
        fanout(3, lambda i: futs.__setitem__(i, fe.submit(
            plan(programs[i]))))
        got = [f.result(timeout=WAIT_S) for f in futs]
        if fe.stats.batch_merges > merges0:
            break
    rep = got[0][1].query
    out = {"merges": fe.stats.batch_merges - merges0, "prefix": prefix,
           "launches": K.fused_fold_cuda.launches - l0,
           "blocks": rep.partials_total - rep.partials_reused,
           "regions": rep.regions_scanned}
    check(out["merges"] >= 1, "no batched tick merged the three plans")
    check(out["launches"] == out["blocks"] > 0,
          f"batched tick: {out['launches']} K1 launches for "
          f"{out['blocks']} blocks")
    out["gap"] = max(max_gap(g[0], plan(P).collect()[0])
                     for g, P in zip(got, programs))
    return out


def fe_mutation(s, fe):
    """Eight mixed queries in flight while three rows upload (once the
    first has answered): each answer is the pre-upload or the
    post-upload direct result, bit for bit."""
    variants = [
        lambda: aged(s.scan().select(["img:data"])).group_by(
            "idx:sex").map(MeanProgram()).reduce(),
        lambda: aged(s.scan().select(["img:data"])).group_by(
            "idx:sex").map(VarianceProgram()).reduce(),
        lambda: aged(s.scan().select(["img:data"])).map(
            MomentsProgram()).reduce(),
        lambda: aged(s.scan().select(["img:data"])).group_by(
            "idx:sex").map(CountProgram()).reduce()]
    pre = [v().collect()[0] for v in variants]
    rng = np.random.default_rng(2)
    keys = [f"sub{i:06d}y" for i in (777, 1777, 2777)]
    rows = {"img": {"data": rng.standard_normal((3,) + VOLUME,
                                                dtype=np.float32)},
            "idx": {"size": np.full(3, 10_000_000),
                    "age": np.array([25.0, 35.0, 45.0], np.float32),
                    "sex": np.array([0, 1, 1], np.int8)}}
    futs = [None] * 8
    muts0 = fe.stats.mutations
    answered = threading.Event()

    def client(i):
        if i == 8:         # upload once one query has answered
            check(answered.wait(WAIT_S), "no query answered")
            fe.upload(keys, rows)
        else:
            futs[i] = fe.submit(variants[i % 4]())
            futs[i].add_done_callback(lambda _: answered.set())

    fanout(9, client)
    got = [f.result(timeout=WAIT_S)[0] for f in futs]
    post = [v().collect()[0] for v in variants]
    check(fe.stats.mutations == muts0 + 1, "upload not applied")
    check(not same_bits(pre[3], post[3]), "upload changed no count")
    seen = {"pre": 0, "post": 0}
    for i, g in enumerate(got):
        if same_bits(g, pre[i % 4]):
            seen["pre"] += 1
        elif same_bits(g, post[i % 4]):
            seen["post"] += 1
        else:
            check(False, f"query {i} saw neither epoch's result")
    for k in keys:           # leave the table as the later phases expect
        check(fe.remove(rowkey=k) == 1, "cleanup remove")
    return seen


def fe_load(s, fe):
    """64 mixed submissions from 8 clients: queries/s and latency."""
    plans = [aged(s.scan(prefix=p).select(["img:data"])).group_by(
        "idx:sex").map(P()).reduce()
        for p in key_prefixes(s, 4)
        for P in (MeanProgram, VarianceProgram, CountProgram)]
    fe.stats.reset_latencies()
    served0 = fe.stats.served
    futs = [None] * 64

    def client(i):
        for j in range(8):
            k = i * 8 + j
            futs[k] = fe.submit(plans[(k * 5) % len(plans)])

    t0 = time.perf_counter()
    fanout(8, client)
    for f in futs:
        f.result(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    p50, p99 = fe.stats.latency_percentiles()
    check(fe.stats.served - served0 == 64, "load: not every query served")
    return {"wall": wall, "qps": 64 / wall, "p50": p50, "p99": p99,
            "distinct": len(plans)}


def frontend_phase(s):
    """Phase (h): ``GridFrontend(s, workers=8, tick_ms=2.0)`` over the
    main path's session; K1's count is read over the whole phase."""
    K.fused_fold_cuda.launches = 0
    with GridFrontend(s, workers=8, tick_ms=2.0) as fe:
        out = {"single": fe_single_flight(s, fe),
               "batched": fe_batched_tick(s, fe),
               "mutation": fe_mutation(s, fe),
               "load": fe_load(s, fe)}
        out["stats"] = fe.stats.snapshot()
    out["launches"] = K.fused_fold_cuda.launches
    check(out["launches"] > 0, "the frontend path never launched K1")
    return out


def report_phases(sk, fe, card):
    for name, _ in SKETCH_PROGRAMS:
        r = sk[name]
        log(f"sketch {name} over img:data, age 20-60, by sex, on {card}: "
            f"{r['wall']:.3f} s, {r['rows']} rows folded, fold paths "
            f"{r['paths']}, n by group {r['n']}, peak device memory above "
            f"the resident blocks {r['peak'] / 1e9:.3f} GB")
    c = sk["card_vs_cpu"]
    log(f"sketches card vs CPU at region {c['rid']} [{c['rows']} x "
        f"{int(np.prod(VOLUME))}] ({c['items'] / 1e6:.0f} M items, ages "
        f"20-60): {c['leaves']} int32 leaves equal bit for bit over the "
        f"four programs (card {c['card_s']:.2f} s, CPU {c['cpu_s']:.2f} s); "
        f"fmix32 equal on the card and the CPU at {sk['fmix_values']} "
        f"values; dense vs count-min median gap {sk['median_gap']:.4f}; "
        f"K1 launches during the sketch queries 0")
    a, b, m, ld = fe["single"], fe["batched"], fe["mutation"], fe["load"]
    st = fe["stats"]
    log(f"frontend on {card}: single flight, 8 clients: coalesce_hits "
        f"{a['hits']}, executions {a['executions']}, K1 launches "
        f"{a['launches']} (direct run {a['direct_launches']}), 8 results "
        f"the same bits as a direct re-fold; batched tick over prefix "
        f"{b['prefix']} ({b['regions']} regions): batch_merges "
        f"{b['merges']}, K1 launches {b['launches']} for {b['blocks']} "
        f"blocks, max gap to the direct runs {b['gap']:.3g}; upload under "
        f"8 queries: {m['pre']} pre-upload and {m['post']} post-upload "
        f"answers, each bit-equal to a direct run; K1 launches over the "
        f"phase {fe['launches']}")
    log(f"frontend load on {card}: 64 mixed submissions ({ld['distinct']} "
        f"distinct plans) from 8 clients in {ld['wall']:.3f} s = "
        f"{ld['qps']:.1f} queries/s, latency p50 {ld['p50'] * 1e3:.2f} ms, "
        f"p99 {ld['p99'] * 1e3:.2f} ms; stats submitted {st.submitted}, "
        f"served {st.served}, coalesce_hits {st.coalesce_hits}, "
        f"batch_merges {st.batch_merges}, partial_coalesce_hits "
        f"{st.partial_coalesce_hits}, ticks {st.ticks}")


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


def device_ms(fn, reps=20):
    """The card's time for one call of ``fn``: the profiler's device
    kernel time over ``reps`` calls, without the host's gaps between
    launches (which set the pace of a loop of small launches)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.time_range.elapsed_us() for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def fold_bound(sel, R, F, G, names, itemsize=4):
    """The least time of one fold on the card: the selected rows' payload,
    the mask and gids, and the sums moved once; the powers and weighted
    adds of the selected elements at the fp32 rate.  -> (ms, bound_by)."""
    n_wide = sum(1 for n in names if n != "count")
    top = max([int(n[1]) for n in names if n != "count"], default=0)
    need = sel * F * itemsize + R * 8 + (n_wide * G * F + G) * 4
    ops = sel * F * (2 * n_wide + max(0, top - 1)) + sel
    b_ms, o_ms = need / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations"), need


def time_fold(x, gd, mf, G, names):
    """K1 against its plain version on one block, then its time, the plain
    version's and one ``index_add_`` of the selected rows' payload (Σx
    only, the nearest single PyTorch call).  Comparison launches do not
    count."""
    before = K.fused_fold_cuda.launches
    got = K.fused_fold_cuda(x, gd, mf, G, names)
    plain = K.fused_fold_torch(x, gd, mf, G, names)
    torch.cuda.synchronize()
    err = max(float((got[n] - plain[n]).abs().max()) for n in names)
    for n in names:
        check(torch.allclose(got[n], plain[n], rtol=1e-4, atol=1e-3),
              f"K1 block {tuple(x.shape)} G={G} vs plain {n}")
    ms = event_ms(lambda: K.fused_fold_cuda(x, gd, mf, G, names), 50)
    dev_ms = device_ms(lambda: K.fused_fold_cuda(x, gd, mf, G, names), 50)
    plain_ms = event_ms(lambda: K.fused_fold_torch(x, gd, mf, G, names), 5)
    dump = torch.where(mf > 0, gd.long(), torch.full_like(gd.long(), G))
    acc = torch.zeros((G + 1, x.shape[1]), dtype=torch.float32, device=DEV)
    library_ms = event_ms(lambda: acc.index_add_(0, dump, x), 5)
    K.fused_fold_cuda.launches = before
    return err, ms, dev_ms, plain_ms, library_ms


def measure_block(table, shapes):
    """K1 at the main path's blocks, each timed alone: the largest
    region's ``img:data`` block of the grouped query (its pow2 bucket, the
    rows aged 20-60 selected, G = 2 by sex, all five sums); the Mean run's
    most frequent block (``shapes``: its rows of that region, all real,
    G = 1, its sums); and the same region's ``idx:age`` block (``[bucket x
    1]``, as the grouped query folds it)."""
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
    F = x.shape[1]
    sel = int(m.sum())
    blocks = {"grouped": (x, gd, mf, 2, NAMES, sel, rows)}

    mean_key = max((k for k in shapes if k[2] == 1 and k[1] == F),
                   key=lambda k: shapes[k], default=None)
    check(mean_key is not None, f"no G=1 fold of F={F} on the main path: "
                                f"{shapes}")
    R_mean, names_mean = mean_key[0], mean_key[3]
    blocks["mean"] = (x[:R_mean].contiguous(),
                      torch.zeros(R_mean, dtype=torch.int32, device=DEV),
                      (torch.arange(R_mean, device=DEV) < rows).float(), 1,
                      names_mean, min(R_mean, rows), min(R_mean, rows))
    xa = torch.zeros((bucket, 1), dtype=torch.float32)
    xa[:rows, 0] = torch.from_numpy(age.astype(np.float32))
    blocks["age"] = (xa.cuda(), gd, mf, 2, NAMES, sel, rows)

    out = {}
    for name, (xb, gb, mb, G, names, nsel, real) in blocks.items():
        err, ms, dev_ms, plain_ms, library_ms = time_fold(xb, gb, mb, G,
                                                          names)
        bound_ms, bound_by, need = fold_bound(nsel, xb.shape[0],
                                              xb.shape[1], G, names)
        hbm = kernel_hbm_bytes(xb.shape[0], xb.shape[1], 4, names, G)
        out[name] = {
            "rows": real, "bucket": xb.shape[0], "selected": nsel,
            "F": xb.shape[1], "G": G, "names": names,
            "calls": shapes.get((xb.shape[0], xb.shape[1], G,
                                 tuple(names)), 0),
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "kernel_hbm_gbps": hbm / ms / 1e6,
            "need_gbps": need / ms / 1e6,
        }
    return out


# ----------------------------------------------------------------------
# phase 6: zamba2-1.2b serving at full width and depth
# ----------------------------------------------------------------------

SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 2048, 64
SERVE_HEADS, SERVE_SSM_HEADS = 32, 64       # zamba2-1.2b's attention, SSM
#: the serving launcher's default prompt (launch/serve.py), shorter than
#: one SSD chunk; the reduced config's prompt (4 of its 16-step chunks)
SHORT_PROMPT, REDUCED_PROMPT, REDUCED_NEW = 12, 64, 8
#: Kernel run against plain-kernel run.  With random weights the model in
#: bf16 drifts far from its own fp32 computation (about 30% relative in the
#: last hidden state, measured on the card), and any two bf16 runs whose
#: fp32 kernels merely sum in other orders drift apart as far.  So the
#: kernels are held to their plain versions twice: with fp32 activations,
#: where the gap is the kernels' own (logits are O(1): 2e-2 is 1/50 of one
#: standard deviation), and in bf16 against the bf16 noise floor: the
#: kernel run may be no further from the fp32 run than the plain bf16 run
#: is, within 10% on the mean |Δlogit| and 25% on the largest.
F32_LOGIT_TOL = 2e-2
F32_GREEDY_MIN = 0.98
BF16_MEAN_RATIO, BF16_MAX_RATIO = 1.10, 1.25


def only(kernel, **n):
    """``by_variant`` of K2 or K3 (``kernel``) after a run that launched
    just ``n`` of its variants."""
    return dict(dict.fromkeys(kernel.VARIANTS, 0), **n)


def plain_ssd(x, a, Bm, Cm, chunk, init_state=None):
    return ssd_chunked_ref(x, a, Bm, Cm, min(chunk, x.shape[1]), init_state)


@contextlib.contextmanager
def plain_kernels():
    """The forward hooks of the model's kernel Functions (``K2_ops.FORWARD``,
    ``K3_ops.FORWARD``, ``NR.NORM_FORWARD``, ``NR.ROPE_FORWARD``) pointed at
    the kernels' plain versions (``attention_ref``; ``ssd_chunked_ref`` from
    the given state; ``rms_norm_plain``; ``rope_qk_plain``); undone on exit,
    where the norm and RoPE kernels must have launched nothing.  The
    wrappers are never reached while it is active, and the Functions'
    backwards (the plain versions recomputed) are those of the kernel
    runs."""
    saved = (K2_ops.FORWARD, K3_ops.FORWARD, NR.NORM_FORWARD,
             NR.ROPE_FORWARD)
    before = nr_launches()
    (K2_ops.FORWARD, K3_ops.FORWARD, NR.NORM_FORWARD,
     NR.ROPE_FORWARD) = (attention_ref, plain_ssd, rms_norm_plain,
                         rope_qk_plain)
    try:
        yield
        check(nr_launches() == before,
              f"plain-kernel run launched the norm or RoPE kernel: "
              f"{before} -> {nr_launches()}")
    finally:
        (K2_ops.FORWARD, K3_ops.FORWARD, NR.NORM_FORWARD,
         NR.ROPE_FORWARD) = saved


def nr_launches():
    return NR.rms_norm_cuda.launches, NR.rope_cuda.launches


@contextlib.contextmanager
def nr_counted():
    """The norm and RoPE launches of one main path: the counters zeroed,
    the model's calls of ``NR.rms_norm`` and ``NR.rope`` counted beside
    them; the dict it yields gets ``norm``/``rope`` (launches) and
    ``norm_calls``/``rope_calls`` on exit, where every call must have
    launched its kernel once."""
    out = {}
    calls = {"norm_calls": 0, "rope_calls": 0}
    saved = NR.rms_norm, NR.rope

    def norm(*a, **k):
        calls["norm_calls"] += 1
        return saved[0](*a, **k)

    def rope(*a, **k):
        calls["rope_calls"] += 1
        return saved[1](*a, **k)

    NR.reset_counts()
    NR.rms_norm, NR.rope = norm, rope
    try:
        yield out
    finally:
        NR.rms_norm, NR.rope = saved
    out.update(calls, norm=NR.rms_norm_cuda.launches,
               rope=NR.rope_cuda.launches)
    check(out["norm"] == out["norm_calls"] > 0
          and out["rope"] == out["rope_calls"] > 0,
          f"norm and RoPE calls against launches: {out}")


def teacher_forced(model, cfg, params, capacity, prompts, tokens):
    """``[B, steps, V]`` fp32 logits: the prefill's, then each decode
    step's when ``tokens`` (the kernel run's greedy stream) is fed in."""
    B, S = prompts.shape
    logits, caches = model.prefill(params, prompts)
    caches = pad_caches(cfg, caches, capacity)
    out = [logits.float()]
    for i in range(tokens.shape[1] - 1):
        pos = torch.full((B,), S + i, dtype=torch.int64, device=DEV)
        logits, caches = model.decode_step(params, tokens[:, i], pos, caches)
        out.append(logits.float())
    return torch.stack(out, dim=1)


def gaps(a, b):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def profiled(fn):
    """Run ``fn`` under the profiler -> (host seconds, the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(fn)
    return wall, prof


def device_breakdown(fn):
    """Run ``fn`` under the profiler -> (host seconds, {category: device
    seconds}, {category: kernel count}, the five longest kernel names with
    their seconds and counts).  cuBLAS's Hopper GEMMs are named
    ``nvjet_*`` or ``sm90_xmma_*``."""
    return breakdown(*profiled(fn))


def breakdown(wall, prof):
    """:func:`device_breakdown`'s result from a profile."""
    secs, calls, by_name = {}, {}, {}
    for evt in prof.events():
        # a record_function range also shows as a device-side annotation
        # spanning its kernels: not a kernel of its own
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        name = evt.name.lower()
        if "flash_wgmma_kernel" in name:
            cat = "K2"
        elif "flash_wgmma_split_kernel" in name:
            cat = "K2 f32"
        elif "ssd_wgmma_kernel" in name:
            cat = "K3"
        elif "ssd_short_kernel" in name:
            cat = "K3 short"
        elif "split_bc_kernel" in name:
            cat = "K3 pre-pass"
        elif "rmsnorm_rows_kernel" in name:
            cat = "norm"
        elif "rope_qk_kernel" in name:
            cat = "rope"
        elif "memcpy" in name or "memset" in name:
            cat = "copy"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "nvjet",
                                     "cublas")):
            cat = "matmul"
        else:
            cat = "other"
        us = evt.time_range.elapsed_us()
        secs[cat] = secs.get(cat, 0.0) + us / 1e6
        calls[cat] = calls.get(cat, 0) + 1
        t, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (t + us / 1e6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return wall, secs, calls, top


def serve_path():
    """zamba2-1.2b through ``ServeEngine(device="cuda")``; returns the
    measurements."""
    cfg = zamba2_1p2b.full()
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device=DEV,
                            dtype=torch.int32).cpu().numpy()
    engine = ServeEngine(cfg, params, capacity=SERVE_PROMPT + SERVE_NEW + 1,
                         batch_size=SERVE_B, device=DEV)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"init_s": time.perf_counter() - t0, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count()}
    engine.generate(prompts[:, :256], 2)          # warm-up: libraries, plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K2.reset_counts()
    K3.reset_counts()
    with nr_counted() as nr:
        res = engine.generate(prompts, SERVE_NEW)
    out["nr_launches"] = nr
    out["launches"] = {"K2": K2.flash_attention_cuda.launches,
                       "K3": K3.ssd_scan_cuda.launches}
    out["k2_variants"] = dict(K2.flash_attention_cuda.by_variant)
    out["k3_variants"] = dict(K3.ssd_scan_cuda.by_variant)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    kinds = cfg.layer_kinds()
    want = {"K2": kinds.count("attn_shared") + kinds.count("attn"),
            "K3": kinds.count("ssm")}          # 6 and 32 for zamba2-1.2b
    check(out["launches"] == want,
          f"launches per prefill {out['launches']} != {want}")
    check(out["k2_variants"] == only(K2, wgmma=want["K2"]),
          f"bf16 prefill K2 variants {out['k2_variants']}")
    check(out["k3_variants"] == only(K3, wgmma=want["K3"]),
          f"bf16 prefill K3 variants {out['k3_variants']}")
    check(res.tokens.shape == (SERVE_B, SERVE_NEW)
          and 0 <= res.tokens.min() and res.tokens.max() < cfg.vocab,
          "generated tokens")
    out["prefill_s"] = res.prefill_s
    out["decode_s"] = res.decode_s
    out["decode_tok_s"] = SERVE_B * (SERVE_NEW - 1) / res.decode_s

    pr = torch.as_tensor(prompts, dtype=torch.int64, device=DEV)
    toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=DEV)
    with nr_counted() as nr:
        wall, secs, calls, top = device_breakdown(
            lambda: engine.model.prefill(engine.params, pr))
    out["nr_prefill"] = nr
    check(calls.get("K2") == want["K2"] and calls.get("K3") == want["K3"]
          and calls.get("norm") == nr["norm"]
          and calls.get("rope") == nr["rope"],
          f"profiler kernel names per prefill: {calls}, norm and RoPE "
          f"launches {nr}")
    out["prefill_trace"] = (wall, secs, calls, top)
    _, caches = engine.model.prefill(engine.params, pr)
    caches = pad_caches(cfg, caches, engine.capacity)
    pos = torch.full((SERVE_B,), SERVE_PROMPT, dtype=torch.int64,
                     device=DEV)
    out["decode_trace"] = device_breakdown(
        lambda: engine.model.decode_step(engine.params, toks[:, 0], pos,
                                         caches))
    del caches

    run = (engine.model, cfg, engine.params, engine.capacity, pr, toks)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = cast_for_compute(cfg32, engine.params, DEV)
    run32 = (build_model(cfg32), cfg32, params32, engine.capacity, pr, toks)
    K2.reset_counts()
    K3.reset_counts()
    kern = teacher_forced(*run)
    bf16_variants = (dict(K2.flash_attention_cuda.by_variant),
                     dict(K3.ssd_scan_cuda.by_variant))
    K2.reset_counts()
    K3.reset_counts()
    kern32 = teacher_forced(*run32)
    out["f32_k2_variants"] = dict(K2.flash_attention_cuda.by_variant)
    out["f32_k3_variants"] = dict(K3.ssd_scan_cuda.by_variant)
    check(bf16_variants[0] == only(K2, wgmma=want["K2"])
          and out["f32_k2_variants"] == only(K2, wgmma_f32=want["K2"]),
          f"teacher-forced K2 variants: bf16 {bf16_variants[0]}, fp32 "
          f"{out['f32_k2_variants']}")
    check(bf16_variants[1] == only(K3, wgmma=want["K3"])
          and out["f32_k3_variants"] == only(K3, wgmma_split=want["K3"]),
          f"teacher-forced K3 variants: bf16 {bf16_variants[1]}, fp32 "
          f"{out['f32_k3_variants']}")
    K2.reset_counts()
    k3_before = K3.ssd_scan_cuda.launches
    with plain_kernels():
        plain, plain32 = teacher_forced(*run), teacher_forced(*run32)
    check(K2.flash_attention_cuda.launches == 0
          and K3.ssd_scan_cuda.launches == k3_before,
          "plain-kernel runs launched a kernel")
    out["prefill32_s"] = kernel_vs_plain_s(
        lambda: run32[0].prefill(params32, pr))
    out["short"] = short_prefill(engine, run32[0], params32, prompts, want)
    del params32
    check(all(bool(torch.isfinite(t).all())
              for t in (kern, plain, kern32, plain32)), "non-finite logits")
    out["logit_max_err"], out["logit_mean_err"] = gaps(kern, plain)
    out["prefill_logit_max_err"] = gaps(kern[:, 0], plain[:, 0])[0]
    out["f32_max_err"], out["f32_mean_err"] = gaps(kern32, plain32)
    out["kern_to_f32"] = gaps(kern, plain32)
    out["plain_to_f32"] = gaps(plain, plain32)
    out["logit_absmax"] = float(plain32.abs().max())
    out["greedy_self"] = float(
        (kern.argmax(-1).cpu().numpy() == res.tokens).mean())
    out["greedy_plain"] = float(
        (plain.argmax(-1).cpu().numpy() == res.tokens).mean())
    out["greedy_f32"] = float(
        (kern32.argmax(-1) == plain32.argmax(-1)).float().mean())
    check(out["greedy_self"] == 1.0,
          "teacher-forced kernel run disagrees with generate()")
    check(out["f32_max_err"] <= F32_LOGIT_TOL
          and out["greedy_f32"] >= F32_GREEDY_MIN,
          f"fp32 kernel vs plain logits: max {out['f32_max_err']:.3g}, "
          f"greedy agreement {out['greedy_f32']:.3f}")
    (km, kmean), (pm, pmean) = out["kern_to_f32"], out["plain_to_f32"]
    check(kmean <= BF16_MEAN_RATIO * pmean and km <= BF16_MAX_RATIO * pm,
          f"bf16 kernel run further from fp32 than the plain run: mean "
          f"{kmean:.3g} vs {pmean:.3g}, max {km:.3g} vs {pm:.3g}")
    del engine, kern, plain, kern32, plain32
    gc.collect()
    torch.cuda.empty_cache()
    out["reduced"] = reduced_serve()
    return out


def kernel_vs_plain_s(fn):
    """Seconds of ``fn()`` on the kernels and under ``plain_kernels()``,
    each the mean of two timed runs in turns (kernels, plain, plain,
    kernels) after one untimed run of each: a shape's first run pays
    allocations and library set-up, whichever side it falls on."""
    def plain():
        with plain_kernels():
            return fn()

    fn()
    plain()
    secs = {"kernels": [], "plain": []}
    for name, f in (("kernels", fn), ("plain", plain), ("plain", plain),
                    ("kernels", fn)):
        secs[name].append(timed(f)[1])
    return {name: sum(t) / len(t) for name, t in secs.items()}


def short_prefill(engine, model32, params32, prompts, want):
    """The serving launcher's default prompt of SHORT_PROMPT tokens,
    shorter than one SSD chunk: generated through the engine in bf16 (K3
    must run its short kernel once a layer, ``wgmma_short``: one chunk
    padded to 64 steps, and no other K3 variant), then its prefill logits
    on the kernels in bf16 and fp32 (``wgmma_split_short``) against
    ``plain_kernels()``, with the full prompt's tolerances."""
    p = prompts[:, :SHORT_PROMPT]
    reset_kernel_counts()
    with nr_counted() as nr:
        res = engine.generate(p, 4)
    out = {"k2": dict(K2.flash_attention_cuda.by_variant),
           "k3": dict(K3.ssd_scan_cuda.by_variant),
           "prefill_s": res.prefill_s, "nr_launches": nr}
    check(out["k2"] == only(K2, wgmma=want["K2"])
          and out["k3"] == only(K3, wgmma_short=want["K3"]),
          f"{SHORT_PROMPT}-token bf16 prefill: K2 {out['k2']}, K3 "
          f"{out['k3']}")
    pr = torch.as_tensor(p, dtype=torch.int64, device=DEV)
    reset_kernel_counts()
    kern32 = model32.prefill(params32, pr)[0].float()
    out["k3_f32"] = dict(K3.ssd_scan_cuda.by_variant)
    check(out["k3_f32"] == only(K3, wgmma_split_short=want["K3"]),
          f"{SHORT_PROMPT}-token fp32 prefill: K3 {out['k3_f32']}")
    kern = engine.model.prefill(engine.params, pr)[0].float()
    with plain_kernels():
        plain = engine.model.prefill(engine.params, pr)[0].float()
        plain32 = model32.prefill(params32, pr)[0].float()
    check(all(bool(torch.isfinite(t).all())
              for t in (kern, plain, kern32, plain32)),
          f"{SHORT_PROMPT}-token prefill: non-finite logits")
    out["f32_max_err"], _ = gaps(kern32, plain32)
    out["greedy_f32"] = float(
        (kern32.argmax(-1) == plain32.argmax(-1)).float().mean())
    check(out["f32_max_err"] <= F32_LOGIT_TOL
          and out["greedy_f32"] >= F32_GREEDY_MIN,
          f"{SHORT_PROMPT}-token fp32 prefill vs plain: max "
          f"{out['f32_max_err']:.3g}, greedy {out['greedy_f32']:.3f}")
    (km, kmean), (pm, pmean) = gaps(kern, plain32), gaps(plain, plain32)
    out["kern_to_f32"], out["plain_to_f32"] = (km, kmean), (pm, pmean)
    check(kmean <= BF16_MEAN_RATIO * pmean and km <= BF16_MAX_RATIO * pm,
          f"{SHORT_PROMPT}-token bf16 prefill further from fp32 than the "
          f"plain run: mean {kmean:.3g} vs {pmean:.3g}, max {km:.3g} vs "
          f"{pm:.3g}")
    return out


def reduced_serve():
    """zamba2-1.2b's reduced config (head dims 16, SSM P = N = 16, chunk
    16, fp32) through its own ``ServeEngine``: the narrow instances.  Its
    prefill of REDUCED_PROMPT tokens must take K2's wgmma_f32 once an
    attention layer and K3's wgmma_split_short (one chunk padded to 64
    steps) once an SSM layer, and nothing else; the prefill logits on the
    kernels against ``plain_kernels()`` at the fp32 tolerance."""
    cfg = get_config("zamba2_1p2b", reduced=True)
    gen = torch.Generator(device=DEV).manual_seed(4)
    params = build_model(cfg).init(gen, DEV)
    engine = ServeEngine(cfg, params, REDUCED_PROMPT + REDUCED_NEW + 1,
                         SERVE_B, device=DEV)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, REDUCED_PROMPT),
                            generator=gen, device=DEV,
                            dtype=torch.int32).cpu().numpy()
    kinds = cfg.layer_kinds()
    want = (only(K2, wgmma_f32=kinds.count("attn_shared")
                 + kinds.count("attn")),
            only(K3, wgmma_split_short=kinds.count("ssm")))
    reset_kernel_counts()
    with nr_counted() as nr:
        res = engine.generate(prompts, REDUCED_NEW)
    out = {"counts": kernel_counts(), "want": want,
           "prefill_s": res.prefill_s, "nr_launches": nr}
    check(out["counts"] == want,
          f"reduced config launches {out['counts']}, want {want}")
    pr = torch.as_tensor(prompts, dtype=torch.int64, device=DEV)
    kern = engine.model.prefill(engine.params, pr)[0].float()
    with plain_kernels():
        plain = engine.model.prefill(engine.params, pr)[0].float()
    out["max_err"], _ = gaps(kern, plain)
    check(bool(torch.isfinite(kern).all())
          and out["max_err"] <= F32_LOGIT_TOL,
          f"reduced config kernel vs plain logits: max {out['max_err']:.3g}")
    del engine, params
    free_card()
    return out


# ----------------------------------------------------------------------
# phase (i): the MoE, MLA, RWKV-6, M-RoPE and encoder-decoder families
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Family:
    """One serving family at full width: ``cut`` replaces config fields
    (only where memory forces it), ``cuts`` says so in words; ``k2`` is
    K2's wgmma launches per prefill; ``check`` runs the fp32 kernel-vs-
    plain comparison at 2 layers."""
    arch: str
    cut: tuple
    cuts: str
    batch: int
    prompt: int
    new: int
    k2: int
    check: bool


FAMILIES = (
    Family("mixtral_8x7b", (("n_layers", 8), ("param_dtype", BF16)),
           "8 of 32 layers; param_dtype bf16", 4, 6144, 32, 8, True),
    Family("deepseek_v3_671b", (("n_layers", 4), ("mtp_depth", 0),
                                ("param_dtype", BF16)),
           "4 of 61 layers (3 dense + 1 MoE); mtp_depth 0; param_dtype bf16",
           2, 1024, 8, 0, False),
    Family("rwkv6_3b", (), "none", 4, 512, 16, 0, False),
    Family("qwen2_vl_7b", (), "none", 4, 2048, 16, 28, True),
    # the prompt is the decoder's; 1,500 stub frames feed the encoder, and
    # K2 runs 32 encoder, 32 self- and 32 cross-attention calls
    Family("whisper_large_v3", (), "none", 4, 64, 16, 96, True),
)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def k2_counts():
    return dict(K2.flash_attention_cuda.by_variant)


def encdec_generate(model, params, frames, prompts, new, capacity):
    """Greedy whisper decoding through ``EncDecModel.prefill`` and
    ``decode_step`` (the engine serves decoder-only models, as the
    reference's does) -> (tokens [B, new], prefill s, decode s, the
    prefill's logits)."""
    B, S = prompts.shape
    t0 = time.perf_counter()
    logits, (caches, kv) = model.prefill(params, frames, prompts)
    state = (_pad_attn_cache(model.cfg, caches, capacity), kv)
    tok = torch.argmax(logits, dim=-1)
    first = logits
    out = [tok.cpu()]
    t1 = time.perf_counter()
    pos = torch.full((B,), S, dtype=torch.int64, device=DEV)
    for _ in range(new - 1):
        logits, state = model.decode_step(params, tok, pos, state)
        tok = torch.argmax(logits, dim=-1)
        pos = pos + 1
        out.append(tok.cpu())
    t2 = time.perf_counter()
    return torch.stack(out, dim=1).numpy(), t1 - t0, t2 - t1, first


def family_inputs(cfg, fam, gen, batch=None):
    """Seeded prompts ``[B, S]`` (int64 on the card) and, for whisper,
    frames ``[B, 1500, D]`` in the compute dtype."""
    B = batch or fam.batch
    prompts = torch.randint(0, cfg.vocab, (B, fam.prompt), generator=gen,
                            device=DEV)
    frames = None
    if cfg.is_encdec:
        frames = torch.randn(B, cfg.encoder.n_frames, cfg.d_model,
                             generator=gen, device=DEV).to(cfg.dtype)
    return prompts, frames


def f32_check(fam):
    """The family's full width at 2 layers in fp32, one request, its
    logits at every prompt position on the kernels and under
    ``plain_kernels()``; K2 must run its wgmma_f32 variant twice a layer
    stack (six times for whisper), and nothing else."""
    cut = dict(fam.cut, n_layers=2, dtype=F32, param_dtype=F32)
    cfg = get_config(fam.arch)
    if cfg.is_encdec:
        cut["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2)
    cfg = dataclasses.replace(cfg, **cut)
    gen = torch.Generator(device=DEV).manual_seed(2)
    model = build_model(cfg)
    params = model.init(gen, DEV)
    prompts, frames = family_inputs(cfg, fam, gen, batch=1)
    args = (frames, prompts) if cfg.is_encdec else (prompts,)
    K2.reset_counts()
    kern, _ = model.forward(params, *args)
    variants = k2_counts()
    want = 3 * cfg.n_layers if cfg.is_encdec else cfg.n_layers
    check(variants == only(K2, wgmma_f32=want),
          f"{fam.arch} fp32 K2 variants {variants}")
    with plain_kernels():
        plain, _ = model.forward(params, *args)
    check(K2.flash_attention_cuda.launches == want,
          "the plain-kernel run launched K2")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          f"{fam.arch} fp32 logits not finite")
    err, mean = gaps(kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    check(err <= F32_LOGIT_TOL and agree >= F32_GREEDY_MIN,
          f"{fam.arch} fp32 kernel vs plain logits: max {err:.3g}, greedy "
          f"agreement {agree:.3f}")
    out = {"max_err": err, "mean_err": mean, "greedy": agree,
           "positions": int(kern.shape[1]), "variants": variants,
           "absmax": float(plain.abs().max())}
    del kern, plain
    out["secs"] = kernel_vs_plain_s(lambda: model.forward(params, *args))
    del params
    free_card()
    return out


def family_phase(fam):
    """One family at full width through its entry points; returns its
    measurements.  The card is freed before it returns."""
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(fam.arch), **dict(fam.cut))
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = build_model(cfg)
    capacity = fam.prompt + fam.new + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, DEV)
    prompts, frames = family_inputs(cfg, fam, gen)
    if cfg.is_encdec:
        params = cast_for_compute(cfg, params, DEV)   # the engine's cast
        run = lambda p, n: encdec_generate(        # noqa: E731
            model, params, frames, p, n, capacity)
        prefill = lambda: model.prefill(params, frames, prompts)  # noqa: E731
    else:
        engine = ServeEngine(cfg, params, capacity=capacity,
                             batch_size=fam.batch, device=DEV)
        del params
        host = prompts.cpu().numpy()
        run = lambda p, n: engine.generate(p, n)   # noqa: E731
        prefill = lambda: engine.model.prefill(    # noqa: E731
            engine.params, prompts)
    free_card()
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "params": cfg.param_count(),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.is_encdec:
        out["frames"] = cfg.encoder.n_frames
    warm = 64 if not cfg.is_encdec else fam.prompt
    run(prompts[:, :warm] if cfg.is_encdec else host[:, :warm], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K2.reset_counts()
    if cfg.is_encdec:
        tokens, out["prefill_s"], out["decode_s"], logits = run(prompts,
                                                                fam.new)
    else:
        res = run(host, fam.new)
        tokens, out["prefill_s"], out["decode_s"] = (res.tokens,
                                                     res.prefill_s,
                                                     res.decode_s)
    torch.cuda.synchronize()
    out["k2"] = k2_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["decode_tok_s"] = fam.batch * (fam.new - 1) / out["decode_s"]
    check(out["k2"] == only(K2, wgmma=fam.k2),
          f"{fam.arch}: K2 by variant per prefill {out['k2']}, want "
          f"{fam.k2} wgmma")
    check(tokens.shape == (fam.batch, fam.new) and tokens.min() >= 0
          and tokens.max() < cfg.vocab, f"{fam.arch}: generated tokens")
    got = []
    K2.reset_counts()
    out["trace"] = device_breakdown(lambda: got.append(prefill()))
    logits = got[0][0]
    check(K2.flash_attention_cuda.launches == fam.k2
          and out["trace"][2].get("K2", 0) == fam.k2,
          f"{fam.arch}: traced prefill K2 launches "
          f"{K2.flash_attention_cuda.launches}, profiler {out['trace'][2]}")
    check(logits.shape == (fam.batch, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{fam.arch}: prefill logits not finite")
    out["tokens_head"] = tokens[0, :8].tolist()
    del got, logits, run, prefill
    if cfg.is_encdec:
        del params
    else:
        del engine
    free_card()
    if fam.check:
        out["f32"] = f32_check(fam)
    out["phase_s"] = time.perf_counter() - t_start
    return out


def families_phase():
    return {fam.arch: family_phase(fam) for fam in FAMILIES}


def report_families(fm, card):
    for fam in FAMILIES:
        r = fm[fam.arch]
        traffic = (f"{fam.batch} requests, "
                   + (f"{r['frames']} stub frames and a " if "frames" in r
                      else "")
                   + f"{fam.prompt}-token prompt, {fam.new} new tokens")
        log(f"phase (i) {fam.arch} on {card}: {r['layers']} layers, d_model "
            f"{r['d_model']}, {r['params'] / 1e9:.3f} B params; cuts: "
            f"{fam.cuts}; {traffic}, bf16, greedy: init {r['init_s']:.2f} s "
            f"(peak {r['init_peak_gb']:.1f} GB), prefill "
            f"{r['prefill_s']:.3f} s, decode {r['decode_tok_s']:.1f} tok/s "
            f"({r['decode_s']:.3f} s for {fam.new - 1} steps), peak device "
            f"memory serving {r['peak_gb']:.1f} GB; K2 by variant per "
            f"prefill {r['k2']}; first request's tokens {r['tokens_head']}; "
            f"phase {r['phase_s']:.1f} s")
        w, secs, calls, top = r["trace"]
        busy = sum(secs.values())
        log(f"  traced prefill on {card}: wall {w:.4f} s, device busy "
            f"{busy:.4f} s (idle share {1 - busy / w:.3f}): " + ", ".join(
                f"{k} {secs[k]:.4f} s/{calls[k]} kernels"
                for k in sorted(secs, key=lambda k: -secs[k])))
        for evt_name, (sec, n) in top:
            log(f"    {sec:.4f} s in {n} calls: {evt_name[:90]}")
        if "f32" in r:
            c = r["f32"]
            log(f"  fp32 at 2 layers of full width, one request, logits at "
                f"all {c['positions']} positions, kernels vs plain_kernels()"
                f": max |logit diff| {c['max_err']:.4g}, mean "
                f"{c['mean_err']:.3g} (tolerance {F32_LOGIT_TOL}; max |logit|"
                f" {c['absmax']:.3g}), greedy agreement "
                f"{c['greedy'] * 100:.2f}% (min {F32_GREEDY_MIN * 100:.0f}%);"
                f" K2 {c['variants']}; forward {c['secs']['kernels']:.4f} s "
                f"on the kernels, {c['secs']['plain']:.4f} s on the plain "
                f"versions (means of two turns each)")


# ----------------------------------------------------------------------
# phase (j): training zamba2-1.2b through the port's trainer
# ----------------------------------------------------------------------

#: (j2): global batch and sequence (zamba2's serving traffic), microbatches
#: and steps; (j1) runs one sequence of the same length
TRAIN_B, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 2048, 2, 4
#: (j1) fp32: the worst leaf's max|kernel grad - plain grad| over its
#: max|plain grad|.  (j1) bf16: each leaf's distance to the fp32 plain
#: gradients, so measured, is held to the bf16 plain run's (the noise
#: floor) as serving's logits are: the mean over leaves within
#: BF16_MEAN_RATIO of the plain run's mean, the worst leaf within
#: BF16_MAX_RATIO of its worst
GRAD_F32_TOL = 1e-3
#: a K2 output or K3 output cut off from autograd would leave these with a
#: zero gradient
DETACH_LEAVES = ("/shared_block/attn/wq", "/shared_block/attn/wk",
                 "/shared_block/attn/wv")


def leaf_paths(tree):
    """``{path: tensor}`` over a nested dict/list tree, with paths such as
    ``/runs[0]/ssm/in_proj``."""
    return {"".join(f"[{k}]" if isinstance(k, int) else f"/{k}"
                    for k in path): t
            for path, t in tree_leaves_with_path(tree)}


def launches_per_microbatch(cfg):
    """(K2, K3) launches of one forward and backward: the remat recompute
    runs each block of a layer run again, never the shared attention block
    (``stack_full`` leaves it outside remat, as the reference does)."""
    kinds = cfg.layer_kinds()
    again = 2 if cfg.remat_policy != "none" else 1
    return (kinds.count("attn_shared") + again * kinds.count("attn"),
            again * kinds.count("ssm"))


def loss_and_grads(cfg, params, tokens):
    """``lm_loss`` and every leaf's fp32 gradient by path, by autograd."""
    leaves = leaf_paths(params)
    for p in leaves.values():
        p.requires_grad_(True)
        p.grad = None
    loss, _ = lm_loss(cfg, build_model(cfg), params, tokens)
    loss.backward()
    grads = {k: (torch.zeros(p.shape, dtype=F32, device=p.device)
                 if p.grad is None else p.grad.float())
             for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
        p.requires_grad_(False)
    return float(loss.detach()), grads


def leaf_gaps(grads, ref):
    """(mean over leaves of max|g - ref| / max|ref|, the largest, its
    leaf)."""
    gaps = {k: float((grads[k] - r).abs().max() / r.abs().max())
            for k, r in ref.items()}
    k = max(gaps, key=gaps.get)
    return sum(gaps.values()) / len(gaps), gaps[k], k


def kernel_counts():
    return (dict(K2.flash_attention_cuda.by_variant),
            dict(K3.ssd_scan_cuda.by_variant))


def reset_kernel_counts():
    K2.reset_counts()
    K3.reset_counts()


def grad_check():
    """(j1): zamba2-1.2b at full width and 6 layers (five Mamba2 layers
    and one shared attention block), fp32 params, one sequence of
    TRAIN_SEQ tokens: ``lm_loss`` and every gradient on the kernels and
    under ``plain_kernels()``, in fp32 (K2's wgmma_f32 and K3's
    wgmma_split) and bf16 compute (the wgmma variants)."""
    cfg32 = dataclasses.replace(zamba2_1p2b.full(), n_layers=6, dtype=F32)
    gen = torch.Generator(device=DEV).manual_seed(3)
    params = build_model(cfg32).init(gen, DEV)
    tokens = torch.randint(0, cfg32.vocab, (1, TRAIN_SEQ + 1),
                           generator=gen, device=DEV)
    k2, k3 = launches_per_microbatch(cfg32)
    out = {"params": sum(p.numel() for p in leaf_paths(params).values()),
           "k2": k2, "k3": k3}
    for tag, dt, var2, var3 in (("f32", F32, "wgmma_f32", "wgmma_split"),
                                ("bf16", BF16, "wgmma", "wgmma")):
        cfg = dataclasses.replace(cfg32, dtype=dt)
        reset_kernel_counts()
        loss_k, g_k = loss_and_grads(cfg, params, tokens)
        counts = kernel_counts()
        check(counts == (only(K2, **{var2: k2}), only(K3, **{var3: k3})),
              f"(j1) {tag} launches {counts}, want K2 {k2} {var2} and K3 "
              f"{k3} {var3}")
        with plain_kernels():
            loss_p, g_p = loss_and_grads(cfg, params, tokens)
        check(kernel_counts() == counts, "(j1) plain run launched a kernel")
        secs = kernel_vs_plain_s(lambda: loss_and_grads(cfg, params, tokens))
        zero = [k for k, g in g_k.items() if not bool(g.abs().max() > 0)]
        check(not zero, f"(j1) {tag}: zero gradient for {zero}")
        in_proj = [k for k in g_k if k.endswith("/ssm/in_proj")]
        check(all(bool(g_k[k][i].abs().max() > 0) for k in in_proj
                  for i in range(g_k[k].shape[0])),
              f"(j1) {tag}: a layer's in_proj gradient is zero")
        check(all(k in g_k for k in DETACH_LEAVES) and in_proj,
              "(j1) q/k/v or in_proj leaves missing")
        check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
              f"(j1) {tag}: non-finite gradients")
        out[tag] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                    "secs": secs,
                    "counts": counts, "leaves": len(g_k),
                    "kern_vs_plain": leaf_gaps(g_k, g_p)}
        if tag == "f32":
            ref32 = g_p
            check(out[tag]["kern_vs_plain"][1] <= GRAD_F32_TOL,
                  f"(j1) fp32 kernel vs plain gradients "
                  f"{out[tag]['kern_vs_plain']}")
        else:
            (kmean, km, _) = out[tag]["kern_to_f32"] = leaf_gaps(g_k, ref32)
            (pmean, pm, _) = out[tag]["plain_to_f32"] = leaf_gaps(g_p, ref32)
            check(kmean <= BF16_MEAN_RATIO * pmean
                  and km <= BF16_MAX_RATIO * pm,
                  f"(j1) bf16 kernel gradients further from fp32 than the "
                  f"plain bf16 run: mean {kmean:.3g} vs {pmean:.3g}, max "
                  f"{km:.3g} vs {pm:.3g}")
        del g_k, g_p
    del params, ref32
    free_card()
    return out


def range_seconds(prof, name):
    """Device seconds of the kernels launched inside profiler ranges
    named ``name``, and the number of such ranges."""
    evts = [e for e in prof.events() if e.name == name
            and e.device_type == torch.autograd.DeviceType.CPU]
    return sum(e.device_time_total for e in evts) / 1e6, len(evts)


def train_path():
    """(j2): zamba2-1.2b at full width and depth, fp32 params, bf16
    compute, remat "dots", through ``Trainer`` over a ``GridSession``'s
    token dataset: TRAIN_STEPS AdamW steps of TRAIN_B x TRAIN_SEQ tokens
    in TRAIN_MICRO microbatches; then one more step under the profiler."""
    cfg = zamba2_1p2b.full()
    model = build_model(cfg)
    gen = torch.Generator(device=DEV).manual_seed(0)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state = make_train_state(cfg, model, gen, DEV)
    table = synthetic_token_table(n_rows=256, seq_len=TRAIN_SEQ + 1,
                                  vocab=cfg.vocab)
    session = GridSession(table, devices=[DEV], payload_family="tok",
                          payload_qualifier="ids")
    ds = session.token_dataset(TRAIN_B)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "params": cfg.param_count(),
           "layers": cfg.n_layers, "steps": []}
    # no warmup: linear_warmup_cosine scales step 0 by s / warmup = 0 for
    # any warmup, which would leave the first update empty
    step = make_train_step(
        cfg, model, AdamWConfig(lr=3e-4),
        TrainStepConfig(num_microbatches=TRAIN_MICRO,
                        schedule=lambda s: cosine_schedule(s, TRAIN_STEPS)))
    batch0 = ds.next_batch(0)
    check(batch0.shape == (TRAIN_B, TRAIN_SEQ + 1)
          and batch0.dtype == torch.int32
          and batch0.device.type == torch.device(DEV).type,
          f"token batch {tuple(batch0.shape)} {batch0.dtype} "
          f"{batch0.device}")
    with torch.no_grad():
        out["loss0_before"] = float(lm_loss(cfg, model, params, batch0)[0])
    snap = [p.flatten()[:4096].clone() for p in tree_leaves(params)]
    k2, k3 = launches_per_microbatch(cfg)
    out["want"] = (only(K2, wgmma=k2 * TRAIN_MICRO),
                   only(K3, wgmma=k3 * TRAIN_MICRO))

    def counted(p, o, batch, i):
        reset_kernel_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = step(p, o, batch, i)
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t, "counts": kernel_counts(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if i == 0:
            rec["moved"] = sum(not torch.equal(a, b.flatten()[:4096])
                               for a, b in zip(snap, tree_leaves(res[0])))
        out["steps"].append(rec)
        return res

    trainer = Trainer(counted, ds, TrainerConfig(
        total_steps=TRAIN_STEPS, log_every=1,
        checkpoint_every=TRAIN_STEPS + 1))
    params, opt_state, hist = trainer.run(params, opt_state)
    out["history"] = hist
    with torch.no_grad():
        out["loss0_after"] = float(lm_loss(cfg, model, params, batch0)[0])
    check(len(hist) == TRAIN_STEPS and all(
        np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
        for h in hist), f"(j2) non-finite loss or grad norm: {hist}")
    check(out["steps"][0]["moved"] == len(snap),
          f"(j2) {len(snap) - out['steps'][0]['moved']} of {len(snap)} "
          f"leaves unchanged by step 1")
    check(all(r["counts"] == out["want"] for r in out["steps"]),
          f"(j2) launches per step "
          f"{[r['counts'] for r in out['steps']]}, want {out['want']}")
    check(out["loss0_after"] < out["loss0_before"],
          f"(j2) step 0's batch: loss {out['loss0_before']:.4f} before, "
          f"{out['loss0_after']:.4f} after {TRAIN_STEPS} steps")
    batch = ds.next_batch(TRAIN_STEPS)
    reset_kernel_counts()
    wall, prof = profiled(lambda: step(params, opt_state, batch,
                                       TRAIN_STEPS))
    out["trace"] = breakdown(wall, prof)
    out["trace_counts"] = kernel_counts()
    out["bwd"] = {"K2": range_seconds(prof, K2_ops.BACKWARD_RANGE),
                  "K3": range_seconds(prof, K3_ops.BACKWARD_RANGE)}
    del prof, params, opt_state, session, ds, batch, batch0
    free_card()
    return out


def resume_check():
    """(j3): ``Trainer`` with a checkpoint directory on zamba2's smoke
    config on the card: 6 steps saved every 3; a second ``Trainer`` must
    resume at step 6 with tensors on the card equal to the first run's."""
    cfg = zamba2_1p2b.smoke()
    model = build_model(cfg)
    gen = torch.Generator(device=DEV).manual_seed(0)
    init = make_train_state(cfg, model, gen, DEV)
    ds = ColocatedTokenDataset(
        synthetic_token_table(n_rows=32, seq_len=17, vocab=cfg.vocab),
        [DEV], global_batch=4)
    step = make_train_step(cfg, model, AdamWConfig(lr=1e-3))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(total_steps=6, log_every=100, checkpoint_every=3,
                           checkpoint_dir=d)
        fresh = lambda: [tree_map(torch.clone, t) for t in init]  # noqa: E731
        p1, o1, _ = Trainer(step, ds, tc).run(*fresh())
        saved = sorted(os.listdir(d))
        p2, o2, hist = Trainer(step, ds, tc).run(*fresh())
    a, b = tree_leaves((p1, o1)), tree_leaves((p2, o2))
    check(saved == ["step_000000003", "step_000000006"],
          f"(j3) checkpoints {saved}")
    check(hist == [] and int(o2["step"]) == 6,
          f"(j3) resumed at step {int(o2['step'])}, ran {len(hist)} steps")
    check(all(t.device.type == torch.device(DEV).type for t in b),
          "(j3) restored tensors not on the card")
    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          "(j3) resumed state differs from the first run's")
    return {"saved": saved, "leaves": len(b)}


def report_training(gc_out, tr, rs, card, secs):
    log(f"phase (j1) on {card}: zamba2-1.2b at full width, 6 layers (5 "
        f"Mamba2 + the shared attention block), "
        f"{gc_out['params'] / 1e6:.1f} M fp32 params, 1 x {TRAIN_SEQ} "
        f"tokens, lm_loss and all gradients, kernels vs plain_kernels(): "
        + "; ".join(
            f"{tag} compute: loss {r['loss_kernel']:.6f} vs "
            f"{r['loss_plain']:.6f}, max|Δg|/max|g_plain| mean over leaves "
            f"{r['kern_vs_plain'][0]:.3g}, worst "
            f"{r['kern_vs_plain'][1]:.3g} ({r['kern_vs_plain'][2]}) over "
            f"{r['leaves']} leaves, launches K2 {r['counts'][0]} K3 "
            f"{r['counts'][1]}, loss and gradients "
            f"{r['secs']['kernels']:.3f} s on the kernels, "
            f"{r['secs']['plain']:.3f} s on the plain versions (means of two "
            f"turns each)"
            for tag, r in ((t, gc_out[t]) for t in ("f32", "bf16")))
        + "; bf16 distance to the fp32 plain gradients, mean over leaves / "
        "worst: kernels {:.3g} / {:.3g} ({}), plain {:.3g} / {:.3g} ({}) "
        "(ratios {:.3f} / {:.3f}, at most {} / {})".format(
            *gc_out['bf16']['kern_to_f32'], *gc_out['bf16']['plain_to_f32'],
            gc_out['bf16']['kern_to_f32'][0]
            / gc_out['bf16']['plain_to_f32'][0],
            gc_out['bf16']['kern_to_f32'][1]
            / gc_out['bf16']['plain_to_f32'][1],
            BF16_MEAN_RATIO, BF16_MAX_RATIO)
        + f"; fp32 tolerance {GRAD_F32_TOL}; every leaf's "
        f"gradient nonzero (q/k/v and each layer's in_proj)")
    log(f"phase (j2) on {card}: zamba2-1.2b training, {tr['layers']} layers,"
        f" {tr['params'] / 1e9:.3f} B fp32 params, bf16 compute, remat "
        f"dots, AdamW lr 3e-4 on a cosine over {TRAIN_STEPS} steps; global "
        f"batch "
        f"{TRAIN_B} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches from "
        f"GridSession.token_dataset; init {tr['init_s']:.2f} s; step 0's "
        f"batch loss {tr['loss0_before']:.4f} before, "
        f"{tr['loss0_after']:.4f} after {TRAIN_STEPS} steps")
    for h, r in zip(tr["history"], tr["steps"]):
        log(f"  step {h['step']}: loss {h['loss']:.4f}, grad_norm "
            f"{h['grad_norm']:.4f}, lr_scale {h['lr_scale']:.3f}, "
            f"{r['s']:.3f} s, {TRAIN_B * TRAIN_SEQ / r['s']:.0f} tokens/s, "
            f"K2 {r['counts'][0]}, K3 {r['counts'][1]}, peak "
            f"{r['peak_gb']:.1f} GB")
    w, secs_by, calls, top = tr["trace"]
    busy = sum(secs_by.values())
    log(f"  traced step on {card}: wall {w:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / w:.3f}): " + ", ".join(
            f"{k} {secs_by[k]:.4f} s/{calls[k]} kernels"
            for k in sorted(secs_by, key=lambda k: -secs_by[k]))
        + f"; of which the plain backwards: K2 {tr['bwd']['K2'][0]:.4f} s "
        f"in {tr['bwd']['K2'][1]} calls, K3 {tr['bwd']['K3'][0]:.4f} s in "
        f"{tr['bwd']['K3'][1]} calls; launches {tr['trace_counts']}")
    for evt_name, (sec, n) in top:
        log(f"    {sec:.4f} s in {n} calls: {evt_name[:90]}")
    log(f"phase (j3) on {card}: zamba2 smoke config, 6 steps, checkpoints "
        f"{rs['saved']}; a second Trainer resumed at step 6 with "
        f"{rs['leaves']} leaves on the card, equal to the first run's")
    log(f"phase (j) training {secs:.1f} s")


# ----------------------------------------------------------------------
# phase (k): the distributed layer on the card, one rank
# ----------------------------------------------------------------------

#: (k1): CellBuilder's sharded step against the mesh-less step from the
#: same state and batch, on a one-rank mesh, at full depth in bf16: the
#: loss and the grad norm reduce over every token and every gradient, so
#: bf16 noise averages out in them: within K1_LOSS_TOL and K1_GNORM_TOL
#: relative
K1_LOSS_TOL, K1_GNORM_TOL = 1e-3, 1e-2
#: Gradients, (k1) and (k2): fp32 compute at zamba2-1.2b's width and
#: GRAD_LAYERS layers, GRAD_B x TRAIN_SEQ tokens, one mesh-less step as the
#: yardstick.  A first AdamW step moves every parameter by about +-lr
#: whatever its gradient's size, so a gradient of the wrong scale does
#: not show in the parameters: each leaf's gradient is read from m after
#: one step (m = (1 - b1) clip g, clip from the step's own grad norm) and
#: held within GRAD_RTOL of the leaf's largest magnitude plus GRAD_ATOL,
#: the fp32 bound of tests/test_torch_train_families.py.  The compressed
#: step's one pod rounds each leaf to int8 before the update, so it may
#: differ by half a quantum (max|g| / 127 / 2) more, and must differ by
#: more than the fp32 bound somewhere (else nothing was rounded)
GRAD_LAYERS, GRAD_B = 6, 2
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: (k2): also the reference test's bounds (loss, worst parameter) at lr
#: 1e-3
K2_LOSS_TOL, K2_PARAM_TOL, K2_LR = 5e-2, 5e-3, 1e-3
#: (k4): the dry run's wall time limit, seconds
DRYRUN_TIMEOUT = 420


def leaf_gap(a, b):
    """max |a - b| of two trees of (D)Tensors, its leaf's path."""
    out = {}
    for (path, x), y in zip(tree_leaves_with_path(a), tree_leaves(b)):
        x = x.full_tensor() if hasattr(x, "full_tensor") else x
        y = y.full_tensor() if hasattr(y, "full_tensor") else y
        out["/".join(map(str, path))] = float((x.float() - y.float())
                                              .abs().max())
    k = max(out, key=out.get)
    return out[k], k, sum(out.values()) / len(out)


def step_grads(opt_state, gnorm, opt_cfg):
    """Each leaf's gradient by path, from AdamW's m after one step."""
    clip = min(1.0, opt_cfg.grad_clip_norm / (gnorm + 1e-9))
    out = {}
    for path, m in tree_leaves_with_path(opt_state["m"]):
        m = m.full_tensor() if hasattr(m, "full_tensor") else m
        out["/".join(map(str, path))] = m.float() / ((1 - opt_cfg.b1) * clip)
    return out


def grad_gap(got, want, quantized=False):
    """-> (worst gap over its bound, its leaf, worst gap in int8 quanta,
    leaves whose gap exceeds the fp32 bound) of two gradient trees."""
    worst, leaf, quanta, rounded = 0.0, "", 0.0, 0
    for k, w in want.items():
        amax = float(w.abs().max())
        tol = GRAD_RTOL * amax + GRAD_ATOL
        gap = float((got[k] - w).abs().max())
        half = 0.5 * (amax / 127 + 1e-12) * (1 + GRAD_RTOL)
        bound = tol + (half if quantized else 0.0)
        rounded += gap > tol
        quanta = max(quanta, gap / (2 * half))
        if gap / bound > worst:
            worst, leaf = gap / bound, k
    return worst, leaf, quanta, rounded


def sharded_train(mesh):
    """(k1): zamba2-1.2b at full width and depth, fp32 params, bf16
    compute, remat "dots", phase (j)'s batch shape (TRAIN_B x TRAIN_SEQ in
    TRAIN_MICRO microbatches) from a ``ColocatedTokenDataset`` over the
    mesh: one mesh-less step, then two of ``CellBuilder``'s step, both
    from seed 0's state."""
    cfg = dataclasses.replace(zamba2_1p2b.full(),
                              train_microbatches=TRAIN_MICRO)
    builder = CellBuilder(cfg, mesh, "train")
    model = builder.model
    table = synthetic_token_table(n_rows=256, seq_len=TRAIN_SEQ + 1,
                                  vocab=cfg.vocab)
    ds = ColocatedTokenDataset(table, mesh, global_batch=TRAIN_B)
    batches = [ds.next_batch(i) for i in range(2)]
    check(isinstance(batches[0], DTensor)
          and tuple(batches[0].shape) == (TRAIN_B, TRAIN_SEQ + 1)
          and batches[0].device.type == torch.device(DEV).type,
          f"(k1) mesh batch {type(batches[0]).__name__} "
          f"{tuple(batches[0].shape)}")
    k2, k3 = launches_per_microbatch(cfg)
    want = (only(K2, wgmma=k2 * TRAIN_MICRO), only(K3, wgmma=k3 * TRAIN_MICRO))
    out = {"want": want, "steps": []}

    gen = torch.Generator(device=DEV).manual_seed(0)
    params, opt = make_train_state(cfg, model, gen, DEV)
    plain = make_train_step(cfg, model, AdamWConfig(), TrainStepConfig(
        num_microbatches=TRAIN_MICRO))
    reset_kernel_counts()
    (p_plain, _, m_plain), out["plain_s"] = timed(
        lambda: plain(params, opt, batches[0].full_tensor(), 0))
    out["plain_counts"] = kernel_counts()
    out["plain_loss"] = float(m_plain["loss"])
    out["plain_gnorm"] = float(m_plain["grad_norm"])
    del opt, params
    free_card()

    gen = torch.Generator(device=DEV).manual_seed(0)
    params = builder.place_params(model.init(gen, DEV))
    opt = adamw_init(params)
    fn, _, _, _ = builder.build({"tokens": batches[0]})
    for i, batch in enumerate(batches):
        reset_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        (params, opt, m), secs = timed(lambda: fn(params, opt, batch, i))
        out["steps"].append({
            "s": secs, "counts": kernel_counts(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": float(m["loss"]), "gnorm": float(m["grad_norm"])})
    s0 = out["steps"][0]
    check(out["plain_counts"] == want
          and all(r["counts"] == want for r in out["steps"]),
          f"(k1) launches: mesh-less {out['plain_counts']}, sharded "
          f"{[r['counts'] for r in out['steps']]}, want {want}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"])
              for r in out["steps"]), "(k1) non-finite loss or grad norm")
    check(abs(s0["loss"] - out["plain_loss"])
          <= K1_LOSS_TOL * abs(out["plain_loss"])
          and abs(s0["gnorm"] - out["plain_gnorm"])
          <= K1_GNORM_TOL * abs(out["plain_gnorm"]),
          f"(k1) step 1: loss {s0['loss']:.6f} vs {out['plain_loss']:.6f}, "
          f"grad norm {s0['gnorm']:.6f} vs {out['plain_gnorm']:.6f}")
    del params, opt, p_plain, fn, builder, ds, batches
    free_card()
    return out


def gradient_checks(mesh):
    """(k1) and (k2) gradients in fp32 at zamba2-1.2b's width and
    GRAD_LAYERS layers, GRAD_B x TRAIN_SEQ tokens, from one state: the
    mesh-less step (lr K2_LR), ``CellBuilder``'s step on ``mesh`` and
    ``make_compressed_train_step`` on a (1, 1, 1) pod/data/model mesh."""
    cfg = dataclasses.replace(zamba2_1p2b.full(), n_layers=GRAD_LAYERS,
                              dtype=F32, train_microbatches=1)
    model = build_model(cfg)
    gen = torch.Generator(device=DEV).manual_seed(5)
    params = model.init(gen, DEV)
    tokens = torch.randint(0, cfg.vocab, (GRAD_B, TRAIN_SEQ + 1),
                           generator=gen, device=DEV, dtype=torch.int32)
    k2, k3 = launches_per_microbatch(cfg)
    want = (only(K2, wgmma_f32=k2), only(K3, wgmma_split=k3))
    opt_cfg = AdamWConfig(lr=K2_LR)
    out = {"want": want}

    reset_kernel_counts()
    p1, o1, m1 = make_train_step(cfg, model, opt_cfg)(
        tree_map(torch.clone, params), adamw_init(params), tokens, 0)
    out["plain_counts"] = kernel_counts()
    g_plain = step_grads(o1, float(m1["grad_norm"]), opt_cfg)
    del o1

    builder = CellBuilder(cfg, mesh, "train")
    fn, _, pls, _ = builder.build({"tokens": tokens})
    dp = builder.place_params(tree_map(torch.clone, params))
    reset_kernel_counts()
    dp, od, md = fn(dp, adamw_init(dp), builder.place(tokens, pls[2]), 0)
    out["cell_counts"] = kernel_counts()
    out["cell"] = grad_gap(step_grads(od, float(md["grad_norm"]),
                                        AdamWConfig()), g_plain)
    del dp, od, fn, builder

    pmesh = init_device_mesh(torch.device(DEV).type, (1, 1, 1),
                             mesh_dim_names=("pod", "data", "model"))
    p0 = tree_map(torch.clone, params)   # dp shares params' storage
    dp = distribute_tree(params, model.logical_axes(), sharding_rules(),
                         pmesh)
    comp = make_compressed_train_step(cfg, model, opt_cfg, pmesh)
    reset_kernel_counts()
    (p2, o2, m2), out["s"] = timed(lambda: comp(dp, adamw_init(dp),
                                                tokens, 0))
    out["counts"] = kernel_counts()
    out["loss"] = (float(m1["loss"]), float(m2["loss"]))
    out["gap"] = leaf_gap(p1, p2)
    out["moved"] = leaf_gap(p0, p2)[0]
    out["comp"] = grad_gap(step_grads(o2, float(m2["grad_norm"]), opt_cfg),
                             g_plain, quantized=True)
    check(all(c == want for c in (out["plain_counts"], out["cell_counts"],
                                  out["counts"])),
          f"(k1/k2) fp32 launches: mesh-less {out['plain_counts']}, "
          f"CellBuilder {out['cell_counts']}, compressed {out['counts']}, "
          f"want {want}")
    check(out["cell"][0] <= 1.0,
          f"(k1) CellBuilder's fp32 gradient of {out['cell'][1]} off the "
          f"mesh-less step's by {out['cell'][0]:.3g}x the bound")
    check(out["comp"][0] <= 1.0 and out["comp"][3] > 0,
          f"(k2) compressed gradients: worst {out['comp'][0]:.3g}x the "
          f"bound ({out['comp'][1]}), {out['comp'][3]} leaves rounded")
    check(abs(out["loss"][0] - out["loss"][1]) < K2_LOSS_TOL
          and out["gap"][0] < K2_PARAM_TOL and out["moved"] > 0,
          f"(k2) compressed vs plain step: loss {out['loss']}, worst "
          f"parameter gap {out['gap'][0]:.3g} ({out['gap'][1]})")
    del params, p0, p1, p2, dp, o2, comp, g_plain
    free_card()
    return out


def sharded_serve(mesh):
    """(k3): ``CellBuilder``'s prefill and one decode step of zamba2-1.2b
    at phase 6's serving shape against the engine's, with an fp32 prefill
    as the yardstick of serving's bf16 rule."""
    cfg = zamba2_1p2b.full()
    model = build_model(cfg)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = model.init(gen, DEV)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device=DEV, dtype=torch.int32)
    engine = ServeEngine(cfg, params, capacity=SERVE_PROMPT + SERVE_NEW + 1,
                         batch_size=SERVE_B, device=DEV)
    cfg32 = dataclasses.replace(cfg, dtype=F32)
    logits32, _ = build_model(cfg32).prefill(
        cast_for_compute(cfg32, params, DEV), prompts)
    del params
    free_card()
    logits_e, caches_e = engine.model.prefill(engine.params, prompts)
    caches_e = pad_caches(cfg, caches_e, engine.capacity)

    pre = CellBuilder(cfg, mesh, "prefill")
    fn, _, pls, _ = pre.build({"tokens": prompts})
    dparams = pre.place_params(engine.params)
    reset_kernel_counts()
    (logits_c, caches_c), secs = timed(
        lambda: fn(dparams, pre.place(prompts, pls[1])))
    out = {"prefill_s": secs, "counts": kernel_counts()}
    logits_c = logits_c.full_tensor().float()
    kinds = cfg.layer_kinds()
    want = (only(K2, wgmma=kinds.count("attn_shared")),
            only(K3, wgmma=kinds.count("ssm")))
    check(out["counts"] == want,
          f"(k3) prefill launches {out['counts']}, want {want}")
    out["mesh_to_f32"] = gaps(logits_c, logits32.float())
    out["engine_to_f32"] = gaps(logits_e.float(), logits32.float())
    out["mesh_vs_engine"] = gaps(logits_c, logits_e.float())
    (cm, cmean), (em, emean) = out["mesh_to_f32"], out["engine_to_f32"]
    check(cmean <= BF16_MEAN_RATIO * emean and cm <= BF16_MAX_RATIO * em,
          f"(k3) mesh prefill further from fp32 than the engine's: mean "
          f"{cmean:.3g} vs {emean:.3g}, max {cm:.3g} vs {em:.3g}")

    dec = CellBuilder(cfg, mesh, "decode")
    token = logits_e.argmax(-1).to(torch.int32)
    pos = torch.full((SERVE_B,), SERVE_PROMPT, dtype=torch.int32, device=DEV)
    specs = {"token": token, "pos": pos, "caches": caches_e}
    fn, _, pls, _ = dec.build(specs)
    dcaches = dec.place(tree_map(torch.clone, caches_e), pls[1])
    reset_kernel_counts()
    (next_c, _), out["decode_s"] = timed(lambda: fn(
        dec.place_params(engine.params), dcaches, dec.place(token, pls[2]),
        dec.place(pos, pls[3])))
    logits_d, _ = engine.model.decode_step(engine.params, token, pos,
                                           caches_e)
    out["greedy"] = float((next_c.full_tensor() == logits_d.argmax(-1)
                           .to(torch.int32)).float().mean())
    check(out["greedy"] >= F32_GREEDY_MIN,
          f"(k3) decode next tokens agree with the engine's on "
          f"{out['greedy']:.3f}")
    del engine, dparams, caches_c, caches_e, dcaches, logits32
    free_card()
    return out


#: (k4): one rank's counts of phase (j)'s step (a one-rank ``fake``
#: group), printed as JSON by a subprocess
HOST_ROOFLINE = """
import dataclasses, json, sys
from repro_torch.configs import zamba2_1p2b
from repro_torch.launch.dryrun import compile_cell
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.launch.roofline import derive_terms
from repro_torch.launch.shapes import ShapeSpec
b, seq, micro = map(int, sys.argv[1:4])
cfg = dataclasses.replace(zamba2_1p2b.full(), train_microbatches=micro)
fake_process_group(1)
raw = compile_cell(cfg, ShapeSpec("phase_j", seq, b, "train"),
                   make_host_mesh(device_type="cpu"), "train")
terms = derive_terms(raw["flops"], raw["bytes"], raw["wire_bytes"],
                     raw["cross_node_bytes"])
print(json.dumps({"raw": raw, "bound_s": terms.bound_s,
                  "dominant": terms.dominant}))
"""


def dryrun_phase(step_s):
    """(k4): the dry run of zamba2-1.2b train_4k on the 16 x 16 mesh, and
    one rank's counts at phase (j)'s shape, in subprocesses (a process
    holds one default process group); MFU of phase (j)'s measured step
    from ``model_flops`` at its shape."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"))
    with tempfile.TemporaryDirectory() as d:
        runs = [subprocess.Popen(cmd, env=env, cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for cmd in ([sys.executable, "-m", "repro_torch.launch.dryrun",
                             "--arch", "zamba2_1p2b", "--shape", "train_4k",
                             "--mesh", "single", "--out", d],
                            [sys.executable, "-c", HOST_ROOFLINE,
                             str(TRAIN_B), str(TRAIN_SEQ), str(TRAIN_MICRO)])]
        texts = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in runs]
        check(all(p.returncode == 0 for p in runs),
              "(k4) dry run failed:\n" + "\n".join(t[-2000:] for t in texts))
        single = json.load(open(os.path.join(
            d, "zamba2_1p2b__train_4k__single.json")))
    host = json.loads(texts[1].strip().splitlines()[-1])
    check(single["status"] == "ok", "(k4) dry-run cell not ok")
    mf = model_flops(zamba2_1p2b.full(),
                     ShapeSpec("phase_j", TRAIN_SEQ, TRAIN_B, "train"))
    return {"single": single, "host": host, "step_s": step_s,
            "model_flops": mf, "mfu": mf / (step_s * BF16_FLOPS),
            "bound_share": host["bound_s"] / step_s}


def distributed_phase(step_s):
    """(k1)-(k4) on a one-rank NCCL group (made here, destroyed after)."""
    ensure_process_group(torch.device(DEV).type)
    try:
        mesh = make_host_mesh(device_type=torch.device(DEV).type)
        t0 = time.perf_counter()
        k1 = sharded_train(mesh)
        k2 = gradient_checks(mesh)
        k3 = sharded_serve(mesh)
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    k4 = dryrun_phase(step_s)
    return k1, k2, k3, k4, secs, time.perf_counter() - t0


def report_distributed(k1, k2, k3, k4, secs, dry_s, card):
    s0, s1 = k1["steps"]
    step_j = k4["step_s"]
    log(f"phase (k1) on {card}: CellBuilder(zamba2-1.2b full, (data 1, "
        f"model 1) NCCL mesh, train) at {TRAIN_B} x {TRAIN_SEQ} in "
        f"{TRAIN_MICRO} microbatches, fp32 params, bf16 compute, batches "
        f"from ColocatedTokenDataset over the mesh: steps {s0['s']:.3f} s "
        f"and {s1['s']:.3f} s (loss {s0['loss']:.4f}, {s1['loss']:.4f}; "
        f"peak {s0['peak_gb']:.1f} / {s1['peak_gb']:.1f} GB; K2 "
        f"{s0['counts'][0]}, K3 {s0['counts'][1]} a step); the mesh-less "
        f"make_train_step from the same state {k1['plain_s']:.3f} s (loss "
        f"{k1['plain_loss']:.4f}, grad norm {k1['plain_gnorm']:.4f} vs "
        f"{s0['gnorm']:.4f}; K2 {k1['plain_counts'][0]}, K3 "
        f"{k1['plain_counts'][1]}, the first step of this phase); against "
        f"phase (j)'s warm steps ({step_j:.3f} s, same batch shape and "
        f"kernels), DTensor's host cost is {s1['s'] - step_j:.3f} s a step "
        f"({s1['s'] / step_j:.2f}x; the first sharded step "
        f"{s0['s'] - step_j:.3f} s, its sharding propagation not yet "
        f"cached); loss tolerance {K1_LOSS_TOL}, grad norm {K1_GNORM_TOL}")
    w, leaf, _, _ = k2["cell"]
    log(f"phase (k1) gradients on {card}: fp32, zamba2-1.2b width x "
        f"{GRAD_LAYERS} layers, {GRAD_B} x {TRAIN_SEQ} tokens, K2 "
        f"{k2['cell_counts'][0]}, K3 {k2['cell_counts'][1]}: every leaf "
        f"of CellBuilder's step against the mesh-less step's, worst "
        f"{w:.3g}x the bound {GRAD_RTOL} max|g| + {GRAD_ATOL} ({leaf})")
    w, leaf, quanta, rounded = k2["comp"]
    log(f"phase (k2) on {card}: make_compressed_train_step on a (pod 1, "
        f"data 1, model 1) NCCL mesh, same fp32 state and tokens, lr "
        f"{K2_LR}: every leaf's gradient within {w:.3g}x (half an int8 "
        f"quantum + the fp32 bound; worst {leaf}) of the plain step's, at "
        f"most {quanta:.3g} quantum off, {rounded} leaves past the fp32 "
        f"bound (rounded); loss {k2['loss'][1]:.6f} vs "
        f"{k2['loss'][0]:.6f} (bound {K2_LOSS_TOL}), worst parameter gap "
        f"{k2['gap'][0]:.3g} ({k2['gap'][1]}; bound {K2_PARAM_TOL}), "
        f"{k2['s']:.3f} s, K2 {k2['counts'][0]}, K3 {k2['counts'][1]}")
    (cm, cmean), (em, emean) = k3["mesh_to_f32"], k3["engine_to_f32"]
    log(f"phase (k3) on {card}: CellBuilder prefill of zamba2-1.2b at "
        f"{SERVE_B} x {SERVE_PROMPT} in {k3['prefill_s']:.3f} s (K2 "
        f"{k3['counts'][0]}, K3 {k3['counts'][1]}): |Δlogit| to an fp32 "
        f"prefill max {cm:.4g} / mean {cmean:.4g} vs the engine's "
        f"{em:.4g} / {emean:.4g} (serving's bf16 rule: at most "
        f"{BF16_MAX_RATIO} / {BF16_MEAN_RATIO} x); mesh vs engine max "
        f"{k3['mesh_vs_engine'][0]:.4g}; one decode step through "
        f"CellBuilder in {k3['decode_s']:.3f} s, next tokens equal to the "
        f"engine's on {k3['greedy']:.3f}")
    r = k4["single"]
    ro, raw = r["roofline"], r["raw"]
    log(f"phase (k4) zamba2-1.2b train_4k single mesh ({r['devices']} "
        f"ranks, batch {r['spec']['global_batch']} x "
        f"{r['spec']['seq_len']}) (dry-run, H100 constants): per rank "
        f"{raw['flops']:.4g} FLOPs, {raw['bytes']:.4g} bytes, wire "
        f"{raw['wire_bytes']:.4g} bytes ({raw['cross_node_bytes']:.4g} "
        f"across nodes; by kind "
        f"{ {k: float(f'{v:.4g}') for k, v in raw['coll_by_op'].items()} }), "
        f"peak {r['per_device_bytes'] / 1e9:.2f} GB (fits "
        f"80 GB: {r['fits_h100']}); compute {ro['compute_s']:.4g} s, "
        f"memory {ro['memory_s']:.4g} s, collective "
        f"{ro['collective_s']:.4g} s, bound {ro['bound_s']:.4g} s "
        f"({ro['dominant']}); useful FLOPs ratio "
        f"{ro['useful_flops_ratio']:.4f}; dry run {r['wall_s']:.1f} s")
    h = k4["host"]["raw"]
    log(f"phase (k4) zamba2-1.2b at phase (j)'s shape on one rank "
        f"({TRAIN_B} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches) (dry-run, "
        f"H100 constants): {h['flops']:.4g} FLOPs, {h['bytes']:.4g} bytes, "
        f"peak {h['memory']['peak_live_bytes'] / 1e9:.2f} GB; bound "
        f"{k4['host']['bound_s']:.4g} s ({k4['host']['dominant']})")
    log(f"phase (k4) on {card}: model FLOPs of phase (j)'s step "
        f"{k4['model_flops']:.4g} over its measured {k4['step_s']:.3f} s x "
        f"989e12: MFU {k4['mfu']:.4f} (dry-run, H100 constants); the "
        f"one-rank bound over the step {k4['bound_share']:.4f}")
    log(f"phase (k) distributed {secs:.1f} s on the card, dry run "
        f"{dry_s:.1f} s")


#: K2's timed calls: zamba2-1.2b's prefill attention, qwen3-8b's heads (32
#: query heads over 8 KV heads of 128) at the same batch and prompt, and
#: the reduced configs' head dims 16 and 32 at the same batch, heads and
#: prompt; (B, H, Hkv, S, D), bf16 and fp32, causal, as [B, S, H, D] views
K2_TIMED = {"zamba2": (SERVE_B, SERVE_HEADS, SERVE_HEADS, SERVE_PROMPT, 64),
            "qwen3_d128": (SERVE_B, 32, 8, SERVE_PROMPT, 128),
            "d16": (SERVE_B, SERVE_HEADS, SERVE_HEADS, SERVE_PROMPT, 16),
            "d32": (SERVE_B, SERVE_HEADS, SERVE_HEADS, SERVE_PROMPT, 32)}
#: the calls also timed by the profiler's device time (in the child
#: process of :func:`measure_apart`)
K2_DEVICE_TIMED = ("d16", "d32")
#: ex2 results a clock an SM on compute capability 9.0 (the CUDA C
#: Programming Guide's throughput table), and the H100's SMs
SFU_PER_CLOCK, SMS = 16, 132


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def sdpa(q, k, v, scale):
    """PyTorch's fused attention on a causal call (GQA where k has fewer
    heads): K2's yardstick, timed beside it and used nowhere in the
    port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale,
        enable_gqa=k.shape[1] != q.shape[1])


def measure_k2(gen, B, H, Hkv, S, D, device=False):
    """K2's instances, SDPA and the plain version on one causal call,
    timed in turns by loop time (wgmma, SDPA, plain, then the fp32 ones:
    wgmma_f32, SDPA, plain; then backwards); each time is the mean of its
    two turns.  With ``device`` also the profiler's device time of each
    kernel and of SDPA.  wgmma_f32's bound is the split contract's: three
    bf16 products for each.  Each bound's terms: bytes, tensor operations
    and the softmax's exponentials (one ex2 a causal pair on the SFUs at
    the card's maximum SM clock)."""
    q = torch.randn(B, S, H, D, generator=gen, device=DEV).to(BF16)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=DEV).to(BF16)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = D ** -0.5
    counts = (K2.flash_attention_cuda.launches,
              dict(K2.flash_attention_cuda.by_variant))
    want = attention_ref(q, k, v, scale)
    got = K2.flash_attention_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    errs = {"wgmma": float((got.float() - want.float()).abs().max())}
    check(torch.allclose(got.float(), want.float(), rtol=K2_TOL[BF16],
                         atol=K2_TOL[BF16]),
          f"K2 wgmma at {(B, H, Hkv, S, D)}: max err {errs['wgmma']:.3g}")
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want32 = attention_ref(q32, k32, v32, scale)
    want64 = attention_ref(q32.double(), k32.double(), v32.double(), scale)
    f64 = {"plain": float((want32.double() - want64).abs().max())}
    got32 = K2.flash_attention_cuda(q32, k32, v32, scale)
    torch.cuda.synchronize()
    errs["wgmma_f32"] = float((got32 - want32).abs().max())
    f64["wgmma_f32"] = float((got32.double() - want64).abs().max())
    check(torch.allclose(got32, want32, rtol=K2_TOL[F32], atol=K2_TOL[F32]),
          f"K2 wgmma_f32 at {(B, H, Hkv, S, D)}: max err "
          f"{errs['wgmma_f32']:.3g}")
    del got, want, got32, want32, want64
    runs = {
        "wgmma": (lambda: K2.flash_attention_cuda(q, k, v, scale), 20),
        "sdpa": (lambda: sdpa(q, k, v, scale), 20),
        "plain": (lambda: attention_ref(q, k, v, scale), 3),
        "wgmma_f32": (lambda: K2.flash_attention_cuda(q32, k32, v32, scale),
                      10),
        "sdpa_f32": (lambda: sdpa(q32, k32, v32, scale), 5),
        "plain_f32": (lambda: attention_ref(q32, k32, v32, scale), 3),
    }
    turns = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            fn, reps = runs[name]
            turns[name].append(event_ms(fn, reps))
    dev = ({name: device_ms(runs[name][0], 10)
            for name in ("wgmma", "sdpa", "wgmma_f32", "sdpa_f32")}
           if device else {})
    # comparison launches
    K2.flash_attention_cuda.launches, K2.flash_attention_cuda.by_variant = \
        counts
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    pairs = B * H * (S * (S + 1) // 2)            # the causal pairs only
    flops = 4 * D * pairs
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2   # q, o; k, v
    ex2_ms = pairs / (SFU_PER_CLOCK * SMS * max_sm_clock_hz()) * 1e3
    entry = {
        "wgmma": bound_entry(errs["wgmma"], ms["wgmma"], ms["plain"],
                             ms["sdpa"], flops, nbytes, ex2_ms=ex2_ms),
        "wgmma_f32": bound_entry(errs["wgmma_f32"], ms["wgmma_f32"],
                                 ms["plain_f32"], ms["sdpa_f32"], 3 * flops,
                                 2 * nbytes, ex2_ms=ex2_ms),
        "f64_err": f64, "turns": turns, "device_ms": dev}
    return entry


def fmt_terms(terms):
    return ", ".join(f"{k} {v:.5f}" for k, v in terms.items())


def report_k2(k2m, card):
    for tag, (B, H, Hkv, S, D) in K2_TIMED.items():
        turns, f64, dev = (k2m[tag][k] for k in ("turns", "f64_err",
                                                 "device_ms"))
        for var, dt, sdpa, plain in (("wgmma", "bf16", "sdpa", "plain"),
                                     ("wgmma_f32", "fp32", "sdpa_f32",
                                      "plain_f32")):
            km = k2m[tag][var]
            log(f"K2 {var} at {tag} q [{B},{H},{S},{D}], k/v [{B},{Hkv},"
                f"{S},{D}] {dt} causal on {card}: {km['ms']:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns[var])})"
                + (f", device {dev[var]:.4f} ms" if dev else "")
                + f", bound {km['bound_ms']:.5f} ms ({km['bound_by']}: "
                f"{fmt_terms(km['terms'])}"
                + ("; three bf16 products for each" if dt == "fp32" else "")
                + f"; {km['flops'] / 1e9:.1f} GFLOP, "
                f"{km['bytes'] / 1e6:.1f} MB), SDPA {dt} "
                f"{km['library_ms']:.4f} ms (turns "
                f"{', '.join(f'{t:.4f}' for t in turns[sdpa])})"
                + (f", device {dev[sdpa]:.4f} ms" if dev else "")
                + f", plain {km['plain_ms']:.3f} ms, max |kernel-plain| "
                f"{km['max_abs_err']:.3g}"
                + (f", max |kernel-float64| {f64[var]:.3g} (fp32 plain "
                   f"version: {f64['plain']:.3g})" if dt == "fp32" else ""))


def k3_work(B, L, H, P, N, Q, bc_bytes):
    """(operations, bytes) of one chunked scan from zero: the lower
    triangles of C.B^T and of M.x, the carried state's term and the state
    update per chunk of Q; x and y f32, a, B and C read once, the final
    state written."""
    per_chunk = Q * (Q + 1) * (N + P) + 4 * Q * P * N + 2 * P * N
    flops = B * H * -(-L // Q) * per_chunk
    nbytes = (2 * B * L * H * P * 4 + B * L * H * 4 + 2 * B * L * N * bc_bytes
              + B * H * P * N * 4)
    return flops, nbytes


#: the dims of K3's timed calls: (P, N, configured chunk) at H 64
K3_WIDE, K3_NARROW = (64, 64, 128), (16, 16, 16)
#: K3's timed calls: (tag, L, B, B/C dtype, the kernels timed beside the
#: plain version, (P, N, chunk)).  The serving call; then below one
#: chunk, L 1, 12 (the serving launcher's prompt) and 64 at B 8 and at B
#: 4 (the launcher's batch), with bf16 and with f32 B/C: the short kernel
#: and the 128-step tile called directly; then the reduced config's dims
#: (P = N = 16, chunk 16) at the serving batch, heads and prompt, and at
#: L 12, bf16 and f32 B/C
K3_TIMED = (("serve", SERVE_PROMPT, SERVE_B, BF16, ("wgmma",), K3_WIDE),
            ("serve_f32bc", SERVE_PROMPT, SERVE_B, F32, ("wgmma_split",),
             K3_WIDE),
            ) + tuple(
    (f"L{L}_B{B}_{'bf16' if dt == BF16 else 'f32bc'}", L, B, dt,
     ("wgmma_short", "wgmma") if dt == BF16
     else ("wgmma_split_short", "wgmma_split"), K3_WIDE)
    for L in (1, SHORT_PROMPT, 64) for B in (SERVE_B, 4) for dt in (BF16, F32)
) + tuple(
    (f"narrow_L{L}_{'bf16' if dt == BF16 else 'f32bc'}", L, SERVE_B, dt,
     (("wgmma" if dt == BF16 else "wgmma_split")
      + ("_short" if L <= 64 else ""),), K3_NARROW)
    for L in (SERVE_PROMPT, SHORT_PROMPT) for dt in (BF16, F32))


def k3_kernel(name):
    """The K3 kernel a name of ``K3_TIMED`` calls, the wgmma tile fixed:
    ``fn(x, a, Bm, Cm, chunk)``."""
    return functools.partial(K3.ssd_scan_cuda,
                             tile=64 if name.endswith("_short") else 128)


def k3_launchers(mod=K3):
    """{loaded library: the names of its C launchers} of the K3 kernels
    of ``mod`` (this tree's ``kernel`` module, or another tree's, which
    may also have a CUDA-core library)."""
    out = {mod.WGMMA_LIBRARY.get(): ("ssd_scan_wgmma_launch",
                                     "ssd_scan_split_launch",
                                     "ssd_scan_split_bc_launch")}
    if hasattr(mod, "LIBRARY"):
        out[mod.LIBRARY.get()] = ("ssd_scan_launch",)
    return out


@contextlib.contextmanager
def timed_launchers(ranges, mod=K3):
    """The C launchers of ``mod``'s K3 kernels wrapped so that each call's
    host seconds add up in the yielded one-element list, and with
    ``ranges`` also run inside a profiler range "k3 ctypes"; the bound
    functions are put back on exit."""
    spent = [0.0]
    real = [(lib, name, getattr(lib, name))
            for lib, names in k3_launchers(mod).items() for name in names]

    def wrap(fn):
        def call(*args):
            with (torch.profiler.record_function("k3 ctypes") if ranges
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[0] += time.perf_counter() - t0
        return call

    for lib, name, fn in real:
        setattr(lib, name, wrap(fn))
    try:
        yield spent
    finally:
        for lib, name, fn in real:
            setattr(lib, name, fn)


def k3_call_times(fn, per_call=1, reps=200, prof_reps=20, mod=K3):
    """One K3 call ``fn()`` split into the card's time and the host's:
    ``loop_ms`` (CUDA events over a loop of 50 launches), ``device_ms``
    (the profiler's kernel time a call of its ``per_call`` kernels, of
    which ``prepass_device_ms`` the split pre-pass's: the mean of each
    kernel's records, since a trace can keep only some of them; None when
    a kernel has none; ``kernel_records`` of ``kernel_launches`` were
    kept), ``host_ms`` and ``ctypes_ms``
    (perf_counter over ``reps`` calls without synchronising: the whole
    wrapper, and the C launchers inside it: ``mod``'s), and the profiler's
    CPU time a call of the wrapper (``prof_call_ms``, range "k3 call") and
    of its C launchers (``prof_ctypes_ms``), which the profiler's own cost
    inflates."""
    out = {"loop_ms": event_ms(fn, 50)}
    with timed_launchers(False, mod) as spent:
        fn()
        torch.cuda.synchronize()
        spent[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out["host_ms"] = (time.perf_counter() - t0) / reps * 1e3
        out["ctypes_ms"] = spent[0] / reps * 1e3
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with timed_launchers(True, mod):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(prof_reps):
                with torch.profiler.record_function("k3 call"):
                    fn()
            torch.cuda.synchronize()
    kernels, call, ctypes_us = {}, 0.0, 0.0
    for evt in prof.events():
        us = evt.time_range.elapsed_us()
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if not (getattr(evt, "is_user_annotation", False)
                    or evt.name in ("k3 call", "k3 ctypes")):
                kernels.setdefault(evt.name, []).append(us)
        elif evt.name == "k3 call":
            call += us
        elif evt.name == "k3 ctypes":
            ctypes_us += us
    mean_ms = {name: sum(v) / len(v) / 1e3 for name, v in kernels.items()}
    whole = len(mean_ms) == per_call
    out.update(device_ms=sum(mean_ms.values()) if whole else None,
               prepass_device_ms=sum(ms for name, ms in mean_ms.items()
                                     if "split_bc_kernel" in name)
               if whole else None,
               kernel_records=sum(len(v) for v in kernels.values()),
               kernel_launches=prof_reps * per_call,
               prof_call_ms=call / 1e3 / prof_reps,
               prof_ctypes_ms=ctypes_us / 1e3 / prof_reps)
    return out


def mean_turns(turns):
    """:func:`k3_call_times`'s results of several turns: each time the
    mean over the turns (the device times over the turns that have one,
    else None), the kernel records and launches summed."""
    out = {}
    for key in turns[0]:
        vals = [t[key] for t in turns if t[key] is not None]
        if key in ("kernel_records", "kernel_launches"):
            out[key] = sum(vals)
        else:
            out[key] = sum(vals) / len(vals) if vals else None
    return out


def measure_k3(gen, timed=K3_TIMED):
    """K3 at each call of ``timed`` (x [B, L, 64, P] f32, a [B, L, 64],
    B/C [B, L, N] column slices): each kernel checked against
    the plain version (K3_TOL x scale), then timed by
    :func:`k3_call_times` in turns (forwards, then backwards; each number
    the mean of its two turns), the plain version's loop time before and
    after.  Errors: each kernel against the plain version, and each
    kernel and the fp32 plain version against the plain version run in
    float64 on the card.  Comparison launches: the counts are put back.
    -> {tag: {kernel: measurements, "plain_f64_err": ...}}; a split
    instance's bound is the contract's (three bf16 products for each)."""
    H = SERVE_SSM_HEADS
    counts = (K3.ssd_scan_cuda.launches, dict(K3.ssd_scan_cuda.by_variant))

    def dist(y, s, yw, sw):
        return max(float((y.double() - yw.double()).abs().max()),
                   float((s.double() - sw.double()).abs().max()))

    out = {}
    for tag, L, B, bdt, names, (P, N, Q) in timed:
        x, a, Bm, Cm = k3_inputs(gen, B, L, H, P, N, bdt, 0.7)
        check(K3.variant(Bm.dtype, P, N, L) == names[0],
              f"K3 {tag} variant")
        yp, sp = ssd_chunked_ref(x, a, Bm, Cm, min(Q, L))
        y64, s64 = ssd_chunked_ref(x.double(), a.double(), Bm.double(),
                                   Cm.double(), min(Q, L))
        scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
        fns = {name: k3_kernel(name) for name in names}
        errs, f64 = {}, {"plain": dist(yp, sp, y64, s64)}
        for name in names:
            y, s = fns[name](x, a, Bm, Cm, Q)
            torch.cuda.synchronize()
            errs[name] = dist(y, s, yp, sp)
            f64[name] = dist(y, s, y64, s64)
            check(errs[name] <= K3_TOL * scale,
                  f"K3 {name} at {tag}: max err {errs[name]:.3g} (scale "
                  f"{scale:.3g})")
        del y, s, yp, sp, y64, s64

        def plain():
            return ssd_chunked_ref(x, a, Bm, Cm, min(Q, L))

        plain_turns = [event_ms(plain, 3 if L > Q else 10)]
        turns = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                turns[name].append(k3_call_times(
                    lambda fn=fns[name]: fn(x, a, Bm, Cm, Q),
                    per_call=2 if "split" in name else 1))
        plain_turns.append(event_ms(plain, 3 if L > Q else 10))
        plain_ms = sum(plain_turns) / 2
        flops, nbytes = k3_work(B, L, H, P, N, min(Q, L), Bm.element_size())
        entry = {"plain_f64_err": f64["plain"], "plain_turns": plain_turns,
                 "scale": scale}
        for name in names:
            m = mean_turns(turns[name])
            entry[name] = dict(
                bound_entry(errs[name], m["loop_ms"], plain_ms, None,
                            3 * flops if "split" in name else flops, nbytes),
                f64_err=f64[name],
                loop_turns=[t["loop_ms"] for t in turns[name]], **m)
        out[tag] = entry
        del x, a, Bm, Cm
    K3.ssd_scan_cuda.launches, K3.ssd_scan_cuda.by_variant = counts
    return out


def report_k3(k3m, timed, card):
    for tag, L, B, bdt, names, (P, N, Q) in timed:
        k3 = k3m[tag]
        plain_turns = ", ".join(f"{t:.4f}" for t in k3["plain_turns"])
        for var in names:
            km = k3[var]
            log(f"K3 {var} at x [{B},{L},64,{P}] f32, N {N}, B/C "
                f"{str(bdt).replace('torch.', '')}, chunk {Q} on {card}: "
                f"{km['ms']:.4f} ms in a loop (turns "
                + ", ".join(f"{t:.4f}" for t in km["loop_turns"])
                + ("), device not measured" if km["device_ms"] is None
                   else f"), device {km['device_ms']:.4f} ms"
                   + (f" (pre-pass {km['prepass_device_ms']:.4f})"
                      if "split" in var else ""))
                + f" ({km['kernel_records']} of {km['kernel_launches']} "
                f"kernel records)"
                + f", host {km['host_ms']:.4f} ms a call, of which the C "
                f"launchers {km['ctypes_ms']:.4f} (profiled CPU: wrapper "
                f"{km['prof_call_ms']:.4f}, C launchers "
                f"{km['prof_ctypes_ms']:.4f}); bound {km['bound_ms']:.5f} "
                f"ms ({km['bound_by']}; {km['flops'] / 1e9:.3f} GFLOP, "
                f"{km['bytes'] / 1e6:.2f} MB), plain {km['plain_ms']:.4f} "
                f"ms (turns {plain_turns}), library none (no single PyTorch"
                f" call computes it), max |kernel-plain| "
                f"{km['max_abs_err']:.3g} (scale {k3['scale']:.3g}), max "
                f"|kernel-float64| {km['f64_err']:.3g} (fp32 plain "
                f"version: {k3['plain_f64_err']:.3g})")


def report_k3_occupancy():
    """CTAs an SM of each wgmma tile (bf16 and split, from zero); the
    short kernel must fit two."""
    occ = {(tile, split): K3.ctas_per_sm(tile, split)
           for tile in (128, 64) for split in (False, True)}
    log("K3 wgmma CTAs an SM: " + ", ".join(
        f"tile {tile}{' split' if split else ''} {n}"
        for (tile, split), n in occ.items()))
    check(occ[(64, False)] >= 2 and occ[(64, True)] >= 2,
          f"the short kernel does not fit two CTAs an SM: {occ}")


def measure_apart():
    """The calls timed by the profiler's device time, in a process of its
    own (``--measure-apart``), whose profiler is fresh: in a process that
    has traced many runs, later traces keep only some kernel records, or
    none (the K1 device times went wrong when K3's 76 traces ran in this
    process, and K2's at D 16/32 read 0 at the end of a full run).
    The libraries are built already; the child loads them.  -> {"k2":
    :func:`measure_k2` of each ``K2_DEVICE_TIMED`` call, "k3":
    :func:`measure_k3` over ``K3_TIMED``}."""
    path = REPO / "build" / "timing_apart.json"
    path.unlink(missing_ok=True)
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--measure-apart",
         str(path)], capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0,
          f"the timing process failed ({proc.returncode}): "
          f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return json.loads(path.read_text())


def measure_apart_main(path) -> int:
    """``python3 chip_smoke.py --measure-apart PATH``: K2's device-timed
    calls (first, on the fresh profiler) and K3's, written to PATH as
    JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(1)
    k2 = {tag: measure_k2(gen, *K2_TIMED[tag], device=True)
          for tag in K2_DEVICE_TIMED}
    Path(path).write_text(json.dumps({"k2": k2, "k3": measure_k3(gen)}))
    return 0


def k3_short_main() -> int:
    """``python3 chip_smoke.py --k3-short``: K3 alone, built from this
    tree's sources: its registers and CTAs an SM, the K3 sweeps, and the
    calls of ``K3_TIMED`` below one chunk."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    K3.WGMMA_LIBRARY.get()
    log(f"built {K3.WGMMA_LIBRARY.source.name} in "
        f"{K3.WGMMA_LIBRARY.build_seconds:.1f} s")
    report_ptxas(K3.WGMMA_LIBRARY)
    report_k3_occupancy()
    gen = torch.Generator(device="cuda").manual_seed(1)
    n3, worst3 = k3_sweep(gen)
    state3 = k3_state_sweep(gen)
    log(f"K3 sweep: {n3} cases, " + ", ".join(
        f"{ran}: {n} cases, max |kernel-plain| {w:.3g}"
        for ran, (n, w) in sorted(worst3.items())) + "; from a state: "
        + ", ".join(f"{ran}: {n} cases, max |kernel-plain| / scale {w:.3g}"
                    for ran, (n, w) in sorted(state3.items())))
    short = [t for t in K3_TIMED if t[1] <= 64]
    report_k3(measure_k3(gen, short), short, card)
    print(card, flush=True)
    return 0


def bound_entry(err, ms, plain_ms, library_ms, flops, nbytes,
                peak=BF16_FLOPS, ex2_ms=0.0):
    """A measurement with its bound: the larger of the bytes' time at the
    memory rate and the operations' at ``peak``; ``ex2_ms``, the
    exponentials' time on the SFUs, is a third term (an operation)."""
    terms = {"bytes": nbytes / HBM_BPS * 1e3, "operations": flops / peak * 1e3}
    if ex2_ms:
        terms["ex2"] = ex2_ms
    top = max(terms, key=terms.get)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": terms[top],
            "bound_by": "bytes" if top == "bytes" else "operations",
            "terms": terms, "flops": flops, "bytes": nbytes}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def report_serve(sv, card):
    log(f"zamba2-1.2b serve on {card}: {sv['layers']} layers, d_model "
        f"{sv['d_model']}, {sv['params'] / 1e9:.3f} B params; batch "
        f"{SERVE_B}, prompt {SERVE_PROMPT}, {SERVE_NEW} new tokens, greedy: "
        f"prefill {sv['prefill_s']:.3f} s, decode {sv['decode_tok_s']:.1f} "
        f"tok/s ({sv['decode_s']:.3f} s for {SERVE_NEW - 1} steps), peak "
        f"device memory {sv['peak_gb']:.1f} GB; launches per prefill "
        f"{sv['launches']}, K2 by variant {sv['k2_variants']}, K3 by variant "
        f"{sv['k3_variants']} (fp32 activations: K2 "
        f"{sv['f32_k2_variants']}, K3 {sv['f32_k3_variants']}; an fp32 "
        f"prefill {sv['prefill32_s']['kernels']:.4f} s on the kernels, "
        f"{sv['prefill32_s']['plain']:.4f} s on the plain versions, means "
        f"of two turns each)")
    for what in ("prefill", "decode"):
        w, secs, calls, top = sv[f"{what}_trace"]
        busy = sum(secs.values())
        log(f"  traced {what} on {card}: wall {w:.4f} s, device busy "
            f"{busy:.4f} s (idle share {1 - busy / w:.3f}): " + ", ".join(
                f"{k} {secs[k]:.4f} s/{calls[k]} kernels"
                for k in sorted(secs, key=lambda k: -secs[k])))
        for evt_name, (sec, n) in top:
            log(f"    {sec:.4f} s in {n} calls: {evt_name[:90]}")
    (km, kmean), (pm, pmean) = sv["kern_to_f32"], sv["plain_to_f32"]
    log(f"kernel run vs plain-kernel run, same weights and token stream, "
        f"prefill + {SERVE_NEW - 1} decode steps: fp32 activations max "
        f"|logit diff| {sv['f32_max_err']:.4g}, mean {sv['f32_mean_err']:.3g}"
        f" (tolerance {F32_LOGIT_TOL}), greedy agreement "
        f"{sv['greedy_f32'] * 100:.1f}%; bf16 max {sv['logit_max_err']:.4g} "
        f"(prefill {sv['prefill_logit_max_err']:.4g}), mean "
        f"{sv['logit_mean_err']:.3g}, greedy tokens matching the plain "
        f"run's argmax {sv['greedy_plain'] * 100:.1f}%; distance to the fp32"
        f" run: kernel bf16 max {km:.4g} mean {kmean:.3g}, plain bf16 max "
        f"{pm:.4g} mean {pmean:.3g} (max |logit| {sv['logit_absmax']:.3g})")
    sh, red = sv["short"], sv["reduced"]
    (km, kmean), (pm, pmean) = sh["kern_to_f32"], sh["plain_to_f32"]
    log(f"{SHORT_PROMPT}-token prefill (the serving launcher's default "
        f"prompt) through the engine on {card}: bf16 {sh['prefill_s']:.4f}"
        f" s, K2 {sh['k2']}, K3 {sh['k3']}; fp32 K3 {sh['k3_f32']}; fp32 "
        f"kernel vs plain max |logit diff| {sh['f32_max_err']:.4g}, greedy "
        f"agreement {sh['greedy_f32'] * 100:.1f}%; distance to the fp32 "
        f"plain run: kernel bf16 max {km:.4g} mean {kmean:.3g}, plain bf16 "
        f"max {pm:.4g} mean {pmean:.3g}")
    log(f"zamba2-1.2b reduced config ({REDUCED_PROMPT}-token prompts, "
        f"batch {SERVE_B}, fp32) through its engine on {card}: prefill "
        f"{red['prefill_s']:.4f} s, K2 {red['counts'][0]}, K3 "
        f"{red['counts'][1]}; kernel vs plain max |logit diff| "
        f"{red['max_err']:.3g}")


def ptxas_entries(text):
    """``[(kernel, registers, spill store bytes, spill load bytes)]`` from
    an ``-Xptxas -v`` report."""
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return out


def report_k1_ptxas(text):
    """K1's kernels: registers of the f32 register-path instantiations
    (groups compiled, powers), the others', and any that spill."""
    entries = ptxas_entries(text)
    f32 = []
    for name, regs, st, ld in entries:
        m = re.search(r"fold_registers_kernelIfLi(\d)ELi(\d)E", name)
        if m:
            f32.append(f"G{m.group(1)}xP{m.group(2)}: {regs}")
        elif "fold_shared_kernelIf" in name or "count_kernel" in name:
            f32.append(f"{name.split('_kernel')[0].rsplit('_', 1)[-1]}: "
                       f"{regs}")
    spills = [(n, st, ld) for n, _, st, ld in entries if st or ld]
    log(f"  ptxas: K1 {len(entries)} kernels; f32 registers "
        + ", ".join(f32) + f"; {len(spills)} spill"
        + (f": {spills}" if spills else ""))


def report_ptxas(lib):
    """Log a library's ptxas registers and spills; a tensor-core library
    (``*_wgmma.cu``) must keep every accumulator in registers (a library
    found already built has no compiler report to read)."""
    if lib is K.LIBRARY:       # 118 kernels: the f32 ones and spills
        report_k1_ptxas(lib.build_log)
        return
    for line in lib.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Performance Loss")):
            log("  ptxas:", line.strip())
    if not lib.source.name.endswith("_wgmma.cu"):
        return
    if not lib.build_log:
        log(f"  {lib.source.name}: reused build, no ptxas report")
        return
    entries = ptxas_entries(lib.build_log)
    log(f"  {lib.source.name} kernels (registers, spill bytes): "
        + "; ".join(f"{n} {r} {st}/{ld}" for n, r, st, ld in entries))
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", lib.build_log)
    check(spills and not any(int(n) for n in spills),
          f"{lib.source.name} spills registers: {spills}")


def build_kernels():
    """Start every kernel's nvcc at once, then wait on each."""
    t0 = time.perf_counter()
    libs = (K.LIBRARY, K2.WGMMA_LIBRARY, K3.WGMMA_LIBRARY, NR.LIBRARY)
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.get()
        log(f"built {lib.source.name} in {lib.build_seconds:.1f} s "
            f"({lib.path.name})")
        report_ptxas(lib)
    log(f"all kernels built in {time.perf_counter() - t0:.1f} s, side by "
        f"side")
    report_k3_occupancy()


#: the long cell's mean request (mixtral-8x7b, 7,208 tokens): the norm's
#: rows and RoPE's q and k
NR_TOKENS, NR_WIDTH = 7208, 4096
NR_HEADS, NR_KV_HEADS, NR_HEAD_DIM = 32, 8, 128
NR_THETA = 1e6


def ulps(got, want):
    """The largest gap between ``got`` and ``want`` in units in the last
    place of their dtype (bf16 or f16) at the larger magnitude."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[got.dtype]
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(got.dtype).tiny)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 1 - mant)
    return float(((g - w).abs() / ulp).max())


def measure_norm_rope(reps=50):
    """Both one-pass kernels at the long cell's mean shape beside the
    plain functions (CUDA events over ``reps`` calls, bf16): ``{"norm":
    ..., "rope": ...}`` as :func:`bound_entry`s, each with ``ulps``, its
    largest gap to the plain function in bf16 units in the last place,
    which must be at most one.  The norm's ``library_ms`` is
    ``F.rms_norm`` (one PyTorch call, the same function), with its own
    gap as ``library_ulps``; RoPE has no such call.  The bound counts
    each input read once and each output written once."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    T, D = NR_TOKENS, NR_HEAD_DIM
    x = torch.randn(T, NR_WIDTH, generator=gen, device="cuda").to(bf)
    w = (1 + 0.1 * torch.randn(NR_WIDTH, generator=gen, device="cuda")).to(bf)
    q = torch.randn(1, T, NR_HEADS * D, generator=gen, device="cuda").to(
        bf).view(1, T, NR_HEADS, D)
    k = torch.randn(1, T, NR_KV_HEADS * D, generator=gen, device="cuda").to(
        bf).view(1, T, NR_KV_HEADS, D)
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    out = {}
    with torch.no_grad():
        want = rms_norm_plain(x, w)
        got = NR.rms_norm_cuda(x, w, 1e-6)
        err = ulps(got, want)
        gap = float((got.float() - want.float()).abs().max())
        check(err <= 1, f"norm kernel {err:.3g} ulps from the plain norm")
        ms = event_ms(lambda: NR.rms_norm_cuda(x, w, 1e-6), reps)
        plain = event_ms(lambda: rms_norm_plain(x, w), reps)
        lib = lib_err = None
        if hasattr(torch.nn.functional, "rms_norm"):
            def lib_fn():
                return torch.nn.functional.rms_norm(x, (NR_WIDTH,), w, 1e-6)
            lib_err = ulps(lib_fn(), want)
            lib = event_ms(lib_fn, reps)
        out["norm"] = bound_entry(gap, ms, plain, lib, 0,
                                  2 * x.numel() * 2 + w.numel() * 2)
        out["norm"].update(ulps=err, library_ulps=lib_err)
        qo, ko = NR.rope_cuda(q, k, pos, NR_THETA)
        wq, wk = rope_qk_plain(q, k, pos, NR_THETA)
        err = max(ulps(qo, wq), ulps(ko, wk))
        gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in ((qo, wq), (ko, wk)))
        check(err <= 1, f"RoPE kernel {err:.3g} ulps from the plain RoPE")
        ms = event_ms(lambda: NR.rope_cuda(q, k, pos, NR_THETA), reps)
        plain = event_ms(lambda: rope_qk_plain(q, k, pos, NR_THETA), reps)
        out["rope"] = bound_entry(gap, ms, plain, None, 0,
                                  2 * (q.numel() + k.numel()) * 2 + T * 4)
        out["rope"].update(ulps=err)
    return out


def report_norm_rope(m, card):
    for tag, what in (("norm", f"rms_norm [{NR_TOKENS}, {NR_WIDTH}] bf16"),
                      ("rope", f"RoPE q [1, {NR_TOKENS}, {NR_HEADS}, "
                       f"{NR_HEAD_DIM}] and k [1, {NR_TOKENS}, "
                       f"{NR_KV_HEADS}, {NR_HEAD_DIM}] bf16")):
        e = m[tag]
        log(f"{what} on {card}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"(bytes), {100 * e['bound_ms'] / e['ms']:.1f}% of it; "
            f"{e['ulps']:.3g} ulps from plain"
            + ("" if e["library_ms"] is None else
               f"; F.rms_norm {e['library_ms']:.4f} ms, "
               f"{e['library_ulps']:.3g} ulps"))


def norm_rope_main() -> int:
    """``python3 chip_smoke.py --norm-rope``: the norm and RoPE kernels
    alone: build, registers, timing at the long cell's mean shape."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    NR.LIBRARY.get()
    log(f"built {NR.LIBRARY.source.name} in {NR.LIBRARY.build_seconds:.1f} "
        f"s")
    report_ptxas(NR.LIBRARY)
    m = measure_norm_rope()
    report_norm_rope(m, card)
    print(json.dumps({"norm_rope": m}), flush=True)
    print(card, flush=True)
    return 0


def kernel_line(name, source, replaces, launches, m):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(1)

    t0 = time.perf_counter()
    cases, worst = kernel_sweep()
    nf = nonfinite_sweep()
    ne = k1_edge_sweep()
    log(f"K1 sweep: {cases} cases vs plain and float64, max |kernel-plain| "
        f"{worst:.3g}; {nf} cases with NaN/Inf/1e20 in valid rows give the "
        f"plain version's NaN/Inf positions and values; {ne} cases of "
        f"blocks longer than a row-list chunk, wholly masked blocks and "
        f"weights -1/0.5/1/0; every re-launch the same bits; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n2, worst2 = k2_sweep(gen)
    n3, worst3 = k3_sweep(gen)
    state3 = k3_state_sweep(gen)
    log(f"K2 sweep: {n2} cases vs plain, " + ", ".join(
        f"{ran} {dt}: {n} cases, max |kernel-plain| {w:.3g}"
        for (ran, dt), (n, w) in sorted(worst2.items())) + "; "
        f"K3 sweep: {n3} cases vs plain (and the recurrence on the small "
        f"ones), " + ", ".join(
            f"{ran}: {n} cases, max |kernel-plain| {w:.3g}"
            for ran, (n, w) in sorted(worst3.items())) + "; "
        f"K3 from a random initial state vs ssd_chunked_ref from it: "
        + ", ".join(f"{ran}: {n} cases, max |kernel-plain| / scale "
                    f"{w:.3g}" for ran, (n, w) in sorted(state3.items()))
        + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cont = continuity_check(gen)
    log(f"continuity at zamba2-1.2b's full width on {card}: one Mamba2 "
        f"layer's ssm_full over {SERVE_B} x {SERVE_PROMPT} tokens vs "
        f"{SERVE_PROMPT // 2} + {SERVE_PROMPT // 2} from the returned conv "
        f"and SSM state: " + "; ".join(
            f"{dt} ({c['variant']}): chained vs one scan over the same "
            f"steps max err {c['err']:.3g} (scale {c['scale']:.3g}, "
            f"tolerance {K3_TOL * c['scale']:.3g}); scan inputs vs the "
            f"whole prompt's {c['input_gap']:.3g}, scan outputs "
            f"{c['vs_whole']:.3g}, conv state {c['conv_gap']:.3g}"
            for dt, c in cont.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    apart = measure_apart()
    k3m = apart["k3"]
    log(f"K2 (D 16/32) and K3 timing in a process of its own "
        f"{time.perf_counter() - t0:.1f} s (reported below)")

    table, t_draw, t_upload = build_population(SCALE)
    log(f"population: {table.num_rows} subjects x {VOLUME} float32 = "
        f"{table.column('img', 'data').nbytes / 1e9:.2f} GB; drawn in "
        f"{t_draw:.1f} s, uploaded in {t_upload:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    final, m, s = main_path(table)
    log(f"population path on {card}: cold {m['cold_s']:.3f} s, warm "
        f"{m['warm_s']:.4f} s, dirty upload {m['dirty_upload_s']:.3f} s "
        f"({m['refold_upload']} partials re-folded), dirty remove "
        f"{m['dirty_remove_s']:.3f} s ({m['refold_remove']}), rebalance "
        f"{m['rebalance_s']:.4f} s ({m['moved']} regions moved), "
        f"run(impl=kernel) {m['run_kernel_s']:.3f} s; "
        f"host->device {m['h2d_bytes'] / 1e9:.2f} GB; "
        f"K1 launches {m['launches']}; fold paths {m['fold_path_counts']}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    log("K1 launches on the main path by block [R x F], G, sums: " + ", ".join(
        f"[{R} x {F}] G={G} {'+'.join(n)}: {c}"
        for (R, F, G, n), c in sorted(m["k1_shapes"].items(),
                                      key=lambda kv: -kv[1])))
    t0 = time.perf_counter()
    sk = sketch_phase(s, table)
    t_sk = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = frontend_phase(s)
    report_phases(sk, fe, card)
    log(f"phase (g) sketches {t_sk:.1f} s, phase (h) frontend "
        f"{time.perf_counter() - t0:.1f} s")
    close_session(s)
    del s
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
    blocks = measure_block(table, m["k1_shapes"])
    b = blocks["grouped"]
    for tag, what in (("grouped", "the grouped query's largest img:data "
                       "block"), ("mean", "the Mean run's block"),
                      ("age", "the grouped query's idx:age block")):
        k = blocks[tag]
        log(f"K1 at {what} [{k['bucket']} x {k['F']}] f32 ({k['rows']} "
            f"rows, {k['selected']} selected), G={k['G']}, "
            f"{'+'.join(k['names'])}, {k['calls']} such launches on the "
            f"main path, on {card}: {k['ms']:.4f} ms/block in a loop of "
            f"launches, {k['device_ms']:.4f} ms of device time; "
            f"{k['kernel_hbm_gbps']:.0f} GB/s by kernel_hbm_bytes, "
            f"{k['need_gbps']:.0f} GB/s of needed bytes; bound "
            f"{k['bound_ms']:.4g} ms ({k['bound_by']}), "
            f"{k['bound_ms'] / k['device_ms']:.3g} of the device time; "
            f"plain {k['plain_ms']:.3f} ms; index_add_ "
            f"{k['library_ms']:.3f} ms; "
            f"max |kernel-plain| {k['max_abs_err']:.3g}")
    del table, final
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    sv = serve_path()
    report_serve(sv, card)
    t0 = time.perf_counter()
    fm = families_phase()
    report_families(fm, card)
    log(f"phase (i) families {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gc_out = grad_check()
    tr = train_path()
    rs = resume_check()
    report_training(gc_out, tr, rs, card, time.perf_counter() - t0)
    step_j = float(np.mean([r["s"] for r in tr["steps"][1:]]))
    report_distributed(*distributed_phase(step_j), card=card)

    k2m = {tag: measure_k2(gen, *shape) for tag, shape in K2_TIMED.items()
           if tag not in K2_DEVICE_TIMED}
    k2m.update(apart["k2"])
    report_k2(k2m, card)
    report_k3(k3m, K3_TIMED, card)
    nrm = measure_norm_rope()
    report_norm_rope(nrm, card)

    red = sv["reduced"]["counts"]
    print(json.dumps({"kernels": [
        kernel_line("fused_fold",
                    "src/repro_torch/kernels/fused_fold/csrc/fused_fold.cu",
                    "src/repro/kernels/fused_fold/kernel.py:49",
                    m["launches"], b),
        kernel_line("flash_attention",
                    "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_wgmma.cu",
                    "src/repro/kernels/flash_attention/kernel.py:33",
                    sv["k2_variants"]["wgmma"], k2m["zamba2"]["wgmma"]),
        kernel_line("flash_attention_f32",
                    "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_wgmma.cu",
                    "src/repro/kernels/flash_attention/kernel.py:33",
                    sv["f32_k2_variants"]["wgmma_f32"],
                    k2m["zamba2"]["wgmma_f32"]),
        kernel_line("flash_attention_f32_narrow",
                    "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_wgmma.cu",
                    "src/repro/kernels/flash_attention/kernel.py:33",
                    red[0]["wgmma_f32"], k2m["d16"]["wgmma_f32"]),
        kernel_line("ssd_scan",
                    "src/repro_torch/kernels/ssm_scan/csrc/"
                    "ssd_scan_wgmma.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:29",
                    sv["k3_variants"]["wgmma"], k3m["serve"]["wgmma"]),
        kernel_line("ssd_scan_split",
                    "src/repro_torch/kernels/ssm_scan/csrc/"
                    "ssd_scan_wgmma.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:29",
                    sv["f32_k3_variants"]["wgmma_split"],
                    k3m["serve_f32bc"]["wgmma_split"]),
        kernel_line("ssd_scan_short",
                    "src/repro_torch/kernels/ssm_scan/csrc/"
                    "ssd_scan_wgmma.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:29",
                    sv["short"]["k3"]["wgmma_short"],
                    k3m[f"L{SHORT_PROMPT}_B{SERVE_B}_bf16"]["wgmma_short"]),
        kernel_line("ssd_scan_short_split",
                    "src/repro_torch/kernels/ssm_scan/csrc/"
                    "ssd_scan_wgmma.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:29",
                    sv["short"]["k3_f32"]["wgmma_split_short"],
                    k3m[f"L{SHORT_PROMPT}_B{SERVE_B}_f32bc"]
                    ["wgmma_split_short"]),
        kernel_line("ssd_scan_short_split_narrow",
                    "src/repro_torch/kernels/ssm_scan/csrc/"
                    "ssd_scan_wgmma.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:29",
                    red[1]["wgmma_split_short"],
                    k3m[f"narrow_L{SHORT_PROMPT}_f32bc"]
                    ["wgmma_split_short"]),
        kernel_line("rms_norm",
                    "src/repro_torch/kernels/norm_rope/csrc/norm_rope.cu",
                    None, sv["nr_launches"]["norm"], nrm["norm"]),
        kernel_line("rope",
                    "src/repro_torch/kernels/norm_rope/csrc/norm_rope.cu",
                    None, sv["nr_launches"]["rope"], nrm["rope"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure-apart"] and len(sys.argv) == 3:
        sys.exit(measure_apart_main(sys.argv[2]))
    if sys.argv[1:] == ["--norm-rope"]:
        sys.exit(norm_rope_main())
    sys.exit(k3_short_main() if sys.argv[1:] == ["--k3-short"] else main())
