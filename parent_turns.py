#!/usr/bin/env python3
"""Time this tree's K1 and K3 kernels against a parent commit's, in turns,
on one GPU.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    python3 parent_turns.py build/parent

Loads the parent's fused-fold (K1) and SSD-scan (K3) wrappers from their
files under the given tree; each builds its library from the parent's CUDA
sources into ``build/kernels/`` (named by a hash of them).  Then, on one
card and in the order parent, this tree, this tree, parent:

- K1 at the population path's blocks: a grouped query's ``[256 x
  902629]`` f32 block (58 of its first 148 rows selected, G = 2, all five
  sums), a Mean run's ``[16 x 902629]`` block (every row, G = 1, count,
  s1, s2) and an ``idx:age`` block ``[256 x 1]`` (as the grouped one), by
  the profiler's device time;
- K3's wgmma kernel at the serving call (x ``[8, 2048, 64, 64]`` f32, B/C
  bf16, chunk 128, from a zero state), by CUDA events, and whether the two
  trees give the same bits;
- K3 below one chunk (L 12 at B 8 and B 4, and L 64 at B 8, bf16 B/C; L
  12 at B 8 with f32 B/C): each tree's ``ssd_scan_wgmma`` as serving
  calls it, split by ``chip_smoke.k3_call_times`` into its loop time,
  device time and host time a call (the C launchers apart).

Each K1 result is checked against the plain version first.  Prints the
card's name and power limit beside every time.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.fused_fold import kernel as K  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as K3  # noqa: E402


def load(name: str, path: Path):
    """A module from a file of the parent tree; its imports of
    ``repro_torch`` resolve to this tree's (shared helpers only)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def k1_blocks():
    rng = np.random.default_rng(0)
    F = 91 * 109 * 91
    x = torch.randn(256, F, device="cuda")
    x[148:] = 0
    sel = np.zeros(256, np.float32)
    sel[rng.choice(148, 58, replace=False)] = 1
    sel = torch.from_numpy(sel).cuda()
    gids = torch.from_numpy(rng.integers(0, 2, 256).astype(np.int32)).cuda()
    zeros16 = torch.zeros(16, dtype=torch.int32, device="cuda")
    return {
        "grouped [256 x 902629] G=2, 58 rows": (x, gids, sel, 2, C.NAMES),
        "Mean [16 x 902629] G=1, 16 rows": (
            x[:16].contiguous(), zeros16, torch.ones(16, device="cuda"), 1,
            ("count", "s1", "s2")),
        "idx:age [256 x 1] G=2, 58 rows": (x[:, :1].contiguous(), gids, sel,
                                           2, C.NAMES),
    }


def main(argv) -> int:
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[1]).resolve()
    pk = parent / "src" / "repro_torch" / "kernels"
    sides = {"parent": (load("parent_k1", pk / "fused_fold" / "kernel.py"),
                        load("parent_k3", pk / "ssm_scan" / "kernel.py")),
             "this": (K, K3)}
    card = C.card_line()
    libs = [k1.LIBRARY for k1, _ in sides.values()] + [
        lib for _, k3 in sides.values()
        for lib in (k3.WGMMA_LIBRARY, k3.LIBRARY)]
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.get()
    order = ("parent", "this", "this", "parent")

    for name, (x, g, m, G, names) in k1_blocks().items():
        plain = K.fused_fold_torch(x, g, m, G, names)
        for side, (k1, _) in sides.items():
            got = k1.fused_fold_cuda(x, g, m, G, names)
            torch.cuda.synchronize()
            C.check(all(torch.allclose(got[n], plain[n], rtol=1e-4,
                                       atol=1e-3) for n in names),
                    f"K1 ({side}) vs plain at {name}")
        turns = {s: [] for s in sides}
        for side in order:
            fn = sides[side][0].fused_fold_cuda
            turns[side].append(C.device_ms(lambda: fn(x, g, m, G, names),
                                           50))
        print(f"K1 at {name} on {card}, device ms: " + "; ".join(
            f"{s} {sum(t) / len(t):.5f} (turns "
            f"{', '.join(f'{v:.5f}' for v in t)})" for s, t in turns.items()),
            flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    x, a, Bm, Cm = C.k3_inputs(gen, 8, 2048, 64, 64, 64, C.BF16, 0.7)
    outs = {s: k3.ssd_scan_wgmma(x, a, Bm, Cm, 128)
            for s, (_, k3) in sides.items()}
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(outs["parent"],
                                                  outs["this"]))
    turns = {s: [] for s in sides}
    for side in order:
        fn = sides[side][1].ssd_scan_wgmma
        turns[side].append(C.event_ms(lambda: fn(x, a, Bm, Cm, 128), 20))
    print(f"K3 wgmma at x [8,2048,64,64] f32, B/C bf16, chunk 128, from "
          f"zero, on {card}: " + "; ".join(
              f"{s} {sum(t) / len(t):.4f} ms (turns "
              f"{', '.join(f'{v:.4f}' for v in t)})"
              for s, t in turns.items())
          + f"; same bits: {same}", flush=True)

    keys = ("loop_ms", "device_ms", "host_ms", "ctypes_ms")
    for L, B, bdt in ((12, 8, C.BF16), (12, 4, C.BF16), (64, 8, C.BF16),
                      (12, 8, C.F32)):
        x, a, Bm, Cm = C.k3_inputs(gen, B, L, 64, 64, 64, bdt, 0.7)
        want = C.ssd_chunked_ref(x, a, Bm, Cm, L)
        turns = {s: [] for s in sides}
        for side in order:
            k3 = sides[side][1]
            y, st = k3.ssd_scan_wgmma(x, a, Bm, Cm, 128)
            torch.cuda.synchronize()
            scale = max(1.0, float(want[0].abs().max()),
                        float(want[1].abs().max()))
            C.check(max(float((y - want[0]).abs().max()),
                        float((st - want[1]).abs().max()))
                    <= C.K3_TOL * scale, f"K3 ({side}) vs plain at L {L}")
            turns[side].append(C.k3_call_times(
                lambda fn=k3.ssd_scan_wgmma: fn(x, a, Bm, Cm, 128),
                per_call=2 if bdt == C.F32 else 1, mod=k3))

        def fmt(v):
            return "not measured" if v is None else f"{v:.4f}"

        print(f"K3 at x [{B},{L},64,64] f32, B/C "
              f"{str(bdt).replace('torch.', '')}, chunk 128, as serving "
              f"calls it, on {card}: " + "; ".join(
                  f"{s} " + ", ".join(
                      f"{k} {fmt(C.mean_turns(ts)[k])}"
                      + f" ({', '.join(fmt(t[k]) for t in ts)})"
                      for k in keys)
                  for s, ts in turns.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
