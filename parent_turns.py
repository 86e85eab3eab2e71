#!/usr/bin/env python3
"""Time this tree's K2 and K3 kernels against a parent commit's, in turns,
on one GPU.

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    python3 parent_turns.py build/parent
    python3 parent_turns.py build/parent --wide-only 4

Loads the parent's flash-attention (K2) and SSD-scan (K3) wrappers from
their files under the given tree; each builds its libraries from the
parent's CUDA sources into ``build/kernels/`` (named by a hash of them).
Each side is called through its own dispatch (``flash_attention_cuda``,
``ssd_scan_cuda``), so each runs the kernel its own ``variant`` picks.
Then, on one card and in the order parent, this tree, this tree, parent:

- K2 at the narrow head dims of the reduced configs: causal ``[8, 32,
  2048, D]`` for D 16 and 32, bf16 and fp32, as ``[B, S, H, D]`` views;
  and at zamba2-1.2b's serving call (D 64, bf16 and fp32);
- K3 at the narrow dims: x ``[8, 2048, 64, 16]`` f32, N 16, a configured
  chunk of 16, bf16 and f32 B/C, and the same at L 12; and at the
  serving call (P = N = 64, chunk 128, bf16 B/C) twice, the second time
  in the mirrored order (this tree, parent, parent, this tree).

``--wide-only ROUNDS`` times only K3's serving call, in ROUNDS rounds
whose order alternates between the two.

Each side's result is checked against the plain version first.  Each
time is a loop time by CUDA events and the profiler's device time, the
mean of the two turns, beside the plain version's loop time and, for
K2, SDPA's (loop and device) on the same inputs.  Each row has its
bound, with every term shown: bytes at 3.35 TB/s, tensor operations at
989 TFLOP/s (three products a product under the split contract, for
f32) and, for K2, the softmax's exponentials: one ``ex2`` a causal pair
at 16 results a clock an SM (the CUDA C Programming Guide's throughput
table for compute capability 9.0) on 132 SMs at the card's maximum SM
clock, which ``nvidia-smi`` reports.  Prints the card's name and power
limit beside every time.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K2  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as K3  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref  # noqa: E402

ORDER = ("parent", "this", "this", "parent")
MIRRORED = ("this", "parent", "parent", "this")


def load(name: str, path: Path):
    """A module from a file of the parent tree; its imports of
    ``repro_torch`` resolve to this tree's (shared helpers only)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def libraries(mod):
    return [getattr(mod, n) for n in ("WGMMA_LIBRARY", "LIBRARY")
            if hasattr(mod, n)]


def turns_of(fns, timer, order=ORDER):
    out = {s: [] for s in fns}
    for side in order:
        out[side].append(timer(fns[side]))
    return out


def mean(v):
    return sum(v) / len(v)


def fmt_turns(t):
    return f"{mean(t):.4f} ({', '.join(f'{v:.4f}' for v in t)})"


def k2_row(sides, card, clock, gen, B, H, S, D, dt):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scale = D ** -0.5
    want = attention_ref(q, k, v, scale)
    ran = {}
    for side, mod in sides.items():
        ran[side] = mod.variant(dt, D)
        got = mod.flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        C.check(err <= C.K2_TOL[dt] * (1 + float(want.float().abs().max())),
                f"K2 {side} ({ran[side]}) at D {D} {dt}: max err {err:.3g}")
    del got, want
    fns = {s: (lambda m=m: m.flash_attention_cuda(q, k, v, scale))
           for s, m in sides.items()}
    loop = turns_of(fns, lambda fn: C.event_ms(fn, 5))
    dev = turns_of(fns, lambda fn: C.device_ms(fn, 5))
    def lib():
        return C.sdpa(q, k, v, scale)

    sdpa_loop, sdpa_dev = C.event_ms(lib, 10), C.device_ms(lib, 10)
    plain = C.event_ms(lambda: attention_ref(q, k, v, scale), 2)
    pairs = B * H * (S * (S + 1) // 2)
    split = 3 if dt == torch.float32 else 1
    b = C.bound_entry(None, None, None, None, split * 4 * D * pairs,
                      4 * B * S * H * D * q.element_size(),
                      ex2_ms=pairs / (C.SFU_PER_CLOCK * C.SMS * clock) * 1e3)
    name = str(dt).replace("torch.", "")
    print(f"K2 causal [{B},{H},{S},{D}] {name} on {card}: "
          + "; ".join(f"{s} {ran[s]} loop {fmt_turns(loop[s])} ms, device "
                      f"{fmt_turns(dev[s])} ms" for s in sides)
          + f"; SDPA loop {sdpa_loop:.4f} ms, device {sdpa_dev:.4f} ms; "
          f"plain {plain:.4f} ms; bound {b['bound_ms']:.5f} ms "
          f"({C.fmt_terms(b['terms'])})",
          flush=True)


def k3_row(sides, card, gen, B, L, H, P, N, chunk, bdt, order=ORDER):
    x, a, Bm, Cm = C.k3_inputs(gen, B, L, H, P, N, bdt, 0.7)
    want = ssd_chunked_ref(x, a, Bm, Cm, min(chunk, L))
    scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
    ran = {}
    for side, mod in sides.items():
        # the variant the call ran, from the counts: the two trees'
        # ``variant`` need not take the same arguments
        mod.reset_counts()
        y, st = mod.ssd_scan_cuda(x, a, Bm, Cm, chunk)
        ran[side] = next(k for k, v in mod.ssd_scan_cuda.by_variant.items()
                         if v)
        torch.cuda.synchronize()
        err = max(float((y - want[0]).abs().max()),
                  float((st - want[1]).abs().max()))
        C.check(err <= C.K3_TOL * scale,
                f"K3 {side} ({ran[side]}) at {(B, L, H, P, N, chunk)}: max "
                f"err {err:.3g} (scale {scale:.3g})")
    del y, st, want
    turns = {s: [] for s in sides}
    for side in order:
        mod = sides[side]
        turns[side].append(C.k3_call_times(
            lambda m=mod: m.ssd_scan_cuda(x, a, Bm, Cm, chunk),
            per_call=2 if "split" in ran[side] else 1, mod=mod))
    plain = C.event_ms(lambda: ssd_chunked_ref(x, a, Bm, Cm, min(chunk, L)),
                       3)
    flops, nbytes = C.k3_work(B, L, H, P, N, min(chunk, L),
                              Bm.element_size())
    b = C.bound_entry(None, None, None, None,
                      (1 if bdt == C.BF16 else 3) * flops, nbytes)

    def fmt(ts, key):
        vals = [u[key] for u in ts]
        if any(v is None for v in vals):
            return "not measured"
        return fmt_turns(vals)

    name = str(bdt).replace("torch.", "")
    print(f"K3 x [{B},{L},{H},{P}] N {N} chunk {chunk} B/C {name} on "
          f"{card}, order {', '.join(order)}: " + "; ".join(
              f"{s} {ran[s]} loop {fmt(turns[s], 'loop_ms')} ms, device "
              f"{fmt(turns[s], 'device_ms')} ms, host "
              f"{fmt(turns[s], 'host_ms')} ms a call" for s in sides)
          + f"; plain {plain:.4f} ms; library none; bound "
          f"{b['bound_ms']:.5f} ms ({C.fmt_terms(b['terms'])})", flush=True)


def main(argv) -> int:
    wide_only = len(argv) == 4 and argv[2] == "--wide-only"
    if (len(argv) != 2 and not wide_only) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[1]).resolve()
    pk = parent / "src" / "repro_torch" / "kernels"
    k2s = {"parent": load("parent_k2", pk / "flash_attention" / "kernel.py"),
           "this": K2}
    k3s = {"parent": load("parent_k3", pk / "ssm_scan" / "kernel.py"),
           "this": K3}
    card = C.card_line()
    clock = C.max_sm_clock_hz()
    print(f"card {card}, max SM clock {clock / 1e6:.0f} MHz", flush=True)
    mods = [*k3s.values()] if wide_only else [*k2s.values(), *k3s.values()]
    libs = [lib for m in mods for lib in libraries(m)]
    # one build a source: the two trees may share one
    unique = {lib.target(): lib for lib in libs}
    for lib in unique.values():
        lib.start()
    for lib in [*unique.values(), *libs]:
        lib.get()
    gen = torch.Generator(device="cuda").manual_seed(1)
    if wide_only:
        for r in range(int(argv[3])):
            k3_row(k3s, card, gen, 8, 2048, 64, 64, 64, 128, C.BF16,
                   MIRRORED if r % 2 else ORDER)
        print(card, flush=True)
        return 0
    for D in (16, 32):
        for dt in (C.BF16, C.F32):
            k2_row(k2s, card, clock, gen, 8, 32, 2048, D, dt)
    for dt in (C.BF16, C.F32):
        k2_row(k2s, card, clock, gen, 8, 32, 2048, 64, dt)
    for L in (2048, 12):
        for bdt in (C.BF16, C.F32):
            k3_row(k3s, card, gen, 8, L, 64, 16, 16, 16, bdt)
    for order in (ORDER, MIRRORED):
        k3_row(k3s, card, gen, 8, 2048, 64, 64, 64, 128, C.BF16, order)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
