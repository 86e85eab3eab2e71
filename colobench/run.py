#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 colobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository's root.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` profiles
a short steady stretch instead and reports the per-layer metrics.  Both
then compare what the timed calls produced with the plain float32
reference and print each compared number beside its limit, as the last
lines on standard error and under ``checks``, the last key of the result
line, which is the last line on standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    program and the benchmark importable from it."""
    cache = ROOT / "build" / "colobench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"colobench: {msg}", file=sys.stderr, flush=True)


def result_line(cell, out: dict, trace: bool, dev_info: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace
    0``) or its per-layer metrics (``--trace 1``), then ``checks``."""
    metrics = {}
    if trace:
        from colobench.lib.cells import reader
        for m in cell.per_layer:
            v = reader(m["name"]).read(out["reading"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = dict(dev_info, memory_peak_bytes=out["peak"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        tr = out["reading"].trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.breakdown()
    line["checks"] = out["checks"]
    return line


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float
        ) -> dict:
    """One run of ``cell`` on ``device`` -> the harness's output dict, by
    the generator of its traffic's kind
    (``colobench/generators/<kind>.py``)."""
    import importlib
    gen = importlib.import_module(
        f"colobench.generators.{cell.traffic['kind']}")
    return gen.run(cell, seed, seconds, trace, device, t0, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from colobench.lib import cells
    from colobench.lib import device as dev

    cell = cells.load(args.workload)
    dev.require(cell.chips)
    log(f"card: {dev.smi()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    line = result_line(cell, out, bool(args.trace),
                       dev.describe(cell.chips))
    bad = loaded_forbidden()
    if bad:
        log(f"the run loaded {bad}; no result")
        return 3
    for name, v in out["checks"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
