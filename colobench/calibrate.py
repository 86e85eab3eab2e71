#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
chip at the cell's own size: the program's numbers over many seeds
(short runs through the run's own path, window and check) and the
control's over a few; or, with ``--rates``, a sweep of the offered rate
that finds the highest the system sustains.

    python3 colobench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 4 [--out <file>.jsonl]
    python3 colobench/calibrate.py --workload <cell> --seeds 0 \
        --control-seeds 0 --rates 60,30,25 --sweep-seconds 10

Each reading is printed as one JSON line (and appended to ``--out``);
the last lines give, for each number, the program's largest reading and
the control's smallest.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from colobench import run as R  # noqa: E402

#: seeds past 2**31, as a check's are, and unlike any a run used
BASE = 2**31 + 104_729


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--rates", default="",
                    help="offered rates a second, comma-separated")
    ap.add_argument("--sweep-seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    R._environment()
    from colobench.generators.prefill import Traffic
    from colobench.lib import cells, control
    from colobench.lib import device as dev

    cell = cells.load(args.workload)
    if args.device == "cuda":
        dev.require(cell.chips)
        R.log(f"card: {dev.smi()}")
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for rate in [float(r) for r in args.rates.split(",") if r]:
        swept = copy.deepcopy(cell)
        swept.traffic["arrivals"]["rate_per_s"] = rate
        out = R.run(swept, BASE, args.sweep_seconds, False, args.device,
                    time.perf_counter())
        emit({"cell": cell.name, "side": "sweep", "rate_per_s": rate,
              "requests": out["attempted"], "e2e": out["e2e"],
              "values": out["values"]})
    for k in range(args.seeds):
        seed = BASE + 7919 * k
        out = R.run(cell, seed, args.seconds, False, args.device,
                    time.perf_counter())
        emit({"cell": cell.name, "side": "program", "seed": seed,
              "values": out["values"],
              "e2e": out["e2e"], "peak": out["peak"]})
    for k in range(args.control_seeds):
        seed = BASE + 7919 * k
        t = Traffic(cell.traffic, cell.config["vocab"], seed)
        n_req = max(t.n, t.arrived_by(args.seconds))
        emit({"cell": cell.name, "side": "control", "seed": seed,
              "values": control.prefill_control(cell, seed, args.device,
                                                n_req, R.log)})
    for name in (rows[-1]["values"] if rows else cell.limits):
        by_side = {}
        for r in rows:
            by_side.setdefault(r["side"], []).append(r["values"][name])
        by_side.pop("sweep", None)
        prog = by_side.pop("program", [])
        R.log(f"{name}: program max {max(prog) if prog else None!r} over "
              f"{len(prog)} seeds; " + "; ".join(
                  f"{side} min {min(v)!r} over {len(v)} seeds"
                  for side, v in by_side.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
