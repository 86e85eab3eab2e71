"""Perf iteration: one cell under config or rules overrides.

Port of ``src/repro/launch/perf.py``.  Counts one (arch x shape) cell on
the single-pod mesh of fake ranks under config and sharding-rule
overrides, with the dry run's probe-corrected accounting
(``launch/dryrun.py``), and caches the record under
``artifacts/perf_torch/<arch>__<shape>__<tag>.json``::

    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3_405b \\
        --shape train_4k --tag chunked_attn --set attention_impl=chunked
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.dryrun import compile_cell, make_mesh
from repro_torch.launch.probes import corrected, make_probe_plan
from repro_torch.launch.roofline import HBM_BYTES, derive_terms, model_flops
from repro_torch.launch.shapes import SHAPES


def apply_overrides(cfg, overrides: Dict[str, str]):
    moe_fields = {f.name for f in dataclasses.fields(type(cfg.moe))} \
        if cfg.moe else set()
    kw = {}
    for key, val in overrides.items():
        if key in moe_fields:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **{key: _conv(val)}))
        else:
            kw[key] = _conv(val)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _conv(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return v == "true"
    return v


def measure(arch: str, shape: str, tag: str,
            overrides: Optional[Dict[str, str]] = None,
            rules_overrides: Optional[Dict[str, tuple]] = None,
            out_dir: str = "artifacts/perf_torch",
            force: bool = False) -> Dict:
    path = os.path.join(out_dir, f"{arch}__{shape}__{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = apply_overrides(get_config(arch), overrides or {})
    mesh = make_mesh("single")
    spec = SHAPES[shape]
    # rule overrides hook into the single resolution point
    orig_rules_for = steps_mod.rules_for
    if rules_overrides:
        def patched(kind, fsdp=True):
            r = dict(orig_rules_for(kind, fsdp))
            r.update(rules_overrides)
            return r
        steps_mod.rules_for = patched
    keys = ("flops", "bytes", "wire_bytes", "cross_node_bytes")
    try:
        t0 = time.perf_counter()
        main = compile_cell(cfg, shape, mesh, spec.kind)
        probe_a, probe_bs = make_probe_plan(cfg)
        a = compile_cell(probe_a, shape, mesh, spec.kind)
        bs = [(pb, compile_cell(pb.cfg, shape, mesh, spec.kind))
              for pb in probe_bs]
        corr = corrected(a, bs, keys)
    finally:
        steps_mod.rules_for = orig_rules_for

    terms = derive_terms(corr["flops"], corr["bytes"], corr["wire_bytes"],
                         corr["cross_node_bytes"])
    mf = model_flops(cfg, spec)
    per_dev = main["memory"]["peak_live_bytes"]
    record = {
        "arch": arch, "shape": shape, "tag": tag,
        "overrides": overrides or {},
        "rules_overrides": {k: list(v) for k, v in
                            (rules_overrides or {}).items()},
        "per_device_bytes": per_dev,
        "fits_h100": bool(per_dev < HBM_BYTES),
        "corrected": {k: corr[k] for k in keys},
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "compute_fraction": terms.compute_fraction(),
            "useful_flops_ratio":
                (mf / mesh.size()) / max(corr["flops"], 1e-30),
        },
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def show(rec: Dict):
    r = rec["roofline"]
    print(f"{rec['arch']} {rec['shape']} [{rec['tag']}] (dry-run, H100 "
          f"constants): dom={r['dominant']} comp={r['compute_s']:.3g}s "
          f"mem={r['memory_s']:.3g}s coll={r['collective_s']:.3g}s "
          f"frac={r['compute_fraction']:.3f} "
          f"peak={rec['per_device_bytes'] / 1e9:.1f}GB "
          f"fits={rec['fits_h100']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (moe fields auto-nested)")
    ap.add_argument("--rule", action="append", default=[],
                    help="rules override name=axis1+axis2 (or empty)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    rules = {}
    for kv in args.rule:
        name, axes = kv.split("=", 1)
        rules[name] = tuple(a for a in axes.split("+") if a)
    show(measure(args.arch, args.shape, args.tag, overrides, rules,
                 force=args.force))


if __name__ == "__main__":
    main()
