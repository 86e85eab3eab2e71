"""A cell found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its limits and the readers of its
per-layer metrics.  Everything that belongs to one configuration, mix or
metric is a file of its own:

- ``colobench/configs/<config>.json`` (the file ``BENCHMARK.json``
  names), whose ``reference`` key names both the plain reference
  ``colobench/reference/<ref>.py`` and the family's adapter
  ``colobench/families/<ref>.py``;
- ``colobench/traffic/<traffic>.json``, read by the one generator of its
  ``kind``, ``colobench/generators/<kind>.py``;
- ``colobench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
- ``colobench/metrics/<metric>.py``: ``read(ctx)`` of one per-layer
  metric, returning a number or None when the trace holds nothing for
  it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "colobench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"colobench.reference.{self.config['reference']}")


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "colobench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "colobench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module of ``colobench/metrics/<metric>.py`` (names hold dots,
    so it is loaded from its path)."""
    path = root / "colobench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "colobench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
