"""Nothing a run loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), and the references
load nothing of the program."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import sys, time
from colobench import run as R
R._environment()
import colobench.calibrate, colobench.lib.control
from colobench.lib import cells
from colobench.tests.colobench_tiny import tiny_cell
for name in [w["name"] for w in cells.benchmark()["workloads"]]:
    cell = cells.load(name)
    for m in cell.per_layer:
        cells.reader(m["name"])
    cell.reference()
import torch
torch.set_num_threads(1)
cell = tiny_cell(cells.benchmark()["workloads"][0]["name"])
out = R.run(cell, 3, 0.2, True, "cpu", time.perf_counter())
R.result_line(cell, out, True, {"platform": "cpu", "kind": "cpu", "count": 1})
print("FORBIDDEN", R.loaded_forbidden())
print("PORT", "repro_torch" in sys.modules)
"""

REFERENCE = r"""
import importlib, json, sys
bench = json.load(open("BENCHMARK.json"))
refs = sorted({json.load(open(c["file"]))["reference"]
               for c in bench["configs"]})
for ref in ["common"] + refs:
    importlib.import_module("colobench.reference." + ref)
print("REFS", ",".join(refs))
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                       & {"repro_torch", "repro", "jax", "jaxlib"}))
"""


def _probe(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(line.split(" ", 1) for line in out.stdout.splitlines()
                if " " in line)


def test_a_run_loads_no_jax_and_no_reference_package():
    lines = _probe(RUN)
    assert lines["FORBIDDEN"] == "[]"
    assert lines["PORT"] == "True"


def test_references_load_nothing_of_the_program():
    """The reference of every configuration in ``BENCHMARK.json``."""
    lines = _probe(REFERENCE)
    assert lines["REFS"] and lines["LOADED"] == "[]"


def test_forbidden_names_compare_whole():
    from colobench import run as R
    sys.modules.setdefault("reprox_fake_module", sys)
    try:
        assert "reprox_fake_module" not in R.loaded_forbidden()
    finally:
        sys.modules.pop("reprox_fake_module", None)


def test_harness_sources_name_no_jax():
    for f in (ROOT / "colobench").rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        for w in ("import jax", "from jax", "import repro\n", "from repro.",
                  "import repro.", "import flax"):
            assert w not in text, f"{w!r} in {f}"
