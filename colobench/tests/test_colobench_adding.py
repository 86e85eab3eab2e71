"""A configuration goes into the benchmark through new files and entries
alone: a copy of ``BENCHMARK.json`` and ``colobench/`` gains a second
Mixtral configuration (4 layers, a name of its own), one cell with its
limits, the cell's name in the ``workloads`` of the end-to-end metric it
reports and one per-layer entry of its own, and the tests that loop over
every configuration and cell pass on the copy, the new cell's included,
with no file that was there edited."""

import json
import os
import shutil
import subprocess
import sys

from colobench.lib import cells

CONFIG = "mixtral-8x7b-4L"
#: sorts before the existing cells, so tests that take the first one take
#: it
CELL = "mixtral-4L-prefill-short"
METRIC = "mfu.ttft-4L"
TESTS = ["test_colobench_reference.py", "test_colobench_faults.py",
         "test_colobench_work.py", "test_colobench_cells.py"]


def add_a_configuration(root):
    """New files and entries under ``root``: nothing that is there
    changes but the lists that a new cell joins."""
    here = root / "colobench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    c = json.loads((here / "configs" / "mixtral-8x7b-8L.json").read_text())
    c.update(name=CONFIG, n_layers=4)
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(c, indent=2))
    entry = next(x for x in bench["configs"]
                 if x["name"] == "mixtral-8x7b-8L")
    bench["configs"].append(dict(entry, name=CONFIG,
                                 file=f"colobench/configs/{CONFIG}.json"))
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "azure-conv-under-knee",
        "chips": 1, "why": "the short mix on half of a pipeline stage"})
    shutil.copy(here / "limits" / "mixtral-prefill-short.json",
                here / "limits" / f"{CELL}.json")
    next(m for m in bench["end_to_end"]
         if m["name"] == "ttft_p95_ms")["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": METRIC, "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "whole step",
        "moves": "ttft_p95_ms", "workloads": [CELL]})
    (here / "metrics" / f"{METRIC}.py").write_text(
        "from colobench.lib.readers import mfu as read  # noqa: F401\n")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def run_tests(root, src, timeout=600):
    """The tests that loop over every configuration and cell, run on the
    benchmark under ``root`` with the program under ``src`` -> (exit
    code, output)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env.update(PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-p", "no:randomly"]
        + [f"colobench/tests/{t}" for t in TESTS],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def test_a_configuration_goes_in_by_files_alone(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(cells.ROOT / "BENCHMARK.json", root)
    shutil.copytree(cells.ROOT / "colobench", root / "colobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    add_a_configuration(root)
    changed = {p.relative_to(root).as_posix() for p, b in before.items()
               if p.read_bytes() != b}
    assert changed == {"BENCHMARK.json"}
    rc, out = run_tests(root, cells.ROOT / "src")
    assert rc == 0, out[-6000:]
    passed = [ln for ln in out.splitlines() if ln.startswith("PASSED")]
    for test in ("test_prefill_logits_and_caches", "test_sound_prefill",
                 "test_broken_prefill", "test_altered_token",
                 "test_prefill_control", "test_cell_files_found_by_name",
                 "test_active_weights_match_the_program"):
        assert any(test in ln and ("4L" in ln) for ln in passed), test
