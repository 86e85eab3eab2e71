"""The port stands alone: importing every module of ``repro_torch`` and
everything ``chip_smoke.py`` imports loads neither JAX nor the reference
package, and a session with no devices refuses to run without CUDA."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
import torch
from repro_torch.core.grid import GridSession
from repro_torch.data.pipeline import synthetic_image_population
if not torch.cuda.is_available():
    t = synthetic_image_population(payload_shape=(2, 2, 2), scale=0.01)
    try:
        GridSession(t)
    except RuntimeError as e:
        print("RAISED", "CUDA" in str(e))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 20
    assert lines["BAD"] == "[]"
    import torch
    if not torch.cuda.is_available():
        assert lines["RAISED"] == "True"


def test_no_jax_in_port_sources():
    words = ("import jax", "from jax", "from repro.", "import repro.",
             "scaled_dot_product_attention", "torch.compile", "triton")
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += list((ROOT / "src" / "repro_torch").rglob("*.cu"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        for w in words:
            assert w not in text, f"{w!r} in {f}"
