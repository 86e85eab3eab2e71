"""The card the run uses: its name, count, power limit and clocks, and
the synchronise and memory readings that a CPU run (the tests) stubs."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict

import torch


def require(chips: int) -> None:
    """Raise unless CUDA is there with at least ``chips`` cards."""
    if not torch.cuda.is_available():
        raise SystemExit("colobench: torch.cuda.is_available() is false; "
                         "the benchmark measures the card and prints no "
                         "result without one")
    have = torch.cuda.device_count()
    if have < chips:
        raise SystemExit(f"colobench: the cell asks for {chips} cards and "
                         f"{have} are visible")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def describe(count: int) -> Dict:
    """The result line's ``device``: the card's name and the count."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def smi() -> str:
    """The card's name, power limit and draw, SM clock and its maximum,
    as ``nvidia-smi`` reads them (empty where it is missing)."""
    if not shutil.which("nvidia-smi"):
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
         "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
