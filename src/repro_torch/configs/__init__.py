"""Assigned-architecture registry: ``get_config(name, reduced=...)``.

One module per architecture; each defines ``full()`` (the exact assigned
config, sources cited in-module) and ``smoke()`` (a reduced config of the
same family for CPU tests — same structural flags, tiny dims).

Port of ``src/repro/configs/__init__.py`` (shape-only, copied).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "zamba2_1p2b",
    "llama3_405b",
    "llama3p2_1b",
    "qwen2p5_14b",
    "qwen3_8b",
    "qwen2_vl_7b",
    "mixtral_8x7b",
    "deepseek_v3_671b",
    "whisper_large_v3",
    "rwkv6_3b",
]

#: assignment-sheet ids -> module names
ALIASES: Dict[str, str] = {
    "zamba2-1.2b": "zamba2_1p2b",
    "llama3-405b": "llama3_405b",
    "llama3.2-1b": "llama3p2_1b",
    "qwen2.5-14b": "qwen2p5_14b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-3b": "rwkv6_3b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke() if reduced else mod.full()


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}
