"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk-norm.  [hf:Qwen/Qwen3-8B]

Port of ``src/repro/configs/qwen3_8b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12288, vocab=151936, head_dim=128,
        rope_theta=1_000_000.0, qk_norm=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        rope_theta=1_000_000.0, qk_norm=True, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32,
    )
