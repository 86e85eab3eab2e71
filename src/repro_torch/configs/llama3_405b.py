"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]

Port of ``src/repro/configs/llama3_405b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256, head_dim=128,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=16,
        rope_theta=500_000.0, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32,
    )
