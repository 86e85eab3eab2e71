"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings.  [hf:meta-llama/Llama-3.2-1B]

Port of ``src/repro/configs/llama3p2_1b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=64,
        rope_theta=500_000.0, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        rope_theta=500_000.0, tie_embeddings=True, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32,
    )
