"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) vocab=32000,
8 experts top-2 (expert d_ff=14336), sliding-window attention 4096.
[arXiv:2401.04088]

Port of ``src/repro/configs/mixtral_8x7b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, head_dim=128,
        rope_theta=1_000_000.0, sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336,
                      capacity_factor=1.25),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        rope_theta=1_000_000.0, sliding_window=8,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      capacity_factor=2.0),
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
