"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone (ssm_state=64)
with a SHARED full-attention+MLP block every 6th layer (32H MHA kv=32,
d_ff=8192), vocab=32000.  [arXiv:2411.15242]

Simplification noted in DESIGN.md: the shared block is reused verbatim
(Zamba2's per-invocation LoRA deltas on the shared weights are omitted).

Port of ``src/repro/configs/zamba2_1p2b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig, SSMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                      chunk=128),
        block_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "attn_shared"),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=16),
        block_pattern=("ssm", "ssm", "ssm", "attn_shared"),
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
