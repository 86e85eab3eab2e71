"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5-14B]

Port of ``src/repro/configs/qwen2p5_14b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, head_dim=128,
        rope_theta=1_000_000.0, qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
        d_ff=160, vocab=512, head_dim=16,
        rope_theta=1_000_000.0, qkv_bias=True, remat_policy="none",
        dtype=torch.float32, param_dtype=torch.float32,
    )
