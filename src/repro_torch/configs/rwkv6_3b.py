"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 attention-free, d_ff=8960
vocab=65536, data-dependent decay.  [arXiv:2404.05892]

Port of ``src/repro/configs/rwkv6_3b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig, RWKVConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65536, head_dim=64,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=32),
        block_pattern=("rwkv",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=224, vocab=512, head_dim=16,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8),
        block_pattern=("rwkv",),
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
