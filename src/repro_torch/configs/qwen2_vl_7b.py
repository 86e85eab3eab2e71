"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE; vision frontend is a STUB (input_specs provides patch
embeddings).  [arXiv:2409.12191]

Port of ``src/repro/configs/qwen2_vl_7b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, head_dim=128,
        rope_theta=1_000_000.0, qkv_bias=True, mrope=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        rope_theta=1_000_000.0, qkv_bias=True, mrope=True,
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
