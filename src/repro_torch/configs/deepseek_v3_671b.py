"""deepseek-v3-671b [moe] — 61L d_model=7168 128H, MLA, MoE 256 routed
top-8 + 1 shared (expert d_ff=2048), first 3 layers dense (d_ff=18432),
MTP depth 1, vocab=129280.  [arXiv:2412.19437]

Port of ``src/repro/configs/deepseek_v3_671b.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432,                       # dense layers (first 3)
        vocab=129280, head_dim=128,
        rope_theta=10_000.0,
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared_experts=1, first_k_dense=3,
                      capacity_factor=1.25),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mtp_depth=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, first_k_dense=1,
                      capacity_factor=2.0),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        mtp_depth=1,
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
