"""whisper-large-v3 [audio] — enc-dec, 32L each side, d_model=1280 20H
d_ff=5120 vocab=51866; conv/mel frontend is a STUB (input_specs provides
1500 frame embeddings).  [arXiv:2212.04356]

Port of ``src/repro/configs/whisper_large_v3.py`` (shape-only, copied).
"""

import torch

from repro_torch.models.config import EncoderConfig, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, head_dim=64,
        encoder=EncoderConfig(n_layers=32, n_frames=1500, d_model=1280,
                              n_heads=20, d_ff=5120),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        encoder=EncoderConfig(n_layers=2, n_frames=16, d_model=64,
                              n_heads=4, d_ff=128),
        remat_policy="none", dtype=torch.float32, param_dtype=torch.float32,
    )
