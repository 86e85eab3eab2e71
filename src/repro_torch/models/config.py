"""Model configuration dataclasses for every assigned architecture family.

Port of ``src/repro/models/config.py``: the same dataclasses, with
``torch`` dtypes.  ``param_count()`` counts the shapes of a parameter tree
built on the ``meta`` device, so it allocates nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2/V3 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 14336
    n_shared_experts: int = 0          # deepseek: 1 shared expert
    first_k_dense: int = 0             # deepseek: first 3 layers dense
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01
    # >1 splits tokens into independently-capacitied groups (GShard style);
    # aligned to the batch sharding, dispatch scatters stay shard-local
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer."""

    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128                   # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 "Finch" time/channel mixing."""

    head_dim: int = 64
    decay_lora: int = 64               # rank of the data-dependent decay MLP
    gate_lora: int = 32


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper); frontend is a stub —
    ``input_specs`` provides precomputed frame/patch embeddings."""

    n_layers: int = 32
    n_frames: int = 1500               # whisper: 30 s of audio after conv
    d_model: int = 1280
    n_heads: int = 20
    d_ff: int = 5120


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|vlm|audio|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None     # default d_model // n_heads

    # attention flavour flags
    rope_theta: float = 10_000.0
    qkv_bias: bool = False             # qwen2.5
    qk_norm: bool = False              # qwen3
    sliding_window: Optional[int] = None  # mixtral SWA
    mrope: bool = False                # qwen2-vl M-RoPE (3D positions)
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None

    # hybrid layout (zamba2): cycle of block kinds; "attn_shared" blocks all
    # reuse ONE set of attention weights (the Zamba trick)
    block_pattern: Tuple[str, ...] = ("attn",)

    mtp_depth: int = 0                 # deepseek multi-token-prediction heads

    # numerics
    dtype: torch.dtype = torch.bfloat16    # activations/compute
    param_dtype: torch.dtype = torch.float32

    # training-time knobs
    remat_policy: str = "dots"         # none|dots|full
    scan_layers: bool = True
    attention_impl: str = "einsum"     # einsum | chunked (flash-style XLA)
    attention_block: int = 1024        # KV block for the chunked path
    train_microbatches: int = 1        # grad-accumulation depth per step
    microbatch_unroll: bool = False    # accounting mode (see TrainStepConfig)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return all(k in ("ssm", "rwkv") for k in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """Strictly sub-quadratic in sequence length (every block is
        recurrent or windowed)."""
        for kind in self.block_pattern:
            if kind in ("attn", "attn_shared") and self.sliding_window is None:
                return False
        return True

    @property
    def runs_long_context(self) -> bool:
        """Eligible for the ``long_500k`` cell: SSM/hybrid/linear-attn archs
        run it (per the assignment), pure full-attention archs skip it.
        A hybrid's occasional full-attention block decodes in O(S)/token, so
        hybrids qualify even though their prefill is quadratic."""
        if self.is_encdec:
            return False
        has_recurrent = any(k in ("ssm", "rwkv") for k in self.block_pattern)
        return has_recurrent or self.subquadratic

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer block kinds of the decoder stack."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    # -- parameter counting (for 6ND roofline math) ----------------------

    def param_count(self) -> int:
        """Exact decoder-stack parameter count (embeddings included)."""
        from repro_torch.models.model import count_params_from_shapes  # lazy
        return count_params_from_shapes(self)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed-in experts)."""
        from repro_torch.models.model import count_active_params  # lazy
        return count_active_params(self)
