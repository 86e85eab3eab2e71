"""Encoder-decoder stack (whisper-large-v3 backbone).

Port of ``src/repro/models/encdec.py``.  The conv/mel frontend is a stub:
the caller passes frame embeddings ``[B, n_frames, d_model]``.  Encoder
blocks are pre-LN bidirectional attention (K2, not causal) with a GELU
MLP over fixed sinusoidal positions; decoder blocks add causal
self-attention (K2 at prefill, cached for decode) and cross-attention
against the encoder K/V computed once per request (K2 at prefill, plain
at decode).  No RoPE anywhere: whisper adds absolute positions at the
input.  Both stacks are stacked ``[n, ...]`` as the reference's ``vmap``
makes them, and its ``lax.scan`` over layers is a Python loop.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed_apply,
    embedding_axes,
    gelu_mlp_apply,
    gelu_mlp_axes,
    init_embedding,
    init_gelu_mlp,
    init_layer_norm,
    layer_norm,
    layer_norm_axes,
    sinusoid_positions,
    unembed_apply,
)
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import compute_view, constrain
from repro_torch.models.transformer import (
    _layer,
    _stack,
    stack_layers,
    stack_leading,
    unbind_layers,
)

#: rows of the learned decoder position table; positions wrap modulo it
POS_TABLE = 8192
#: the activations' logical axes (under a sharding policy)
ACT = ("batch", "seq", "embed_act")


def _ln(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


# ----------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------

def init_encoder_block(cfg: ModelConfig, init: Init) -> Dict:
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        "ln1": init_layer_norm(d, dt, init),
        "attn": attn.init_attention(cfg, init),
        "ln2": init_layer_norm(d, dt, init),
        "mlp": init_gelu_mlp(d, cfg.d_ff, dt, init),
    }


def encoder_block_axes(cfg: ModelConfig) -> Dict:
    return {"ln1": layer_norm_axes(), "attn": attn.attention_axes(cfg),
            "ln2": layer_norm_axes(), "mlp": gelu_mlp_axes()}


def encoder_block_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor
                        ) -> torch.Tensor:
    p = compute_view(p, encoder_block_axes(cfg))
    y, _ = attn.attention_full(cfg, p["attn"], _ln(p["ln1"], x),
                               positions=None, causal=False)
    x = x + constrain(y, ACT)
    return constrain(x + gelu_mlp_apply(p["mlp"], _ln(p["ln2"], x), x.dtype),
                     ACT)


# ----------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------

def init_decoder_block(cfg: ModelConfig, init: Init) -> Dict:
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        "ln1": init_layer_norm(d, dt, init),
        "self_attn": attn.init_attention(cfg, init),
        "ln_x": init_layer_norm(d, dt, init),
        "cross_attn": attn.init_attention(cfg, init, cross=True),
        "ln2": init_layer_norm(d, dt, init),
        "mlp": init_gelu_mlp(d, cfg.d_ff, dt, init),
    }


def decoder_block_axes(cfg: ModelConfig) -> Dict:
    return {"ln1": layer_norm_axes(),
            "self_attn": attn.attention_axes(cfg),
            "ln_x": layer_norm_axes(),
            "cross_attn": attn.attention_axes(cfg, cross=True),
            "ln2": layer_norm_axes(), "mlp": gelu_mlp_axes()}


def decoder_block_full(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       enc_kv: Dict) -> Tuple[torch.Tensor, Dict]:
    p = compute_view(p, decoder_block_axes(cfg))
    y, cache = attn.attention_full(cfg, p["self_attn"], _ln(p["ln1"], x),
                                   positions=None)
    x = x + constrain(y, ACT)
    x = x + constrain(attn.cross_attention(cfg, p["cross_attn"],
                                           _ln(p["ln_x"], x), enc_kv), ACT)
    y = gelu_mlp_apply(p["mlp"], _ln(p["ln2"], x), x.dtype)
    return constrain(x + y, ACT), cache


def decoder_block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                         pos: torch.Tensor, cache: Dict, enc_kv: Dict
                         ) -> Tuple[torch.Tensor, Dict]:
    y, cache = attn.attention_decode(cfg, p["self_attn"], _ln(p["ln1"], x),
                                     cache, pos, use_rope=False)
    x = x + y
    x = x + attn.cross_attention(cfg, p["cross_attn"], _ln(p["ln_x"], x),
                                 enc_kv, decode=True)
    return x + gelu_mlp_apply(p["mlp"], _ln(p["ln2"], x), x.dtype), cache


# ----------------------------------------------------------------------
# full model
# ----------------------------------------------------------------------

def init_encdec(cfg: ModelConfig, init: Init) -> Dict:
    dt = cfg.param_dtype
    return {
        "embed": init_embedding(cfg.vocab, cfg.d_model, dt, init),
        "pos_embed": normal_init(init, (POS_TABLE, cfg.d_model), dt,
                                 scale=0.01),
        "encoder": stack_layers(cfg.encoder.n_layers,
                                lambda: init_encoder_block(cfg, init)),
        "enc_ln": init_layer_norm(cfg.d_model, dt, init),
        "decoder": stack_layers(cfg.n_layers,
                                lambda: init_decoder_block(cfg, init)),
        "dec_ln": init_layer_norm(cfg.d_model, dt, init),
    }


def encdec_axes(cfg: ModelConfig) -> Dict:
    return {"embed": embedding_axes(), "pos_embed": (None, "embed"),
            "encoder": stack_leading(encoder_block_axes(cfg)),
            "enc_ln": layer_norm_axes(),
            "decoder": stack_leading(decoder_block_axes(cfg)),
            "dec_ln": layer_norm_axes()}


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames ``[B, T, D]`` (the stub frontend's output) -> encoder
    states."""
    T = frames.shape[1]
    x = frames + sinusoid_positions(T, cfg.d_model, frames.device)[None].to(
        frames.dtype)
    x = constrain(x, ACT)
    for lp in unbind_layers(params["encoder"]):
        x = encoder_block_apply(cfg, lp, x)
    return _ln(params["enc_ln"], x)


def cross_kv_all(cfg: ModelConfig, params: Dict, enc_out: torch.Tensor
                 ) -> Dict:
    """Every decoder layer's cross K/V, stacked ``[L, B, T, Hkv, Dh]``."""
    return _stack([attn.encode_cross_kv(cfg, lp["cross_attn"], enc_out)
                   for lp in unbind_layers(params["decoder"])])


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = embed_apply(params["embed"], tokens, cfg.dtype)
    table = compute_view(params, {"pos_embed": (None, "embed")})["pos_embed"]
    pe = table[positions % table.shape[0]]
    return constrain(x + pe.to(x.dtype), ACT)


def decode_full(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                enc_out: torch.Tensor, collect_cache: bool = False
                ) -> Tuple[torch.Tensor, Any]:
    """Teacher-forced decoder pass -> (logits ``[B, S, V]``, (self-attention
    caches stacked ``[L, ...]`` or None, cross K/V))."""
    x = _embed(cfg, params, tokens,
               torch.arange(tokens.shape[1], device=tokens.device))
    kv = cross_kv_all(cfg, params, enc_out)
    caches = []
    for lp, lkv in zip(unbind_layers(params["decoder"]), unbind_layers(kv)):
        x, cache = decoder_block_full(cfg, lp, x, lkv)
        if collect_cache:
            caches.append(cache)
    x = _ln(params["dec_ln"], x)
    logits = unembed_apply(compute_view(params["embed"], embedding_axes()), x,
                           x.dtype)
    return (constrain(logits, ("batch", "seq", "vocab")),
            (_stack(caches) if collect_cache else None, kv))


def decode_step(cfg: ModelConfig, params: Dict, token: torch.Tensor,
                pos: torch.Tensor, caches: Dict, kv: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token ``[B, 1]`` at ``pos [B]`` against the stacked
    self-attention caches (updated in place) and the cross K/V."""
    x = _embed(cfg, params, token, pos[:, None])
    for i in range(cfg.n_layers):
        x, _ = decoder_block_decode(cfg, _layer(params["decoder"], i), x,
                                    pos, _layer(caches, i), _layer(kv, i))
    x = _ln(params["dec_ln"], x)
    return unembed_apply(params["embed"], x, x.dtype), caches
