"""Assigned input shapes and their stand-ins on the ``meta`` device.

Port of ``src/repro/launch/shapes.py``.  Four cells per LM architecture:

    train_4k      seq_len=4096    global_batch=256   the train step
    prefill_32k   seq_len=32768   global_batch=32    prefill
    decode_32k    seq_len=32768   global_batch=128   one decode step
    long_500k     seq_len=524288  global_batch=1     one decode step
                                  (SSM/hybrid/windowed archs only)

``input_specs`` returns ``meta`` tensors of the right shape and dtype
(the reference's ``ShapeDtypeStruct``s): nothing is allocated for the
full configs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """-> (runs?, reason if skipped)."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.runs_long_context:
        return False, ("pure full-attention arch: 500k decode cache is "
                       "eligible only for SSM/hybrid/windowed archs")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """``meta`` stand-ins for every input of the cell's step (``shape``: a
    name of ``SHAPES`` or a ``ShapeSpec``)."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32
    if spec.kind in ("train", "prefill"):
        if cfg.is_encdec:
            return {"frames": _meta((B, cfg.encoder.n_frames, cfg.d_model),
                                    cfg.dtype),
                    "tokens": _meta((B, S), i32)}
        if cfg.family == "vlm":
            # frontend stub: precomputed patch/text embeddings + M-RoPE ids
            if spec.kind == "prefill":
                return {"embeds": _meta((B, S, cfg.d_model), cfg.dtype)}
            return {"embeds": _meta((B, S, cfg.d_model), cfg.dtype),
                    "positions": _meta((B, 3, S), i32),
                    "targets": _meta((B, S), i32)}
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against a seq_len cache
    return {"token": _meta((B,), i32), "pos": _meta((B,), i32),
            "caches": build_model(cfg).init_cache(B, S, device="meta")}
