"""Serving: batched prefill + decode with fixed-capacity caches.

Port of ``src/repro/serve/engine.py``.  ``make_serve_step`` builds the
one-token ``serve_step``; ``ServeEngine`` is the host-side loop: prefill
the batch once, then decode greedily or with temperature.  The engine runs
on the card (``device="cuda"``, the default) and raises without CUDA unless
the caller asks for ``device="cpu"``.  At load it casts the weights that
every product casts to the compute dtype once (``cast_for_compute``), so no
step pays that conversion again.

Spans.  While a ``torch.profiler`` records, the prefill path names its
layers as profiler ranges (``repro_torch.tracing.span``; untraced, each
costs one check and records nothing):

- ``serve.generate``: one request, the whole of :meth:`ServeEngine.generate`;
  every other span of the request nests inside it.  Directly under it:
  ``serve.upload`` (the prompts' host-to-device copy), ``serve.pad_caches``
  and ``serve.sample`` (sampling and the first token's copy to the host,
  the prefill's one synchronisation).
- ``model.embed`` and ``model.head`` (``LM.prefill``: the embedding and
  positions; the final norm and head at the last position).
- ``model.block``, once a layer (``transformer.block_full``), holding
  ``model.norm`` (its two norms), ``attn.qkv``, ``attn.rope``,
  ``attn.out`` (``attention.attention_full``), ``attn.k2`` (K2's host
  wrapper and launch, ``kernels.flash_attention.flash_attention`` on a
  CUDA tensor), and in an MoE layer ``moe.route``, ``moe.dispatch``,
  ``moe.experts`` (with ``moe.swiglu`` inside) and ``moe.combine``
  (``moe.py``).

The decode loop carries no spans.  To see them, call ``generate`` inside
``with torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA]) as prof:``, then write the trace with
``prof.export_chrome_trace(path)``: the file opens in Perfetto or
``chrome://tracing``, each span above the kernels it launched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    build_model,
    cast_for_compute,
    pad_caches,
    resolve_device,
)
from repro_torch.tracing import span


def make_serve_step(cfg: ModelConfig, model=None) -> Callable:
    """-> ``serve_step(params, caches, token[B], pos[B]) -> (next_token[B],
    logits[B,V], caches)`` with greedy argmax inside."""
    model = model or build_model(cfg)

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(params, token, pos, caches)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches

    return serve_step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # [B, steps]
    steps: int
    #: host-clock seconds of the prefill and of the decode loop, each
    #: ending when its last token is on the host
    prefill_s: float = 0.0
    decode_s: float = 0.0


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, capacity: int,
                 batch_size: int, device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.model = build_model(cfg)
        self.params = cast_for_compute(cfg, params, device)
        self.capacity = capacity
        self.batch_size = batch_size
        self._decode = make_serve_step(cfg, self.model)

    def generate(
        self,
        prompts: np.ndarray,          # [B, S] int32
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> GenerationResult:
        """Prefill the prompts, then decode ``max_new_tokens`` tokens.
        Temperature sampling draws from a ``torch.Generator`` seeded with
        ``seed`` on the engine's device."""
        B, S = prompts.shape
        assert B == self.batch_size
        with span("serve.generate"):
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            t0 = time.perf_counter()
            with span("serve.upload"):
                tokens = torch.as_tensor(np.asarray(prompts),
                                         dtype=torch.int64,
                                         device=self.device)
            logits, caches = self.model.prefill(self.params, tokens)
            with span("serve.pad_caches"):
                caches = pad_caches(self.cfg, caches, self.capacity)
            pos = torch.full((B,), S, dtype=torch.int64, device=self.device)
            with span("serve.sample"):
                tok = _sample(logits, temperature, gen)
                out = [tok.cpu().numpy()]
            t1 = time.perf_counter()
            for _ in range(max_new_tokens - 1):
                nxt, logits, caches = self._decode(self.params, caches, tok,
                                                   pos)
                tok = nxt if temperature <= 0 else _sample(logits,
                                                           temperature, gen)
                pos = pos + 1
                out.append(tok.cpu().numpy())
            t2 = time.perf_counter()
        return GenerationResult(tokens=np.stack(out, axis=1),
                                steps=max_new_tokens, prefill_s=t1 - t0,
                                decode_s=t2 - t1)
