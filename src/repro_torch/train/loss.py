"""Losses: next-token cross entropy (+ the MoE aux loss, + DeepSeek MTP).

Port of ``src/repro/train/loss.py``.  The target logit is a ``gather``
on a plain tensor; on a DTensor (vocab split over ``model``) it is the
reference's masked reduction (``sharded_safe``), which reduces over the
vocab shards where they lie.  Both add one nonzero term to zeros, so
they give the same value.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import local_call, mesh_coordinate, shard_sum


def _sharded_lse_target(z, targets):
    """Log-sum-exp and target logit of DTensor logits whose vocab dim may
    be split over ``model``: each rank sums over its own vocab slice
    (``local_call``) into partial sums, so neither pass ever holds a
    whole-vocab tensor.  The max is a constant shift (no gradient)."""
    from torch.distributed.tensor import Partial, Replicate

    last = z.dim() - 1
    zp = tuple(z.placements)
    split = [p.is_shard(last) for p in zp]
    whole = tuple(Replicate() if s else p for p, s in zip(zp, split))
    out = tuple(Partial() if s else p for p, s in zip(zp, split))
    m = z.detach().amax(dim=-1, keepdim=True)
    m = m.redistribute(z.device_mesh, whole)

    def sumexp(zl, ml):
        return torch.exp(zl - ml).sum(-1)

    def target(zl, tl):
        lo = mesh_coordinate("model") * zl.shape[-1] if any(split) else 0
        iota = lo + torch.arange(zl.shape[-1], device=zl.device)
        return torch.where(iota == tl[..., None], zl, 0.0).sum(-1)

    lse = torch.log(local_call(sumexp, (z, m), (zp, whole), out)) + m[..., 0]
    tgt = local_call(target, (z, targets), (zp, whole), out)
    return lse, tgt


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in fp32.  logits [..., V], targets [...] int."""
    z = logits.to(torch.float32)
    if hasattr(z, "device_mesh"):
        lse, tgt = _sharded_lse_target(z, targets)
    else:
        lse = torch.logsumexp(z, dim=-1)
        tgt = torch.gather(z, -1, targets[..., None].to(torch.int64))[..., 0]
    nll = lse - tgt
    if mask is None:
        return shard_sum(nll) / nll.numel()
    m = mask.to(torch.float32)
    return shard_sum(nll * m) / torch.clamp(m.sum(), min=1.0)


def lm_loss(
    cfg: ModelConfig,
    model,
    params: Dict,
    tokens: torch.Tensor,          # [B, S]
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss over tokens[:, :-1] -> tokens[:, 1:]."""
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    tgt_mask = None if mask is None else mask[:, 1:]

    if cfg.mtp_depth > 0:
        hidden, aux = model.forward_hidden(params, inputs)
        logits = tf.lm_logits(cfg, params, hidden)
        ce = cross_entropy(logits, targets, tgt_mask)
        # MTP: from h_t and emb(t+1), predict token t+2
        mtp_logits = model.mtp_logits(params, hidden[:, :-1], inputs[:, 1:])
        mtp_ce = cross_entropy(mtp_logits, targets[:, 1:],
                               None if tgt_mask is None else tgt_mask[:, 1:])
        loss = ce + 0.3 * mtp_ce
        if cfg.moe:
            loss = loss + cfg.moe.aux_loss_weight * aux
        metrics = {"ce": ce, "mtp_ce": mtp_ce, "aux": aux}
    else:
        logits, aux = model.forward_train(params, inputs)
        ce = cross_entropy(logits, targets, tgt_mask)
        loss = ce + cfg.moe.aux_loss_weight * aux if cfg.moe else ce
        metrics = {"ce": ce, "aux": aux}
    metrics["loss"] = loss
    return loss, metrics


def encdec_loss(cfg: ModelConfig, model, params: Dict, frames: torch.Tensor,
                tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model.forward_train(params, frames, tokens[:, :-1])
    ce = cross_entropy(logits, tokens[:, 1:])
    return ce, {"ce": ce, "loss": ce, "aux": aux}
