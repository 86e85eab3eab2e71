"""The train step: gradient accumulation, AdamW, LR schedules.

Port of ``src/repro/train/step.py``.  ``make_train_step`` returns
``step(params, opt_state, batch, step_idx) -> (params, opt_state,
metrics)``.  Gradients come from ``loss.backward()`` over microbatches
(batch slices), so activation memory is one microbatch deep, and are
summed in fp32 before the mean: an fp32 parameter's ``.grad`` takes each
microbatch's gradient in place, any other's is added into an fp32
buffer.  The reference's ``lax.scan`` and unrolled modes compute the same
numbers, so both are this one Python loop and ``TrainStepConfig`` has no
``unroll_microbatches``.  The step updates ``params`` and the optimizer
state in place (``optim/adamw.py``).

``make_compressed_train_step`` (int8 gradients over a pod axis) needs a
mesh and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.loss import lm_loss
from repro_torch.utils import tree_flatten, tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    num_microbatches: int = 1
    schedule: Optional[Callable] = None  # step -> lr scale


def make_train_state(cfg: ModelConfig, model,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> Tuple[PyTree, PyTree]:
    """Random parameters from ``generator`` on ``device`` (the card unless
    the caller asks for the CPU), and their AdamW state."""
    params = model.init(generator, device)
    return params, adamw_init(params)


def _accumulated_grads(loss_fn: Callable, params: PyTree,
                       batch: torch.Tensor, n_micro: int
                       ) -> Tuple[PyTree, Dict[str, torch.Tensor]]:
    """-> (fp32 grads, metrics), both averaged over microbatches."""
    leaves, treedef = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    B = batch.shape[0]
    micros = (batch,) if n_micro == 1 else batch.reshape(
        n_micro, B // n_micro, *batch.shape[1:])
    acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
    metrics: Dict[str, torch.Tensor] = {}
    for micro in micros:
        loss, m = loss_fn(params, micro)
        loss.backward()
        for k, v in m.items():
            v = v.detach()
            metrics[k] = v if k not in metrics else metrics[k] + v
        for i, p in enumerate(leaves):
            if p.dtype != torch.float32 and p.grad is not None:
                g = p.grad.to(torch.float32)
                p.grad = None
                acc[i] = g if acc[i] is None else acc[i].add_(g)
    grads = []
    for i, p in enumerate(leaves):
        g = p.grad if p.dtype == torch.float32 else acc[i]
        p.grad = None
        p.requires_grad_(False)
        if g is None:           # a leaf the loss never reads
            g = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        grads.append(g)
    if n_micro > 1:
        inv = 1.0 / n_micro
        grads = [g.mul_(inv) for g in grads]
        metrics = {k: v * inv for k, v in metrics.items()}
    return tree_unflatten(treedef, grads), metrics


def make_train_step(
    cfg: ModelConfig,
    model,
    opt_cfg: AdamWConfig,
    step_cfg: TrainStepConfig = TrainStepConfig(),
    loss_fn: Optional[Callable] = None,
):
    """Returns ``step(params, opt_state, batch, step_idx) -> (p, o,
    metrics)``; metrics add ``grad_norm`` (before clipping) and
    ``lr_scale``."""
    if loss_fn is None:
        def loss_fn(p, tokens):
            return lm_loss(cfg, model, p, tokens)

    def step(params, opt_state, batch, step_idx):
        grads, metrics = _accumulated_grads(
            loss_fn, params, batch, step_cfg.num_microbatches)
        lr_scale = (step_cfg.schedule(step_idx)
                    if step_cfg.schedule is not None else 1.0)
        params, opt_state, gnorm = adamw_update(
            opt_cfg, params, grads, opt_state, lr_scale)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr_scale"] = torch.as_tensor(lr_scale, dtype=torch.float32)
        return params, opt_state, metrics

    return step
