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
state in place (``optim/adamw.py``).  Parameters, optimizer state and
batch may be DTensors (``launch/steps.py`` runs the step under a
sharding policy).

``make_compressed_train_step`` syncs int8 gradients over a ``pod`` mesh
axis: each pod computes gradients on its own batch shard, then the
int32-cast payloads are summed and the scales maxed over ``pod``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import int8_compress
from repro_torch.train.loss import lm_loss
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

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


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (``x`` itself if
    plain)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _accumulated_grads(loss_fn: Callable, params: PyTree,
                       batch: torch.Tensor, n_micro: int
                       ) -> Tuple[PyTree, Dict[str, torch.Tensor]]:
    """-> (fp32 grads, metrics), both averaged over microbatches."""
    leaves, treedef = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if n_micro == 1:
        micros = (batch,)
    else:
        Bm = batch.shape[0] // n_micro
        whole = batch
        if hasattr(batch, "device_mesh"):   # slice whole rows, re-split
            from torch.distributed.tensor import Replicate
            mesh = batch.device_mesh
            whole = batch.redistribute(mesh, [Replicate()] * mesh.ndim)
        micros = [whole[i * Bm:(i + 1) * Bm] for i in range(n_micro)]
        if whole is not batch:
            micros = [m.redistribute(mesh, batch.placements) for m in micros]
    acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
    metrics: Dict[str, torch.Tensor] = {}
    for micro in micros:
        loss, m = loss_fn(params, micro)
        _full(loss).backward()
        for k, v in m.items():
            v = _full(v.detach())
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
            g = torch.zeros_like(p, dtype=torch.float32)
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
        metrics["grad_norm"] = _full(gnorm)
        metrics["lr_scale"] = torch.as_tensor(lr_scale, dtype=torch.float32)
        return params, opt_state, metrics

    return step


def make_compressed_train_step(
    cfg: ModelConfig,
    model,
    opt_cfg: AdamWConfig,
    mesh,
    step_cfg: TrainStepConfig = TrainStepConfig(),
):
    """int8 gradient sync over the ``pod`` axis of ``mesh``.

    Parameters and optimizer state are DTensors on ``mesh``, whole over
    ``pod`` (the rules never split a weight over it); the batch is split
    over ``(pod, data)``, or is a full tensor that each pod slices.  Each
    pod computes gradients on its own batch shard under the sharding
    policy of its ``(data, model)`` submesh (no reduction across pods),
    quantizes them to int8 (``optim/compression.py``), sums the
    int32-cast payloads and maxes the scales over ``pod``, divides by the
    pod count, averages the metrics over pods and then applies an
    identical AdamW update on every pod, in place."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import sharding_rules
    from repro_torch.models.sharding import ShardingPolicy, use_policy

    names = tuple(mesh.mesh_dim_names)
    pod = names.index("pod")
    inner = tuple(n for n in names if n != "pod")
    sub = mesh[inner]
    group = mesh.get_group("pod")
    n_pods = mesh.size(pod)
    policy = ShardingPolicy(sub, sharding_rules())

    def to_sub(t):
        """The pod's view of a DTensor whole over ``pod`` (its storage)."""
        pl = list(t.placements)
        if not pl[pod].is_replicate():
            raise ValueError(f"{pl}: state must be whole over pod")
        del pl[pod]
        return DTensor.from_local(t.to_local(), sub, pl, run_check=False)

    def batch_to_sub(batch):
        if isinstance(batch, DTensor):
            pl = list(batch.placements)
            del pl[pod]
            return DTensor.from_local(batch.to_local(), sub, pl,
                                      run_check=False)
        per = batch.shape[0] // n_pods
        i = mesh.get_local_rank("pod")
        return policy.constrain(batch[i * per:(i + 1) * per],
                                ("batch",) + (None,) * (batch.dim() - 1))

    def loss_fn(p, tokens):
        return lm_loss(cfg, model, p, tokens)

    def step(params, opt_state, batch, step_idx):
        sp = tree_map(to_sub, params)
        so = {"m": tree_map(to_sub, opt_state["m"]),
              "v": tree_map(to_sub, opt_state["v"]),
              "step": opt_state["step"]}
        with use_policy(policy):
            grads, metrics = _accumulated_grads(
                loss_fn, sp, batch_to_sub(batch), step_cfg.num_microbatches)
            q, scales = int8_compress(grads)

        def synced(qq, ss):
            # int8 payload over the wire; summed in int32 (no overflow)
            total = qq.to_local().to(torch.int32)
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            s = ss.full_tensor().reshape(1)
            dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
            g = total.to(torch.float32) * s / n_pods
            return DTensor.from_local(g, sub, qq.placements, run_check=False)

        grads = tree_map(synced, q, scales)
        for v in metrics.values():
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
        metrics = {k: v / n_pods for k, v in metrics.items()}
        lr_scale = (step_cfg.schedule(step_idx)
                    if step_cfg.schedule is not None else 1.0)
        with use_policy(policy):
            _, so, gnorm = adamw_update(opt_cfg, sp, grads, so, lr_scale)
        metrics["grad_norm"] = _full(gnorm)
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "step": so["step"]}, metrics

    return step
