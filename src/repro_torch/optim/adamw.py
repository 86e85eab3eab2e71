"""AdamW from scratch over the port's parameter trees.

Port of ``src/repro/optim/adamw.py``.  Moments are fp32 whatever the
parameters' dtype, the step counter is an int32 scalar, and the update
runs in fp32 and casts back.

The update is in place: each parameter, ``m`` and ``v`` keeps its storage
(the reference's jitted step donates params and optimizer state,
``src/repro/launch/train.py``, so no caller keeps the old values there
either).  At zamba2-1.2b's 1.017 B fp32 parameters a functional update
would hold a second 12 GB copy of params, m and v at its peak.

The decay mask reproduces the reference's leaf names, including its
quirk: ``no_decay_substrings`` holds ``"u"``, which matches every path
under ``runs/`` and every ``mlp/up``, so those leaves skip weight decay
too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    # names whose params skip weight decay (norms, biases, scalar gains)
    no_decay_substrings: Tuple[str, ...] = (
        "scale", "bias", "norm", "a_log", "dt_bias", "d_skip", "mu",
        "w0", "u", "ln_",
    )


def adamw_init(params: PyTree) -> PyTree:
    def zeros(p):       # a DTensor's state is a DTensor of its layout
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: PyTree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def decay_names(params: PyTree) -> List[str]:
    """Each leaf's name as the reference's mask reads it: dict keys and
    ``[i]`` list indices joined by ``/``, lower-cased."""
    return ["/".join(f"[{k}]" if isinstance(k, int) else str(k)
                     for k in path).lower()
            for path, _ in tree_leaves_with_path(params)]


def _decay_mask(params: PyTree, cfg: AdamWConfig) -> List[bool]:
    """Per leaf, in flatten order: whether weight decay applies."""
    return [not any(s in name for s in cfg.no_decay_substrings)
            for name in decay_names(params)]


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: PyTree,
    grads: PyTree,
    state: PyTree,
    lr_scale=1.0,
) -> Tuple[PyTree, PyTree, torch.Tensor]:
    """-> (params, new state, pre-clip grad norm).  ``params``, ``m`` and
    ``v`` are updated in place and returned; ``grads`` is left as it
    is."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)

    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    lr = cfg.lr * lr_scale

    flat_p = tree_leaves(params)
    for p, g, m, v, do_decay in zip(flat_p, tree_leaves(grads),
                                    tree_leaves(state["m"]),
                                    tree_leaves(state["v"]),
                                    _decay_mask(params, cfg)):
        g32 = g.to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * (g32 * g32))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        if do_decay:
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
