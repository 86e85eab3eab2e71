"""A configuration file made into the program's ``ModelConfig``, its
family's adapter, and the weights drawn from the seed.

The weights are the benchmark's input: drawn on the device from one
``torch.Generator`` in one ``randn`` call per dtype, in the dtype each
leaf is served in, then scaled in place: matrices by 1/sqrt(fan-in), the
projections that write into the residual stream further by
1/sqrt(2 n_layers) (GPT-2's and Megatron's init), leaves that the
family names by a std of their own or a fixed law.  The family's adapter
(``colobench/families/<reference>.py``, named by the configuration's
``reference`` key) holds those names and lays the program's tree and
caches out as one dict a layer for the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from types import ModuleType
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig
from repro_torch.models.model import COMPUTE_LEAVES, build_model

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def model_config(c: Dict) -> ModelConfig:
    """The program's config from a configuration file's dict (its
    ``ModelConfig`` fields; the other keys are notes)."""
    kw = {k: v for k, v in c.items() if k in _FIELDS}
    for k in ("dtype", "param_dtype"):
        if k in kw:
            kw[k] = DTYPES[kw[k]]
    if kw.get("ssm"):
        kw["ssm"] = SSMConfig(**kw["ssm"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def family(c: Dict) -> ModuleType:
    """The adapter of the configuration's family: ``STD`` (leaves drawn
    with a std of their own), ``RESIDUAL`` (projections into the residual
    stream), ``FIXED`` (leaves with a fixed value), ``layer_view``,
    ``cache_view``, ``params_per_token`` and ``attention_layers``."""
    return importlib.import_module(f"colobench.families.{c['reference']}")


def leaf_paths(tree: Any, path=()):
    """``(path, leaf)`` of a tree of dicts and lists, dict keys sorted (as
    the program's ``tree_map`` rebuilds them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    else:
        yield path, tree


def _set(tree: Any, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


@torch.no_grad()
def make_weights(cfg: ModelConfig, seed: int, device, laws: ModuleType
                 ) -> Dict:
    """The parameter tree in the program's layout, drawn from ``seed``,
    with the std and fixed laws of the family ``laws``.  Each leaf the
    program computes with in ``cfg.dtype`` holds that dtype already, as
    it is served (the engine's cast is then a no-op)."""
    tree = build_model(cfg).init(device="meta")
    leaves = list(leaf_paths(tree))
    drawn: Dict[torch.dtype, List[Tuple[tuple, Any]]] = {}
    # any whole number, folded into 64 bits
    gen = torch.Generator(device=device).manual_seed(seed & (2**64 - 1))
    for path, t in leaves:
        name = path[-1]
        dt = cfg.dtype if name in COMPUTE_LEAVES else t.dtype
        if name in laws.FIXED:
            _set(tree, path, torch.full(t.shape, laws.FIXED[name],
                                        dtype=dt, device=device))
        else:
            drawn.setdefault(dt, []).append((path, t.shape))
    residual = 1.0 / math.sqrt(2 * cfg.n_layers)
    for dt, items in drawn.items():
        n = sum(math.prod(s) for _, s in items)
        buf = torch.randn(n, generator=gen, device=device, dtype=dt)
        at = 0
        for path, shape in items:
            k = math.prod(shape)
            w = buf[at:at + k].view(shape)
            at += k
            std = laws.STD.get(path[-1], 1.0 / math.sqrt(shape[-2]))
            w.mul_(std * (residual if path[-1] in laws.RESIDUAL else 1.0))
            _set(tree, path, w)
    return tree
