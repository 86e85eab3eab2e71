"""A configuration file made into the program's ``ModelConfig``, its
family's adapter, and the weights drawn from the seed.

The weights are the benchmark's input: drawn on the device from one
``torch.Generator`` in one ``randn`` call per dtype, in the dtype each
leaf is served in, then scaled in place: matrices by 1/sqrt(fan-in), the
projections that write into the residual stream further by
1/sqrt(2 n_layers) (GPT-2's and Megatron's init), leaves that the
family names by a std of their own or a fixed value.  A leaf with fewer
than two dimensions of its own (the layer axis of a stacked run does
not count) has no fan-in: its family names its law, and then from the
same generator, after the ``randn`` calls, draws each leaf that it
names under ``LAWS``.  The family's adapter
(``colobench/families/<reference>.py``, named by the configuration's
``reference`` key) holds those names and lays the program's tree and
caches out as one dict a layer for the reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import typing
from types import ModuleType
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import COMPUTE_LEAVES, build_model

_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{name!r} names no torch dtype")
    return dt


def _value(hint: Any, v: Any) -> Any:
    """``v`` as JSON holds it, made into the type its field's annotation
    names: a config dataclass from a dict, a dtype from its name, a tuple
    from a list (``Optional[X]`` reads as ``X``)."""
    if v is None:
        return None
    for t in (hint, *typing.get_args(hint)):
        if dataclasses.is_dataclass(t):
            return _build(t, v)
        if t is torch.dtype:
            return _dtype(v)
        if t is tuple or typing.get_origin(t) is tuple:
            return tuple(v)
    return v


def _build(cls: type, d: Dict) -> Any:
    hints = typing.get_type_hints(cls)
    return cls(**{k: _value(hints.get(k), v) for k, v in d.items()})


def model_config(c: Dict) -> ModelConfig:
    """The program's config from a configuration file's dict (its
    ``ModelConfig`` fields, each nested group as a dict and each dtype by
    its name; the other keys are notes).  Each field is read by its
    annotation, so every config dataclass the program has is taken."""
    return _build(ModelConfig, {k: v for k, v in c.items() if k in _FIELDS})


def family(c: Dict) -> ModuleType:
    """The adapter of the configuration's family, named by its
    ``reference`` key: ``STD`` (leaves drawn with a std of their own),
    ``RESIDUAL`` (projections into the residual stream), ``FIXED``
    (leaves with a fixed value), ``TINY`` (the sizes of the CPU tests'
    stand-in), ``layer_view``, ``cache_view``, ``params_per_token`` and
    ``attention_layers``; optionally ``LAWS`` (leaves drawn by a law of
    their own), ``WINDOWS`` (the attention windows the CPU tests try)
    and ``uses`` (how often a token passes a leaf)."""
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


def own_dims(path: tuple, t: torch.Tensor) -> int:
    """A leaf's dimensions less the layer axis of a stacked run."""
    return t.dim() - (path[0] == "runs")


@torch.no_grad()
def make_weights(cfg: ModelConfig, seed: int, device, laws: ModuleType
                 ) -> Dict:
    """The parameter tree in the program's layout, drawn from ``seed``,
    with the std, fixed and drawn laws of the family ``laws``.  Each leaf
    the program computes with in ``cfg.dtype`` holds that dtype already,
    as it is served (the engine's cast is then a no-op).  A leaf of fewer
    than two dimensions of its own that the family does not name is an
    error."""
    tree = build_model(cfg).init(device="meta")
    leaves = list(leaf_paths(tree))
    special = getattr(laws, "LAWS", {})
    drawn: Dict[torch.dtype, List[Tuple[tuple, Any]]] = {}
    by_law: List[Tuple[tuple, Any, torch.dtype]] = []
    # any whole number, folded into 64 bits
    gen = torch.Generator(device=device).manual_seed(seed & (2**64 - 1))
    for path, t in leaves:
        name = path[-1]
        dt = cfg.dtype if name in COMPUTE_LEAVES else t.dtype
        if name in laws.FIXED:
            _set(tree, path, torch.full(t.shape, laws.FIXED[name],
                                        dtype=dt, device=device))
        elif name in special:
            by_law.append((path, t.shape, dt))
        elif name in laws.STD or own_dims(path, t) >= 2:
            drawn.setdefault(dt, []).append((path, t.shape))
        else:
            raise ValueError(
                f"leaf {'/'.join(map(str, path))} {tuple(t.shape)} has no "
                f"fan-in: name {name!r} under FIXED, STD or LAWS in "
                f"{getattr(laws, '__file__', 'the family adapter')}")
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
    for path, shape, dt in by_law:
        w = special[path[-1]](shape, dt, gen, device)
        if w.shape != shape or w.dtype != dt:
            raise ValueError(f"law of {path[-1]!r} gave {w.dtype} "
                             f"{tuple(w.shape)}, not {dt} {tuple(shape)}")
        _set(tree, path, w)
    return tree
