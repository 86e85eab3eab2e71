"""Parameter initialisation and logical-axis sharding resolution.

Port of ``src/repro/models/params.py``.  ``jax.random`` keys become one
:class:`Init` that carries a generator and a device; on the ``meta``
device it draws nothing, so a model's shapes cost no memory.

Every parameter has a tuple of *logical axis names*, one per dim (e.g.
``("embed", "heads")``).  A rules table maps logical names to mesh axes,
and :func:`resolve_spec` turns (shape, logical axes, rules, mesh shape)
into the reference's ``PartitionSpec`` as a plain tuple (one mesh-axis
name, a tuple of names, or ``None`` per dim, trailing ``None``s trimmed),
dropping any mesh axis that does not divide the dimension.
:func:`placements` turns such a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute_tree` places a whole tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]


# ----------------------------------------------------------------------
# rules: logical axis -> candidate mesh axes, in priority order
# ----------------------------------------------------------------------

def sharding_rules(fsdp: bool = True, expert_parallel: bool = True
                   ) -> Dict[Optional[str], Tuple[str, ...]]:
    """The default mapping: ``model`` carries tensor parallelism (heads,
    mlp, vocab, experts); ``data`` carries FSDP parameter sharding (the
    ``embed`` dim of every weight) besides batch parallelism; ``pod`` is
    pure data parallelism."""
    return {
        "batch": ("pod", "data"),
        "seq": (),
        "embed_act": (),   # hidden dim of activations ("model" enables SP)
        "vocab": ("model",),
        "embed": ("data",) if fsdp else (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "qk_dim": (),
        "mlp": ("model",),
        "experts": ("model",) if expert_parallel else (),
        "expert_mlp": ("model",),
        "lora": (),
        "state": (),
        "conv": (),
        "frames": (),
        "layers": (),
        None: (),
    }


def resolve_spec(
    shape: Sequence[int],
    axes: Optional[LogicalAxes],
    rules: Mapping[Optional[str], Tuple[str, ...]],
    mesh_shape: Mapping[str, int],
) -> Spec:
    """Logical axes -> the reference's ``PartitionSpec`` as a tuple, with
    its divisibility and axis-reuse checks; size-1 mesh axes are
    skipped."""
    if axes is None:
        axes = (None,) * len(shape)
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {tuple(shape)}")
    used: set = set()
    parts: List[Any] = []
    for dim, lname in zip(shape, axes):
        assigned: List[str] = []
        factor = 1
        for maxis in rules.get(lname, ()):
            if maxis not in mesh_shape or maxis in used:
                continue
            size = mesh_shape[maxis]
            if size > 1 and dim % (factor * size) == 0:
                assigned.append(maxis)
                used.add(maxis)
                factor *= size
        if not assigned:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(tuple(assigned))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of a resolved spec: one per mesh dim, ``Shard(d)``
    where the spec puts that mesh axis on tensor dim ``d``, else
    ``Replicate()``.  A dim over ``("pod", "data")`` is sharded on both
    mesh dims in mesh order (pod-major, as the reference splits it)."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh.mesh_dim_names)


def is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def _zip_axes(fn, tree, axes, path=()):
    """``fn(leaf, axes)`` over a tree and its logical-axes tree; the two
    must have one structure (the guard that keeps ``init`` and the
    ``*_axes`` functions in step)."""
    if is_axes_leaf(axes) and not isinstance(tree, (dict, list)):
        return fn(tree, axes)
    if isinstance(tree, dict) and isinstance(axes, dict):
        if set(tree) != set(axes):
            raise ValueError(f"tree and axes differ at {path}: "
                             f"{sorted(tree)} vs {sorted(axes)}")
        return {k: _zip_axes(fn, tree[k], axes[k], path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)) and isinstance(axes, (list, tuple)) \
            and not is_axes_leaf(axes):
        if len(tree) != len(axes):
            raise ValueError(f"tree and axes differ in length at {path}")
        out = [_zip_axes(fn, t, a, path + (i,))
               for i, (t, a) in enumerate(zip(tree, axes))]
        return tuple(out) if isinstance(tree, tuple) else out
    raise ValueError(f"tree and axes differ in structure at {path}")


def resolve_tree(params: Any, logical: Any,
                 rules: Mapping[Optional[str], Tuple[str, ...]],
                 mesh) -> Any:
    """Zip a params tree (tensors or anything with ``.shape``) with its
    logical-axes tree into specs; structures that differ raise."""
    shape = mesh_shape(mesh) if not isinstance(mesh, Mapping) else mesh
    return _zip_axes(lambda p, ax: resolve_spec(tuple(p.shape), ax, rules,
                                                shape), params, logical)


def distribute_tree(tree: Any, axes_tree: Any,
                    rules: Mapping[Optional[str], Tuple[str, ...]],
                    mesh) -> Any:
    """Every leaf as a DTensor with its resolved placements (the
    reference's ``named_shardings`` + ``device_put``).  Each rank holds the
    same full tensors (made from one seed) and keeps its own shards; no
    data moves."""
    from torch.distributed.tensor import distribute_tensor

    shape = mesh_shape(mesh)

    def one(t, ax):
        pl = placements(resolve_spec(tuple(t.shape), ax, rules, shape), mesh)
        return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)

    return _zip_axes(one, tree, axes_tree)


class Init:
    """Where parameters are made and the generator that draws them."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device="cpu"):
        self.device = torch.device(device)
        self.generator = generator

    def randn(self, shape: Sequence[int]) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(tuple(shape), device=self.device)
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def full(self, shape: Sequence[int], value: float,
             dtype: torch.dtype) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=self.device)


def normal_init(init: Init, shape, dtype, scale: Optional[float] = None,
                fan_in: Optional[int] = None) -> torch.Tensor:
    fi = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    std = scale if scale is not None else 1.0 / math.sqrt(max(fi, 1))
    # scaled in place: one fp32 temporary, not two (an expert stack of
    # deepseek-v3 is 15 GB in fp32)
    return init.randn(shape).mul_(std).to(dtype)


def embed_init(init: Init, shape, dtype, **_) -> torch.Tensor:
    return init.randn(shape).mul_(0.02).to(dtype)
