"""Small shared utilities: owner devices, pytree helpers, tree sizing, rng.

Port of ``src/repro/utils.py``.  ``make_mesh``/``shard_map_compat`` have no
counterpart: the port's "mesh" is a plain list of owner devices
(:func:`owner_devices`), which may repeat one physical device so that four
logical owners share one card (or the CPU in the tests).

JAX's pytree utilities become the small helpers below.  They walk dicts
(keys sorted, as ``jax.tree_util`` flattens them), tuples, lists and
``None`` subtrees; every other object is a leaf.  The sorted dict order
matters: per-leaf merge operators (``merge_ops_for``) are aligned with it.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

PyTree = Any


# ----------------------------------------------------------------------
# owner devices (the port's 1-D data mesh)
# ----------------------------------------------------------------------

def owner_devices(devices: Optional[Sequence[Any]] = None
                  ) -> List[torch.device]:
    """The owner list a session folds on: one entry per logical node.

    ``None`` means one CUDA device; it raises when CUDA is missing rather
    than running on the CPU unasked.  Entries may repeat a physical device
    (``["cuda:0"] * 4``, ``["cpu"] * 4``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=['cpu'] (or a list of CPU "
                "devices) to run on the CPU")
        devices = [torch.device("cuda")]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("need at least one owner device")
    for d in out:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"owner device {d} needs CUDA, which is absent")
    return out


# ----------------------------------------------------------------------
# pytrees
# ----------------------------------------------------------------------

def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef is a plain nested structure."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, tuple(walk(x) for x in t))
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: Sequence[Any]) -> PyTree:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        items = [build(c) for c in d[1]]
        return tuple(items) if kind == "tuple" else items

    return build(treedef)


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


# ----------------------------------------------------------------------
# sizing + rng
# ----------------------------------------------------------------------

def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape, dtype=np.int64)) * np.dtype(x.dtype).itemsize


def tree_size_bytes(tree) -> int:
    """Total bytes of all array leaves in a pytree (by shape/dtype, not
    device residency)."""
    return sum(_nbytes(x) for x in tree_leaves(tree)
               if hasattr(x, "shape") and hasattr(x, "dtype"))


def tree_param_count(tree) -> int:
    return sum(int(np.prod(tuple(x.shape), dtype=np.int64))
               for x in tree_leaves(tree) if hasattr(x, "shape"))


def fold_seed(seed: int, *names: str) -> torch.Generator:
    """Deterministic named rng derivation: a CPU ``torch.Generator`` seeded
    from ``seed`` and a CRC-32 of each name (stable across processes,
    unlike ``hash``).  It does not reproduce ``jax.random`` bits."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    for n in names:
        s = (s * 0x9E3779B97F4A7C15 + zlib.crc32(n.encode())) \
            & 0xFFFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(s)
