"""Carrying state across from the reference: tables and fold partials.

A port table is rebuilt from plain numpy arrays and strings, so no object
of the JAX package crosses over.  The regions keep the reference table's
boundaries and ids, because regions decide blocks, partial keys, placement
and every counter; later splits then number their children alike.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mapreduce import partial_from_host
from repro_torch.core.regions import (
    KEY_MAX,
    KEY_MIN,
    ConstantSizeSplitPolicy,
    HierarchicalSplitPolicy,
    Region,
)
from repro_torch.core.table import (
    ColumnFamily,
    ColumnSpec,
    RowKey,
    TensorTable,
    _as_key,
)
from repro_torch.utils import tree_map

_POLICIES = {"ConstantSizeSplitPolicy": ConstantSizeSplitPolicy,
             "HierarchicalSplitPolicy": HierarchicalSplitPolicy}

#: one family: (name, [(qualifier, per-row shape, dtype string), ...])
FamilySpec = Tuple[str, Sequence[Tuple[str, Sequence[int], str]]]


def table_from_arrays(
    name: str,
    families: Sequence[FamilySpec],
    rowkeys: Sequence[RowKey],
    columns: Mapping[str, np.ndarray],
    region_start_keys: Sequence[RowKey],
    region_ids: Optional[Sequence[int]] = None,
    split_policy: Optional[Tuple[str, int]] = None,
) -> TensorTable:
    """A port ``TensorTable`` holding exactly these rows and regions.

    ``columns`` maps ``"family:qualifier"`` to a ``[rows, *shape]`` array
    in rowkey order.  ``region_start_keys`` lists every region's start key
    in ascending order (the first is the empty key); ``region_ids`` their
    ids (default ``0..n-1``).  ``split_policy`` is ``(policy class name,
    max_region_bytes)``; None keeps the table unsplittable, as the
    reference's default policy does."""
    fams = [ColumnFamily(f, tuple(ColumnSpec(q, tuple(shape), np.dtype(dt))
                                  for q, shape, dt in cols))
            for f, cols in families]
    policy = None
    if split_policy is not None:
        kind, max_bytes = split_policy
        if kind not in _POLICIES:
            raise ValueError(f"unknown split policy {kind!r}")
        policy = _POLICIES[kind](int(max_bytes))
    table = TensorTable(name, fams, split_policy=policy)

    keys = np.array([_as_key(k) for k in rowkeys], dtype="S64")
    if len(keys) > 1 and not np.all(keys[:-1] < keys[1:]):
        raise ValueError("rowkeys must be strictly ascending")
    table._keys = keys
    for fam in fams:
        for col in fam.columns:
            arr = np.array(columns[f"{fam.name}:{col.qualifier}"],
                           dtype=col.dtype)
            if arr.shape != (len(keys),) + col.shape:
                raise ValueError(f"{fam.name}:{col.qualifier} shape "
                                 f"{arr.shape} != {(len(keys),) + col.shape}")
            table._data[(fam.name, col.qualifier)] = arr

    starts = [_as_key(k) for k in region_start_keys]
    if not starts or starts[0] != KEY_MIN:
        raise ValueError("the first region must start at the empty key")
    rids = (list(range(len(starts))) if region_ids is None
            else [int(r) for r in region_ids])
    if len(rids) != len(starts):
        raise ValueError(f"{len(rids)} region ids for {len(starts)} regions")
    stops = starts[1:] + [KEY_MAX]
    rs = table.regions
    rs._regions = [Region(r, a, b) for r, a, b in zip(rids, starts, stops)]
    rs._starts = list(starts)
    rs._next_rid = max(rids) + 1
    table.check_invariants()
    return table


def partial_from_numpy(leaves: Sequence[np.ndarray], treedef: Any,
                       device: Optional[Any] = None) -> Any:
    """A fold partial saved as numpy leaves (in sorted-key flatten order)
    and the port's treedef, as tensors on ``device`` (default: CPU)."""
    partial = partial_from_host(leaves, treedef)
    if device is None:
        return partial
    return tree_map(lambda x: x.to(torch.device(device)), partial)


def lm_params_from_jax(cfg, params: Any, device="cuda") -> Any:
    """The port's model weights from the reference's parameter tree.

    ``params`` is the reference ``build_model(cfg).init`` tree with every
    leaf as a numpy array (``jax.tree.map(np.asarray, params)``): a decoder
    stack's ``"embed"``, ``"final_norm"``, ``"lm_head"``, ``"shared_block"``,
    ``"runs"`` with stacked ``[n, ...]`` leaves and ``"mtp"``, or whisper's
    ``"embed"``, ``"pos_embed"``, ``"encoder"``, ``"decoder"`` and their
    norms.  Returns the same tree of tensors in ``cfg.param_dtype`` on
    ``device`` (the card unless the caller asks for ``"cpu"``), checked leaf
    by leaf against the shapes of the port's own ``init`` on the ``meta``
    device."""
    from repro_torch.models.model import build_model, resolve_device

    device = resolve_device(device)
    want = build_model(cfg).init(device="meta")

    def conv(p, w, path):
        if isinstance(w, dict):
            if not isinstance(p, Mapping) or set(p) != set(w):
                raise ValueError(f"{path}: keys {sorted(p) if isinstance(p, Mapping) else type(p)}"
                                 f" != {sorted(w)}")
            return {k: conv(p[k], w[k], f"{path}/{k}") for k in w}
        if isinstance(w, list):
            if not isinstance(p, (list, tuple)) or len(p) != len(w):
                raise ValueError(f"{path}: expected a list of {len(w)}")
            return [conv(a, b, f"{path}[{i}]")
                    for i, (a, b) in enumerate(zip(p, w))]
        arr = np.asarray(p)
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(w.shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=cfg.param_dtype)

    return conv(params, want, "params")
