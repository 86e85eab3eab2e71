"""Per-tensor symmetric int8 gradient compression.

Port of ``src/repro/optim/compression.py``: ``scale = max|x| / 127`` (plus
1e-12), ``q = clip(round(x / scale), -127, 127)`` as int8, all in fp32;
``round`` is half to even in both packages.  The reference runs these
inside its jitted step, where XLA turns ``/ 127`` into a product with
fp32 ``1/127``; the port computes that compiled form, so the int8 trees
and scales equal the jitted reference's bit for bit (an eager call of the
reference divides, and its scale can differ in the last bit).  The
pod-axis step that uses them is ``train/step.py``'s
``make_compressed_train_step``.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.utils import tree_map

PyTree = Any

#: fp32 ``1/127``, the constant XLA multiplies by in place of ``/ 127``
_INV_127 = float(np.float32(1.0 / 127.0))


def _one(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    scale = torch.max(torch.abs(xf)) * _INV_127 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_compress(tree: PyTree) -> Tuple[PyTree, PyTree]:
    """-> (int8 tree, per-tensor fp32 scales)."""
    return (tree_map(lambda x: _one(x)[0], tree),
            tree_map(lambda x: _one(x)[1], tree))


def int8_decompress(q_tree: PyTree, scale_tree: PyTree) -> PyTree:
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scale_tree)
