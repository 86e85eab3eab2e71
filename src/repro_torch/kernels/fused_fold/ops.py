"""Public op: fused grouped power-sum fold over a block of rows.

Port of ``src/repro/kernels/fused_fold/ops.py``.  Flattens the row shape,
applies the mask/gid defaults, and runs the CUDA kernel on a CUDA tensor or
its plain PyTorch version on a CPU tensor (``kernel.fused_fold_block``).
Unlike the Pallas wrapper it pads nothing: the kernel masks its own ragged
edges and sizes its outputs to the true ``G`` and ``F``.

The op's contract is the CSE shared-accumulator pool of
``repro_torch.core.stats``: ``{name: tensor}`` with ``count`` of shape
``[G]`` and ``s1..s4`` of shape ``[G, *feature_shape]``, all fp32.  The
analytic cost helpers return the reference's numbers (which count the
Pallas kernel's sublane-padded G); ``max_groups_for_smem`` states the CUDA
kernel's own G limit, which ``MapReduceEngine.fold_path`` consults.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.fused_fold.kernel import (
    ACC_ORDER,
    fused_fold_block,
    max_groups,
)


def canonical_names(names: Tuple[str, ...]) -> Tuple[str, ...]:
    """Validate and order accumulator names along ``ACC_ORDER``."""
    bad = set(names) - set(ACC_ORDER)
    if bad:
        raise ValueError(f"unknown shared accumulators {sorted(bad)}; "
                         f"supported: {ACC_ORDER}")
    if not names:
        raise ValueError("fused_fold needs at least one accumulator name")
    return tuple(n for n in ACC_ORDER if n in set(names))


def _pad_groups(num_groups: int) -> int:
    """Groups padded to the Pallas kernel's fp32 sublane multiple (8); used
    only so the cost helpers report the reference's numbers."""
    return max(8, -(-int(num_groups) // 8) * 8)


def fused_fold(
    rows: torch.Tensor,                      # [R, *feature_shape]
    mask: Optional[torch.Tensor] = None,     # [R] bool/float; None = all
    gids: Optional[torch.Tensor] = None,     # [R] int; None = all group 0
    num_groups: int = 1,
    names: Tuple[str, ...] = ACC_ORDER,
) -> Dict[str, torch.Tensor]:
    """-> ``{name: acc}``: count ``[G]``, s_k ``[G, *feature_shape]`` fp32.

    One streaming pass over the block whatever ``G`` or how many
    accumulators were asked for.  ``mask`` and ``gids`` may be numpy or
    torch; they are moved to the block's device."""
    names = canonical_names(names)
    G = max(1, int(num_groups))
    R = int(rows.shape[0])
    fshape = tuple(rows.shape[1:])
    x = rows.reshape(R, -1)
    if not x.is_contiguous():
        x = x.contiguous()
    dev = x.device
    m = (torch.ones(R, dtype=torch.float32, device=dev) if mask is None
         else torch.as_tensor(mask, device=dev).to(torch.float32))
    g = (torch.zeros(R, dtype=torch.int32, device=dev) if gids is None
         else torch.as_tensor(gids, device=dev).to(torch.int32))
    out = fused_fold_block(x, g.contiguous(), m.contiguous(), G, names)
    return {n: (out[n] if n == "count" else out[n].reshape((G,) + fshape))
            for n in names}


# ----------------------------------------------------------------------
# analytic cost model (the reference's numbers) + the kernel's G limit
# ----------------------------------------------------------------------

def kernel_hbm_bytes(rows: int, features: int, itemsize: int,
                     names: Tuple[str, ...], num_groups: int = 1) -> int:
    """Device-memory bytes one launch must move: the payload ONCE, the
    per-row mask/gid sidecars, and the accumulator write-back (G counted
    sublane-padded, as the reference does)."""
    names = canonical_names(names)
    G = _pad_groups(max(1, num_groups))
    out = sum(G * 4 if n == "count" else G * features * 4 for n in names)
    return rows * features * itemsize + rows * (4 + 4) + out


def kernel_flops(rows: int, features: int,
                 names: Tuple[str, ...], num_groups: int = 1) -> int:
    """FLOPs per launch as the reference counts them: one [BR,G]x[BR,X]
    contraction per accumulator (2·R·X·G each) plus the elementwise power
    raises and weight build."""
    names = canonical_names(names)
    G = _pad_groups(max(1, num_groups))
    f = 0
    for n in names:
        f += 2 * rows * G * (1 if n == "count" else features)
    n_pows = sum(1 for n in names if n != "count")
    f += rows * features * max(0, n_pows - 1)
    f += rows * features + rows * G
    return f


def max_groups_for_smem(names: Tuple[str, ...] = ACC_ORDER) -> int:
    """Largest G the CUDA kernel takes for these names: its per-group
    accumulators (one fp32 word per power sum per thread of a 32-wide
    block, plus the count) must fit one block's shared memory on an H100.
    The engine folds with plain PyTorch above this."""
    names = canonical_names(names)
    return max_groups(sum(1 for n in names if n != "count"))
