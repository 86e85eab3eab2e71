"""NumPy oracle for the fused grouped fold — the property-test ground truth.

Port of ``src/repro/kernels/fused_fold/ref.py`` (copied).  Accumulates in
float64 by default: the sweeps compare the kernel's fp32 one-pass result
against this under accumulation tolerance.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

ACC_ORDER: Tuple[str, ...] = ("count", "s1", "s2", "s3", "s4")


def fused_fold_numpy(
    rows: np.ndarray,                  # [R, *feature_shape]
    mask: Optional[np.ndarray] = None,    # [R] bool
    gids: Optional[np.ndarray] = None,    # [R] int
    num_groups: int = 1,
    names: Tuple[str, ...] = ACC_ORDER,
    acc_dtype=np.float64,
) -> Dict[str, np.ndarray]:
    """-> ``{name: acc}``: count ``[G]``, s_k ``[G, *feature_shape]``.

    Masked-off rows are zeroed BEFORE the power raises (the kernel's
    NaN/Inf-poisoning contract); rows keep their gid but contribute nothing.
    """
    G = max(1, int(num_groups))
    R = rows.shape[0]
    fshape = rows.shape[1:]
    m = (np.ones(R, bool) if mask is None else np.asarray(mask, bool))
    g = (np.zeros(R, np.int64) if gids is None
         else np.asarray(gids, np.int64))

    x = np.where(m.reshape((R,) + (1,) * len(fshape)),
                 np.asarray(rows, acc_dtype), 0).reshape(R, -1)
    out: Dict[str, np.ndarray] = {}
    powers = {"s1": x, "s2": x * x, "s3": x ** 3, "s4": x ** 4}
    for n in names:
        if n == "count":
            acc = np.zeros(G, acc_dtype)
            np.add.at(acc, g[m], 1)
            out[n] = acc
        else:
            acc = np.zeros((G, x.shape[1]), acc_dtype)
            np.add.at(acc, g[m], powers[n][m])
            out[n] = acc.reshape((G,) + fshape)
    return out
