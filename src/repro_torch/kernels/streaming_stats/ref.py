"""Plain PyTorch oracle for the streaming-stats facade.  Port of
``src/repro/kernels/streaming_stats/ref.py``."""

from __future__ import annotations

import torch


def streaming_stats_ref(x: torch.Tensor, mask: torch.Tensor):
    """x [R, F], mask [R] -> (sum [F], sumsq [F], count []) in fp32."""
    xf = x.to(torch.float32)
    m = mask.to(torch.float32)[:, None]
    xm = xf * m
    return xm.sum(0), (xm * xf).sum(0), m.sum()
