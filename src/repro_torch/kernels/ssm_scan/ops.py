"""Public SSD-scan op in the model layout.

Port of ``src/repro/kernels/ssm_scan/ops.py``.  On CPU tensors it runs the
plain chunked scan (``ref.ssd_chunked_ref``), which autograd
differentiates.  On CUDA tensors it runs :class:`SSDScan`, an
``autograd.Function`` whose forward is the CUDA kernel that
``kernel.variant`` picks (called directly, without the Function, when no
input needs a gradient) and whose backward recomputes the plain scan and
differentiates it (the reference has no backward kernel: its models
differentiate the XLA form of the same scan).  A kernel that fails
raises; nothing falls back to the plain forward.  Both start from the
given initial state or from zero.  No head-major copies and no padding:
the kernels read the model layout and pad the tail chunk themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import require_local
from repro_torch.kernels.ssm_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_ref

DEFAULT_CHUNK = 128

#: what :class:`SSDScan`'s forward runs, with ``ssd_scan_cuda``'s
#: signature.  Tests point it at the plain version (run without autograd)
#: so the Function's own backward runs on CPU tensors.
FORWARD = ssd_scan_cuda
#: the profiler range around the plain backward
BACKWARD_RANGE = "ssd_scan.backward"


class SSDScan(torch.autograd.Function):
    """Forward :data:`FORWARD` -> ``(y, final_state)``; backward:
    ``ssd_chunked_ref`` recomputed from the saved inputs and
    differentiated, giving the gradients of x, a, B, C and the initial
    state (when one was given) in their own dtypes."""

    @staticmethod
    def forward(ctx, x, a, Bm, Cm, chunk, init_state):
        y, final = FORWARD(x, a, Bm, Cm, chunk, init_state)
        ctx.save_for_backward(x, a, Bm, Cm, init_state)
        ctx.chunk = min(chunk, x.shape[1])
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        ins = ctx.saved_tensors
        need = list(ctx.needs_input_grad[:4]) + [ctx.needs_input_grad[5]]
        with torch.enable_grad(), torch.profiler.record_function(
                BACKWARD_RANGE):
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ins, need)]
            y, final = ssd_chunked_ref(*leaves[:4], ctx.chunk, leaves[4])
            outs = [(o, g) for o, g in ((y, dy), (final, dfinal))
                    if g is not None]
            wrt = [t for t, n in zip(leaves, need) if n]
            # the final state does not depend on C
            got = torch.autograd.grad([o for o, _ in outs], wrt,
                                      [g for _, g in outs], allow_unused=True)
        it = iter(got)
        grads = [None if not n else _zeros_if_none(next(it), t)
                 for n, t in zip(need, ins)]
        return (*grads[:4], None, grads[4])


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


def ssd_scan(
    x: torch.Tensor,          # [B, L, H, P]  (dt folded in)
    a: torch.Tensor,          # [B, L, H]
    Bm: torch.Tensor,         # [B, L, N]     (shared across heads)
    Cm: torch.Tensor,         # [B, L, N]
    chunk: int = DEFAULT_CHUNK,
    init_state: Optional[torch.Tensor] = None,   # [B, H, P, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(y [B, L, H, P], final_state [B, H, P, N])``, fp32, from
    ``init_state`` (None: zero)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, a, Bm, Cm, min(chunk, x.shape[1]),
                               init_state)
    require_local(x, a, Bm, Cm, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, Bm, Cm, init_state)):
        return SSDScan.apply(x, a, Bm, Cm, chunk, init_state)
    return FORWARD(x, a, Bm, Cm, chunk, init_state)   # nothing to save
