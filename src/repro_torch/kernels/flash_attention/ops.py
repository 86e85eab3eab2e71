"""Public flash-attention op: ``[B, H, S, D]`` layout, GQA, sliding window.

Port of ``src/repro/kernels/flash_attention/ops.py``.  On CPU tensors it
runs the plain version (``ref.attention_ref``), which autograd
differentiates.  On CUDA tensors it runs :class:`FlashAttention`, an
``autograd.Function`` whose forward is the CUDA kernel (``kernel.variant``
picks which) and whose backward recomputes the plain version and
differentiates it: the reference has no backward kernel (its models
differentiate XLA einsums), so none is ported.  A kernel that fails
raises; nothing falls back to the plain forward.  Unlike the Pallas
wrapper it pads nothing: the kernels mask keys past ``Skv`` and skip
query rows past ``Sq`` themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import require_local
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.tracing import span

#: what :class:`FlashAttention`'s forward runs, with ``attention_ref``'s
#: signature.  Tests point it at the plain version (run without autograd)
#: so the Function's own backward runs on CPU tensors.
FORWARD = flash_attention_cuda
#: the profiler range around the plain backward
BACKWARD_RANGE = "flash_attention.backward"


class FlashAttention(torch.autograd.Function):
    """Forward :data:`FORWARD`; backward: ``attention_ref`` recomputed one
    batch entry at a time and differentiated, so the fp32 ``[H, Sq, Skv]``
    scores and their gradients exist for one entry at a time (0.54 GB
    each at 32 heads and 2,048 positions).  Gradients come back in q's, k's
    and v's dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        o = FORWARD(q, k, v, scale, causal, window)
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        grads = [torch.empty_like(t) if n else None
                 for t, n in zip((q, k, v), need)]
        with torch.profiler.record_function(BACKWARD_RANGE):
            for b in range(q.shape[0]):
                with torch.enable_grad():
                    ins = [t[b:b + 1].detach().requires_grad_(n)
                           for t, n in zip((q, k, v), need)]
                    o = attention_ref(*ins, *ctx.args)
                    got = torch.autograd.grad(
                        o, [t for t, n in zip(ins, need) if n], do[b:b + 1])
                it = iter(got)
                for g, n in zip(grads, need):
                    if n:
                        g[b:b + 1] = next(it)
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,          # [B, H, Sq, D]
    k: torch.Tensor,          # [B, Hkv, Skv, D]
    v: torch.Tensor,          # [B, Hkv, Skv, D]
    scale: float,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention, output in q's dtype; ``window=0`` means none."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale, causal, window)
    with span("attn.k2"):        # the host wrapper and the launch
        require_local(q, k, v)
        return FlashAttention.apply(q, k, v, scale, causal, window)
