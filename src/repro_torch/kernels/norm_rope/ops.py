"""RMSNorm and RoPE in one pass each: ``csrc/norm_rope.cu``, built with
``nvcc`` at first use into ``build/kernels/`` and bound through
``ctypes``.

No Pallas kernel stands behind them: the JAX package leaves both to XLA,
which fuses each into one pass.  :func:`rms_norm` and :func:`rope` are
what ``models/layers.py`` calls.  On CPU and meta tensors they run the
plain versions (``ref.py``).  On CUDA tensors they always launch: where
autograd records, through :class:`RmsNorm` and :class:`Rope`, whose
forward is the kernel and whose backward recomputes the plain version and
differentiates it (the reference has no norm or RoPE kernel, so none is
owed a backward pass); where it records nothing, the kernel alone.  A
DTensor raises (the model calls them on local shards), as does a dtype or
shape the kernels do not take; nothing falls back to the plain forward.

Both read their inputs as they lie where the last dimension has unit
stride (a copy is made first where not, or where a norm's leading
dimensions do not merge into three), and write new contiguous outputs.
The launch shape adapts to what the call shows: a norm row gets as many
warps as hold it at eight 16-byte vectors a thread (a row of 4,096 bf16:
two), so rows up to 2,048 bf16 get one warp each and share a CTA;
16-byte vectors where every row is aligned for them, scalar loads where
not.  A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import (
    CudaLibrary,
    check_launch,
    require_local,
)
from repro_torch.kernels.norm_rope.ref import (
    rms_norm_plain,
    rope_freqs,
    rope_qk_plain,
)
from repro_torch.tracing import launch

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POS_CODES = {torch.int32: 0, torch.int64: 1}
#: the device type whose tensors the kernels take (tests point it at the
#: CPU, with :data:`NORM_FORWARD` and :data:`ROPE_FORWARD` at the plain
#: versions, to run the CUDA path's dispatch there)
DEVICE = "cuda"
#: norm rows a CTA where a row takes one warp
NARROW_ROWS_PER_CTA = 8
#: 16-byte vectors a thread holds in registers (the kernel's MAX_VPT)
MAX_VPT = 8
#: threads a norm CTA (the kernel's launch bound)
MAX_THREADS = 512
#: 16-byte vectors a thread of a norm row aims to hold
WIDE_VPT = 8
#: widest RoPE head dim (the angle table lives in shared memory)
MAX_HEAD_DIM = 1024
_CSRC = Path(__file__).resolve().parent / "csrc"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.rms_norm_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _L, _I, _L, _L, _L, _L, _L,
                   ctypes.c_float, _I, _I, _I, _I, _P]
    fn.restype = _I
    fn = lib.rope_qk_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _P]
    fn.restype = _I


LIBRARY = CudaLibrary(_CSRC / "norm_rope.cu", _bind)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the library's launcher ``name`` with ``args`` and the current
    stream of ``device``, from that device, inside the profiler range
    ``name`` (so that a trace charges the kernel to the spans around the
    call); raise on a CUDA error."""
    fn = getattr(LIBRARY.get(), name)
    idx = device.index
    with launch(name):
        if idx == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    check_launch(err, name)


def _leading(x: torch.Tensor) -> Optional[Tuple[int, ...]]:
    """``(n1, n2, s0, s1, s2)``: x's leading dimensions as at most three
    (sizes n0, n1, n2; strides s0, s1, s2), merging those that step
    evenly; None if more than three remain."""
    if x.is_contiguous():
        return 1, x.numel() // x.shape[-1], 0, 0, x.shape[-1]
    dims = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    merged = []
    for n, s in dims:
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if len(merged) > 3:
        return None
    merged = [(1, 0)] * (3 - len(merged)) + merged
    (_, s0), (n1, s1), (n2, s2) = merged
    return n1, n2, s0, s1, s2


def _norm_shape(x: torch.Tensor, weight: torch.Tensor, n: int):
    """``(vec, vpt, threads, rows_per_cta)`` for rows of width n: enough
    warps a row that each thread holds :data:`WIDE_VPT` vectors, so a
    row narrower than ``32 * WIDE_VPT`` vectors gets one warp, and such
    rows share a CTA; scalar loads, and a thread for every 8 elements,
    where a row does not start on 16 bytes or would not fit."""
    es = x.element_size()
    nv = n // (16 // es)
    # every row of x and of the contiguous output starts on 16 bytes
    aligned = (x.data_ptr() % 16 == 0 and weight.data_ptr() % 16 == 0
               and (x.numel() == n or n * es % 16 == 0)
               and all(s * es % 16 == 0 for s, m in zip(x.stride()[:-1],
                                                         x.shape[:-1])
                       if m != 1))
    threads = min(MAX_THREADS, 32 * max(1, -(-nv // (32 * WIDE_VPT))))
    vpt = max(1, -(-nv // threads))
    vec = aligned and vpt <= MAX_VPT
    if not vec:
        threads, vpt = min(256, 32 * max(1, -(-n // 256))), 1
    return vec, vpt, threads, NARROW_ROWS_PER_CTA if threads == 32 else 1


def rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """``rms_norm_plain`` in one launch, on the current stream: the rows of
    x to a new contiguous tensor in x's dtype.  x is f32, bf16 or f16 and
    the weight ``[n]`` one of those too; a non-unit last stride, or more
    than three leading dimensions that do not merge, is copied first.
    ``rms_norm_cuda.launches`` counts the launches."""
    n = x.shape[-1]
    if x.dtype not in _CODES or weight.dtype not in _CODES:
        raise TypeError(f"rms_norm kernel: x {x.dtype}, weight "
                        f"{weight.dtype}; it takes f32, bf16 and f16")
    if weight.shape != (n,) or weight.device != x.device:
        raise ValueError(f"rms_norm kernel: weight {tuple(weight.shape)} on "
                         f"{weight.device} for rows of {n} on {x.device}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return y
    lead = _leading(x) if x.stride(-1) == 1 else None
    if lead is None:
        x = x.contiguous()
        lead = _leading(x)
    weight = weight.contiguous()
    n1, n2, s0, s1, s2 = lead
    vec, vpt, threads, per_cta = _norm_shape(x, weight, n)
    _launch("rms_norm_launch", x.device, x.data_ptr(), weight.data_ptr(),
            y.data_ptr(), _CODES[x.dtype], _CODES[weight.dtype],
            x.numel() // n, n, n1, n2, s0, s1, s2, eps, int(vec), vpt,
            threads, per_cta)
    rms_norm_cuda.launches += 1
    return y


#: ``rope_freqs`` by (head dim, theta, device), for the RoPE kernel
_INV_FREQ: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_inv_freq(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    """``rope_freqs(head_dim, theta, device)``, computed once a key."""
    key = (head_dim, float(theta), device)
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = rope_freqs(head_dim, theta, device)
    return inv


def _rope_args(q: torch.Tensor, k: Optional[torch.Tensor],
               positions: torch.Tensor) -> None:
    """Raise unless q and k are ``[B, S, heads, D]`` in one f32, bf16 or
    f16 dtype on one device with D even and at most
    :data:`MAX_HEAD_DIM`, and positions int32 or int64 there,
    broadcastable to ``[B, S]``."""
    ts = (q,) if k is None else (q, k)
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _CODES:
        raise TypeError(f"RoPE kernel: {[t.dtype for t in ts]}; it takes "
                        f"one of f32, bf16 and f16")
    if positions.dtype not in _POS_CODES:
        raise TypeError(f"RoPE kernel: positions {positions.dtype}; it "
                        f"takes int32 and int64")
    B, S, _, D = q.shape if q.dim() == 4 else (0, 0, 0, 0)
    if (q.dim() != 4 or D % 2 or D > MAX_HEAD_DIM
            or any(t.dim() != 4 or t.shape[:2] != q.shape[:2]
                   or t.shape[3] != D or t.device != q.device for t in ts)
            or positions.dim() > 2 or positions.device != q.device
            or any(p not in (1, m) for p, m in zip(
                reversed(positions.shape), (S, B)))):
        raise ValueError(
            f"RoPE kernel: q {tuple(q.shape)}, k "
            f"{None if k is None else tuple(k.shape)}, positions "
            f"{tuple(positions.shape)} on {positions.device}; it takes "
            f"[B, S, heads, D] on one device, D even and at most "
            f"{MAX_HEAD_DIM}, positions broadcastable to [B, S]")


def rope_cuda(q: torch.Tensor, k: Optional[torch.Tensor],
              positions: torch.Tensor, theta: float
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``ref.rope_qk_plain`` in one launch, on the current stream: q and k
    (or q alone) to new contiguous outputs in q's dtype; inputs with a
    non-unit last stride are copied first.  ``rope_cuda.launches`` counts
    the launches."""
    _rope_args(q, k, positions)
    q = q if q.stride(-1) == 1 else q.contiguous()
    k = k if k is None or k.stride(-1) == 1 else k.contiguous()
    B, S, H, D = q.shape
    qo = torch.empty_like(q, memory_format=torch.contiguous_format)
    ko = (None if k is None
          else torch.empty_like(k, memory_format=torch.contiguous_format))
    if q.numel() == 0:
        return qo, ko
    Hk = 0 if k is None else k.shape[2]
    pos = positions.expand(B, S)
    inv = rope_inv_freq(D, theta, q.device)
    es = q.element_size()
    half = D // 2
    ts = (q,) if k is None else (q, k)
    vec = (half * es % 16 == 0
           and all(t.data_ptr() % 16 == 0 and all(
               s * es % 16 == 0 for s, m in zip(t.stride()[:3], t.shape[:3])
               if m != 1) for t in ts))
    per = half // (16 // es) if vec else half
    tasks = (H + Hk) * per
    threads = min(128, 32 * -(-tasks // 32))
    per_cta = 256 // threads
    kt = q if k is None else k
    _launch("rope_qk_launch", q.device, q.data_ptr(),
            None if k is None else k.data_ptr(), qo.data_ptr(),
            None if ko is None else ko.data_ptr(), _CODES[q.dtype],
            pos.data_ptr(), _POS_CODES[pos.dtype], inv.data_ptr(), B, S,
            H, Hk, D, *q.stride()[:3], *kt.stride()[:3], *pos.stride(),
            int(vec), threads, per_cta)
    rope_cuda.launches += 1
    return qo, ko


def reset_counts() -> None:
    """Zero both launch counters."""
    rms_norm_cuda.launches = 0
    rope_cuda.launches = 0


reset_counts()

#: what the norm's forward runs on a CUDA tensor, with ``rms_norm_plain``'s
#: signature; tests and ``chip_smoke.plain_kernels`` point it at that
NORM_FORWARD = rms_norm_cuda
#: what RoPE's forward runs on CUDA tensors, with ``ref.rope_qk_plain``'s
#: signature; pointed at that as :data:`NORM_FORWARD` is
ROPE_FORWARD = rope_cuda


def _regrad(fn, ins, needs, douts):
    """Gradients of ``fn`` at detached copies of ``ins`` for those that
    ``needs`` marks (None for the rest), pulled back from ``douts`` (one
    for each output of ``fn``)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(ins, needs)]
        pairs = [(o, d) for o, d in zip(fn(*xs), douts)
                 if d is not None and o is not None and o.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], [x for x, n in zip(xs, needs) if n],
            [d for _, d in pairs]))
    return [next(got) if n else None for n in needs]


class RmsNorm(torch.autograd.Function):
    """Forward :data:`NORM_FORWARD`; backward: ``rms_norm_plain``
    recomputed and differentiated."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return NORM_FORWARD(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        eps = ctx.eps
        gx, gw = _regrad(lambda x, w: (rms_norm_plain(x, w, eps),),
                         ctx.saved_tensors, ctx.needs_input_grad[:2], (dy,))
        return gx, gw, None


class Rope(torch.autograd.Function):
    """Forward :data:`ROPE_FORWARD` on q and k (k may be None, and then
    only q comes out); backward: ``apply_rope_plain`` recomputed on each
    and differentiated."""

    @staticmethod
    def forward(ctx, positions, theta, q, k):
        ctx.save_for_backward(positions, q, k)
        ctx.theta = theta
        qo, ko = ROPE_FORWARD(q, k, positions, theta)
        return qo if k is None else (qo, ko)

    @staticmethod
    def backward(ctx, dq, dk=None):
        positions, q, k = ctx.saved_tensors
        theta = ctx.theta
        n = 1 if k is None else 2
        got = _regrad(
            lambda *xs: rope_qk_plain(xs[0], xs[1] if n == 2 else None,
                                      positions, theta),
            (q, k)[:n], ctx.needs_input_grad[2:2 + n], (dq, dk))
        return (None, None, *got, *([None] * (2 - n)))


def _records(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on these tensors; where not,
    the wrappers call the forward alone, sparing the serving path the
    Function's host bookkeeping (about 25 calls a Mixtral prefill)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to x's dtype: ``rms_norm_plain`` on a CPU or
    meta tensor, one launch of the norm kernel on a CUDA tensor."""
    if x.device.type != DEVICE:
        return rms_norm_plain(x, weight, eps)
    require_local(x, weight)
    if _records(x, weight):
        return RmsNorm.apply(x, weight, eps)
    return NORM_FORWARD(x, weight, eps)


def rope(q: torch.Tensor, k: Optional[torch.Tensor], positions: torch.Tensor,
         theta: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q and k (k may be None) rotated by ``positions``:
    ``ref.rope_qk_plain`` on CPU or meta tensors, one launch of the RoPE
    kernel for both on CUDA tensors."""
    if q.device.type != DEVICE:
        return rope_qk_plain(q, k, positions, theta)
    require_local(q, positions, *(() if k is None else (k,)))
    if not _records(q, k):
        return ROPE_FORWARD(q, k, positions, theta)
    if k is None:
        return Rope.apply(positions, theta, q, None), None
    return Rope.apply(positions, theta, q, k)
