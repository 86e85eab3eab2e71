"""Shared layer primitives: norms, RoPE and M-RoPE, MLPs, embeddings.

Port of ``src/repro/models/layers.py``.  ``compute_dtype`` casts mirror
the reference's ``astype`` calls; they cost nothing when the weights
already hold that dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.norm_rope import ops as norm_rope
from repro_torch.kernels.norm_rope.ref import (  # noqa: F401 (re-exported)
    apply_rope_plain,
    rms_norm_plain,
    rope_freqs,
)
from repro_torch.models.params import Init, normal_init, embed_init
from repro_torch.models.sharding import (
    compute_view,
    current_policy,
    is_dtensor,
    local_call,
    mesh_coordinate,
)


def _rows_whole(t) -> tuple:
    """A DTensor's placements with its last dimension gathered and partial
    sums reduced: the layout a kernel over whole rows takes."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() or p.is_shard(t.dim() - 1)
                 else p for p in t.placements)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to x's dtype: the norm kernel on CUDA
    tensors (a DTensor's local shards, rows whole), ``rms_norm_plain`` on
    the rest."""
    if is_dtensor(x) and x.device.type == norm_rope.DEVICE:
        from torch.distributed.tensor import Replicate

        pl = _rows_whole(x)
        return local_call(lambda a, w: norm_rope.rms_norm(a, w, eps),
                          (x, weight), (pl, (Replicate(),) * len(pl)), pl)
    return norm_rope.rms_norm(x, weight, eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 inside (population variance), cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def init_rms_norm(d: int, dtype, init: Init) -> Dict:
    return {"scale": init.full((d,), 1.0, dtype)}


def rms_norm_axes() -> Dict:
    return {"scale": ("embed",)}


def init_layer_norm(d: int, dtype, init: Init) -> Dict:
    return {"scale": init.full((d,), 1.0, dtype),
            "bias": init.full((d,), 0.0, dtype)}


def layer_norm_axes() -> Dict:
    return {"scale": ("embed",), "bias": ("embed",)}


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]`` (split-half
    rotation, fp32 inside): the RoPE kernel on CUDA tensors (``[B, S, H,
    D]``; a DTensor's local shards, head dims whole),
    ``apply_rope_plain`` on the rest."""
    if is_dtensor(x) and x.device.type == norm_rope.DEVICE:
        from torch.distributed.tensor import Replicate, Shard

        pl = _rows_whole(x)
        lead = x.dim() - 2                 # positions align with x[..., S]
        ppl = []
        for p in pl:
            j = p.dim - lead + positions.dim() if p.is_shard() else -1
            ppl.append(Shard(j) if 0 <= j < positions.dim() and p.dim < lead
                       and positions.shape[j] == x.shape[p.dim] > 1
                       else Replicate())
        return local_call(
            lambda a, pos: norm_rope.rope(a, None, pos, theta)[0],
            (x, positions), (pl, tuple(ppl)), pl)
    return norm_rope.rope(x, None, positions, theta)[0]


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_rope`` on q and on k, in one launch of the RoPE kernel on
    CUDA tensors (one each on DTensors)."""
    if is_dtensor(q) or is_dtensor(k):
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    return norm_rope.rope(q, k, positions, theta)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (1, 1, 2)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: ``positions3 [..., 3, S]`` carries
    (temporal, height, width) ids, and the head dim's frequency bands are
    split among them in the ratio ``sections``.  The band bounds are
    Python ``int(half * s / total)``, as in the reference; text tokens
    carry one id in all three channels, which reduces to RoPE."""
    d = x.shape[-1]
    half = d // 2
    inv = rope_freqs(d, theta, x.device)                  # [half]
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        acc += int(half * s / total)
        bounds.append(acc)
    bounds[-1] = half
    band = torch.zeros(half, dtype=torch.int64, device=x.device)
    band[bounds[0]:bounds[1]] = 1
    band[bounds[1]:] = 2
    # [..., 3, S] -> [..., S, 3] -> the channel of each band -> [..., S, half]
    p = positions3.to(torch.float32).movedim(-2, -1)
    ang = p[..., band] * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings ``[n, d]`` (fp32)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device),
                          2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_swiglu(d_model: int, d_ff: int, dtype, init: Init) -> Dict:
    return {
        "gate": normal_init(init, (d_model, d_ff), dtype),
        "up": normal_init(init, (d_model, d_ff), dtype),
        "down": normal_init(init, (d_ff, d_model), dtype),
    }


def swiglu_axes() -> Dict:
    return {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
            "down": ("mlp", "embed")}


def swiglu_apply(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = x @ p["gate"].to(compute_dtype)
    u = x @ p["up"].to(compute_dtype)
    return (F.silu(h) * u) @ p["down"].to(compute_dtype)


def init_gelu_mlp(d_model: int, d_ff: int, dtype, init: Init) -> Dict:
    return {
        "fc1": normal_init(init, (d_model, d_ff), dtype),
        "b1": init.full((d_ff,), 0.0, dtype),
        "fc2": normal_init(init, (d_ff, d_model), dtype),
        "b2": init.full((d_model,), 0.0, dtype),
    }


def gelu_mlp_axes() -> Dict:
    return {"fc1": ("embed", "mlp"), "b1": ("mlp",),
            "fc2": ("mlp", "embed"), "b2": ("embed",)}


def gelu_mlp_apply(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The reference's GELU is the tanh form (``approximate=True``)."""
    h = x @ p["fc1"].to(compute_dtype)
    h = F.gelu(h + p["b1"].to(compute_dtype), approximate="tanh")
    return h @ p["fc2"].to(compute_dtype) + p["b2"].to(compute_dtype)


def init_embedding(vocab: int, d_model: int, dtype, init: Init) -> Dict:
    return {"table": embed_init(init, (vocab, d_model), dtype)}


def embedding_axes() -> Dict:
    return {"table": ("vocab", "embed")}


def embed_apply(p: Dict, tokens: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """Row lookup.  Under a sharding policy the table is gathered over its
    storage axes and each rank looks up the tokens of its vocab slice
    (zeros elsewhere): a partial sum over ``model``, reduced where the
    caller constrains the activations."""
    table = p["table"]
    if not is_dtensor(table):
        return table[tokens].to(compute_dtype)
    from torch.distributed.tensor import Partial

    table = compute_view(p, embedding_axes())["table"]
    pl = tuple(table.placements)
    split = [q.is_shard(0) for q in pl]
    tok_pl = current_policy().placements_for(tokens.shape, ("batch",) + (
        None,) * (tokens.dim() - 1))
    out_pl = tuple(Partial() if s else t for t, s in zip(tok_pl, split))

    def body(tl, tok):
        V = tl.shape[0]
        at = tok - (mesh_coordinate("model") * V if any(split) else 0)
        held = (at >= 0) & (at < V)
        rows = tl[torch.clamp(at, 0, V - 1)]
        return torch.where(held[..., None], rows, 0).to(compute_dtype)

    return local_call(body, (table, tokens), (pl, tok_pl), out_pl)


def unembed_apply(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x @ p["table"].to(compute_dtype).T
