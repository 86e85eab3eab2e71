"""Decoder-stack assembly: block kinds, runs of layers, decode caches.

Port of ``src/repro/models/transformer.py``: runs of ``"attn"`` blocks
(dense or MoE MLP; GQA or MLA attention), ``"ssm"`` blocks, ``"rwkv"``
blocks, and ``"attn_shared"`` blocks (zamba2), whose one weight set is
reused at every occurrence with one KV cache per occurrence.  A run's
parameters are stacked ``[n, ...]`` as in the reference, and the
reference's ``lax.scan`` over layers becomes a Python loop over the
stacked weights.  Under autograd each block of a run is rematerialised
as the reference's ``_remat`` asks (``cfg.remat_policy``): ``"full"``
checkpoints the block and recomputes it in the backward pass, ``"dots"``
does the same but keeps the outputs of ``aten.mm`` (the products with no
batch dims, which ``checkpoint_dots_with_no_batch_dims`` keeps), and
``"none"`` saves everything.  As in the reference, the shared attention
block of zamba2 runs outside any remat.  Under a sharding policy each
block gathers its weights over the storage axes first (``compute_view``,
the reference's FSDP just-in-time gather) and constrains its output to
the activation layout (``constrain``), as the reference's does; the
remat recompute re-installs the policy (``_with_policy``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embedding_axes,
    init_embedding,
    init_rms_norm,
    init_swiglu,
    rms_norm,
    rms_norm_axes,
    swiglu_apply,
    swiglu_axes,
    unembed_apply,
)
from repro_torch.models.params import Init, normal_init
from repro_torch.models.sharding import (
    compute_view,
    constrain,
    current_policy,
    use_policy,
)
from repro_torch.tracing import span
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Run:
    kind: str       # attn | attn_shared | ssm | rwkv
    variant: str    # dense | moe | ""
    n: int


def build_runs(cfg: ModelConfig) -> List[Run]:
    kinds = cfg.layer_kinds()
    variants = []
    for i, k in enumerate(kinds):
        if k in ("attn",):
            if cfg.moe is not None and i >= cfg.moe.first_k_dense:
                variants.append("moe")
            else:
                variants.append("dense")
        else:
            variants.append("")
    runs: List[Run] = []
    for k, v in zip(kinds, variants):
        if runs and runs[-1].kind == k and runs[-1].variant == v \
                and k != "attn_shared":
            runs[-1] = dataclasses.replace(runs[-1], n=runs[-1].n + 1)
        else:
            runs.append(Run(k, v, 1))
    return runs


def stacked(run: Run, cfg: ModelConfig) -> bool:
    """Whether a run keeps ``[n, ...]`` stacked caches (the reference's
    scanned runs) rather than a list of per-layer caches."""
    return cfg.scan_layers and run.n > 1


# ----------------------------------------------------------------------
# per-layer block init / apply
# ----------------------------------------------------------------------

def init_block(cfg: ModelConfig, kind: str, variant: str,
               init: Init) -> Dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    if kind in ("attn", "attn_shared"):
        return {"ln1": init_rms_norm(d, dt, init),
                "attn": (attn.init_mla(cfg, init) if cfg.mla
                         else attn.init_attention(cfg, init)),
                "ln2": init_rms_norm(d, dt, init),
                "mlp": (moe_mod.init_moe(cfg, init) if variant == "moe"
                        else init_swiglu(d, cfg.d_ff, dt, init))}
    if kind == "ssm":
        return {"ln1": init_rms_norm(d, dt, init),
                "ssm": ssm_mod.init_ssm(cfg, init)}
    if kind == "rwkv":
        return {"ln1": init_rms_norm(d, dt, init),
                "time": rwkv_mod.init_rwkv_time(cfg, init),
                "ln2": init_rms_norm(d, dt, init),
                "channel": rwkv_mod.init_rwkv_channel(cfg, init)}
    raise ValueError(f"unknown block kind {kind!r}")


def block_axes(cfg: ModelConfig, kind: str, variant: str) -> Dict:
    if kind in ("attn", "attn_shared"):
        return {"ln1": rms_norm_axes(), "ln2": rms_norm_axes(),
                "attn": (attn.mla_axes(cfg) if cfg.mla
                         else attn.attention_axes(cfg)),
                "mlp": (moe_mod.moe_axes(cfg) if variant == "moe"
                        else swiglu_axes())}
    if kind == "ssm":
        return {"ln1": rms_norm_axes(), "ssm": ssm_mod.ssm_axes(cfg)}
    if kind == "rwkv":
        return {"ln1": rms_norm_axes(),
                "time": rwkv_mod.rwkv_time_axes(cfg),
                "ln2": rms_norm_axes(),
                "channel": rwkv_mod.rwkv_channel_axes(cfg)}
    raise ValueError(kind)


def stack_leading(axes: Any, name: Optional[str] = "layers") -> Any:
    """An axes tree with a leading ``name`` axis on every leaf (stacked
    ``[n, ...]`` leaves)."""
    if isinstance(axes, dict):
        return {k: stack_leading(v, name) for k, v in axes.items()}
    return (name,) + tuple(axes)


def block_full(
    cfg: ModelConfig,
    kind: str,
    variant: str,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    state: Optional[Any],
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Whole-sequence block application -> (x, new_state, aux_loss),
    inside the span ``model.block``."""
    with span("model.block"):
        # the FSDP just-in-time gather
        p = compute_view(p, block_axes(cfg, kind, variant))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        act = ("batch", "seq", "embed_act")
        if kind in ("attn", "attn_shared"):
            with span("model.norm"):
                h = rms_norm(x, p["ln1"]["scale"])
            full = attn.mla_full if cfg.mla else attn.attention_full
            y, cache = full(cfg, p["attn"], h, positions)
            # the mixer's partial sums over model, reduced before the
            # residual (else the MLP would run whole on partial inputs)
            x = x + constrain(y, act)
            with span("model.norm"):
                h = rms_norm(x, p["ln2"]["scale"])
            if variant == "moe":
                y, aux = moe_mod.moe_apply(cfg, p["mlp"], h, x.dtype)
            else:
                y = swiglu_apply(p["mlp"], h, x.dtype)
            return constrain(x + y, act), cache, aux
        if kind == "ssm":
            h = rms_norm(x, p["ln1"]["scale"])
            y, new_state = ssm_mod.ssm_full(cfg, p["ssm"], h, state)
            return constrain(x + y, act), new_state, aux
        if kind == "rwkv":
            h = rms_norm(x, p["ln1"]["scale"])
            y, t_new = rwkv_mod.rwkv_time_full(
                cfg, p["time"], h, None if state is None else state["time"])
            x = x + constrain(y, act)
            h = rms_norm(x, p["ln2"]["scale"])
            y, c_new = rwkv_mod.rwkv_channel_full(
                cfg, p["channel"], h,
                None if state is None else state["channel"])
            return (constrain(x + y, act), {"time": t_new, "channel": c_new},
                    aux)
        raise ValueError(kind)


def block_decode(
    cfg: ModelConfig,
    kind: str,
    variant: str,
    p: Dict,
    x: torch.Tensor,                   # [B, 1, D]
    pos: torch.Tensor,                 # [B]
    state: Any,
) -> Tuple[torch.Tensor, Any]:
    if kind in ("attn", "attn_shared"):
        h = rms_norm(x, p["ln1"]["scale"])
        decode = attn.mla_decode if cfg.mla else attn.attention_decode
        y, cache = decode(cfg, p["attn"], h, state, pos)
        x = x + y
        h = rms_norm(x, p["ln2"]["scale"])
        if variant == "moe":
            y, _ = moe_mod.moe_apply(cfg, p["mlp"], h, x.dtype)
        else:
            y = swiglu_apply(p["mlp"], h, x.dtype)
        return x + y, cache
    if kind == "ssm":
        h = rms_norm(x, p["ln1"]["scale"])
        y, new_state = ssm_mod.ssm_decode(cfg, p["ssm"], h, state)
        return x + y, new_state
    if kind == "rwkv":
        h = rms_norm(x, p["ln1"]["scale"])
        y, t_new = rwkv_mod.rwkv_time_decode(cfg, p["time"], h, state["time"])
        x = x + y
        h = rms_norm(x, p["ln2"]["scale"])
        y, c_new = rwkv_mod.rwkv_channel_full(cfg, p["channel"], h,
                                              state["channel"])
        return x + y, {"time": t_new, "channel": c_new}
    raise ValueError(kind)


# ----------------------------------------------------------------------
# stack init
# ----------------------------------------------------------------------

def _stack(trees: List[Dict]) -> Dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def unbind_layers(tree: Dict) -> List[Dict]:
    """The per-layer trees of a stacked ``[n, ...]`` tree, by one
    ``torch.unbind`` a leaf: under autograd the backward then stacks each
    leaf's gradient once, where indexing ``v[i]`` per layer would allocate
    a zero tensor of the whole stack for every layer's gradient."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [tree_unflatten(treedef, list(layer))
            for layer in zip(*per_leaf)]


def _layer(tree: Dict, i: int) -> Dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _put(dst: Dict, src: Dict, i: int) -> None:
    """Write the per-layer tree ``src`` into slot ``i`` of the stacked tree
    ``dst`` (nested dicts, as RWKV's state is); a leaf that is already
    that slot (a cache updated in place) is left alone."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst[k], v, i)
        elif v.data_ptr() != dst[k][i].data_ptr():
            dst[k][i].copy_(v)


def stack_layers(n: int, make: Callable[[], Dict]) -> Dict:
    """``n`` layers of ``make()`` stacked ``[n, ...]``: each stacked leaf is
    allocated once and filled layer by layer, so init holds one layer's
    tensors beside the stack, not every layer twice (a single layer is a
    view of itself)."""
    first = make()
    if n == 1:
        return tree_map(lambda t: t[None], first)
    out = tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                         dtype=t.dtype, device=t.device),
                   first)
    _put(out, first, 0)
    del first
    for i in range(1, n):
        _put(out, make(), i)
    return out


def init_stack(cfg: ModelConfig, init: Init) -> Dict:
    runs = build_runs(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(cfg.vocab, cfg.d_model, cfg.param_dtype,
                                init),
        "final_norm": init_rms_norm(cfg.d_model, cfg.param_dtype, init),
        "runs": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "w": normal_init(init, (cfg.d_model, cfg.vocab), cfg.param_dtype)
        }
    if any(r.kind == "attn_shared" for r in runs):
        params["shared_block"] = init_block(cfg, "attn_shared", "dense", init)
    for run in runs:
        if run.kind == "attn_shared":
            params["runs"].append({})      # weights live in shared_block
            continue
        params["runs"].append(stack_layers(
            run.n, lambda: init_block(cfg, run.kind, run.variant, init)))
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": normal_init(init, (2 * cfg.d_model, cfg.d_model),
                                cfg.param_dtype),
            "block": init_block(cfg, "attn",
                                "moe" if cfg.moe is not None else "dense",
                                init),
            "norm": init_rms_norm(cfg.d_model, cfg.param_dtype, init),
        }
    return params


def stack_axes(cfg: ModelConfig) -> Dict:
    runs = build_runs(cfg)
    ax: Dict[str, Any] = {"embed": embedding_axes(),
                          "final_norm": rms_norm_axes(), "runs": []}
    if not cfg.tie_embeddings:
        ax["lm_head"] = {"w": ("embed", "vocab")}
    if any(r.kind == "attn_shared" for r in runs):
        ax["shared_block"] = block_axes(cfg, "attn_shared", "dense")
    for run in runs:
        ax["runs"].append({} if run.kind == "attn_shared" else stack_leading(
            block_axes(cfg, run.kind, run.variant)))
    if cfg.mtp_depth > 0:
        ax["mtp"] = {"proj": ("embed", None),
                     "block": block_axes(cfg, "attn", "moe"
                                         if cfg.moe is not None else "dense"),
                     "norm": rms_norm_axes()}
    return ax


# ----------------------------------------------------------------------
# stack apply
# ----------------------------------------------------------------------

def _save_mm(ctx, func, *args, **kwargs):
    if func is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_mm)


def _with_policy(fn: Callable) -> Callable:
    """``fn`` under the sharding policy active now.  The remat recompute
    runs on autograd's device thread, where the policy's context variable
    is unset: without it, the recomputed block would hand DTensors to the
    kernels."""
    policy = current_policy()
    if policy is None:
        return fn

    def run(*args, **kwargs):
        with use_policy(policy):
            return fn(*args, **kwargs)
    return run


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` under ``cfg.remat_policy``; as it is without autograd."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    fn = _with_policy(fn)
    if cfg.remat_policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_contexts)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def stack_full(
    cfg: ModelConfig,
    params: Dict,
    x: torch.Tensor,                     # [B, S, D] embedded inputs
    positions: torch.Tensor,
    collect_cache: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[Any]]:
    """Whole-sequence pass -> (hidden, aux_loss, caches per run).  Caches
    keep the reference's structure: stacked ``[n, ...]`` leaves for a
    scanned run, a list of per-layer caches otherwise."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Any] = []
    for run, rp in zip(build_runs(cfg), params["runs"]):
        if run.kind == "attn_shared":
            x, cache, aux = block_full(cfg, "attn", "dense",
                                       params["shared_block"], x, positions,
                                       None)
            aux_total = aux_total + aux
            caches.append(cache if collect_cache else None)
            continue
        block = _remat(cfg, functools.partial(block_full, cfg, run.kind,
                                              run.variant))
        run_cache = []
        for lp in unbind_layers(rp):
            x, cache, aux = block(lp, x, positions, None)
            aux_total = aux_total + aux
            run_cache.append(cache if collect_cache else None)
        if stacked(run, cfg):
            run_cache = _stack(run_cache) if collect_cache else None
        caches.append(run_cache)
    return x, aux_total, caches


def stack_decode(
    cfg: ModelConfig,
    params: Dict,
    x: torch.Tensor,                     # [B, 1, D]
    pos: torch.Tensor,                   # [B]
    caches: List[Any],
) -> Tuple[torch.Tensor, List[Any]]:
    """One token through the stack.  A stacked run's new per-layer states
    are written into its ``[n, ...]`` cache tensors in place; KV caches
    take the new K/V in place (``attention_decode``)."""
    new_caches: List[Any] = []
    for run, rp, cache in zip(build_runs(cfg), params["runs"], caches):
        if run.kind == "attn_shared":
            x, c = block_decode(cfg, "attn", "dense",
                                params["shared_block"], x, pos, cache)
            new_caches.append(c)
            continue
        if stacked(run, cfg):
            for i in range(run.n):
                x, c = block_decode(cfg, run.kind, run.variant,
                                    _layer(rp, i), x, pos, _layer(cache, i))
                _put(cache, c, i)
            new_caches.append(cache)
        else:
            outs = []
            for i in range(run.n):
                x, c = block_decode(cfg, run.kind, run.variant,
                                    _layer(rp, i), x, pos, cache[i])
                outs.append(c)
            new_caches.append(outs)
    return x, new_caches


def lm_logits(cfg: ModelConfig, params: Dict, x: torch.Tensor
              ) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"]["scale"])
    if cfg.tie_embeddings:
        embed = compute_view(params["embed"], embedding_axes())
        logits = unembed_apply(embed, h, x.dtype)
    else:
        head = compute_view(params["lm_head"], {"w": ("embed", "vocab")})
        logits = h @ head["w"].to(x.dtype)
    # keep the vocab dim sharded over `model` (replicated [B,S,V] logits
    # per rank would dominate the step's memory)
    return constrain(logits, ("batch", "seq", "vocab"))
