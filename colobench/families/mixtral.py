"""The Mixtral family's adapter: how its weights are drawn, how the
program's tree and caches map onto the reference's one dict a layer, and
the weights a token multiplies through.

The program keeps one stacked run of ``n_layers`` blocks: ``ln1``,
``attn`` (``wq``, ``wk``, ``wv``, ``wo``), ``ln2`` and ``mlp`` (``router``
and the experts' ``gate``, ``up``, ``down``), each leaf with the layer
as its leading axis; its caches are ``{"k", "v"}`` of ``[n, B, T, Hkv,
D]``, grown to the engine's capacity ``T``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from colobench.lib.model import leaf_paths

#: leaves drawn with a std of their own rather than 1/sqrt(fan-in): the
#: embedding at 1, the router at 0.02
STD = {"table": 1.0, "router": 0.02}
#: projections into the residual stream, scaled by 1/sqrt(2 n_layers)
RESIDUAL = ("wo", "down")
#: leaves with a fixed value: the norms' scales
FIXED = {"scale": 1.0}
#: the CPU tests' stand-in (``colobench/tests/colobench_tiny.py``): the
#: same family and flags at tiny widths
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=512,
            moe={"n_experts": 4, "top_k": 2, "d_ff_expert": 96,
                 "capacity_factor": 1.25})
#: the attention windows the CPU tests run program and reference under:
#: dense, and a window shorter than their prompts
WINDOWS = (None, 24)


def _flat_block(block: Dict) -> Dict:
    """A block's leaves by their last name (``ln1``/``ln2`` keep the norm
    they are)."""
    out = {}
    for path, t in leaf_paths(block):
        key = path[0] if path[0] in ("ln1", "ln2") else path[-1]
        out[key] = t
    return out


def layer_view(cfg, params: Dict) -> Dict:
    """``{"embed", "final_norm", "lm_head", "layers": [...]}``: one dict of
    tensors a layer, in the stack's order."""
    (run,) = params["runs"]
    per = {k: torch.unbind(v) for k, v in _flat_block(run).items()}
    layers = [{k: v[i] for k, v in per.items()}
              for i in range(cfg.n_layers)]
    return {"embed": params["embed"]["table"],
            "final_norm": params["final_norm"]["scale"],
            "lm_head": params["lm_head"]["w"], "layers": layers}


def cache_view(cfg, caches: List[Any], S: int) -> List[Dict]:
    """The program's caches as ``{"k", "v"}`` ([B, S, Hkv, D]) a layer,
    the first ``S`` positions of the engine's capacity."""
    (cache,) = caches
    return [{k: v[i, :, :S] for k, v in cache.items()}
            for i in range(cfg.n_layers)]


def params_per_token(c: Dict) -> int:
    """Weights each token multiplies through in the layers (the embedding
    and the head left out): the attention projections, the router and
    the ``top_k`` experts it picks."""
    d, hd, m = c["d_model"], c["head_dim"], c["moe"]
    qd, kvd = c["n_heads"] * hd, c["n_kv_heads"] * hd
    attn = d * qd + 2 * d * kvd + qd * d
    mlp = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
    return c["n_layers"] * (attn + mlp)


def attention_layers(c: Dict) -> int:
    return c["n_layers"]
