"""Tiny stand-ins for the cells' models, of the same family and
structural flags, and short prompts arriving fast, for runs on the
CPU."""

import copy

from colobench.lib import cells

TINY = {
    "mixtral-8x7b-8L": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=512,
                            moe={"n_experts": 4, "top_k": 2,
                                 "d_ff_expert": 96, "capacity_factor": 1.25}),
}


def tiny_cell(name: str, dtype: str = None, points: int = 4):
    """The cell ``name`` with its model cut to a tiny width and its
    traffic to ``points`` short prompt lengths arriving fast."""
    cell = copy.deepcopy(cells.load(name))
    cell.config.update(TINY[cell.config["name"]])
    if dtype:
        cell.config["dtype"] = dtype
        cell.config["param_dtype"] = dtype
    cell.traffic["lengths"].update(median=24, sigma=0.4, min=8, max=64,
                                   points=points, multiple=8)
    cell.traffic["arrivals"]["rate_per_s"] = 200.0
    cell.traffic["check_requests"] = 3
    return cell
