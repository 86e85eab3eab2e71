"""The plain float32 references agree with the program on tiny
configurations of the same families on the CPU, where the program runs
in float32 too (its kernels' plain versions).  What belongs to one
family (its tiny sizes, the windows to try) comes from its adapter."""

import pytest
import torch

from colobench.lib import cells, check, model
from colobench.tests.colobench_tiny import tiny_cell

CONFIGS = sorted({w["config"]: w["name"]
                  for w in cells.benchmark()["workloads"]}.values())


def _windows(name):
    """The attention windows the family of cell ``name`` declares
    (``WINDOWS``; else the configuration's own)."""
    c = cells.load(name).config
    return getattr(model.family(c), "WINDOWS", (c.get("sliding_window"),))


def _routed_layers(cfg):
    """The layers that route tokens to experts (each gives one entry of
    the reference's routing diagnostics)."""
    return sum(k == "attn" and i >= cfg.moe.first_k_dense
               for i, k in enumerate(cfg.layer_kinds()))


@pytest.mark.parametrize("name,window", [
    pytest.param(n, w, id=f"{n}-{w}") for n in CONFIGS for w in _windows(n)])
def test_prefill_logits_and_caches(name, window):
    """Dense and windowed attention, as the family declares; caches grown
    past the prompt by the engine's padding, as served."""
    cell = tiny_cell(name, dtype="float32")
    cell.config["sliding_window"] = window
    cfg = model.model_config(cell.config)
    fam = model.family(cell.config)
    w = model.make_weights(cfg, 11, "cpu", fam)
    tokens = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    from repro_torch.models.model import build_model, cast_for_compute, \
        pad_caches
    logits, caches = build_model(cfg).prefill(
        cast_for_compute(cfg, w, "cpu"), tokens)
    caches = pad_caches(cfg, caches, 57)
    diag = []
    r_logits, r_caches = cell.reference().prefill(
        cell.config, fam.layer_view(cfg, w), tokens, diag=diag)
    assert max(check.logit_errs(logits, r_logits)) < 1e-5
    assert max(check.cache_errs(fam.cache_view(cfg, caches, 40),
                                r_caches)) < 1e-5
    assert max(check.token_gaps(r_logits, logits.argmax(-1).tolist())) == 0
    if cfg.moe is not None:     # a router gives its diagnostics
        assert len(diag) == _routed_layers(cfg)
        assert all(len(d["margin"]) == 2 and min(d["margin"]) >= 0
                   for d in diag)


def test_capacity_drops_the_last_slots_alike():
    """With experts over capacity, program and reference drop the same
    token-major slots: a capacity factor that drops most slots still
    agrees."""
    name = next(n for n in CONFIGS if cells.load(n).config.get("moe"))
    cell = tiny_cell(name, dtype="float32")
    cell.config["moe"] = dict(cell.config["moe"], capacity_factor=0.3)
    cfg = model.model_config(cell.config)
    fam = model.family(cell.config)
    w = model.make_weights(cfg, 12, "cpu", fam)
    tokens = torch.randint(0, cfg.vocab, (1, 64),
                           generator=torch.Generator().manual_seed(2))
    from repro_torch.models.model import build_model, cast_for_compute
    logits, _ = build_model(cfg).prefill(cast_for_compute(cfg, w, "cpu"),
                                         tokens)
    diag = []
    r_logits, _ = cell.reference().prefill(
        cell.config, fam.layer_view(cfg, w), tokens, diag=diag)
    assert min(d["dropped"] for d in diag) >= 0.4
    assert max(check.logit_errs(logits, r_logits)) < 1e-5
