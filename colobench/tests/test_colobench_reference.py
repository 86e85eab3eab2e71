"""The plain float32 references agree with the program on tiny
configurations of the same families on the CPU, where the program runs
in float32 too (its kernels' plain versions)."""

import pytest
import torch

from colobench.lib import cells, check, model
from colobench.tests.colobench_tiny import tiny_cell

CONFIGS = sorted({w["config"]: w["name"]
                  for w in cells.benchmark()["workloads"]}.values())


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_and_caches(name, window):
    """Dense and windowed attention; caches grown past the prompt by the
    engine's padding, as served."""
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
    assert len(diag) == cfg.n_layers
    assert all(len(d["margin"]) == 2 and min(d["margin"]) >= 0
               for d in diag)


def test_capacity_drops_the_last_slots_alike():
    """With experts over capacity, program and reference drop the same
    token-major slots: a capacity factor that drops most slots still
    agrees."""
    cell = tiny_cell(CONFIGS[0], dtype="float32")
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
