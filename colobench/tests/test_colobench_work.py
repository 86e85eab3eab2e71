"""Operation and byte counts against hand values and against the
program's own parameter counts."""

import json

import pytest

from colobench.lib import cells, model, work

CONFIGS = {c["name"]: json.loads((cells.ROOT / c["file"]).read_text())
           for c in cells.benchmark()["configs"]}


def test_causal_pairs():
    assert work.causal_pairs(4) == 10
    assert work.causal_pairs(4, window=2) == 1 + 2 + 2 + 2
    assert work.causal_pairs(4, window=4) == 10
    assert work.causal_pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096


def test_k2_work():
    flops, nbytes = work.k2_work(1, 2, 1, 4, 8)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2


def test_least_seconds():
    assert work.least_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_active_weights_match_the_program(name):
    """The layers' weights a token multiplies through, against the
    program's active count less the embedding, head and norms, with each
    weight counted as often as a token passes it (the family's ``uses``:
    a shared block at each layer that runs it) and the embedding and head
    as one matrix where the program ties them."""
    c = CONFIGS[name]
    cfg = model.model_config(c)
    fam = model.family(c)
    uses = getattr(fam, "uses", lambda c, path: 1)
    tree = model.build_model(cfg).init(device="meta")
    small = again = 0
    for p, t in model.leaf_paths(tree):
        if model.own_dims(p, t) <= 1:
            small += t.numel()
        elif p[0] not in ("embed", "lm_head"):
            again += (uses(c, p) - 1) * t.numel()
    head = (1 if cfg.tie_embeddings else 2) * c["d_model"] * c["vocab"]
    assert fam.params_per_token(c) == \
        cfg.active_param_count() - head - small + again


def test_flops_of_a_prefill():
    c = CONFIGS["mixtral-8x7b-8L"]
    fam = model.family(c)
    n = fam.params_per_token(c)
    # 2 a weight a token; dense causal attention: 4 D a pair and head
    attn = 8 * 4 * 128 * 32 * (8192 * 8193 // 2)
    assert work.prefill_model_flops(c, fam, 1, 8192) == \
        2 * n * 8192 + 2 * 4096 * 32000 + attn
    # by hand: 8 layers of attention (4096 x 6144 in, 4096 x 4096 out),
    # the router and two SwiGLU experts of 14336
    assert n == 8 * (4096 * 4096 * 2 + 2 * 4096 * 1024 + 4096 * 8
                     + 2 * 3 * 4096 * 14336)
