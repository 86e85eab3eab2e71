"""A configuration's dict made into the program's ``ModelConfig``, and
the weights drawn from the seed by the family's laws."""

import dataclasses
import hashlib
import json
import types

import pytest
import torch

from colobench.families import mixtral
from colobench.lib import model
from colobench.tests.colobench_tiny import tiny_cell
from repro_torch.configs import ARCH_IDS, get_config

#: sha256 of the tiny Mixtral stand-in's weights at seed 11 (path, dtype
#: and bytes of each leaf in order), as drawn before vector leaves needed
#: a law: a change to the draws' order or count changes it
TINY_MIXTRAL_SEED_11 = {
    "float32":
        "cacd18def85233bf9404b226acb8bc7540a412310b814024de3d1c7385ca41cb",
    "bfloat16":
        "728cc86b21617fad010eeaeb249e223635e29614d6b86716b26315cf50507605",
}


def _as_json(x):
    """A config as its file would hold it: dicts, lists, dtype names."""
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, dict):
        return {k: _as_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_json(v) for v in x]
    return x


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_program_config_round_trips(arch, size):
    """Every nested group (MoE, SSM, MLA, RWKV, encoder), tuple and dtype
    comes back as the program has it, and the model builds from it."""
    cfg = get_config(arch, reduced=size == "smoke")
    c = json.loads(json.dumps(_as_json(dataclasses.asdict(cfg))))
    got = model.model_config(c)
    assert got == cfg
    tree = model.build_model(got).init(device="meta")
    assert sum(t.numel() for _, t in model.leaf_paths(tree)) == \
        cfg.param_count()


def test_a_config_file_keeps_its_notes_out():
    c = dict(tiny_cell("mixtral-prefill-short").config)
    assert {"reference", "source", "reduced", "assumed"} <= set(c)
    cfg = model.model_config(c)
    assert cfg.moe.d_ff_expert == c["moe"]["d_ff_expert"]
    assert cfg.dtype is torch.bfloat16


def test_an_unknown_dtype_or_group_key_is_refused():
    c = tiny_cell("mixtral-prefill-short").config
    with pytest.raises(ValueError, match="float5"):
        model.model_config(dict(c, dtype="float5"))
    with pytest.raises(TypeError, match="n_expert"):
        model.model_config(dict(c, moe=dict(c["moe"], n_expert=3)))


def _digest(tree):
    h = hashlib.sha256()
    for path, t in model.leaf_paths(tree):
        h.update("/".join(map(str, path)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _tiny(dtype="float32"):
    cell = tiny_cell("mixtral-prefill-short", dtype=dtype)
    return model.model_config(cell.config)


@pytest.mark.parametrize("dtype", sorted(TINY_MIXTRAL_SEED_11))
def test_tiny_mixtral_weights_match_the_checksum(dtype):
    cfg = _tiny(dtype)
    assert cfg.dtype == getattr(torch, dtype)
    w = model.make_weights(cfg, 11, "cpu", mixtral)
    assert _digest(w) == TINY_MIXTRAL_SEED_11[dtype]


def _adapter(**laws):
    base = dict(STD=mixtral.STD, RESIDUAL=mixtral.RESIDUAL, FIXED={})
    return types.SimpleNamespace(**dict(base, **laws))


def test_an_unnamed_vector_leaf_is_refused():
    """The norms' scales are vectors: left unnamed, they have no law (a
    fan-in over the layer axis would be 1/sqrt(n_layers))."""
    with pytest.raises(ValueError, match="final_norm/scale"):
        model.make_weights(_tiny(), 11, "cpu", _adapter())


def _uniform(lo, hi):
    def law(shape, dtype, gen, device):
        u = torch.rand(shape, generator=gen, device=device)
        return (lo + (hi - lo) * u).to(dtype)
    return law


def test_a_law_draws_its_leaf_from_the_seed():
    cfg = _tiny()
    fam = _adapter(LAWS={"scale": _uniform(0.5, 2.0)})
    a, b = (model.make_weights(cfg, 11, "cpu", fam) for _ in range(2))
    c = model.make_weights(cfg, 12, "cpu", fam)
    plain = model.make_weights(cfg, 11, "cpu", mixtral)
    scales = 0
    for (path, x), (_, y), (_, z), (_, p) in zip(
            *(model.leaf_paths(t) for t in (a, b, c, plain))):
        assert torch.equal(x, y), path
        if path[-1] == "scale":
            scales += 1
            assert not torch.equal(x, z)
            assert 0.5 <= x.min() and x.max() <= 2.0
        else:       # drawn after every randn leaf: those are unchanged
            assert torch.equal(x, p), path
    assert scales == 3          # ln1, ln2 and the final norm


def test_a_law_of_the_wrong_shape_is_refused():
    def law(shape, dtype, gen, device):
        return torch.ones(3, dtype=dtype, device=device)
    with pytest.raises(ValueError, match="scale"):
        model.make_weights(_tiny(), 11, "cpu", _adapter(LAWS={"scale": law}))
