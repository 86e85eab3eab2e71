"""The prefill path's spans (``repro_torch.tracing.span``): recorded under a
``torch.profiler``, nested as the serving engine's docstring lists them,
never built without a profiler, and changing no output."""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.mixtral_8x7b import smoke
from repro_torch.models.model import build_model, pad_caches
from repro_torch.serve.engine import ServeEngine
from repro_torch.utils import tree_flatten

CFG = smoke()
PROMPTS = np.random.default_rng(3).integers(
    0, CFG.vocab, (2, 12)).astype(np.int32)
CALLS = 2
PROGRAM = ("serve.", "model.", "attn.", "moe.")
#: spans that lie inside a layer's ``model.block``
IN_BLOCK = ["model.norm", "attn.qkv", "attn.rope", "attn.out", "moe.route",
            "moe.dispatch", "moe.experts", "moe.swiglu", "moe.combine"]
#: spans directly under ``serve.generate``
IN_REQUEST = ["serve.upload", "serve.pad_caches", "serve.sample",
              "model.embed", "model.head", "model.block"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    params = build_model(CFG).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    return ServeEngine(CFG, params, capacity=16, batch_size=2, device="cpu")


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


@pytest.fixture(scope="module")
def spans(engine):
    """The program's spans of ``CALLS`` one-token requests, as (name,
    start, end, enclosing program span's name) by start."""
    prof, _ = _profiled(lambda: [engine.generate(PROMPTS, 1)
                                 for _ in range(CALLS)])
    out = []
    for e in prof.events():
        if not e.name.startswith(PROGRAM):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(PROGRAM):
            parent = parent.cpu_parent
        out.append((e.name, e.time_range.start, e.time_range.end,
                    parent.name if parent is not None else None))
    return sorted(out, key=lambda x: x[1])


def test_one_request_span_per_call(spans):
    requests = [s for s in spans if s[0] == "serve.generate"]
    assert len(requests) == CALLS
    assert all(s[3] is None for s in requests)


def test_a_block_span_per_layer_in_each_request(spans):
    for _, lo, hi, _ in [s for s in spans if s[0] == "serve.generate"]:
        blocks = [s for s in spans if s[0] == "model.block"
                  and lo <= s[1] and s[2] <= hi]
        assert len(blocks) == CFG.n_layers


@pytest.mark.parametrize("name", IN_BLOCK)
def test_layer_spans_lie_inside_a_block(spans, name):
    mine = [s for s in spans if s[0] == name]
    per_layer = 2 if name == "model.norm" else 1
    assert len(mine) == CALLS * CFG.n_layers * per_layer
    blocks = [s for s in spans if s[0] == "model.block"]
    for _, s, e, _ in mine:
        assert any(b[1] <= s and e <= b[2] for b in blocks)
    want = {"moe.swiglu": "moe.experts"}.get(name, "model.block")
    assert {s[3] for s in mine} == {want}


@pytest.mark.parametrize("name", IN_REQUEST)
def test_engine_spans_lie_directly_under_the_request(spans, name):
    mine = [s for s in spans if s[0] == name]
    per_call = CFG.n_layers if name == "model.block" else 1
    assert len(mine) == CALLS * per_call
    assert {s[3] for s in mine} == {"serve.generate"}


def test_span_is_the_shared_no_op_without_a_profiler():
    assert tracing.span("model.block") is tracing.span("moe.route")
    _, inner = _profiled(lambda: tracing.span("model.block"))
    assert isinstance(inner, torch.profiler.record_function)


@pytest.mark.parametrize("profiled", [False, True])
def test_record_functions_built_only_under_a_profiler(engine, monkeypatch,
                                                      profiled):
    built = []
    real = tracing.record_function

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    if profiled:
        _profiled(lambda: engine.generate(PROMPTS, 1))
        assert built.count("serve.generate") == 1
        assert built.count("model.block") == CFG.n_layers
    else:
        engine.generate(PROMPTS, 1)
        assert built == []


def test_outputs_are_bit_identical_with_the_profiler_on(engine):
    tokens = torch.as_tensor(PROMPTS, dtype=torch.int64)

    def run():
        logits, caches = engine.model.prefill(engine.params, tokens)
        caches = pad_caches(CFG, caches, engine.capacity)
        return logits, caches, engine.generate(PROMPTS, 3).tokens

    off = run()
    _, on = _profiled(run)
    assert torch.equal(off[0], on[0])
    a, b = tree_flatten(off[1])[0], tree_flatten(on[1])[0]
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(off[2], on[2])
