"""The readers of the program's spans (``colobench/lib/spans.py``) on
synthetic traces, and on a traced CPU run of a tiny cell, whose spans
the program records as it does on the card."""

import time

import numpy as np
import pytest

from colobench.lib import cells, spans
from colobench.lib.stats import gaps
from colobench.lib.trace import CALL, Reading, Trace

IDLE = ["engine_idle_ms.ttft", "stack_idle_ms.ttft", "moe_idle_ms.ttft",
        "k2_idle_ms.ttft"]
RANGES = {"moe_passes_ms.tok_s": spans.MOE_PASSES,
          "norm_rope_ms.tok_s": spans.NORM_ROPE}


def _trace(host, records, window=(0.0, 100.0), ranges=None):
    return Trace([("k", s, e) for s, e in records], window, ranges or {},
                 host)


def _reading(trace, calls=1):
    return Reading(trace, {}, None, [(1, 64)] * calls, "prefill")


def _read(metric, reading):
    return cells.reader(metric).read(reading)


def test_a_gap_is_split_over_adjacent_spans_by_overlap():
    host = [("serve.generate", 0, 10), ("model.block", 1, 9),
            ("moe.dispatch", 1, 4), ("moe.experts", 4, 8)]
    by = spans.idle_by_span(_trace(host, [(0, 2), (6, 10)]))
    assert by == pytest.approx({"moe.dispatch": 2.0, "moe.experts": 2.0})


def test_a_gap_under_an_aten_op_goes_to_the_program_span_around_it():
    host = [("serve.generate", 0, 10), ("model.block", 1, 9),
            ("moe.route", 1, 6), ("aten::mm", 2, 5), ("aten::empty", 3, 4)]
    tr = _trace(host, [(0, 2), (5, 10)])
    assert spans.idle_by_span(tr) == pytest.approx({"moe.route": 3.0})
    assert _read("moe_idle_ms.ttft", _reading(tr)) == pytest.approx(3e3)


def test_gaps_outside_the_request_are_ignored():
    host = [(CALL, 4, 12), ("serve.generate", 5, 10),
            ("serve.sample", 8, 10), ("aten::copy_", 1, 3)]
    by = spans.idle_by_span(_trace(host, [(6, 7)], window=(0, 20)))
    assert by == pytest.approx({"serve.generate": 2.0, "serve.sample": 2.0})


@pytest.mark.parametrize("metric", sorted(IDLE) + sorted(RANGES))
def test_every_reader_gives_none_without_a_program_span(metric):
    host = [(CALL, 0, 10), ("aten::mm", 1, 2), ("FlashAttention", 3, 4)]
    tr = _trace(host, [(1, 2), (3, 5)], ranges={CALL: 3.0})
    assert _read(metric, _reading(tr)) is None


def _random_trace(seed, calls=3):
    """``calls`` requests nested as the program nests them, at random
    times, under random device records."""
    rng = np.random.default_rng(seed)
    host, at = [], 0.0

    def put(name, lo, hi, children):
        host.append((name, lo, hi))
        cuts = np.sort(rng.uniform(lo, hi, 2 * len(children)))
        for (child, sub), a, b in zip(children, cuts[::2], cuts[1::2]):
            put(child, a, b, sub)

    layer = [("model.norm", []), ("attn.qkv", [("aten::mm", [])]),
             ("attn.rope", []), ("attn.k2", [("FlashAttention", [])]),
             ("attn.out", []), ("model.norm", []), ("moe.route", []),
             ("moe.dispatch", [("aten::index_copy_", [])]),
             ("moe.experts", [("aten::bmm", []), ("moe.swiglu", [])]),
             ("moe.combine", [])]
    for _ in range(calls):
        lo, hi = at + rng.uniform(1, 5), at + rng.uniform(40, 60)
        host.append((CALL, lo - 0.5, hi + 0.5))
        put("serve.generate", lo, hi,
            [("serve.upload", []), ("model.embed", [])]
            + [("model.block", layer)] * 3
            + [("model.head", []), ("serve.pad_caches", []),
               ("serve.sample", [("aten::copy_", [])])])
        at = hi + 1
    starts = np.sort(rng.uniform(0, at, 200))
    records = [(s, s + rng.exponential(0.2)) for s in starts]
    return _trace(host, records, window=(0, at + 1)), calls


def _innermost_by_sampling(tr, step=1e-3):
    """Idle seconds by innermost program span, from a fine grid of
    points: the program span with the latest start that holds a point."""
    prog = sorted(((n, s, e) for n, s, e in tr.host
                   if n.startswith(spans.PROGRAM)), key=lambda h: h[1])
    t = np.arange(tr.window[0] + step / 2, tr.window[1], step)
    idle = np.ones(t.shape, bool)
    for _, s, e in tr.records:
        idle &= ~((t >= s) & (t < e))
    owner = np.full(t.shape, -1)
    for i, (_, s, e) in enumerate(prog):
        owner[(t >= s) & (t < e)] = i
    inside = np.zeros(t.shape, bool)
    for n, s, e in prog:
        if n == spans.REQUEST:
            inside |= (t >= s) & (t < e)
    out = {}
    for i in owner[idle & inside]:
        out[prog[i][0]] = out.get(prog[i][0], 0.0) + step
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_by_span_matches_a_sampled_timeline(seed):
    tr, _ = _random_trace(seed, calls=2)
    got = spans.idle_by_span(tr)
    want = _innermost_by_sampling(tr)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=0.05)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_four_idle_metrics_sum_to_the_in_call_idle(seed):
    tr, calls = _random_trace(seed)
    r = _reading(tr, calls)
    idle = sum(e - s for lo, hi in tr.spans(spans.REQUEST)
               for s, e in gaps([(a, b) for _, a, b in tr.records], lo, hi))
    got = [_read(m, r) for m in sorted(IDLE)]
    assert all(v > 0 for v in got)
    assert sum(got) == pytest.approx(1e3 * idle / calls, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(RANGES))
def test_a_range_metric_sums_its_named_ranges_over_the_calls(metric):
    ranges = {"moe.route": 0.001, "moe.dispatch": 0.002, "moe.swiglu": 0.003,
              "moe.combine": 0.004, "moe.experts": 0.5, "model.norm": 0.01,
              "attn.rope": 0.02, "model.block": 1.0, CALL: 2.0}
    host = [("serve.generate", 0, 10), ("model.block", 1, 9)]
    tr = _trace(host, [(1, 2)], ranges=ranges)
    want = 1e3 * sum(ranges[n] for n in RANGES[metric]) / 2
    assert _read(metric, _reading(tr, calls=2)) == pytest.approx(want)


def test_layers_split_the_program_spans():
    assert [spans.layer(n) for n in (
        "serve.generate", "serve.sample", "model.block", "model.norm",
        "attn.qkv", "attn.rope", "attn.out", "attn.k2", "moe.route",
        "moe.swiglu")] == ["engine", "engine", "stack", "stack", "stack",
                           "stack", "stack", "k2", "moe", "moe"]


def test_a_traced_cpu_run_carries_the_program_spans():
    """The tiny cell traced on the CPU: one ``serve.generate`` a call,
    each range's name in ``Trace.ranges``; with device records laid over
    it, the four idle metrics split the requests' idle."""
    from colobench import run as R
    from colobench.tests.colobench_tiny import tiny_cell

    cell = tiny_cell("mixtral-prefill-short")
    out = R.run(cell, 2**31 + 5, 0.2, True, "cpu", time.perf_counter())
    r = out["reading"]
    tr = r.trace
    requests = tr.spans(spans.REQUEST)
    assert len(requests) == len(r.calls) == len(tr.spans(CALL))
    layers = cell.config["n_layers"]
    assert len(tr.spans("model.block")) == layers * len(r.calls)
    assert {n for n, _, _ in spans.program_spans(tr)} <= set(tr.ranges)
    assert r.trace.records == [] and _read("k2_idle_ms.ttft", r) is None
    # half of each request busy on a stand-in device
    tr.records = [("k", lo, (lo + hi) / 2) for lo, hi in requests]
    idle = sum(hi - (lo + hi) / 2 for lo, hi in requests)
    got = {m: _read(m, r) for m in IDLE}
    assert got["k2_idle_ms.ttft"] == 0.0      # the CPU runs K2's plain form
    assert sum(got.values()) == pytest.approx(1e3 * idle / len(r.calls))
