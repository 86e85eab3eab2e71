"""The check fails what it should: a run on the CPU with the timed path
broken underneath comes out not correct, once for each fault a prefill
cell can have, and the control (the reference in float8 in the
program's place) comes out not correct too.  The program runs in
float32 here, so its sound runs read no more than rounding, and each
cell's own limits judge.  A call serves one request, so a fault in the
batch's one row is a fault in every request."""

import copy
import time

import pytest
import torch

from colobench import run as R
from colobench.lib import check, cells, control
from colobench.tests.colobench_tiny import tiny_cell

SEED = 2**31 + 4243
PREFILL = [w["name"] for w in cells.benchmark()["workloads"]
           if cells.load(w["name"]).traffic["kind"] == "prefill"]


def _run(cell):
    return R.run(cell, SEED, 0.2, False, "cpu", time.perf_counter())


def _logits_altered(prefill):
    def broken(self, params, tokens=None, embeds=None):
        logits, caches = prefill(self, params, tokens, embeds)
        return logits.roll(1, dims=-1), caches
    return broken


def _state_unchanged(prefill):
    def broken(self, params, tokens=None, embeds=None):
        logits, caches = prefill(self, params, tokens, embeds)
        from repro_torch.utils import tree_map
        return logits, tree_map(torch.zeros_like, caches)
    return broken


def _last_position_left_out(prefill):
    """The prompt's last token dropped: the logits and caches of a shorter
    prompt, the caches padded back to the prompt's length."""
    def broken(self, params, tokens=None, embeds=None):
        logits, caches = prefill(self, params, tokens[:, :-1], embeds)
        from repro_torch.utils import tree_map
        return logits, tree_map(
            lambda x: torch.cat([x, x[:, :, -1:]], dim=2), caches)
    return broken


@pytest.mark.parametrize("name", PREFILL)
def test_sound_prefill_is_correct(name):
    out = _run(tiny_cell(name, dtype="float32"))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4


@pytest.mark.parametrize("fault", [_logits_altered, _state_unchanged,
                                   _last_position_left_out])
@pytest.mark.parametrize("name", PREFILL)
def test_broken_prefill_is_not_correct(name, fault, monkeypatch):
    from repro_torch.models.model import LM
    monkeypatch.setattr(LM, "prefill", fault(LM.prefill))
    out = _run(tiny_cell(name, dtype="float32"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", PREFILL)
def test_altered_token_is_not_correct(name, monkeypatch):
    """A served token altered where the engine produces it, after the
    greedy choice."""
    from repro_torch.serve import engine
    sample = engine._sample

    def broken(logits, temperature, generator):
        tok = sample(logits, temperature, generator).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(engine, "_sample", broken)
    out = _run(tiny_cell(name, dtype="float32"))
    assert not out["correct"]
    assert out["checks"]["token_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_control_is_not_correct(name):
    cell = tiny_cell(name)
    vals = control.prefill_control(cell, SEED, "cpu", requests=8)
    assert not check.passed(check.judge(vals, cell.limits)), vals


def test_every_request_that_arrives_in_the_window_is_served():
    """The open loop sends each request at its arrival and serves every
    one that arrives before the close, however slow the server; the tail
    counts each request's wait from its arrival."""
    cell = tiny_cell("mixtral-prefill-short", dtype="float32")
    cell.traffic["arrivals"]["rate_per_s"] = 40.0
    from colobench.generators.prefill import Traffic
    t = Traffic(cell.traffic, cell.config["vocab"], SEED)
    out = R.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] == max(t.n, t.arrived_by(0.5))
    assert out["e2e"]["ttft_p95_ms"] > 0


def test_calibration_reads_program_control_and_sweep(monkeypatch, tmp_path,
                                                     capsys):
    """``calibrate.py`` on the CPU: a sweep point, the program's numbers on
    two seeds and the control's on one, each a JSON line; the control's
    fail the cell's limits."""
    import json

    from colobench import calibrate
    name = PREFILL[0]
    tiny = tiny_cell(name, dtype="float32")
    monkeypatch.setattr(cells, "load", lambda n: copy.deepcopy(tiny))
    out = tmp_path / "cal.jsonl"
    assert calibrate.main(["--workload", name, "--seeds", "2",
                           "--control-seeds", "1", "--seconds", "0.1",
                           "--rates", "100", "--device", "cpu",
                           "--out", str(out)]) == 0
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["side"] for r in rows] == ["sweep", "program", "program",
                                         "control"]
    limits = tiny.limits
    assert check.passed(check.judge(rows[1]["values"], limits))
    assert not check.passed(check.judge(rows[3]["values"], limits))
