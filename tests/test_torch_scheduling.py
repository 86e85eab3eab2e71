"""The port's host-side planners and the engine's cost oracle.

- ``repro_torch.core.simulator`` against ``repro.core.simulator``: the
  same cluster and job give equal ``SimResult`` fields, task by task, in
  both modes; then the reference's own cases (``tests/test_simulator.py``:
  mechanics and the paper's orderings) run on the port.
- ``repro_torch.core.scheduler.GridScheduler`` held to
  ``tests/test_scheduler.py``'s cases, run on the port.
- ``MapReduceEngine.fold_cost``: the chunked plain fold counted on
  ``meta`` tensors, over every chunk of the block, by the rule its
  docstring states (checked here against a hand count).

The reference files are run with their ``repro.core.`` imports rewritten to
``repro_torch.core.`` (neither imports anything else of the reference), as
``test_torch_differential.py`` runs the differential walk.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import simulator as RS  # noqa: E402
from repro.core.balancer import greedy_allocation as ref_greedy  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.core.balancer import greedy_allocation  # noqa: E402
from repro_torch.core.mapreduce import MapReduceEngine  # noqa: E402
from repro_torch.core.stats import (  # noqa: E402
    FusedProgram,
    GroupedProgram,
    MeanProgram,
    MomentsProgram,
    VarianceProgram,
)


def port_copy(name):
    """Run ``tests/<name>`` with its reference imports pointed at the port
    and return its namespace."""
    src = Path(__file__).with_name(name).read_text()
    src = src.replace("from repro.core.", "from repro_torch.core.")
    assert "repro." not in src.replace("repro_torch.", "")
    ns = {"__name__": f"torch_port_{name[:-3]}"}
    exec(compile(src, f"{name} (port imports)", "exec"), ns)
    return ns


# pytest collects these classes under the names given here
_SIM = port_copy("test_simulator.py")
_SCHED = port_copy("test_scheduler.py")
TestPortSimulatorMechanics = _SIM["TestMechanics"]
TestPortSimulatorPaperOrderings = _SIM["TestPaperOrderings"]
TestPortSimulatorJobBuilder = _SIM["TestMapReduceJobBuilder"]
TestPortSchedulerStragglers = _SCHED["TestStragglerMitigation"]
TestPortSchedulerFailures = _SCHED["TestFailureHandling"]
TestPortSchedulerPlanning = _SCHED["TestPlanning"]


# ----------------------------------------------------------------------
# the simulator against the reference's
# ----------------------------------------------------------------------

def simulate(mod, greedy, mode, steal, eta):
    nodes = mod.paper_cluster()
    rng = np.random.default_rng(eta)
    region_bytes = {i: int(b) for i, b in
                    enumerate(rng.integers(50e6, 150e6, 96))}
    alloc = greedy(region_bytes, nodes)
    maps, red = mod.mapreduce_job_tasks(
        n_img=5153, eta=eta, size_in=13e6, size_gen=21e6,
        avg_fn=lambda e: 0.4 * e + 5,
        placement_of_chunk=lambda i: alloc[i % 96])
    sim = mod.ClusterSim(nodes, bandwidth=70e6, allow_steal=steal)
    return sim.run(maps, mode), red, nodes


@pytest.mark.parametrize("steal", [False, True])
@pytest.mark.parametrize("mode", ["hadoop", "sge"])
@pytest.mark.parametrize("eta", [20, 55])
def test_simulator_matches_reference(mode, steal, eta):
    want, wred, wnodes = simulate(RS, ref_greedy, mode, steal, eta)
    got, gred, gnodes = simulate(PS, greedy_allocation, mode, steal, eta)
    assert [dataclasses.astuple(n) for n in gnodes] == \
        [dataclasses.astuple(n) for n in wnodes]
    assert dataclasses.astuple(gred) == dataclasses.astuple(wred)
    assert got.wall_time == want.wall_time
    assert got.resource_time == want.resource_time
    assert got.remote_read_fraction == want.remote_read_fraction
    assert got.node_busy == want.node_busy
    assert [dataclasses.astuple(t) for t in got.tasks] == \
        [dataclasses.astuple(t) for t in want.tasks]
    assert got.summary() == want.summary()


# ----------------------------------------------------------------------
# fold_cost
# ----------------------------------------------------------------------

PAYLOAD = (3, 4)
CSE_MEMBERS = (MeanProgram(), VarianceProgram(), MomentsProgram())


def test_fold_cost_reports_flops_without_building_a_fold():
    eng = MapReduceEngine(["cpu"])
    cost = eng.fold_cost(MeanProgram(), 16, PAYLOAD, np.float32, 4)
    assert cost["flops"] > 0 and cost["bytes"] > 0
    grouped = eng.fold_cost(GroupedProgram(FusedProgram(CSE_MEMBERS), 3),
                            16, PAYLOAD, np.float32, 4, masked=True,
                            groups=3)
    assert grouped["flops"] > 0 and grouped["bytes"] > 0
    # shape arithmetic on meta tensors: no fold entry, no compile
    assert eng.compile_count == 0 and len(eng._compiled) == 0


def test_cse_fold_costs_fewer_flops_than_naive():
    eng = MapReduceEngine(["cpu"])
    fc = eng.fold_cost(FusedProgram(CSE_MEMBERS), 64, PAYLOAD, np.float32, 8)
    fn = eng.fold_cost(FusedProgram(CSE_MEMBERS, cse=False), 64, PAYLOAD,
                       np.float32, 8)
    assert fc["flops"] < 0.9 * fn["flops"], (fc, fn)
    assert fc["bytes"] < fn["bytes"]


@pytest.mark.parametrize("program", [MeanProgram(),
                                     FusedProgram(CSE_MEMBERS)],
                         ids=["mean", "fused"])
def test_fold_cost_counts_every_chunk(program):
    """Twice the rows at a fixed eta is twice the chunks: the count grows
    by the same amount for every further block of rows (only the identity
    partial and its start are paid once), so it nearly doubles."""
    eng = MapReduceEngine(["cpu"])
    c = {r: eng.fold_cost(program, r, PAYLOAD, np.float32, 8)
         for r in (64, 128, 256)}
    for k in ("flops", "bytes"):
        assert c[256][k] - c[128][k] == 2 * (c[128][k] - c[64][k])
        assert 1.95 < c[128][k] / c[64][k] <= 2.0


def test_fold_cost_equals_a_hand_count_of_mean():
    """``MeanProgram`` over R rows of E f32 elements in chunks of eta, no
    mask, by the stated rule:

    - once: the all-valid mask ``ones(R)`` (R; R bytes) and the identity
      partial ``zeros(E)``, ``zeros(())`` (E + 1; 4E + 4 bytes);
    - per chunk: the masked cast's ``zeros(())`` (1; 4), ``where`` over
      ``[eta, E]`` (eta·E; 8·eta·E + eta + 4), the row sum (eta·E;
      4·eta·E + 4E), the row count ``sum`` (eta; eta + 8) and its cast
      (1; 12), the merge's two adds (1 + E; 12 + 12E).
    """
    R, eta, E = 24, 4, 8 * 8 * 8
    chunks = R // eta
    flops = (R + E + 1) + chunks * (2 * eta * E + E + eta + 3)
    nbytes = (R + 4 * E + 4) + chunks * (12 * eta * E + 16 * E + 2 * eta
                                         + 40)
    eng = MapReduceEngine(["cpu"])
    got = eng.fold_cost(MeanProgram(), R, (8, 8, 8), np.float32, eta)
    assert got == {"flops": float(flops), "bytes": float(nbytes)}
