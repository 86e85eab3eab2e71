"""The reference's stateful differential walk, run against the port.

``tests/test_differential.py`` drives random interleavings of upload,
remove, rebalance and queries against a ``GridSession`` and a plain-NumPy
oracle, and checks every result, the block/partial invariants, the mutation
epochs and an exact recount of every tier's byte gauge after each step.
This file runs that same driver, op for op, with its ``repro.core`` imports
rewritten to ``repro_torch.core`` (the driver itself only uses numpy on
results), so the port meets the very oracle the reference does: plainly,
under spill pressure, under injected faults, and on four owner devices.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

_SOURCE = Path(__file__).with_name("test_differential.py").read_text()
_PORT_SOURCE = _SOURCE.replace("from repro.core.", "from repro_torch.core.")
assert "from repro." not in _PORT_SOURCE and "import repro" not in _PORT_SOURCE
_walk = {"__name__": "torch_differential_walk"}
exec(compile(_PORT_SOURCE, "test_differential.py (port imports)", "exec"),
     _walk)

DifferentialDriver = _walk["DifferentialDriver"]
FaultWalkDriver = _walk["FaultWalkDriver"]
_spill_kwargs = _walk["_spill_kwargs"]
fault_walk_rules = _walk["fault_walk_rules"]
FaultInjector = _walk["FaultInjector"]
RetryPolicy = _walk["RetryPolicy"]

WEIGHTS = np.array([4, 2, 2, 1, 1, 2, 3, 2, 2, 2, 1], dtype=float)


def walk(drv, seed, steps):
    rng = np.random.default_rng(seed)
    ops = list(DifferentialDriver.OPS)
    for _ in range(steps):
        op = rng.choice(ops, p=WEIGHTS / WEIGHTS.sum())
        drv.apply(str(op), int(rng.integers(0, 2**31)))
    assert drv.steps == steps


@pytest.mark.parametrize("walk_seed", [0, 1, 2])
def test_differential_random_walk(walk_seed):
    drv = DifferentialDriver(session_kwargs=dict(devices=["cpu"]))
    walk(drv, walk_seed, 70)
    assert drv.session.blocks.stats.hits > 0
    assert drv.session.blocks.stats.gathers > 0


@pytest.mark.parametrize("walk_seed", [0, 1])
def test_differential_random_walk_four_owners(walk_seed):
    """Four logical owners on one CPU: rebalances move regions between
    owners and additive queries take the tree merge."""
    drv = DifferentialDriver(session_kwargs=dict(devices=["cpu"] * 4))
    walk(drv, walk_seed, 70)
    assert drv.session.engine.merge_path_counts["tree"] > 0


@pytest.mark.parametrize("walk_seed", [0, 1])
def test_differential_random_walk_under_spill(walk_seed, tmpdir):
    kwargs = _spill_kwargs(tmpdir)
    kwargs.update(devices=["cpu"])
    drv = DifferentialDriver(session_kwargs=kwargs)
    walk(drv, walk_seed, 40)
    s = drv.session.blocks.stats.snapshot()
    assert s.demotions + s.spills + s.spill_drops + s.host_serves > 0, s
    drv.session.close()
    assert drv.session.blocks.tier_bytes()["disk"] == 0


@pytest.mark.parametrize("walk_seed", [3, 7])
def test_differential_random_walk_under_faults(walk_seed, tmpdir):
    inj = FaultInjector(rules=fault_walk_rules(), seed=walk_seed)
    kwargs = _spill_kwargs(tmpdir)
    kwargs.update(host_budget=256, partial_budget=512, fault_injector=inj,
                  retry_policy=RetryPolicy(max_attempts=4, base_delay_s=1e-4),
                  devices=["cpu"])
    drv = FaultWalkDriver(session_kwargs=kwargs)
    walk(drv, walk_seed, 70)
    s = drv.session.blocks.stats.snapshot()
    assert s.faults_injected > 0
    assert s.faults_injected == inj.faults_injected
    assert s.retries > 0
    assert s.spill_corruptions > 0
    assert s.spill_recoveries > 0
    drv.session.close()
    assert drv.session.blocks.tier_bytes()["disk"] == 0
