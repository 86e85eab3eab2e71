"""Parity of the port's host-only copies with the reference: regions,
table, balancer, query and faults.  The same inputs must give the same
splits, allocations, prunes and fault schedules."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import balancer as RB  # noqa: E402
from repro.core import faults as RF  # noqa: E402
from repro.core import query as RQ  # noqa: E402
from repro.core import regions as RR  # noqa: E402
from repro.core import table as RT  # noqa: E402
from repro_torch.core import balancer as PB  # noqa: E402
from repro_torch.core import faults as PF  # noqa: E402
from repro_torch.core import query as PQ  # noqa: E402
from repro_torch.core import regions as PR  # noqa: E402
from repro_torch.core import table as PT  # noqa: E402
from repro_torch.core.chunk_model import (  # noqa: E402
    H100_PARAMS,
    PAPER_PARAMS,
    ChunkModel,
)
from repro.core.chunk_model import PAPER_PARAMS as REF_PAPER  # noqa: E402
from repro.core.chunk_model import ChunkModel as RefChunkModel  # noqa: E402


def build(mod_t, mod_r, n=300, seed=0, policy="hier", batches=3):
    rng = np.random.default_rng(seed)
    pol = (mod_r.HierarchicalSplitPolicy(40_000_000) if policy == "hier"
           else mod_r.ConstantSizeSplitPolicy(30_000_000))
    t = mod_t.make_mip_table(
        payload_shape=(2, 3),
        extra_index_columns=[mod_t.ColumnSpec("age", (), np.float32),
                             mod_t.ColumnSpec("sex", (), np.int8)],
        split_policy=pol)
    keys = [f"img{i:05d}" for i in rng.permutation(n)]
    for b in range(batches):
        ks = keys[b::batches]
        m = len(ks)
        t.upload(ks, {
            "img": {"data": rng.normal(size=(m, 2, 3)).astype(np.float32)},
            "idx": {"size": rng.integers(1_000_000, 9_000_000, m),
                    "age": rng.uniform(4, 90, m).astype(np.float32),
                    "sex": rng.integers(0, 2, m).astype(np.int8)}})
    t.delete(start="img00100", stop="img00120")
    return t


@pytest.mark.parametrize("policy", ["hier", "const"])
def test_regions_and_table_parity(policy):
    rt, pt = build(RT, RR, policy=policy), build(PT, PR, policy=policy)
    assert [r.signature for r in rt.regions] == \
        [r.signature for r in pt.regions]
    assert [(p.signature, a.signature, b.signature)
            for p, a, b in rt.split_log] == \
        [(p.signature, a.signature, b.signature) for p, a, b in pt.split_log]
    np.testing.assert_array_equal(rt.keys, pt.keys)
    assert rt.region_bytes() == pt.region_bytes()
    for s, e in [(None, None), (b"img00050", b"img00170"), (b"img002", None)]:
        assert [r.rid for r in rt.regions.prune(s, e)] == \
            [r.rid for r in pt.regions.prune(s, e)]
    assert rt.regions.regions_containing([b"img00007", b"img00299"]) == \
        pt.regions.regions_containing([b"img00007", b"img00299"])


def test_balancer_parity():
    rt, pt = build(RT, RR), build(PT, PR)
    rn = [RB.NodeSpec(i, cores=c, mips=m)
          for i, (c, m) in enumerate([(12, 1.0), (12, 1.0), (32, 1.6)])]
    pn = [PB.NodeSpec(i, cores=c, mips=m)
          for i, (c, m) in enumerate([(12, 1.0), (12, 1.0), (32, 1.6)])]
    rb, pb = rt.region_bytes(), pt.region_bytes()
    for fn in ("greedy_allocation", "balanced_allocation",
               "central_allocation"):
        assert getattr(RB, fn)(rb, rn) == getattr(PB, fn)(pb, pn)
    ra = RB.balanced_allocation(rb, rn)
    skew = [PB.NodeSpec(i, cores=1, mips=m) for i, m in enumerate((1, 5, 9))]
    rskew = [RB.NodeSpec(i, cores=1, mips=m) for i, m in enumerate((1, 5, 9))]
    assert RB.rebalance(ra, rb, rskew) == PB.rebalance(dict(ra), pb, skew)
    assert RB.allocation_imbalance(ra, rb, rn) == \
        PB.allocation_imbalance(dict(ra), pb, pn)
    obs = {0: [1.0, 1.2], 1: [3.0], 2: [0.5, 0.4]}
    assert [n.power for n in RB.powers_from_observations(obs, rn)] == \
        [n.power for n in PB.powers_from_observations(obs, pn)]


def test_query_parity():
    rt, pt = build(RT, RR), build(PT, PR)
    for lo, hi, sex in [(20, 40, None), (30, 60, 1), (None, 10, 0)]:
        for fn in ("indexed_query",):
            rm, rs = getattr(RQ, fn)(rt, RQ.age_sex_predicate(lo, hi, sex),
                                     ["age", "sex"], start=b"img00030")
            pm, ps = getattr(PQ, fn)(pt, PQ.age_sex_predicate(lo, hi, sex),
                                     ["age", "sex"], start=b"img00030")
            np.testing.assert_array_equal(rm, pm)
            assert rs.__dict__ == ps.__dict__


def test_fault_schedule_parity():
    def schedule(mod):
        rules = [mod.FaultRule("gather", "transient", p=0.3),
                 mod.FaultRule("fold", "device_lost", after=7, times=1,
                               device=2),
                 mod.FaultRule("device_put", "transient", p=0.5, times=4)]
        inj = mod.FaultInjector(rules, seed=11)
        out = []
        for i in range(60):
            site = ("gather", "fold", "device_put")[i % 3]
            try:
                inj.fire(site, device=i % 4)
                out.append("ok")
            except mod.DeviceLostError as e:
                out.append(f"lost{e.device}")
            except mod.TransientFaultError:
                out.append("transient")
        pol = mod.RetryPolicy(seed=5)
        return out, sorted(inj.lost_devices), [
            pol.delay_s(a, "k") for a in range(4)]
    assert schedule(RF) == schedule(PF)


def test_chunk_model_parity():
    assert RefChunkModel(REF_PAPER).optimal_eta() == \
        ChunkModel(PAPER_PARAMS).optimal_eta()
    # the H100 parameter set: the population fits one card's stats budget
    assert H100_PARAMS.alpha == 0.0 and H100_PARAMS.core == 1
    assert H100_PARAMS.v_disc_r == 3.35e12


def test_mask_to_device_layout_parity():
    r = np.random.default_rng(3)
    mask = r.random(50) > 0.4
    row_ids = r.integers(0, 50, (4, 16))
    valid = r.random((4, 16)) > 0.2
    np.testing.assert_array_equal(
        RQ.mask_to_device_layout(mask, row_ids, valid),
        PQ.mask_to_device_layout(mask, row_ids, valid))


def test_tree_sizes_match_reference():
    from repro import utils as RU
    from repro_torch import utils as PU
    tree = {"b": np.zeros((3, 4), np.float32),
            "a": (np.zeros(5, np.int8), [np.zeros((2, 2), np.float64)]),
            "c": None}
    ported = PU.tree_map(torch.from_numpy, tree)
    assert PU.tree_size_bytes(tree) == PU.tree_size_bytes(ported) == \
        RU.tree_size_bytes(tree)
    assert PU.tree_param_count(tree) == PU.tree_param_count(ported) == \
        RU.tree_param_count(tree)


def test_fold_seed_is_deterministic_per_name():
    from repro_torch.utils import fold_seed

    def draw(*names):
        return torch.rand(4, generator=fold_seed(7, *names))

    assert torch.equal(draw("data", "shuffle"), draw("data", "shuffle"))
    assert not torch.equal(draw("data", "shuffle"), draw("shuffle", "data"))
    assert not torch.equal(draw("data"), draw("data", "shuffle"))
