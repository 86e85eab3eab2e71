"""The traffic of a seed is the same on every run, and differs between
seeds only in order and ids; its lengths and gaps are the stated laws'
quantiles."""

import math
import statistics

import numpy as np
import pytest

from colobench.generators.prefill import Traffic, quantile_gaps, \
    quantile_lengths
from colobench.lib import cells

SEED = 2**31 + 977
MIXES = [w["name"] for w in cells.benchmark()["workloads"]]


def _traffic(seed, name="mixtral-prefill-short"):
    return Traffic(cells.load(name).traffic, 32000, seed)


def test_same_seed_same_calls():
    a, b = _traffic(SEED), _traffic(SEED)
    for i in range(40):
        assert a.length(i) == b.length(i)
        assert a.arrival(i) == b.arrival(i)
        assert np.array_equal(a.prompt(i), b.prompt(i))
    assert a.sample(40) == b.sample(40)


def test_other_seed_other_order_same_lengths():
    a, b = _traffic(SEED, "mixtral-prefill-long"), \
        _traffic(SEED + 1, "mixtral-prefill-long")
    n = 3 * a.n
    la = [a.length(i) for i in range(n)]
    lb = [b.length(i) for i in range(n)]
    assert la != lb and sorted(la) == sorted(lb)
    ga = [a.arrival(i + 1) - a.arrival(i) for i in range(n - 1)]
    # whole rounds of gaps: the same multiset in another order
    assert a.arrival(n) == pytest.approx(b.arrival(n))
    assert ga != [b.arrival(i + 1) - b.arrival(i) for i in range(n - 1)]
    assert not np.array_equal(a.prompt(0), b.prompt(0))


@pytest.mark.parametrize("name", MIXES)
def test_each_round_holds_each_length_once(name):
    t = _traffic(SEED, name)
    for r in range(5):
        got = sorted(t.length(r * t.n + j) for j in range(t.n))
        assert got == t.lengths
        # a round's gaps add up to its share of the rate
        span = t.arrival((r + 1) * t.n) - t.arrival(r * t.n)
        assert span == pytest.approx(t.n / t.rate)


def test_quantile_lengths_by_hand():
    law = {"median": 1000, "sigma": 1.0, "min": 64, "max": 8192,
           "points": 2, "multiple": 64}
    # the quartiles of a lognormal: median * exp(-+0.6745 sigma)
    z = statistics.NormalDist().inv_cdf(0.75)
    want = [math.ceil(1000 * math.exp(-z) / 64) * 64,
            math.ceil(1000 * math.exp(z) / 64) * 64]
    assert quantile_lengths(law) == want == [512, 1984]
    law.update(points=1)
    assert quantile_lengths(law) == [1024]
    law.update(median=10**6)
    assert quantile_lengths(law) == [8192]


def test_quantile_gaps_keep_the_rate():
    g = quantile_gaps(4.0, 16)
    assert sum(g) / len(g) == pytest.approx(0.25)
    assert g == sorted(g) and g[0] > 0
    # the exponential's shape: the median gap is ln 2 of the mean
    assert statistics.median(g) == pytest.approx(0.25 * math.log(2),
                                                 rel=0.05)


def test_arrivals_within_a_window():
    t = _traffic(SEED)
    n = t.arrived_by(10.0)
    assert t.arrival(n - 1) < 10.0 <= t.arrival(n)
    assert abs(n - 10.0 * t.rate) <= t.n


def test_prompts_are_uniform_ids_of_the_cell_shape():
    t = _traffic(SEED)
    p = t.prompt(5)
    assert p.shape == (1, t.length(5)) and p.dtype == np.int32
    assert 0 <= p.min() and p.max() < 32000


def test_sample_holds_the_longest_call():
    for seed in (1, SEED, 2**40 + 3):
        t = _traffic(seed)
        s = t.sample(40)
        assert len(s) == len(set(s)) == t.check_requests
        assert max(t.lengths) in [t.length(i) for i in s]
        assert all(0 <= i < 40 for i in s)


def test_a_fixed_schedule_is_the_same_for_every_seed():
    t = dict(cells.load("mixtral-prefill-long").traffic, schedule_seed=5)
    a, b = Traffic(t, 32000, SEED), Traffic(t, 32000, SEED + 1)
    assert [a.length(i) for i in range(40)] == [b.length(i)
                                                for i in range(40)]
    assert [a.arrival(i) for i in range(40)] == [b.arrival(i)
                                                 for i in range(40)]
    # the prompts and the checked sample are still the seed's
    assert not np.array_equal(a.prompt(0), b.prompt(0))
    assert a.sample(40) != b.sample(40)
