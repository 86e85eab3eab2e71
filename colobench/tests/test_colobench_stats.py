"""Rates, tails and the union of device intervals, against hand
cases."""

import pytest

from colobench.lib import stats


def test_rate():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5], 50, 3.0),
    ([1, 2, 3, 4, 5], 100, 5.0),
    ([1, 2, 3, 4, 5], 95, 4.8),
    (list(range(1, 101)), 95, 95.05),
    ([7.0], 95, 7.0),
])
def test_percentile(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_percentile_of_a_batch_counts_each_request():
    # 19 calls of 100 ms and one of 500 ms, 8 requests a call: p95 is
    # interpolated between the 151st and 152nd of 160 requests
    ttft = [d for d in [0.1] * 19 + [0.5] for _ in range(8)]
    assert stats.percentile(ttft, 95) == pytest.approx(
        0.1 + (0.5 - 0.1) * ((159 * 0.95) - 151))


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 5), (1, 2), (3, 4)], 5.0),
    ([(3, 4), (0, 1), (0.5, 1.5)], 2.5),
    ([(1, 1), (2, 1)], 0.0),
])
def test_union_length(intervals, want):
    assert stats.union_length(intervals) == pytest.approx(want)


def test_gaps():
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [
        (0, 1), (3, 4), (5, 6)]
    assert stats.gaps([(0, 6)], 0, 6) == []
