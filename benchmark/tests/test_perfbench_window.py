"""The window's arithmetic: rates over whole units, tails over every
request, the device's busy time as a union of overlapping intervals."""

import statistics

import pytest

from benchmark.window import gaps, percentile, rate, union_length


def test_percentile_matches_interpolated_quantiles():
    values = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert percentile(values, 50) == 3.0
    assert percentile(values, 0) == 1.0 and percentile(values, 100) == 5.0
    assert percentile(values, 95) == pytest.approx(4.8)
    many = list(range(1, 401))
    assert percentile(many, 50) == statistics.median(many)


def test_tail_covers_every_request():
    # one slow request in twenty sits above the 95th percentile's rank
    times = [10.0] * 19 + [100.0]
    assert percentile(times, 95) == pytest.approx(14.5)
    assert percentile(times, 50) == 10.0


def test_rate_counts_whole_units_over_the_window():
    # 8 chains of 20 steps at 2 images a step over 21.5 s
    assert rate(8, 20 * 2, 21.5) == pytest.approx(320 / 21.5)
    with pytest.raises(ValueError):
        rate(1, 1, 0.0)


def test_union_counts_overlaps_once():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert union_length([]) == 0
    assert union_length([(3, 4), (0, 1)]) == 2


def test_gaps_are_the_uncovered_stretches():
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]
    assert gaps([(0, 6)], 0, 6) == []
