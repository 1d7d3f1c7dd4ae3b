"""The metrics' arithmetic on made-up timings."""

import pytest

import stats


def test_pods_per_s_counts_every_completed_round_over_the_window():
    assert stats.pods_per_s([10000, 10000, 10000], 0.5) == pytest.approx(60000.0)
    with pytest.raises(ValueError):
        stats.pods_per_s([], 1.0)


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3.0, 1.0, 2.0], 100) == 3.0


def test_spread_is_the_quartiles_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
    assert stats.quartiles([5.0]) == [5.0, 5.0, 5.0]


def test_union_merges_overlaps_and_drops_empty_intervals():
    got = stats.union([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)])
    assert got == [(0, 4), (5, 6)]


def test_busy_and_gaps_within_the_stretch():
    device = [(0.5, 1.5), (1.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert stats.busy_s(device, 1.0, 10.0) == pytest.approx(1.0 + 1.0 + 1.0)
    assert stats.gaps(device, 1.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_idle_time_goes_to_the_innermost_open_span():
    spans = [
        ("solver.solve", 0.0, 10.0),
        ("solve.sort", 1.0, 2.0),
        ("solve.encode", 2.0, 4.0),
        ("solve.pack_fetch", 5.0, 6.0),
    ]
    idle = [(0.5, 3.0), (6.0, 11.0)]
    got = stats.idle_by_span(idle, spans, "outside")
    assert got == pytest.approx({
        "solver.solve": 0.5 + 4.0,  # 0.5-1.0 and 6.0-10.0
        "solve.sort": 1.0,
        "solve.encode": 1.0,
        "outside": 1.0,  # 10.0-11.0
    })


def test_stage_seconds_reads_full_or_resident_keys():
    assert stats.stage_seconds({"encode_s": 0.5}, "encode") == 0.5
    assert stats.stage_seconds({"encode_delta_s": 0.25}, "encode") == 0.25
    assert stats.stage_seconds({}, "encode") == 0.0
