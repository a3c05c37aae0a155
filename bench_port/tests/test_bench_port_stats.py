"""The rate, tail and busy-share arithmetic on synthetic stamps."""

import pytest

from bench_port import stats


def _closed_loop(n, step, stall_at=(), stall=0.0):
    """Capture and done stamps of a closed loop at depth 1: frame i+1 is
    captured when step i starts, and done when its own step ends; the
    steps of the frames in `stall_at` take `stall` seconds more."""
    capture, done, start = [0.0], [], 0.0
    for i in range(n):
        end = start + step + (stall if i in stall_at else 0.0)
        done.append(end)
        capture.append(start)
        start = end
    return capture[:n], done


def test_rate_counts_frames_done_inside_the_window():
    capture, done = _closed_loop(100, 0.1)
    assert stats.rate(done, 0.0, 5.0) == pytest.approx(50 / 5.0)
    assert stats.frames_in_window(done, 0.0, 0.35) == [0, 1, 2]


def test_a_stall_moves_the_rate_and_the_tail():
    capture, done = _closed_loop(100, 0.1)
    c2, d2 = _closed_loop(100, 0.1, stall_at=(10, 20, 30, 40, 50), stall=0.5)
    assert stats.rate(d2, 0.0, 8.0) < stats.rate(done, 0.0, 8.0)
    p95 = stats.percentile(stats.latencies(capture, done, 0.0, 8.0), 95)
    p95_stall = stats.percentile(stats.latencies(c2, d2, 0.0, 8.0), 95)
    assert p95 == pytest.approx(0.2)
    assert p95_stall > 0.6


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 95, 5.0), ([1.0, 2.0, 3.0, 4.0], 50, 2.0), (list(range(1, 101)), 95, 95),
    (list(range(1, 21)), 95, 19),
])
def test_percentile_is_the_nearest_rank(values, q, want):
    assert stats.percentile(values, q) == want


def test_union_busy_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    # a sum of the intervals would count the overlaps twice
    assert sum(b - a for a, b in iv) == pytest.approx(4.6)
    assert stats.busy(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 6.0), (7.0, 10.0)]
    assert stats.gaps(iv, -1.0, 1.5) == [(-1.0, 0.0)]


def test_idle_share_reader():
    from bench_port import spec

    read = spec.metric_reader("device_idle_pct")
    iv = [(0.0, 1.0), (0.5, 2.0)]
    record = dict(trace=dict(window=(0.0, 4.0), busy=stats.busy(iv, 0.0, 4.0)))
    assert read(record) == pytest.approx(50.0)
    assert read(dict(trace={})) is None
