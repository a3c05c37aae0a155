"""The arithmetic of the end-to-end metrics and of the device trace: the
rate and the latency tail of the frames done in a window, and the union of
the device's busy intervals."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def frames_in_window(done: Sequence[float], t_open: float, t_close: float) -> List[int]:
    """Indices of the frames whose outputs were done inside [t_open, t_close]."""
    return [i for i, t in enumerate(done) if t_open <= t <= t_close]


def rate(done: Sequence[float], t_open: float, t_close: float) -> float:
    """Frames done inside the window over the window's seconds: all the work
    over all the time."""
    return len(frames_in_window(done, t_open, t_close)) / (t_close - t_open)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q % of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)), 1) - 1]


def latencies(capture: Sequence[float], done: Sequence[float], t_open: float,
              t_close: float) -> List[float]:
    """Capture-to-done seconds of every frame done inside the window."""
    return [done[i] - capture[i] for i in frames_in_window(done, t_open, t_close)]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of closed intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of `intervals` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi]: where no interval of the union runs."""
    out, t = [], lo
    for a, b in union(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def stage_ms(spans, frames, stages) -> float:
    """Mean host ms a frame of `frames` spent inside the step stages named
    in `stages`, from (stage, frame, t0, t1) spans; None without a span."""
    frames, per = set(frames), {}
    for name, frame, t0, t1 in spans:
        if name in stages and frame in frames:
            per[frame] = per.get(frame, 0.0) + (t1 - t0)
    return 1e3 * sum(per.values()) / len(per) if per else None
