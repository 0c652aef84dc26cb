"""Arithmetic over a run's record: rates over whole jobs, percentiles with
their counts, quartile spreads and the union of device intervals."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between the closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def count_beyond(values: Sequence[float], threshold: float) -> int:
    """How many values lie strictly above threshold (the samples a tail
    rests on)."""
    return sum(1 for v in values if v > threshold)


def rate_over_whole_jobs(jobs: Sequence[Tuple[float, float, float]], window_start: float,
                         deadline: float) -> Tuple[float, float, int]:
    """(units per second, window seconds, jobs counted) over jobs given as
    (start, end, units).  The window opens at window_start and closes at the
    end of the last job to finish by the deadline; a job still running at
    the deadline is neither counted nor timed."""
    done = [j for j in jobs if j[1] <= deadline]
    if not done:
        return 0.0, 0.0, 0
    close = max(j[1] for j in done)
    span = close - window_start
    return sum(j[2] for j in done) / span, span, len(done)


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, the quartiles as statistics.quantiles gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that no interval covers."""
    out = []
    cursor = start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return [(s, e) for s, e in out if e > s]


def idle_share(intervals: Sequence[Tuple[float, float]], start: float, end: float) -> float:
    """The share of [start, end) in which no interval runs."""
    inside = [(max(s, start), min(e, end)) for s, e in intervals if e > start and s < end]
    return 1.0 - union_length(inside) / (end - start)
