"""Arithmetic of the metrics: rates, percentiles, spreads, and the
reductions of a device trace (busy union, idle gaps by host span)."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def pods_per_s(pods_per_round: Sequence[int], window_s: float) -> float:
    """Pods handed over in the rounds completed in the window (a failed
    round counts none) over the window's seconds, from its start to the end
    of its last round, the failed ones' time included."""
    if not pods_per_round or window_s <= 0:
        raise ValueError("no completed round in the window")
    return sum(pods_per_round) / window_s


def stage_seconds(profile: Dict, stage: str) -> float:
    """A stage's seconds in ``Scheduler.last_stage_profile()``, served in
    full (``<stage>_s``) or from resident state (``<stage>_delta_s``)."""
    return profile.get(f"{stage}_s", 0.0) + profile.get(f"{stage}_delta_s", 0.0)


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks (numpy's
    default rule)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def quartiles(values: Sequence[float]) -> List[float]:
    """The first quartile, the median and the third quartile
    (``statistics.quantiles(values, n=4)``; one value is its own)."""
    if len(values) < 2:
        return [values[0]] * 3
    return statistics.quantiles(values, n=4)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_s(device: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some device operation ran."""
    return sum(e - s for s, e in clip(union(device), lo, hi))


def gaps(device: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of ``[lo, hi]``: no device operation running."""
    out, t = [], lo
    for s, e in clip(union(device), lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float, Optional[str]]]:
    """Cut time into pieces, each with the innermost span open over it
    (``(name, start, end)`` spans that nest, as one thread's do; the one
    opened last wins); ``None`` where no span is open."""
    points = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        best = None
        for name, s, e in spans:
            # the latest opened; of two opened together, the shorter
            if s <= mid < e and (best is None or (s, s - e) > best[1]):
                best = (name, (s, s - e))
        out.append((a, b, best[0] if best else None))
    return out


def idle_by_span(idle: Sequence[Tuple[float, float]], spans, outside: str) -> Dict[str, float]:
    """Seconds of idle device time by the innermost span open on the host
    meanwhile; ``outside`` names time when none was."""
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    for gs, ge in idle:
        covered = 0.0
        for a, b, name in pieces:
            lo, hi = max(a, gs), min(b, ge)
            if hi > lo:
                key = outside if name is None else name
                out[key] = out.get(key, 0.0) + (hi - lo)
                covered += hi - lo
        if ge - gs > covered:
            out[outside] = out.get(outside, 0.0) + (ge - gs - covered)
    return out
