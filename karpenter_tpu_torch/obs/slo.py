"""Online SLO evaluation: declarative objectives judged from live spans.

The system measures everything (stage spans, session hit rate, flight
records), and a judgment made offline comes too late. This module closes
that gap:
objectives are declared in a one-line grammar (``solve.p99 < 100ms``),
evaluated ONLINE from the tracer's span-completion hook, and exposed as
``karpenter_slo_*`` metrics plus ``GET /debug/slo`` on both health
servers. The brownout ladder consumes this layer as its sensor; humans consume
it as "is the objective being met RIGHT NOW, and how fast is the error
budget burning".

Objective grammar (the JAX package's, letter for letter)::

    <source>.<stat> <op> <value>[unit]

    solve.p99 < 100ms                  # solver.solve span durations
    provision.success_rate >= 0.999    # error-free provision.round fraction
    time_to_bind.p99 < 5s              # round duration + admission window
    session.catalog_hit_rate >= 0.9    # session_stats hit/miss events
    sidecar.pack.p99 < 100ms           # the sidecar's own end-to-end span

Design constraints, in order:

- **Hook-side cost is O(1).** A span completion does one bucket increment
  under a short lock. Quantiles, burn rates, and gauge publication happen
  on slice rotation and on snapshot — never per event.
- **Log-linear histograms.** Buckets grow by ``GROWTH`` (1.05) per step,
  so a quantile read off the sketch is within ~2.5% of the exact value —
  the acceptance bar (online vs offline percentile within 5%) is a
  property of the bucket scheme, not luck.
- **Trace-id exemplars.** Every bucket remembers the last trace id that
  landed in it, and every budget breach remembers its trace — ``/debug/slo``
  answers "show me a solve that blew the objective" with an id that greps
  straight into ``/debug/traces`` and the flight dir.
- **Multi-window burn rates.** Each objective keeps a fast (default 5 m)
  and slow (12x fast, so 1 h) sliding window over one shared slice ring;
  *burning* means BOTH windows consume error budget faster than allowed —
  the standard multiwindow page condition (a blip trips neither; a real
  regression trips both).
- **Fake-clock testable.** All windowing runs off an injected ``clock``;
  tests drive burn-rate transitions deterministically.

The engine is installed with ``obs.configure_slo`` (a tracer finish-hook
+ a registered flight-recorder state panel, so every slow-solve record
snapshots which objectives were burning at the time). Never import this
module from jit/vmap/pallas-reachable solver code — it is host-side span
machinery like the rest of ``obs``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.obs.trace import Span

# -- log-linear bucket scheme -------------------------------------------------

BASE_S = 1e-4  # 0.1ms: everything faster lands in bucket 0
GROWTH = 1.05  # per-bucket width ratio; quantile error ~ sqrt(1.05)-1 ≈ 2.5%
_LOG_GROWTH = math.log(GROWTH)


def bucket_index(value: float) -> int:
    if value <= BASE_S:
        return 0
    return int(math.log(value / BASE_S) / _LOG_GROWTH) + 1


def bucket_value(index: int) -> float:
    """Representative value of a bucket: the geometric midpoint of its
    bounds, so quantization error is symmetric in log space."""
    if index <= 0:
        return BASE_S
    return BASE_S * GROWTH ** (index - 0.5)


# -- objective grammar --------------------------------------------------------

# span sources: grammar prefix -> (span name, value extraction)
# "duration" = span.duration_s; "duration+admission" additionally counts the
# batcher window the round span carries as an attribute (work that predates
# the span, which is exactly what a pod waiting to bind experienced)
SPAN_SOURCES: Dict[str, Tuple[str, str]] = {
    "solve": ("solver.solve", "duration"),
    "provision": ("provision.round", "duration"),
    "time_to_bind": ("provision.round", "duration+admission"),
    "sidecar.pack": ("sidecar.pack", "duration"),
    # the kube transport choke point (kube/transport.py): one span per
    # logical apiserver request, so `kube.p99 < 1s` pages on a browning-out
    # control plane before the breaker has to open
    "kube": ("kube.request", "duration"),
}

# ratio sources fed by explicit events (not spans): full grammar lhs
RATIO_SOURCES = ("session.catalog_hit_rate",)

_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0}
_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}
_EXPR_RE = re.compile(
    r"^\s*(?P<lhs>[a-z0-9_.]+)\s*(?P<op>[<>]=?)\s*"
    r"(?P<value>[0-9]*\.?[0-9]+)\s*(?P<unit>us|ms|s|m)?\s*$"
)
_PCTL_RE = re.compile(r"^p(\d{1,2})$")

DEFAULT_OBJECTIVES = (
    "solve.p99 < 100ms",
    "provision.success_rate >= 0.999",
    "time_to_bind.p99 < 5s",
    "session.catalog_hit_rate >= 0.9",
    # apiserver health as seen from THIS client (per kube.request span) —
    # a browning-out control plane burns this first, before binds fail
    "kube.p99 < 1s",
)
# the sidecar's own view: its end-to-end unit is the pack span, and the
# session store it owns is the hit-rate source of truth
SIDECAR_OBJECTIVES = (
    "sidecar.pack.p99 < 100ms",
    "session.catalog_hit_rate >= 0.9",
)


class Objective:
    """One parsed objective. ``kind`` is ``latency`` (histogram quantile
    judged against the threshold), ``span_ratio`` (error-free span
    fraction), or ``ratio`` (explicit good/bad events)."""

    __slots__ = (
        "name", "expr", "kind", "span_name", "value_kind", "stat",
        "quantile", "op_name", "op", "threshold", "budget",
    )

    def __init__(self, expr: str):
        m = _EXPR_RE.match(expr)
        if m is None:
            raise ValueError(
                f"unparseable objective {expr!r} "
                "(grammar: <source>.<stat> <op> <value>[us|ms|s|m])"
            )
        lhs, self.op_name = m.group("lhs"), m.group("op")
        self.expr = expr.strip()
        self.op = _OPS[self.op_name]
        self.threshold = float(m.group("value")) * _UNITS.get(m.group("unit") or "", 1.0)

        if lhs in RATIO_SOURCES:
            self.kind = "ratio"
            self.span_name = None
            self.value_kind = None
            self.stat = lhs
            self.quantile = None
            self.name = lhs.replace(".", "_")
            self.budget = self._ratio_budget()
            return
        source, _, stat = lhs.rpartition(".")
        if source not in SPAN_SOURCES:
            raise ValueError(
                f"unknown objective source {source!r} in {expr!r} "
                f"(known: {', '.join((*SPAN_SOURCES, *RATIO_SOURCES))})"
            )
        self.span_name, self.value_kind = SPAN_SOURCES[source]
        self.stat = stat
        self.name = f"{source.replace('.', '_')}_{stat}"
        pm = _PCTL_RE.match(stat)
        if pm is not None:
            self.kind = "latency"
            self.quantile = int(pm.group(1)) / 100.0
            # the error budget of `p99 < X` is the 1% of events allowed
            # over X; burn rate = (observed over-threshold fraction)/budget
            self.budget = max(1.0 - self.quantile, 1e-6)
        elif stat == "mean":
            self.kind = "latency"
            self.quantile = None
            self.budget = 0.01  # treat like a p99: 1% may breach
        elif stat == "success_rate":
            self.kind = "span_ratio"
            self.quantile = None
            self.budget = self._ratio_budget()
        else:
            raise ValueError(
                f"unknown stat {stat!r} in {expr!r} "
                "(pNN, mean, or success_rate)"
            )

    def _ratio_budget(self) -> float:
        # `success_rate >= 0.999` allows 0.1% bad events; a `<=`-style
        # ratio objective would allow `threshold` itself
        if self.op_name in (">", ">="):
            return max(1.0 - self.threshold, 1e-6)
        return max(self.threshold, 1e-6)

    def evaluate(self, value: Optional[float]) -> Optional[bool]:
        if value is None:
            return None
        return bool(self.op(value, self.threshold))


def parse_objectives(exprs: Sequence[str]) -> List[Objective]:
    objs = [Objective(e) for e in exprs]
    seen: Dict[str, str] = {}
    for o in objs:
        if o.name in seen:
            raise ValueError(
                f"objective {o.expr!r} collides with {seen[o.name]!r} "
                f"(both evaluate as {o.name})"
            )
        seen[o.name] = o.expr
    return objs


def load_objectives(path: str) -> List[str]:
    """Read an ``--slo-config`` file: one objective per line, ``#`` starts
    a comment, blank lines ignored. Parse errors raise at load time —
    a typo'd objective must fail startup, not silently never evaluate."""
    out: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    parse_objectives(out)  # validate eagerly
    return out


# -- sliding-window state -----------------------------------------------------


# Raw values retained per slice for SMALL-sample exactness: the sketch's
# ~2.5% bucket quantization is fine at volume but dominates a 12-event
# window, where a p99 IS the max and a bucket midpoint can miss it by a
# whole bucket. While a window's raw list is COMPLETE (no slice hit the cap) the
# quantile is answered exactly; past the cap the sketch takes over and
# its error bound is back to the bucket scheme's.
RAW_SAMPLE_CAP = 64


class _Slice:
    __slots__ = ("index", "counts", "exemplars", "good", "bad", "breach", "raw")

    def __init__(self, index: int):
        self.index = index
        self.counts: Dict[int, int] = {}
        self.exemplars: Dict[int, str] = {}  # bucket -> last trace id
        self.good = 0
        self.bad = 0
        self.breach: Optional[str] = None  # last budget-breaching trace id
        self.raw: List[float] = []  # first RAW_SAMPLE_CAP values, exact


class SlidingWindow:
    """A ring of time slices shared by the fast and slow windows: the fast
    window reads the newest ``fast_slices`` slices, the slow window reads
    them all. One lock, O(1) record."""

    def __init__(
        self,
        slice_s: float,
        fast_slices: int,
        total_slices: int,
        clock: Callable[[], float],
    ):
        self.slice_s = slice_s
        self.fast_slices = fast_slices
        self.total_slices = total_slices
        self._clock = clock
        self._slices: "deque[_Slice]" = deque()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def _current_locked(self) -> Tuple[_Slice, bool]:
        idx = int(self._clock() / self.slice_s)
        rotated = False
        if not self._slices or self._slices[-1].index != idx:
            # a quiet period leaves index gaps; expired slices drop by
            # INDEX, not by count, so silence ages the window correctly
            self._slices.append(_Slice(idx))
            floor = idx - self.total_slices + 1
            while self._slices and self._slices[0].index < floor:
                self._slices.popleft()
            rotated = True
        return self._slices[-1], rotated

    def record(
        self,
        value: Optional[float],
        trace_id: Optional[str],
        bad: bool,
    ) -> bool:
        """One event; returns True when the slice ring rotated (the
        caller's cue to republish derived gauges)."""
        with self._lock:
            sl, rotated = self._current_locked()
            if value is not None:
                b = bucket_index(value)
                sl.counts[b] = sl.counts.get(b, 0) + 1
                if trace_id:
                    sl.exemplars[b] = trace_id
                if len(sl.raw) < RAW_SAMPLE_CAP:
                    sl.raw.append(value)
            if bad:
                sl.bad += 1
                if trace_id:
                    sl.breach = trace_id
            else:
                sl.good += 1
        return rotated

    def merged(self, fast: bool) -> Dict[str, Any]:
        """Counts/exemplars/good/bad merged over the fast or slow window.
        Slices are selected by INDEX AGE against the clock, so a window
        with no recent events still expires its old slices."""
        now_idx = int(self._clock() / self.slice_s)
        span = self.fast_slices if fast else self.total_slices
        floor = now_idx - span + 1
        counts: Dict[int, int] = {}
        exemplars: Dict[int, str] = {}
        good = bad = 0
        breach: Optional[str] = None
        raw: List[float] = []
        with self._lock:
            # merge under the lock: the newest slice's dicts are live —
            # a concurrent record() growing them mid-iteration would raise
            for s in self._slices:
                if s.index < floor:
                    continue
                for b, n in s.counts.items():
                    counts[b] = counts.get(b, 0) + n
                exemplars.update(s.exemplars)
                good += s.good
                bad += s.bad
                if s.breach is not None:
                    breach = s.breach
                raw.extend(s.raw)
        return {
            "counts": counts, "exemplars": exemplars,
            "good": good, "bad": bad, "breach": breach,
            # complete iff len(raw) == sum(counts.values()): no slice in
            # the window overflowed its cap, so exact stats are available
            "raw": raw,
        }


class Histogram:
    """A mergeable log-linear histogram over the FIXED bucket geometry
    above. Because every window in every process shares ``BASE_S``/
    ``GROWTH``, merging two snapshots is plain per-bucket addition — the
    property the fleet telemetry plane (obs/collector.py) leans on: member
    snapshots merge into fleet-wide quantiles with exactly the same ~2.5%
    error bar as a single process's sketch, no re-binning, no loss."""

    __slots__ = ("counts", "good", "bad")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.good = 0
        self.bad = 0

    def observe(self, value: Optional[float], bad: bool = False) -> None:
        if value is not None:
            b = bucket_index(value)
            self.counts[b] = self.counts.get(b, 0) + 1
        if bad:
            self.bad += 1
        else:
            self.good += 1

    def merge(self, snapshot) -> "Histogram":
        """Fold another histogram (or its JSON ``snapshot()`` dict — bucket
        keys may arrive as strings after a round trip) into this one."""
        if isinstance(snapshot, Histogram):
            counts, good, bad = snapshot.counts, snapshot.good, snapshot.bad
        else:
            counts = snapshot.get("counts") or {}
            good = int(snapshot.get("good") or 0)
            bad = int(snapshot.get("bad") or 0)
        for b, n in counts.items():
            b = int(b)
            self.counts[b] = self.counts.get(b, 0) + int(n)
        self.good += good
        self.bad += bad
        return self

    def total(self) -> int:
        return sum(self.counts.values())

    def events(self) -> int:
        return self.good + self.bad

    def quantile(self, q: float) -> Optional[float]:
        return _quantile(self.counts, q)

    def mean(self) -> Optional[float]:
        return _mean(self.counts)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready form; ``merge`` accepts it back verbatim."""
        return {
            "counts": {str(b): n for b, n in self.counts.items()},
            "good": self.good,
            "bad": self.bad,
        }

    @classmethod
    def from_window(cls, merged: Dict[str, Any]) -> "Histogram":
        """Wrap a :meth:`SlidingWindow.merged` result (already bucketed in
        the shared geometry)."""
        h = cls()
        h.counts = dict(merged.get("counts") or {})
        h.good = int(merged.get("good") or 0)
        h.bad = int(merged.get("bad") or 0)
        return h


def _quantile_exact(values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over raw values — the SAME rank formula as
    the sketch walk below (and an offline nearest-rank p99), so a small
    complete window agrees with the offline cross-check to the float."""
    vs = sorted(values)
    rank = min(max(math.ceil(q * len(vs)), 1), len(vs))
    return vs[rank - 1]


def _quantile(counts: Dict[int, int], q: float) -> Optional[float]:
    total = sum(counts.values())
    if not total:
        return None
    rank = max(math.ceil(q * total), 1)
    seen = 0
    for b in sorted(counts):
        seen += counts[b]
        if seen >= rank:
            return bucket_value(b)
    return bucket_value(max(counts))


def _mean(counts: Dict[int, int]) -> Optional[float]:
    total = sum(counts.values())
    if not total:
        return None
    return sum(bucket_value(b) * n for b, n in counts.items()) / total


# -- the engine ---------------------------------------------------------------

FAST_SLICES = 5  # fast window = 5 slices; slow = SLOW_FACTOR x fast
SLOW_FACTOR = 12  # 5m fast -> 1h slow, the classic multiwindow pairing
# Low-traffic guard: a window holding fewer events than this never burns.
# Burn rate divides by OBSERVED volume, so after an idle hour a 5-solve
# blip would otherwise be 100% of both windows and page instantly — the
# exact transient the multiwindow condition exists to filter.
MIN_WINDOW_EVENTS = 10


class _ObjectiveState:
    """One objective's window plus its pre-resolved metric children (label
    lookup once at construction, not per event)."""

    __slots__ = (
        "objective", "window", "_m", "_g_ok", "_g_burning", "_g_fast",
        "_g_slow", "_c_good", "_c_bad",
    )

    def __init__(self, objective: Objective, window: SlidingWindow):
        self.objective = objective
        self.window = window
        self._m = None
        self._g_ok = self._g_burning = None
        self._g_fast = self._g_slow = self._c_good = self._c_bad = None
        try:
            from karpenter_tpu_torch import metrics

            self._m = metrics
            name = objective.name
            # objective_ok stays UNRESOLVED here: instantiating the child
            # would publish 0.0 ("failing") for an objective that has seen
            # no data — it materializes on the first real verdict
            self._g_burning = metrics.SLO_BURNING.labels(objective=name)
            self._g_fast = metrics.SLO_BURN_RATE.labels(objective=name, window="fast")
            self._g_slow = metrics.SLO_BURN_RATE.labels(objective=name, window="slow")
            self._c_good = metrics.SLO_EVENTS.labels(objective=name, verdict="good")
            self._c_bad = metrics.SLO_EVENTS.labels(objective=name, verdict="bad")
        except Exception:
            pass  # the sidecar's trimmed images may lack the registry

    # -- event intake -------------------------------------------------------

    def observe(self, value: Optional[float], trace_id: Optional[str], bad: bool) -> None:
        rotated = self.window.record(value, trace_id, bad)
        c = self._c_bad if bad else self._c_good
        if c is not None:
            c.inc()
        if rotated:
            # derived gauges refresh on slice boundaries (and on every
            # snapshot) — the hot path stays one bucket increment
            self.publish()

    def observe_span(self, span: Span) -> None:
        obj = self.objective
        value = span.duration_s
        if obj.value_kind == "duration+admission":
            try:
                value += float(span.attrs.get("admission_window_s") or 0.0)
            except (TypeError, ValueError):
                pass
        if obj.kind == "span_ratio":
            bad = span.error is not None
        else:
            # a latency objective's budget-consuming event is a breach of
            # the threshold itself (`p99 < 100ms` allows 1% over 100ms)
            bad = obj.evaluate(value) is False
        self.observe(value, span.trace_id or None, bad)

    # -- evaluation ---------------------------------------------------------

    def _value(self, merged: Dict[str, Any]) -> Optional[float]:
        obj = self.objective
        if obj.kind == "latency":
            raw = merged.get("raw") or []
            total = sum(merged["counts"].values())
            if raw and len(raw) == total:
                # small complete window: answer exactly instead of off the
                # sketch (the sketch's bucket quantization dominates at
                # small sample counts — see RAW_SAMPLE_CAP)
                if obj.quantile is not None:
                    return _quantile_exact(raw, obj.quantile)
                return sum(raw) / len(raw)
            if obj.quantile is not None:
                return _quantile(merged["counts"], obj.quantile)
            return _mean(merged["counts"])
        total = merged["good"] + merged["bad"]
        if not total:
            return None
        return merged["good"] / total

    def _burn(self, merged: Dict[str, Any]) -> float:
        total = merged["good"] + merged["bad"]
        if total < MIN_WINDOW_EVENTS:
            return 0.0  # below the volume guard: no verdict, no page
        return (merged["bad"] / total) / self.objective.budget

    def evaluate(self) -> Dict[str, Any]:
        obj = self.objective
        fast = self.window.merged(fast=True)
        slow = self.window.merged(fast=False)
        value = self._value(fast)
        ok = obj.evaluate(value)
        burn_fast, burn_slow = self._burn(fast), self._burn(slow)
        burning = burn_fast >= 1.0 and burn_slow >= 1.0
        worst = None
        if fast["counts"]:
            top = max(b for b in fast["counts"] if fast["counts"][b])
            worst = {
                "trace_id": fast["exemplars"].get(top),
                "value_s": round(bucket_value(top), 6),
            }
        return {
            "expr": obj.expr,
            "kind": obj.kind,
            "threshold": obj.threshold,
            "value": value,
            "ok": ok,
            "burn_rate": {
                "fast": round(burn_fast, 4), "slow": round(burn_slow, 4),
            },
            "burning": burning,
            "events": {
                "fast": fast["good"] + fast["bad"],
                "slow": slow["good"] + slow["bad"],
            },
            "exemplars": {"worst": worst, "breach": fast["breach"]},
        }

    def publish(self) -> Dict[str, Any]:
        out = self.evaluate()
        if self._g_burning is not None:
            if out["ok"] is not None:
                if self._g_ok is None:
                    self._g_ok = self._m.SLO_OBJECTIVE_OK.labels(
                        objective=self.objective.name
                    )
                self._g_ok.set(1.0 if out["ok"] else 0.0)
            self._g_burning.set(1.0 if out["burning"] else 0.0)
            self._g_fast.set(out["burn_rate"]["fast"])
            self._g_slow.set(out["burn_rate"]["slow"])
        return out


class SloEngine:
    """The tracer finish-hook: streams watched spans into per-objective
    sliding windows. Register with ``tracer.add_hook`` (``obs.configure_slo``
    does this); feed non-span ratio events through :meth:`record_ratio`."""

    def __init__(
        self,
        objectives: Optional[Sequence[str]] = None,
        window_s: float = 300.0,
        slow_factor: int = SLOW_FACTOR,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError("SLO window must be positive seconds")
        self.window_s = float(window_s)
        self.slow_window_s = self.window_s * slow_factor
        self._clock = clock
        slice_s = self.window_s / FAST_SLICES
        total = FAST_SLICES * slow_factor
        self._states: Dict[str, _ObjectiveState] = {}
        self._by_span: Dict[str, List[_ObjectiveState]] = {}
        self._by_ratio: Dict[str, _ObjectiveState] = {}
        for obj in parse_objectives(list(objectives or DEFAULT_OBJECTIVES)):
            st = _ObjectiveState(
                obj, SlidingWindow(slice_s, FAST_SLICES, total, clock)
            )
            self._states[obj.name] = st
            if obj.kind == "ratio":
                self._by_ratio[obj.stat] = st
            else:
                self._by_span.setdefault(obj.span_name, []).append(st)

    @property
    def watched_spans(self) -> Tuple[str, ...]:
        return tuple(self._by_span)

    # -- intake -------------------------------------------------------------

    def __call__(self, span: Span) -> None:
        """Tracer finish-hook. Must stay fast and never raise (the tracer
        contains hook exceptions, but a slow hook taxes every span)."""
        states = self._by_span.get(span.name)
        if not states:
            return
        for st in states:
            st.observe_span(span)

    def record_ratio(
        self, key: str, good: bool, trace_id: Optional[str] = None
    ) -> None:
        """An explicit good/bad event for a ratio source (session_stats
        feeds ``session.catalog_hit_rate`` through this)."""
        st = self._by_ratio.get(key)
        if st is not None:
            st.observe(None, trace_id, not good)

    # -- readout ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/slo`` payload; also republishes every gauge so a
        scrape following a snapshot is never staler than the snapshot."""
        return {
            "window_s": self.window_s,
            "slow_window_s": self.slow_window_s,
            "objectives": {
                name: st.publish() for name, st in self._states.items()
            },
        }

    def histogram_snapshot(self) -> Dict[str, Any]:
        """The MERGEABLE form of the engine's state: per objective, the
        fast and slow windows as raw :class:`Histogram` snapshots (fixed
        bucket geometry) plus the expression to re-judge them with. This is
        what the telemetry flusher ships — the collector merges member
        windows bucket-by-bucket into fleet-wide quantiles and burn rates
        (obs/collector.py), which verdict-only snapshots cannot support."""
        out: Dict[str, Any] = {}
        for name, st in self._states.items():
            fast = st.window.merged(fast=True)
            slow = st.window.merged(fast=False)
            out[name] = {
                "expr": st.objective.expr,
                "kind": st.objective.kind,
                "fast": Histogram.from_window(fast).snapshot(),
                "slow": Histogram.from_window(slow).snapshot(),
                "breach": fast.get("breach"),
            }
        return {"window_s": self.window_s, "objectives": out}

    def burning_panel(self) -> Dict[str, Any]:
        """The flight-recorder state panel: which objectives were burning
        when the slow solve happened — compact, no exemplars (the record
        already IS the exemplar)."""
        out: Dict[str, Any] = {}
        for name, st in self._states.items():
            e = st.evaluate()
            out[name] = {
                "ok": e["ok"],
                "burning": e["burning"],
                "burn_fast": e["burn_rate"]["fast"],
                "burn_slow": e["burn_rate"]["slow"],
            }
        return out
