"""karpenter_tpu_torch.obs — the solve path's traces, SLOs and decisions.

The port's copy of ``karpenter_tpu/obs``'s facade, for the parts the port
has. Public surface:

- ``tracer()`` — the process-default :class:`Tracer` (ring exporter
  attached); ``with obs.tracer().span("name") as sp:`` is the ONE way to
  open a span. ``exporter()`` reads the ring back.
- ``set_enabled(bool)`` — the kill switch.
- ``configure_flight(dir, budget_s)`` — install the slow-solve flight
  recorder on the default tracer; ``flight_recorder()`` reads it back.
- ``register_state(name, fn)`` — contribute a state panel to future
  flight records.
- ``configure_slo(...)`` / ``slo_engine()`` / ``shutdown_slo()`` /
  ``slo_snapshot()`` — the online SLO engine (obs/slo.py).
- ``decision_log()`` / ``configure_decisions(...)`` — the decision audit
  log (obs/decisions.py).
- ``to_traceparent`` / ``from_traceparent`` — the cross-process id form
  (the v3 wire's trailer carries the same ids).
- ``debug_*_payload`` helpers — the ONE body function per ``/debug/*``
  endpoint of the sidecar's health server.

The JAX package's collector, profiler, sentinel, incidents and forecast
halves of this facade are not ported yet.

Spans are host-side machinery: nothing here may run between a kernel's
launch and its fetch in a way that waits on the card.
"""

from __future__ import annotations

import threading
from typing import Optional

from karpenter_tpu_torch.obs.decisions import DecisionLog  # noqa: F401
from karpenter_tpu_torch.obs.export import (  # noqa: F401
    RingExporter,
    critical_path,
    overlapping_pairs,
    spans_named,
)
from karpenter_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    register_state,
    state_snapshot,
    unregister_state,
)
from karpenter_tpu_torch.obs.slo import (  # noqa: F401
    DEFAULT_OBJECTIVES,
    SIDECAR_OBJECTIVES,
    Histogram,
    SloEngine,
    load_objectives,
)
from karpenter_tpu_torch.obs.trace import (  # noqa: F401
    TRACE_ANNOTATION,
    Span,
    SpanContext,
    Tracer,
    from_traceparent,
    to_traceparent,
)

_lock = threading.Lock()
_tracer = Tracer(exporter=RingExporter())
_flight: Optional[FlightRecorder] = None  # guarded-by: _lock


def tracer() -> Tracer:
    return _tracer


def exporter() -> RingExporter:
    return _tracer.exporter


def set_enabled(enabled: bool) -> None:
    _tracer.enabled = bool(enabled)


def enabled() -> bool:
    return _tracer.enabled


def configure_flight(
    directory: str,
    budget_s: Optional[float] = None,
    cap: Optional[int] = None,
    watch=None,
) -> FlightRecorder:
    """Install (or replace) the flight recorder on the default tracer."""
    global _flight
    kwargs = {}
    if budget_s is not None:
        kwargs["budget_s"] = budget_s
    if cap is not None:
        kwargs["cap"] = cap
    if watch is not None:
        kwargs["watch"] = watch
    rec = FlightRecorder(directory, **kwargs)
    with _lock:
        if _flight is not None:
            _tracer.remove_hook(_flight)
        _flight = rec
    _tracer.add_hook(rec)
    return rec


def flight_recorder() -> Optional[FlightRecorder]:
    with _lock:
        return _flight


_slo: Optional[SloEngine] = None  # guarded-by: _lock


def configure_slo(
    objectives=None,
    window_s: float = 300.0,
    clock=None,
    slow_factor: Optional[int] = None,
) -> SloEngine:
    """Install (or replace) the online SLO engine on the default tracer:
    a span finish-hook plus the ``slo`` flight-recorder state panel, so
    every slow-solve record snapshots which objectives were burning."""
    global _slo
    kwargs = {}
    if clock is not None:
        kwargs["clock"] = clock
    if slow_factor is not None:
        kwargs["slow_factor"] = slow_factor
    eng = SloEngine(objectives=objectives, window_s=window_s, **kwargs)
    with _lock:
        if _slo is not None:
            _tracer.remove_hook(_slo)
        _slo = eng
    _tracer.add_hook(eng)
    register_state("slo", eng.burning_panel)
    return eng


def slo_engine() -> Optional[SloEngine]:
    with _lock:
        return _slo


def shutdown_slo(engine: Optional[SloEngine] = None) -> None:
    """Detach the engine (hook + flight panel). Pass the engine you
    installed to make teardown ownership-checked: a stopped owner must not
    tear down an engine a LATER configure_slo installed. ``None`` detaches
    unconditionally (reset_for_tests)."""
    global _slo
    with _lock:
        if engine is not None and _slo is not engine:
            return  # someone else's engine is current — not ours to kill
        if _slo is not None:
            _tracer.remove_hook(_slo)
        _slo = None
    unregister_state("slo")


def slo_snapshot() -> dict:
    """The ``/debug/slo`` verdicts ({} while no engine is configured)."""
    eng = slo_engine()
    return eng.snapshot() if eng is not None else {}


# -- the decision audit log (obs/decisions.py) -------------------------------

# memory-only default: /debug/decisions and /debug/explain answer from the
# first round onward even when no directory is configured
_decisions = DecisionLog()  # guarded-by: _lock (replacement only)


def decision_log() -> DecisionLog:
    with _lock:
        return _decisions


def configure_decisions(
    directory: str = "",
    cap: Optional[int] = None,
    write_interval: Optional[float] = None,
) -> DecisionLog:
    """Install (or replace) the process decision log — an on-disk capped
    ring under ``directory`` ('' keeps memory-only), best-effort async
    writes, evictions counted, interval-thinned persistence."""
    global _decisions
    kwargs = {}
    if cap is not None:
        kwargs["cap"] = cap
    if write_interval is not None:
        kwargs["write_interval"] = write_interval
    log = DecisionLog(directory=directory, **kwargs)
    with _lock:
        old, _decisions = _decisions, log
    # stop the replaced log's writer thread (it drains, then exits)
    old.close()
    return log


# -- shared /debug payloads ---------------------------------------------------


def _query(query: str):
    from urllib.parse import parse_qs

    return parse_qs(query or "")


def _limit(q, default: int) -> int:
    try:
        return max(int(q["limit"][0]), 0)
    except (KeyError, ValueError, IndexError):
        return default


def debug_traces_payload(query: str = "") -> dict:
    """The ``GET /debug/traces`` body. ``?limit=`` bounds the tree count
    (default 50), ``?name=`` keeps only trees containing a span of that
    name, and ``?trace_id=`` is the exact lookup."""
    q = _query(query)
    name = (q.get("name") or [None])[0] or None
    trace_id = (q.get("trace_id") or [None])[0] or None
    exp = exporter()
    return {
        "traces": exp.snapshot(limit=_limit(q, 50), name=name, trace_id=trace_id),
        "stats": exp.stats(),
    }


def debug_slo_payload(query: str = "") -> dict:
    """``GET /debug/slo``: live verdicts plus the mergeable histogram form."""
    eng = slo_engine()
    return {
        "slo": eng.snapshot() if eng is not None else {},
        "histograms": eng.histogram_snapshot() if eng is not None else {},
    }


def debug_flight_payload(query: str = "") -> dict:
    """``GET /debug/flight``: recent slow-span incident records."""
    rec = flight_recorder()
    return {"records": rec.recent() if rec is not None else []}


def debug_decisions_payload(query: str = "") -> dict:
    """``GET /debug/decisions``: the newest decision records. ``?limit=``
    bounds the count (default 20), ``?provisioner=`` filters to one
    provisioner."""
    q = _query(query)
    provisioner = (q.get("provisioner") or [None])[0] or None
    return {
        "decisions": decision_log().recent(
            limit=_limit(q, 20), provisioner=provisioner
        )
    }


def debug_explain_payload(query: str = "") -> dict:
    """``GET /debug/explain?pod=<name>``: the newest decision's verdict
    for that pod, null when no recorded decision mentions it."""
    pod = (_query(query).get("pod") or [None])[0] or ""
    return {
        "pod": pod,
        "explain": decision_log().explain(pod) if pod else None,
    }


def reset_for_tests() -> None:
    """Drop collected traces and detach any flight recorder / SLO engine /
    decision log."""
    global _flight, _decisions
    with _lock:
        if _flight is not None:
            _tracer.remove_hook(_flight)
        _flight = None
        old_decisions, _decisions = _decisions, DecisionLog()
    old_decisions.close()
    shutdown_slo()
    from karpenter_tpu_torch.obs import decisions as _dec

    _dec.set_enabled(None)
    _tracer.exporter.clear()
    _tracer.enabled = True
