"""Causally-linked spans for the provisioning pipeline (Dapper-style).

One batch of pending pods crosses many layers — reconcile, batcher,
scheduler stages, the v3 solver wire, the sidecar's device work, cloud
create, bind — and the aggregate histograms can say THAT a p99 regressed
but never WHERE. A span is one timed region with a parent, so a whole
solve becomes a tree whose self-times attribute the latency leg by leg
(the port's copy of ``karpenter_tpu/obs/trace.py``: the same span model,
names and wire form).

Design constraints, in order:

- **Context-manager only.** ``with tracer.span("name") as sp`` is the sole
  sanctioned way to open a span; a bare ``start_span`` call outside this
  package is a bug. An un-closed span is a
  tree that never exports and a contextvar that never resets — the API
  shape makes that unrepresentable.
- **Monotonic clocks.** Durations come from ``time.perf_counter``; a wall
  timestamp is captured once per span for display only. NTP steps can
  never produce a negative stage.
- **Contextvar propagation.** The active span rides
  ``contextvars.ContextVar``, so nesting works across the reconcile call
  tree without threading a span argument through every signature. Threads
  do NOT inherit it (executor pools run launches) — pass ``parent=``
  explicitly there.
- **Cheap when off.** ``Tracer.span`` short-circuits to a shared no-op
  context manager when disabled; the hot path pays two attribute reads.
- **One clock with the device trace.** While a ``torch.profiler`` session
  records, every span also enters a ``torch.profiler.record_function``
  range of its name, so the spans land in the profiler's trace (and its
  chrome export) on the profiler's own clock, nested as the tree is. With
  no profiler recording a span pays one enabled-check for this.

Cross-process propagation uses W3C-traceparent-style ids
(``00-<32 hex trace>-<16 hex span>-01``): the HTTP cloud wire carries the
header, the v3 solver frames carry the same 24 bytes as an optional i32
trailer (solver/service.py), and Node objects carry it as an annotation so
the much-later ready transition still joins the launch trace.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

# is a torch.profiler session recording on this process? (a C call, about
# 0.1 us: the whole cost of the mirror while none is)
_profiler_recording = torch._C._autograd._profiler_enabled

TRACEPARENT_VERSION = "00"

# the annotation provisioning stamps on launched Nodes so the node-ready
# transition (minutes later, another reconcile) joins the launch trace
TRACE_ANNOTATION = "karpenter.sh/trace-context"


class SpanContext(NamedTuple):
    """The portable identity of a span: what crosses a process boundary."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars


# ids are random bits from this process's own generator, seeded from the
# OS (and again in a forked child), not an os.urandom read per span: on the
# host of an NVIDIA H100 machine that read cost 45-70 us a span inside a
# solve, against about 20 us for the rest of the span
_id_bits = random.Random()
os.register_at_fork(after_in_child=_id_bits.seed)


def _new_trace_id() -> str:
    return "%032x" % _id_bits.getrandbits(128)


def _new_span_id() -> str:
    return "%016x" % _id_bits.getrandbits(64)


class Span:
    """One timed region. Created only by :meth:`Tracer.span`'s context
    manager; ``end`` is written exactly once,
    at ``with``-exit."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "start", "end",
        "wall_start", "attrs", "children", "error", "parent",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        parent: Optional["Span"],
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.parent = parent
        self.start = time.perf_counter()
        self.end: Optional[float] = None
        self.wall_start = time.time()
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List["Span"] = []
        self.error: Optional[str] = None

    # -- while open ---------------------------------------------------------
    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_child_record(
        self,
        name: str,
        duration_s: float,
        attrs: Optional[Dict[str, Any]] = None,
        start: Optional[float] = None,
    ) -> "Span":
        """Attach an already-COMPLETED child (a remote peer's reported
        stage, the batcher's admission window): a record, not a live span —
        it never touches the contextvar, so the span-closed contract
        holds. ``start`` is a perf_counter timestamp; defaults to "ends
        now"."""
        child = Span(
            name, self.trace_id, _new_span_id(), self.span_id, self, attrs
        )
        now = time.perf_counter()
        child.start = now - duration_s if start is None else start
        child.end = child.start + duration_s
        child.wall_start = time.time() - duration_s if start is None else (
            self.wall_start + (child.start - self.start)
        )
        self.children.append(child)
        return child

    # -- introspection ------------------------------------------------------
    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return max(end - self.start, 0.0)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready tree. ``t0``/``t1`` are raw perf_counter stamps (for
        same-process overlap analysis — the pipelined overlap check);
        ``wall_start`` anchors the tree in calendar time for humans."""
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t0": self.start,
            "t1": self.end if self.end is not None else self.start,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "wall_start": self.wall_start,
            "attrs": self.attrs,
            "error": self.error,
            "children": [c.to_dict() for c in self.children],
        }

    def __repr__(self) -> str:  # debugging aid, never on a hot path
        return (
            f"Span({self.name!r} {self.trace_id[:8]}/{self.span_id} "
            f"{self.duration_s * 1e3:.2f}ms)"
        )


class _NoopSpan:
    """What disabled tracing hands out: absorbs the Span surface."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent = None
    attrs: Dict[str, Any] = {}

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_child_record(self, name, duration_s, attrs=None, start=None):
        return self

    @property
    def context(self) -> Optional[SpanContext]:
        return None

    @property
    def duration_s(self) -> float:
        return 0.0


_NOOP_SPAN = _NoopSpan()


class _NoopCm:
    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_CM = _NoopCm()

_UNSET = object()


class _SpanCm:
    """The context manager ``Tracer.span`` returns; all lifecycle writes
    (contextvar set/reset, parent attach, export) live in enter/exit so a
    span cannot leak half-open."""

    __slots__ = (
        "_tracer", "_name", "_attrs", "_parent", "_span", "_token",
        "_tid", "_prev_active", "_mirror",
    )

    def __init__(self, tracer: "Tracer", name: str, attrs, parent):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._parent = parent
        self._span: Optional[Span] = None
        self._token = None
        self._tid = 0
        self._prev_active: Optional[Span] = None
        self._mirror: Optional[record_function] = None

    def __enter__(self) -> Span:
        tracer = self._tracer
        parent = self._parent
        if parent is _UNSET:
            parent = tracer._current.get()
        if isinstance(parent, Span):
            span = Span(
                self._name, parent.trace_id, _new_span_id(), parent.span_id,
                parent, self._attrs,
            )
        elif isinstance(parent, SpanContext):
            # remote parent: a local ROOT carrying the caller's trace id —
            # exported as its own tree, joined to the caller's by the ids
            span = Span(
                self._name, parent.trace_id, _new_span_id(), parent.span_id,
                None, self._attrs,
            )
        else:
            span = Span(
                self._name, _new_trace_id(), _new_span_id(), None, None,
                self._attrs,
            )
        self._span = span
        self._token = tracer._current.set(span)
        # thread registry for out-of-context readers (the sampling
        # profiler attributes a sampled thread's stack to its ACTIVE span;
        # a contextvar is unreadable from another thread, this dict isn't).
        # Plain dict ops: atomic under the GIL, no lock on the hot path.
        self._tid = threading.get_ident()
        self._prev_active = tracer._active_by_thread.get(self._tid)
        tracer._active_by_thread[self._tid] = span
        if _profiler_recording():
            # the span's range in the profiler's trace (module docstring)
            self._mirror = record_function(self._name)
            self._mirror.__enter__()
        return span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self._span
        span.end = time.perf_counter()
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
        if exc is not None:
            span.error = f"{exc_type.__name__}: {exc}"
        self._tracer._current.reset(self._token)
        if self._prev_active is None:
            self._tracer._active_by_thread.pop(self._tid, None)
        else:
            self._tracer._active_by_thread[self._tid] = self._prev_active
        if span.parent is not None:
            # list.append is atomic under the GIL; launches from several
            # executor threads attach to one round span concurrently
            span.parent.children.append(span)
        self._tracer._finish(span)
        return False


class Tracer:
    def __init__(self, exporter=None, enabled: bool = True):
        self.exporter = exporter
        self.enabled = enabled
        self._current: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar("karpenter_active_span", default=None)
        )
        self._hooks: List[Callable[[Span], None]] = []  # guarded-by: self._hooks_lock
        self._hooks_lock = threading.Lock()
        # thread id -> innermost open span on that thread; written by
        # _SpanCm enter/exit (GIL-atomic dict ops), read by the sampling
        # profiler from ITS thread — the cross-thread twin of _current
        self._active_by_thread: Dict[int, Span] = {}

    # -- the one sanctioned way to open a span ------------------------------
    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None, parent=_UNSET):
        """``with tracer.span("solve.encode") as sp:`` — context-manager
        only. ``parent``: omitted = the active
        contextvar span; a :class:`Span` = explicit (executor threads); a
        :class:`SpanContext` = remote parent from the wire; ``None`` =
        force a fresh root."""
        if not self.enabled:
            return _NOOP_CM
        return _SpanCm(self, name, attrs, parent)

    def child_span(self, name: str, attrs: Optional[Dict[str, Any]] = None):
        """``span(name)`` under the calling context's active span, or a
        no-op when none is open: for a stage of a callee that also runs
        outside any trace (a kernel wrapper, a shadow probe's thread), so
        it never exports a root of its own."""
        parent = self.current()
        if parent is None:
            return _NOOP_CM
        return _SpanCm(self, name, attrs, parent)

    def start_span(self, name: str, attrs=None, parent=_UNSET) -> Span:
        """Low-level span construction WITHOUT lifecycle management — the
        context manager's internals, exposed for this package's own tests.
        Anywhere else a call to this name is a bug: a span opened here never resets the contextvar and never
        exports unless the caller reimplements ``_SpanCm`` exactly."""
        cm = _SpanCm(self, name, attrs, parent)
        return cm.__enter__()

    # -- ambient context ----------------------------------------------------
    def current(self) -> Optional[Span]:
        """The calling context's active span (None when outside any)."""
        return self._current.get() if self.enabled else None

    def active_spans(self) -> Dict[int, Span]:
        """Snapshot of thread id -> that thread's innermost OPEN span —
        the profiler's attribution surface. A copy: the registry mutates
        under the caller's feet otherwise."""
        return dict(self._active_by_thread)

    # -- completion fan-out -------------------------------------------------
    def add_hook(self, fn: Callable[[Span], None]) -> None:
        """``fn(span)`` runs on every span completion (the flight recorder
        rides this). Hooks must be fast and never raise — a raising hook
        is contained but logged at debug only."""
        with self._hooks_lock:
            self._hooks.append(fn)

    def remove_hook(self, fn: Callable[[Span], None]) -> None:
        with self._hooks_lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def _finish(self, span: Span) -> None:
        with self._hooks_lock:
            hooks = list(self._hooks)
        for fn in hooks:
            try:
                fn(span)
            except Exception:
                import logging

                logging.getLogger("karpenter.obs").debug(
                    "span hook failed", exc_info=True
                )
        if span.parent is None and self.exporter is not None:
            self.exporter.export(span)


# -- traceparent-style wire form ---------------------------------------------


def to_traceparent(span_or_ctx) -> str:
    """``00-<trace_id>-<span_id>-01`` for the HTTP header / annotation."""
    ctx = span_or_ctx.context if isinstance(span_or_ctx, Span) else span_or_ctx
    return f"{TRACEPARENT_VERSION}-{ctx.trace_id}-{ctx.span_id}-01"


def from_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent-style header; None on anything malformed — a
    corrupt header degrades to an unlinked trace, never an error."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())
