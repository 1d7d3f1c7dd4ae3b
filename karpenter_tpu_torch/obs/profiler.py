"""Always-on sampling profiler: stdlib-only, span-attributed.

The span trees say which STAGE ate a slow solve's budget; nothing says
which PYTHON FRAMES did. This module closes that gap with the classic
low-overhead answer — a daemon thread wakes ``hz`` times a second, grabs
``sys._current_frames()``, and folds every other thread's stack into
collapsed-flamegraph counts (``a.py:f;b.py:g 12``). Because it samples
wall-clock state rather than instrumenting calls, the steady-state cost is
one frame walk per thread per tick: the acceptance bar holds it under
1% of headline throughput, self-accounted as
``karpenter_telemetry_profile_overhead_ratio`` so the claim is scrapeable,
not folklore.

Attribution: each sampled thread's stack is ALSO charged to that thread's
innermost open span via the tracer's thread registry
(:meth:`Tracer.active_spans` — a contextvar is unreadable from another
thread, the registry isn't), so ``/debug/profile`` can say "38% of samples
landed under ``solve.encode``" next to the frame-level folds.

Safety notes:

- ``sys._current_frames()`` returns real frame objects; walking
  ``f_back``/``f_code`` only READS them — the sampled thread keeps
  running, nothing is suspended.
- The sampler never takes locks the sampled code could hold: fold storage
  is guarded by its own lock, touched only by the sampler thread and
  readers.
- The default rate (19 Hz) is deliberately off-aligned from common 10/20/
  100 Hz periodic work so the sampler does not phase-lock with it and
  systematically over- or under-count.
- Fold storage is bounded (``max_folds``): a pathological stack churn
  degrades to an ``<other>`` bucket, never unbounded memory.

``GET /debug/profile`` on the sidecar's health server serves
:func:`karpenter_tpu_torch.obs.debug_profile_payload` (top-N self-time JSON, or
the raw collapsed corpus with ``?format=collapsed`` — feed it straight to
a flamegraph renderer). The in-window top folds additionally ride every
flight record via the registered ``profile`` state panel, so a slow-solve
incident file finally names the frames.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

DEFAULT_HZ = 19.0  # off-aligned: never phase-locks with 10/20/100Hz work
DEFAULT_WINDOW_S = 60.0  # the flight-panel "recent" window
MAX_STACK_DEPTH = 64
MAX_FOLDS = 4096  # past this, new stacks fold into "<other>"
OVERFLOW_KEY = "<other>"


def _frame_label(frame) -> str:
    """``path/tail.py:qualname`` — short enough to read, unique enough to
    grep. Two path components keep ``service.py`` in the controller apart
    from any other ``service.py``."""
    code = frame.f_code
    fname = code.co_filename.replace("\\", "/")
    parts = fname.rsplit("/", 2)
    tail = "/".join(parts[-2:]) if len(parts) > 1 else fname
    name = getattr(code, "co_qualname", None) or code.co_name
    return f"{tail}:{name}"


def fold_stack(frame, max_depth: int = MAX_STACK_DEPTH) -> str:
    """Collapse one thread's live stack, outermost frame first — the
    flamegraph 'collapsed' convention."""
    labels: List[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        labels.append(_frame_label(frame))
        frame = frame.f_back
        depth += 1
    labels.reverse()
    return ";".join(labels)


class SamplingProfiler:
    """The daemon sampler. ``obs.configure_profiler`` installs the
    process-wide one; tests drive :meth:`sample_once` directly with no
    thread at all."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        tracer=None,
        window_s: float = DEFAULT_WINDOW_S,
        max_depth: int = MAX_STACK_DEPTH,
        max_folds: int = MAX_FOLDS,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if hz <= 0:
            raise ValueError("profiler rate must be positive Hz")
        self.hz = float(hz)
        self.interval = 1.0 / self.hz
        self.window_s = float(window_s)
        self.max_depth = max_depth
        self.max_folds = max_folds
        self._tracer = tracer
        self._clock = clock
        self._lock = threading.Lock()
        # cumulative since start (the /debug/profile corpus)
        self._folds: Dict[str, int] = {}  # guarded-by: self._lock
        self._leaf: Dict[str, int] = {}  # guarded-by: self._lock
        self._span_samples: Dict[str, int] = {}  # guarded-by: self._lock
        # two half-window slices rotated in place: cur+prev always cover
        # the last [window_s/2, window_s] of samples — the flight panel's
        # "what was hot JUST NOW", without a deque of per-tick dicts
        self._win_cur: Dict[str, int] = {}  # guarded-by: self._lock
        self._win_prev: Dict[str, int] = {}  # guarded-by: self._lock
        self._win_rotated_at = self._clock()  # guarded-by: self._lock
        self.samples = 0  # guarded-by: self._lock
        self.ticks = 0  # guarded-by: self._lock
        self._busy_s = 0.0  # guarded-by: self._lock
        # per-thread fold memo keyed by FRAME IDENTITY: a frame's ancestor
        # chain is fixed for its lifetime, so an unchanged current frame
        # means an unchanged fold — parked threads (most of a controller's
        # worker pool, blocked in wait()) cost one dict probe per tick
        # instead of a stack walk + string build. Entries pin their frame
        # (one stack per live thread, replaced the tick the thread moves)
        # and are pruned to the currently-live thread set every sweep.
        # Only the sampler thread touches it.
        self._fold_memo: Dict[int, tuple] = {}
        self._started_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._started_at = self._clock()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _loop(self) -> None:
        # drift-free schedule: aim at absolute deadlines; if a tick falls
        # behind (GIL starvation under load), skip the lost ticks rather
        # than bursting to catch up — a burst IS overhead
        next_t = self._clock() + self.interval
        while not self._stop.wait(max(next_t - self._clock(), 0.0)):
            t0 = self._clock()
            try:
                self.sample_once()
            except Exception:
                pass  # a torn frame walk must never kill the sampler
            busy = self._clock() - t0
            with self._lock:
                self._busy_s += busy
            next_t += self.interval
            now = self._clock()
            if next_t < now:
                next_t = now + self.interval

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> int:
        """One sweep over every other thread's live stack; returns the
        number of threads sampled. Public so tests drive it deterministically
        without the daemon thread."""
        frames = sys._current_frames()
        own = threading.get_ident()
        active = self._tracer.active_spans() if self._tracer is not None else {}
        sampled = 0
        folds: List[str] = []
        span_names: List[str] = []
        leaves: List[str] = []
        for tid, frame in frames.items():
            if tid == own:
                continue
            memo = self._fold_memo.get(tid)
            if memo is not None and memo[0] is frame:
                stack, leaf = memo[1], memo[2]
            else:
                stack = fold_stack(frame, self.max_depth)
                leaf = _frame_label(frame)
                self._fold_memo[tid] = (frame, stack, leaf)
            folds.append(stack)
            leaves.append(leaf)
            span = active.get(tid)
            if span is not None and getattr(span, "name", None):
                span_names.append(span.name)
            sampled += 1
        for tid in list(self._fold_memo):
            if tid not in frames:
                del self._fold_memo[tid]  # dead thread: drop its pinned stack
        now = self._clock()
        with self._lock:
            if now - self._win_rotated_at > self.window_s / 2:
                self._win_prev = self._win_cur
                self._win_cur = {}
                self._win_rotated_at = now
            for stack in folds:
                self._bump_locked(self._folds, stack)
                self._bump_locked(self._win_cur, stack)
            for leaf in leaves:
                self._bump_locked(self._leaf, leaf)
            for name in span_names:
                self._span_samples[name] = self._span_samples.get(name, 0) + 1
            self.samples += sampled
            self.ticks += 1
        try:
            from karpenter_tpu_torch import metrics

            metrics.TELEMETRY_PROFILE_SAMPLES.inc(sampled)
            metrics.TELEMETRY_PROFILE_OVERHEAD.set(self.overhead_ratio())
        except Exception:
            pass  # trimmed registries
        return sampled

    def _bump_locked(self, d: Dict[str, int], key: str) -> None:
        if key not in d and len(d) >= self.max_folds:
            key = OVERFLOW_KEY
        d[key] = d.get(key, 0) + 1

    # -- readout ------------------------------------------------------------

    def overhead_ratio(self) -> float:
        """Sampler busy-time over wall-time since start — the self-accounted
        cost the <1% bar judges (0.0 before the first tick)."""
        if self._started_at is None:
            return 0.0
        elapsed = self._clock() - self._started_at
        if elapsed <= 0:
            return 0.0
        with self._lock:
            busy = self._busy_s
        return busy / elapsed

    def collapsed(self) -> str:
        """The cumulative corpus in collapsed-flamegraph format, one
        ``stack count`` line per distinct stack."""
        with self._lock:
            items = sorted(self._folds.items())
        return "".join(f"{stack} {n}\n" for stack, n in items)

    def top(self, n: int = 20) -> List[Dict[str, Any]]:
        """Top-N frames by SELF time (leaf-sample counts): where the
        interpreter actually was, not which caller contains it."""
        with self._lock:
            total = max(self.samples, 1)
            items = sorted(self._leaf.items(), key=lambda kv: -kv[1])[:n]
        return [
            {
                "frame": frame,
                "self_samples": count,
                "self_pct": round(count / total * 100, 2),
            }
            for frame, count in items
        ]

    def snapshot(self, top_n: int = 20) -> Dict[str, Any]:
        """The JSON /debug/profile body + what the telemetry flusher ships."""
        with self._lock:
            samples, ticks = self.samples, self.ticks
            spans = dict(self._span_samples)
        return {
            "hz": self.hz,
            "samples": samples,
            "ticks": ticks,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "top": self.top(top_n),
            "span_samples": spans,
        }

    def flight_panel(self) -> Dict[str, Any]:
        """The registered flight-recorder panel: the RECENT window's top
        folds, so a slow-solve incident names the frames hot at the time,
        not the frames hot since boot."""
        with self._lock:
            merged: Dict[str, int] = dict(self._win_prev)
            for stack, n in self._win_cur.items():
                merged[stack] = merged.get(stack, 0) + n
        top = sorted(merged.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": self.window_s,
            "window_samples": sum(merged.values()),
            "top_folds": [{"stack": s, "samples": n} for s, n in top],
        }
