"""Windowed batcher (reference: pkg/controllers/provisioning/batcher.go).

Separates a stream of ``add(item)`` calls into windowed slices: the window
starts on the first item, closes after 1s idle or 10s max or 2,000 items.
Callers block on a gate that flushes when their batch has been processed.

Overload posture (docs/overload.md): the queue is BOUNDED. Past
``max_depth`` the batcher decides what to drop instead of growing without
limit — a full-queue add sheds the oldest entry of the lowest priority
class present (``karpenter_batcher_shed_total{reason="queue_full"}`` + the
``on_shed`` hook, which provisioning turns into a Warning event). The
brownout ladder additionally drives two knobs: ``set_pressure`` scales the
admission window down so saturated rounds stay small and frequent, and
``shed_low_priority`` drains queued below-floor work outright
(``reason="brownout"``).
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Callable, Deque, List, Optional, Tuple

MAX_BATCH_DURATION = 10.0
BATCH_IDLE_DURATION = 1.0
MAX_ITEMS_PER_BATCH = 2000
# queue bound: 5x the largest batch — deep enough that a burst spanning a
# few windows never sheds, shallow enough that a sustained overload sheds
# instead of hoarding hours of stale work (the queue IS the latency)
MAX_QUEUE_DEPTH = 10_000

# bounded-wait slice for the first-item park: stop() notifies the
# condition, the timeout only bounds a missed wakeup
_PARK_SLICE_S = 0.5


class Batcher:
    def __init__(
        self,
        max_duration: float = MAX_BATCH_DURATION,
        idle_duration: float = BATCH_IDLE_DURATION,
        max_items: int = MAX_ITEMS_PER_BATCH,
        max_depth: int = MAX_QUEUE_DEPTH,
        priority_fn: Optional[Callable[[object], int]] = None,
        on_shed: Optional[Callable[[object, str], None]] = None,
    ):
        self.max_duration = max_duration
        self.idle_duration = idle_duration
        self.max_items = max_items
        self.max_depth = max(int(max_depth), 1)
        # item -> priority class (higher = more important); the default
        # treats everything equally, so queue_full sheds pure-oldest
        self._priority = priority_fn or (lambda item: 0)
        # fire-and-forget shed notification (item, reason) — runs OFF the
        # queue lock; a raising hook loses its event, never the batch
        self._on_shed = on_shed
        self._cv = threading.Condition()
        # (priority, item) pairs — the class is computed ONCE at enqueue
        # (pod priority is immutable while queued), so a full-queue shed
        # never re-runs priority_fn over the whole queue under the lock
        self._items: Deque = deque()  # guarded-by: self._cv
        self._pri_counts: Counter = Counter()  # guarded-by: self._cv
        self._pressure = 1.0  # guarded-by: self._cv
        self.max_depth_seen = 0  # guarded-by: self._cv
        self.shed_total = 0  # guarded-by: self._cv
        self._gate = threading.Event()  # guarded-by: self._gate_lock
        self._gate_lock = threading.Lock()
        self._stopped = False  # guarded-by: self._gate_lock

    # -- admission -----------------------------------------------------------

    def add(self, item) -> threading.Event:
        """Enqueue an item; returns the gate event the caller may wait on —
        it is set when the batch containing the item has been processed
        (reference: batcher.go:61-69). After stop() the returned gate is
        pre-set: no flush will ever run again, and a caller handed the
        live gate would park on it for its full wait timeout.

        A full queue sheds rather than grows: the oldest entry of the
        lowest priority class present is dropped (the incoming item itself
        when it is strictly the least important) — under overload the
        queue keeps the newest, most important work."""
        shed = None
        with self._gate_lock:
            if self._stopped:
                done = threading.Event()
                done.set()
                return done
        pri = self._safe_priority(item)
        with self._cv:
            enqueue = True
            if len(self._items) >= self.max_depth:
                shed, enqueue = self._pick_shed_locked(pri, item)
                self.shed_total += 1
            if enqueue:
                self._items.append((pri, item))
                self._pri_counts[pri] += 1
            self.max_depth_seen = max(self.max_depth_seen, len(self._items))
            self._cv.notify()
        if shed is not None:
            self._notify_shed(shed, "queue_full")
        with self._gate_lock:
            if self._stopped:
                done = threading.Event()
                done.set()
                return done
            return self._gate
    # NOTE on the shed gate: the displaced item's caller still holds the
    # live gate; provision_once flushes it every round, so nobody parks
    # forever on shed work — the on_shed hook is where pending-state
    # cleanup and the Warning event happen.

    def _safe_priority(self, item) -> int:
        try:
            return int(self._priority(item))
        except Exception:
            return 0

    def _pick_shed_locked(self, incoming_pri: int, incoming) -> Tuple[object, bool]:
        """Full queue: choose the victim. Returns (victim, enqueue_incoming).
        The victim is the OLDEST entry among the lowest priority class in
        (queue + incoming); ties between a queued item and the incoming one
        shed the queued item (it is older). The class census makes the
        lowest-class lookup O(#classes); the scan for its oldest member
        stops at the first hit — under a homogeneous overload (the common
        storm) that is the queue head."""
        lowest_queued = min(self._pri_counts) if self._pri_counts else None
        if lowest_queued is None or incoming_pri < lowest_queued:
            # the incoming item is strictly the least important thing here
            return incoming, False
        for i, (pri, queued) in enumerate(self._items):
            if pri == lowest_queued:
                del self._items[i]
                self._decr_pri_locked(pri)
                return queued, True
        # unreachable: the census said the class has members
        return incoming, False

    def _decr_pri_locked(self, pri: int) -> None:
        self._pri_counts[pri] -= 1
        if self._pri_counts[pri] <= 0:
            del self._pri_counts[pri]

    def _notify_shed(self, item, reason: str) -> None:
        from karpenter_tpu_torch import metrics

        try:
            metrics.BATCHER_SHED.labels(reason=reason).inc()
        except Exception:
            pass  # trimmed registries (sidecar test rigs)
        if self._on_shed is not None:
            try:
                self._on_shed(item, reason)
            except Exception:
                pass  # a raising hook must never fail the add

    # -- brownout knobs ------------------------------------------------------

    def set_pressure(self, scale: float) -> None:
        """Scale the admission window: ``scale`` < 1 shrinks the idle/max
        durations and the per-batch item cap, so an overloaded system runs
        small frequent rounds instead of giant stale ones. 1.0 restores
        the configured window (the brownout controller re-applies the
        current level every tick, so new batchers converge within one)."""
        with self._cv:
            self._pressure = min(max(float(scale), 0.01), 1.0)

    def pressure(self) -> float:
        with self._cv:
            return self._pressure

    def shed_low_priority(self, floor: int) -> int:
        """Drain queued items whose priority class is below ``floor``
        (oldest first, by construction of the queue). The brownout
        ladder's shed rung; returns how many were dropped."""
        with self._cv:
            keep: Deque = deque()
            shed: List = []
            for pri, item in self._items:
                if pri < floor:
                    shed.append(item)
                    self._decr_pri_locked(pri)
                else:
                    keep.append((pri, item))
            self._items = keep
            self.shed_total += len(shed)
        for item in shed:
            self._notify_shed(item, "brownout")
        return len(shed)

    def _popleft_locked(self):
        pri, item = self._items.popleft()
        self._decr_pri_locked(pri)
        return item

    def depth(self) -> int:
        with self._cv:
            return len(self._items)

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        """Release all waiters and open a new gate
        (reference: batcher.go:72-77)."""
        with self._gate_lock:
            old = self._gate
            self._gate = threading.Event()
        old.set()

    def stop(self) -> None:
        # under the gate lock, paired with add()'s check: once _stopped is
        # visible, add() hands out pre-set gates, and the flush() below
        # releases everyone already parked on the live gate — no waiter is
        # ever left on a gate that no flush will set again
        with self._gate_lock:
            self._stopped = True
        with self._cv:
            self._cv.notify_all()  # wake the wait() parked on the queue
        self.flush()

    def wait(self) -> Tuple[List, float]:
        """Block for the first item, then collect until idle/max-duration/
        max-items; returns (items, window) (reference: batcher.go:80-103).
        All parks are bounded (stop() notifies; the slice only covers a
        missed wakeup), and the window dimensions are scaled by the
        current brownout pressure."""
        items: List = []
        with self._cv:
            while not self._items:
                if self._stopped:
                    return [], 0.0
                self._cv.wait(_PARK_SLICE_S)
            if self._stopped:
                return [], 0.0
            scale = self._pressure
            items.append(self._popleft_locked())
            start = time.monotonic()
            idle = max(self.idle_duration * scale, 0.001)
            deadline = start + max(self.max_duration * scale, 0.001)
            cap = max(int(self.max_items * scale), 1)
            idle_deadline = time.monotonic() + idle
            while len(items) < cap and not self._stopped:
                if self._items:
                    items.append(self._popleft_locked())
                    idle_deadline = time.monotonic() + idle
                    continue
                timeout = min(idle_deadline, deadline) - time.monotonic()
                if timeout <= 0:
                    break
                self._cv.wait(timeout)
            return items, time.monotonic() - start
