"""Rate-limited, deduplicating work queues.

The controller-runtime/client-go workqueue analog (reference: the reconciler
plumbing in ``pkg/controllers/manager.go`` and the rate limiters in
``termination/controller.go:104-113`` and ``utils/parallel/workqueue.go``):

- ``RateLimitingQueue``: dedups keys while queued, supports delayed adds, and
  applies per-item exponential backoff on ``add_rate_limited``.
- ``TokenBucket``: QPS/burst limiter (client-side flow control, e.g. the kube
  client's 200 QPS/300 burst or CreateFleet's 2 QPS/100 burst).
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


class TokenBucket:
    """QPS/burst token bucket; ``take`` blocks until a token is available."""

    def __init__(self, qps: float, burst: int, clock: Optional[Callable[[], float]] = None):
        self.qps = qps
        self.burst = burst
        self.clock = clock or time.monotonic
        self._tokens = float(burst)  # guarded-by: self._lock
        self._last = self.clock()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self.clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_take(self) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1:
                self._tokens -= 1
                return True
            return False

    def wait_time(self) -> float:
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1:
                return 0.0
            return (1 - self._tokens) / self.qps

    def take(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            if self.try_take():
                return True
            wait = self.wait_time()
            if deadline is not None:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    return False
                wait = min(wait, remaining)
            time.sleep(max(wait, 0.001))


class ExponentialBackoff:
    """Per-item exponential failure backoff (client-go's
    ItemExponentialFailureRateLimiter analog)."""

    def __init__(self, base: float = 0.005, cap: float = 1000.0):
        self.base = base
        self.cap = cap
        self._failures: Dict[Any, int] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()

    def when(self, item) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        return min(self.base * (2**n), self.cap)

    def forget(self, item) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def retries(self, item) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class ShutDown(Exception):
    pass


class RateLimitingQueue:
    """Dedup queue with delayed adds and exponential retry backoff.

    Semantics match client-go: an item present in the queue is not added
    again; an item being processed and re-added is requeued after processing
    finishes (``done`` re-adds it).
    """

    def __init__(self, backoff: Optional[ExponentialBackoff] = None):
        self.backoff = backoff or ExponentialBackoff()
        self._lock = threading.Condition()
        self._queue: deque = deque()  # guarded-by: self._lock
        self._queued: Set[Any] = set()  # guarded-by: self._lock
        self._processing: Set[Any] = set()  # guarded-by: self._lock
        self._dirty: Set[Any] = set()  # re-added while processing; guarded-by: self._lock
        self._delayed: List[Tuple[float, int, Any]] = []  # (ready_at, seq, item) heap; guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        self._shutdown = False  # guarded-by: self._lock

    def add(self, item) -> None:
        with self._lock:
            if self._shutdown or item in self._queued:
                return
            if item in self._processing:
                self._dirty.add(item)
                return
            self._queued.add(item)
            self._queue.append(item)
            self._lock.notify()

    def add_after(self, item, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._lock:
            self._seq += 1
            heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, item))
            self._lock.notify()

    def add_rate_limited(self, item) -> None:
        self.add_after(item, self.backoff.when(item))

    def forget(self, item) -> None:
        self.backoff.forget(item)

    def _pump_delayed_locked(self) -> Optional[float]:
        """Move ready delayed items into the queue; returns seconds until the
        next delayed item (None if no delayed items)."""
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item not in self._queued and item not in self._processing:
                self._queued.add(item)
                self._queue.append(item)
            elif item in self._processing:
                self._dirty.add(item)
        if self._delayed:
            return max(self._delayed[0][0] - now, 0.001)
        return None

    def get(self, timeout: Optional[float] = None):
        """Block for the next item; raises ShutDown when stopped and drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                next_delay = self._pump_delayed_locked()
                if self._queue:
                    item = self._queue.popleft()
                    self._queued.discard(item)
                    self._processing.add(item)
                    return item
                if self._shutdown:
                    raise ShutDown()
                wait = next_delay
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._lock.wait(wait)

    def done(self, item) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._queued:
                    self._queued.add(item)
                    self._queue.append(item)
                    self._lock.notify()

    def shut_down(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def is_shut_down(self) -> bool:
        with self._lock:
            return self._shutdown

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)
