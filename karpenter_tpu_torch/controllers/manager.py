"""Controller manager: the watch→queue→reconcile runtime.

Mirrors ``pkg/controllers/manager.go`` + controller-runtime: each registered
controller gets a rate-limited dedup workqueue and N worker threads; watches
feed the queues via ``enqueue``; reconcilers return an optional
requeue-after (seconds) and raise to trigger exponential-backoff retry.
Healthz/readyz are simple liveness flags (reference: manager.go:48-61).

Leader election (reference: cmd/controller/main.go:84-85) degenerates to a
process-local lock here: the in-memory cluster has exactly one writer
process; a multi-process deployment backs ``Cluster`` with a real apiserver
and brings its own lease, so the manager exposes the same hook.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.kube.client import Cluster, Conflict
from karpenter_tpu_torch.utils.workqueue import RateLimitingQueue, ShutDown

logger = logging.getLogger("karpenter.manager")

# Reference concurrency defaults: selection 10,000; everything else 10
# (selection/controller.go:183, provisioning/controller.go:152). Thread-based
# workers cap lower; the queues dedup so throughput is equivalent.
DEFAULT_CONCURRENCY = 10


class _Registration:
    def __init__(self, name: str, reconcile: Callable, concurrency: int):
        self.name = name
        self.reconcile = reconcile
        self.concurrency = concurrency
        self.queue = RateLimitingQueue()
        self.threads: List[threading.Thread] = []
        self.conflicts: Dict = {}  # key -> consecutive Conflict count


class Manager:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._controllers: Dict[str, _Registration] = {}
        self._started = False
        self._healthy = threading.Event()

    # -- registration ------------------------------------------------------
    def register(
        self,
        name: str,
        reconcile: Callable[..., Optional[float]],
        concurrency: int = DEFAULT_CONCURRENCY,
    ) -> None:
        """Register a reconciler. ``reconcile(key)`` may return seconds to
        requeue after, or raise to retry with backoff."""
        if name in self._controllers:
            raise ValueError(f"controller {name} already registered")
        self._controllers[name] = _Registration(name, reconcile, concurrency)

    def enqueue(self, controller: str, key) -> None:
        reg = self._controllers.get(controller)
        if reg is not None:
            reg.queue.add(key)

    def enqueue_after(self, controller: str, key, delay: float) -> None:
        reg = self._controllers.get(controller)
        if reg is not None:
            reg.queue.add_after(key, delay)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for reg in self._controllers.values():
            # a stopped manager's queues are shut down permanently; restart
            # gets fresh queues so workers don't exit on arrival
            if reg.queue.is_shut_down():
                reg.queue = RateLimitingQueue(backoff=reg.queue.backoff)
            reg.threads = [t for t in reg.threads if t.is_alive()]
            for i in range(reg.concurrency):
                # workers pin the queue instance they were started with: a
                # stop()/start() swap must not let an old worker touch the
                # replacement queue (it would break the dedup invariant)
                t = threading.Thread(
                    target=self._worker, args=(reg, reg.queue), daemon=True,
                    name=f"{reg.name}-{i}",
                )
                reg.threads.append(t)
                t.start()
        self._healthy.set()

    def stop(self) -> None:
        self._healthy.clear()
        for reg in self._controllers.values():
            reg.queue.shut_down()
        for reg in self._controllers.values():
            for t in reg.threads:
                t.join(timeout=2)
        self._started = False

    def healthz(self) -> bool:
        return self._healthy.is_set()

    readyz = healthz

    # -- worker loop -------------------------------------------------------
    CONFLICT_REQUEUE = 0.2  # optimistic-concurrency retry, not backoff
    CONFLICT_RETRY_CAP = 5  # then it's a real problem: back off + log

    def _worker(self, reg: _Registration, queue) -> None:
        while True:
            try:
                key = queue.get()
            except ShutDown:
                return
            try:
                requeue_after = self._call(reg, key)
            except Conflict:
                # a stale-resourceVersion write is the normal outcome of
                # optimistic concurrency against an apiserver: requeue
                # promptly (the next reconcile reads the fresher cache).
                # Bounded — a key that conflicts every time (broken watch,
                # fighting writers) must surface and back off, not hot-loop.
                count = reg.conflicts.get(key, 0) + 1
                reg.conflicts[key] = count
                queue.done(key)
                if count >= self.CONFLICT_RETRY_CAP:
                    logger.warning(
                        "%s: reconcile %r conflicted %d times; backing off",
                        reg.name, key, count,
                    )
                    queue.add_rate_limited(key)
                else:
                    logger.debug("%s: reconcile %r conflicted; requeueing", reg.name, key)
                    queue.add_after(key, self.CONFLICT_REQUEUE)
                continue
            except Exception:
                logger.exception("%s: reconcile %r failed", reg.name, key)
                queue.done(key)
                queue.add_rate_limited(key)
                continue
            reg.conflicts.pop(key, None)
            queue.forget(key)
            queue.done(key)
            if requeue_after is not None:
                queue.add_after(key, requeue_after)

    @staticmethod
    def _call(reg: _Registration, key) -> Optional[float]:
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller

        token = reconciling_controller.set(reg.name)
        try:
            if isinstance(key, tuple):
                return reg.reconcile(*key)
            return reg.reconcile(key)
        finally:
            reconciling_controller.reset(token)

    # -- synchronous drive (test harness) ----------------------------------
    def reconcile_now(self, controller: str, key) -> Optional[float]:
        """Run one reconcile inline — the ExpectReconcileSucceeded analog
        (reference: pkg/test/expectations/expectations.go:199-203)."""
        reg = self._controllers[controller]
        return self._call(reg, key)
