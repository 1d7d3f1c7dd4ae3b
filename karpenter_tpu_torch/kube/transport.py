"""Resilient kube transport: the one choke point every apiserver call takes.

Every subsystem shares exactly one dependency — the Kubernetes API server —
and before this module each ``ApiCluster`` write was a single-shot HTTP
request: no retry, no backoff, no 429 handling, no flow control, so a
10-second apiserver blip failed every bind, status patch, shard-lease
renewal, and journal write in flight. :class:`KubeTransport` funnels all of
``ApiCluster``'s traffic through per-verb-class policy (docs/partition.md):

- **read** (uncached GET/LIST) and **mutate** (PUT/PATCH/DELETE — all
  idempotent against apiserver optimistic concurrency): jittered retries on
  connection errors and 5xx, bounded by a hard per-operation deadline that
  the ambient reconcile-round :class:`~karpenter_tpu_torch.resilience.Budget`
  further caps.
- **create** (POST: create/bind/evict — NOT idempotent at the HTTP layer):
  never retried here. Creates keep riding their existing idempotency
  ladders (launch tokens, the 409-rebind check) one level up.
- **watch** (the informer re-list): no transport retry — the watch loop
  owns its own jittered exponential backoff, and stacking two retry layers
  would multiply load against a struggling apiserver.
- **events**: zero retries and a short deadline — an Event write must never
  hold a reconcile hostage; failures are counted
  (``karpenter_kube_events_dropped_total``) and dropped by the recorder.

A 429 anywhere is obeyed, not retried blindly: the server's ``Retry-After``
is slept (retryable classes) or surfaced as :class:`KubeThrottled` so the
caller's own requeue can honor it (eviction's rate-limited queue). 429s
count as breaker *successes* — a throttling apiserver is alive.

Client-side flow control is a QPS/burst token bucket
(``--kube-qps``/``--kube-burst``, client-go's limiter analog) with
mutations prioritized over reads: a reserve slice of the bucket is only
spendable by writes, so an informer re-list storm after a partition heals
cannot starve the binds that actually drain pending pods.

A :class:`~karpenter_tpu_torch.resilience.CircuitBreaker` (availability
semantics, shared across verb classes) records every attempt; while OPEN,
requests fail fast with :class:`ApiUnavailable` and ``ApiCluster`` flips
into degraded read-from-cache mode (``get_live`` serves the informer view).
The lease layer classifies these transport verdicts with
:func:`is_unreachable` — an unreachable apiserver is NOT a peer holding
the lease, and must fence rather than instantly resign (kube/leader.py).

Observability: ``karpenter_kube_request_duration_seconds{verb,kind,code}``
per attempt, retry/throttle counters, and one ``kube.request`` span per
logical call so the SLO engine can carry a ``kube.p99`` objective.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.resilience import CircuitBreaker
from karpenter_tpu_torch.resilience.policy import current_budget, decorrelated_jitter

logger = logging.getLogger("karpenter.kube.transport")

# verb classes (module constants so call sites read declaratively)
VERB_READ = "read"
VERB_MUTATE = "mutate"
VERB_CREATE = "create"
VERB_WATCH = "watch"
VERB_EVENTS = "events"
VERB_LEASE = "lease"

DEPENDENCY = "kube-apiserver"


class ApiUnavailable(Exception):
    """The apiserver is unreachable (breaker open, or the call was not
    even attempted). Callers with a cache may degrade to it; the lease
    layer reads this as UNREACHABLE, never as a lost lease."""


class KubeThrottled(Exception):
    """Flow control refused the call — either the apiserver answered 429
    (``retry_after`` carries its Retry-After hint) or the client-side
    limiter timed out. Callers honor the hint instead of a blind retry."""

    def __init__(self, message: str, retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


def is_unreachable(exc: BaseException) -> bool:
    """Is this failure an UNREACHABLE apiserver (as opposed to a positive
    answer like 404/409, or a programming error)? The lease layer's
    REJECTED/UNREACHABLE split hangs off this classification — a fenced
    replica and a genuinely outbid one behave very differently."""
    if isinstance(exc, (ApiUnavailable, KubeThrottled)):
        return True
    if isinstance(exc, (OSError, http.client.HTTPException, json.JSONDecodeError)):
        return True  # connection refused/reset, timeouts, torn responses
    status = getattr(exc, "status", None)
    if isinstance(status, int) and (status >= 500 or status == 429):
        return True  # ApiError: the server is present but failing
    return False


@dataclass(frozen=True)
class VerbPolicy:
    """Per-verb-class transport policy."""

    max_attempts: int
    deadline: float  # hard per-operation allowance (budget-capped further)
    limiter_wait: float  # longest the flow limiter may park this call
    priority: bool  # mutation-priority lane in the flow limiter
    count_drops: bool = False  # events: failures increment the drop counter
    # lease traffic IS the fencing signal: it must never be fast-failed by
    # a breaker that some OTHER traffic opened (a 1s blip would read as a
    # 5s outage to the lease layer — spurious fleet-wide fencing). Bypass
    # the breaker's allow() gate; outcomes are still recorded.
    bypass_breaker: bool = False


POLICIES = {
    VERB_READ: VerbPolicy(max_attempts=3, deadline=15.0, limiter_wait=5.0, priority=False),
    VERB_MUTATE: VerbPolicy(max_attempts=3, deadline=15.0, limiter_wait=5.0, priority=True),
    VERB_CREATE: VerbPolicy(max_attempts=1, deadline=15.0, limiter_wait=5.0, priority=True),
    VERB_WATCH: VerbPolicy(max_attempts=1, deadline=15.0, limiter_wait=5.0, priority=False),
    VERB_EVENTS: VerbPolicy(
        max_attempts=1, deadline=2.0, limiter_wait=0.2, priority=False, count_drops=True
    ),
    # single attempt (the renew loop is the retry), short deadline (a
    # renew slower than the renew cadence is useless), breaker-bypassed
    VERB_LEASE: VerbPolicy(
        max_attempts=1, deadline=5.0, limiter_wait=1.0, priority=True,
        bypass_breaker=True,
    ),
}

# connection/transport failures worth a retry (a 5xx status is handled by
# code, not exception type)
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException, json.JSONDecodeError)


class FlowLimiter:
    """QPS/burst token bucket with a mutation-priority reserve.

    The client-go limiter is one undifferentiated bucket; here the last
    ``reserve`` tokens are spendable only by priority (mutating) calls, so
    a read storm — the informer re-list wave after a partition heals is
    the canonical one — drains the bucket down to the reserve and no
    further, and binds/patches keep flowing at full rate."""

    def __init__(
        self,
        qps: float,
        burst: int,
        reserve_fraction: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.qps = max(float(qps), 0.001)
        self.burst = max(int(burst), 1)
        self.reserve = max(1.0, self.burst * reserve_fraction) if self.burst > 1 else 0.0
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._tokens = float(self.burst)  # guarded-by: self._lock
        self._last = clock()  # guarded-by: self._lock

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_take(self, priority: bool) -> bool:
        floor = 0.0 if priority else self.reserve
        with self._lock:
            self._refill_locked()
            if self._tokens - 1.0 >= floor:
                self._tokens -= 1.0
                return True
            return False

    def take(self, priority: bool, timeout: float) -> Tuple[bool, bool]:
        """Block (bounded) for a token. Returns ``(acquired, waited)`` —
        ``waited`` flags that flow control actually delayed the caller, so
        the transport can count client-side throttling."""
        if self.try_take(priority):
            return True, False
        deadline = self._clock() + max(timeout, 0.0)
        while True:
            if self.try_take(priority):
                return True, True
            remaining = deadline - self._clock()
            if remaining <= 0:
                return False, True
            self._sleep(min(max(1.0 / self.qps, 0.001), remaining, 0.05))


class KubeTransport:
    """The choke point: flow control → breaker → attempt loop with
    per-verb-class retry/backoff — see the module docstring."""

    def __init__(
        self,
        qps: float = 200.0,
        burst: int = 300,
        breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
    ):
        self.limiter = FlowLimiter(qps, burst, clock=clock, sleep=sleep)
        # availability semantics: trips on a windowed failure rate, so a
        # chaos-level error rate keeps flowing while a dead apiserver
        # opens within a handful of calls; 429s record as SUCCESS.
        self.breaker = breaker or CircuitBreaker(
            dependency=DEPENDENCY, open_seconds=5.0, clock=clock
        )
        self._clock = clock
        self._sleep = sleep
        self._backoff_base = backoff_base
        self._backoff_cap = backoff_cap

    def degraded(self) -> bool:
        """Is the transport currently refusing calls (breaker open, inside
        its cool-off)? Controllers use this to flip into read-from-cache
        mode instead of paying a fast-fail per read."""
        from karpenter_tpu_torch.resilience.breaker import OPEN

        return self.breaker.state == OPEN and not self.breaker.available()

    def _allowance(self, policy: VerbPolicy) -> float:
        budget = current_budget.get()
        if budget is None:
            return policy.deadline
        return min(policy.deadline, max(budget.remaining(), 0.0))

    def request(
        self,
        verb_class: str,
        method: str,
        kind: str,
        attempt: Callable[[], Tuple[int, dict, Optional[float]]],
    ) -> Tuple[int, dict, Optional[float]]:
        """Run one logical request through the policy ladder. ``attempt``
        performs one HTTP round trip and returns
        ``(status, body, retry_after_seconds_or_None)``; the transport
        decides retries. Returns the final attempt's triple — positive
        answers (2xx/404/409/...) go back to the caller for disposition."""
        from karpenter_tpu_torch import obs

        policy = POLICIES[verb_class]
        try:
            with obs.tracer().span(
                "kube.request",
                attrs={"verb": method, "kind": kind, "class": verb_class},
            ) as sp:
                status, doc, retry_after, attempts = self._request_inner(
                    policy, verb_class, method, kind
                )(attempt)
                sp.set_attribute("code", status)
                if attempts > 1:
                    sp.set_attribute("retries", attempts - 1)
                if policy.count_drops and status >= 500:
                    # a 5xx final answer is returned (the caller raises and
                    # the recorder swallows): that write IS a dropped event
                    # and must count like the exception-shaped drops do
                    metrics.KUBE_EVENTS_DROPPED.inc()
                return status, doc, retry_after
        except Exception:
            if policy.count_drops:
                metrics.KUBE_EVENTS_DROPPED.inc()
            raise

    def _request_inner(self, policy: VerbPolicy, verb_class: str, method: str, kind: str):
        def run(attempt):
            start = self._clock()
            allowance = self._allowance(policy)
            taken, waited = self.limiter.take(
                policy.priority, min(policy.limiter_wait, max(allowance, 0.0))
            )
            if waited:
                metrics.KUBE_THROTTLED.labels(source="client").inc()
            if not taken:
                raise KubeThrottled(
                    f"kube client flow control refused {method} {kind} "
                    f"(qps {self.limiter.qps:g}/burst {self.limiter.burst})",
                    retry_after=1.0 / self.limiter.qps,
                )
            backoffs = decorrelated_jitter(self._backoff_base, self._backoff_cap)
            attempts = 0
            while True:
                if not policy.bypass_breaker and not self.breaker.allow():
                    raise ApiUnavailable(
                        f"apiserver circuit open; {method} {kind} not attempted"
                    )
                attempts += 1
                t0 = self._clock()
                try:
                    status, doc, retry_after = attempt()
                except _TRANSPORT_ERRORS as e:
                    self.breaker.record_failure()
                    self._observe(method, kind, "error", t0)
                    pause = next(backoffs)
                    if (
                        attempts >= policy.max_attempts
                        or self._clock() - start + pause > allowance
                    ):
                        raise
                    metrics.KUBE_REQUEST_RETRIES.labels(verb_class=verb_class).inc()
                    logger.debug(
                        "kube %s %s transport error (%s); retry %d in %.2fs",
                        method, kind, e, attempts, pause,
                    )
                    self._sleep(pause)
                    continue
                self._observe(method, kind, str(status), t0)
                if status == 429:
                    # a throttling apiserver is ALIVE: breaker success, and
                    # the server's own hint paces the retry (or the caller)
                    self.breaker.record_success()
                    metrics.KUBE_THROTTLED.labels(source="server").inc()
                    hint = retry_after if retry_after is not None else next(backoffs)
                    if (
                        policy.max_attempts > 1
                        and attempts < policy.max_attempts
                        and self._clock() - start + hint <= allowance
                    ):
                        metrics.KUBE_REQUEST_RETRIES.labels(
                            verb_class=verb_class
                        ).inc()
                        self._sleep(hint)
                        continue
                    raise KubeThrottled(
                        f"apiserver throttled {method} {kind} "
                        f"(Retry-After {hint:.2f}s)",
                        retry_after=hint,
                    )
                if status >= 500:
                    self.breaker.record_failure()
                    pause = next(backoffs)
                    if (
                        policy.max_attempts > 1
                        and attempts < policy.max_attempts
                        and self._clock() - start + pause <= allowance
                    ):
                        metrics.KUBE_REQUEST_RETRIES.labels(
                            verb_class=verb_class
                        ).inc()
                        self._sleep(pause)
                        continue
                    return status, doc, retry_after, attempts
                # every sub-500 answer — success, 404, 409, 403 — is the
                # apiserver being alive and decisive
                self.breaker.record_success()
                return status, doc, retry_after, attempts

        return run

    def _observe(self, method: str, kind: str, code: str, t0: float) -> None:
        metrics.KUBE_REQUEST_DURATION.labels(
            verb=method, kind=kind or "unknown", code=code
        ).observe(max(self._clock() - t0, 0.0))
