"""Latency + resilience decorator for cloud providers.

Mirrors ``pkg/cloudprovider/metrics/cloudprovider.go:37-93``: every
``CloudProvider`` method is wrapped in a duration histogram labeled
{controller, method, provider}. The controller label comes from a
contextvar the manager sets around each reconcile — the analog of the
reference's context injection (``utils/injection/injection.go:72-84``).

On top of the histograms, the decorator is where the resilience layer
(``karpenter_tpu_torch.resilience``) meets the cloud: each control-plane
method gets

- a :class:`~karpenter_tpu_torch.resilience.CircuitBreaker` per
  (provider, method) — a dead control plane costs one windowed burst of
  failures, then callers fail fast (``BreakerOpen``) until a half-open
  probe finds it healthy again;
- a :class:`~karpenter_tpu_torch.resilience.RetryPolicy` with decorrelated
  jitter and a hard per-operation deadline, capped by the active
  reconcile-round :class:`~karpenter_tpu_torch.resilience.Budget`. Capacity
  signals (``InsufficientCapacityError``/stockouts) and validation errors
  are never retried.

``create`` is retried only for delegates whose own ``create`` carries the
``@idempotent`` marker, i.e. replays a committed launch token instead of
launching twice; a token-unaware delegate keeps the breaker-only, no-retry
contract. Every request is stamped with a client launch token before it
reaches the delegate (the provisioning worker stamps its own first; this
decorator backstops direct callers), so a retry that lands after a
partially-completed launch re-finds the SAME instance rather than
orphaning one no Node tracks. The read-path methods and the idempotent
delete retry freely.
"""

from __future__ import annotations

import contextvars
import time
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, InstanceType, NodeRequest
from karpenter_tpu_torch.resilience import BreakerBoard, BreakerOpen, RetryPolicy
from karpenter_tpu_torch.resilience.markers import idempotent, is_idempotent

# Which controller's reconcile (or worker loop) is currently executing.
reconciling_controller: contextvars.ContextVar[str] = contextvars.ContextVar(
    "reconciling_controller", default=""
)

# breaker defaults: a 10%-error chaos regime must NOT trip (windowed rate
# well under 0.5); a dead dependency trips within min_volume calls
BREAKER_WINDOW = 20
BREAKER_MIN_VOLUME = 5
BREAKER_FAILURE_RATE = 0.5
BREAKER_OPEN_SECONDS = 10.0


class MeteredCloudProvider(CloudProvider):
    """Wraps a provider so Create/Delete/GetInstanceTypes are all observed
    (reference: metrics/cloudprovider.go:66-93) and all pass through the
    per-method breaker + retry policy."""

    def __init__(self, delegate: CloudProvider, resilience: bool = True):
        self.delegate = delegate
        self.resilient = resilience
        self.breakers = BreakerBoard(
            window=BREAKER_WINDOW,
            min_volume=BREAKER_MIN_VOLUME,
            failure_rate=BREAKER_FAILURE_RATE,
            open_seconds=BREAKER_OPEN_SECONDS,
        )
        name = delegate.name()
        self._policies: Dict[str, RetryPolicy] = {
            # create retries are safe ONLY against a delegate that replays
            # launch tokens — its own @idempotent marker is the opt-in. A
            # provider that never reads request.launch_token stays at the
            # breaker-only contract: a retried create there would land a
            # second instance no Node tracks.
            "create": RetryPolicy(
                max_attempts=3 if is_idempotent(delegate.create) else 1,
                deadline=20.0, dependency=f"{name}:create",
            ),
            "delete": RetryPolicy(max_attempts=3, deadline=15.0,
                                  dependency=f"{name}:delete"),
            "get_instance_types": RetryPolicy(max_attempts=3, deadline=15.0,
                                              dependency=f"{name}:get_instance_types"),
            "poll_disruptions": RetryPolicy(max_attempts=2, deadline=5.0,
                                            dependency=f"{name}:poll_disruptions"),
        }

    def _observe(self, method: str, start: float) -> None:
        metrics.CLOUDPROVIDER_DURATION.labels(
            controller=reconciling_controller.get(),
            method=method,
            provider=self.delegate.name(),
        ).observe(time.perf_counter() - start)

    def _guarded(self, method: str, fn, *args):
        """breaker(retry(fn)): the retry absorbs transient flakes inside ONE
        logical call; the breaker sees the logical outcome, so a dependency
        that only ever succeeds via retries still counts as healthy.

        Every call runs under a ``cloud.<method>`` span. A breaker-open
        fast-fail never reaches the control plane, so it VANISHES from the
        duration histogram — it is counted
        (``karpenter_cloudprovider_breaker_shortcircuit_total``) and tagged
        ``short_circuit=true`` on both this span and its parent, so a
        traced launch with a gap explains itself."""
        from karpenter_tpu_torch import obs

        start = time.perf_counter()
        with obs.tracer().span(
            f"cloud.{method}",
            attrs={"provider": self.delegate.name(), "method": method},
        ) as span:
            try:
                if not self.resilient:
                    return fn(*args)
                breaker = self.breakers.get(f"{self.delegate.name()}:{method}")
                if not breaker.allow():
                    metrics.CLOUDPROVIDER_BREAKER_SHORTCIRCUIT.labels(
                        provider=self.delegate.name(), method=method
                    ).inc()
                    span.set_attribute("short_circuit", True)
                    if span.parent is not None:
                        span.parent.set_attribute("short_circuit", True)
                    raise BreakerOpen(breaker.dependency, breaker.open_seconds)
                try:
                    result = self._policies[method].call(fn, *args)
                except BreakerOpen:
                    raise
                except Exception as e:
                    # breaker state tracks AVAILABILITY: a deterministic answer
                    # (ICE/stockout, validation) means the dependency responded —
                    # an ICE storm must sideline offerings (the 45s cache), never
                    # open the create breaker and block the recovery launches
                    from karpenter_tpu_torch.resilience import default_retryable

                    if default_retryable(e):
                        breaker.record_failure()
                    else:
                        breaker.record_success()
                    raise
                breaker.record_success()
                return result
            finally:
                self._observe(method, start)

    @idempotent
    def create(self, request: NodeRequest) -> Node:
        # idempotent BY TOKEN: a request arriving without a launch token
        # (direct callers; the provisioning worker stamps its own first)
        # is stamped here, so every retry below replays one logical launch
        if request is not None and not getattr(request, "launch_token", ""):
            import dataclasses
            import uuid

            request = dataclasses.replace(request, launch_token=uuid.uuid4().hex)
        return self._guarded("create", self.delegate.create, request)

    @idempotent
    def delete(self, node: Node) -> None:
        return self._guarded("delete", self.delegate.delete, node)

    @idempotent
    def get_instance_types(self, provider: Optional[Dict[str, Any]] = None) -> List[InstanceType]:
        return self._guarded("get_instance_types", self.delegate.get_instance_types, provider)

    @idempotent
    def poll_disruptions(self):
        """The DisruptionSource poll is a real control-plane call for wire
        providers — observe it like create/delete. An open breaker yields
        an empty poll, not an exception: the interruption loop keeps its
        cadence and picks the stream back up when the breaker closes."""
        try:
            return self._guarded("poll_disruptions", self.delegate.poll_disruptions)
        except BreakerOpen:
            return []

    def instance_gone(self, node: Node) -> Optional[bool]:
        # liveness probes carry their own miss-threshold debouncing; a
        # breaker/retry layer here would only delay the reset-on-sighting
        return self.delegate.instance_gone(node)

    def list_instances(self):
        # the GC sweep's read path: unmetered passthrough (the sweep has
        # its own cadence; a raised list simply defers one GC round, and a
        # breaker here could mask a real leak for its whole open window)
        return self.delegate.list_instances()

    def requeue_disruption(self, notice) -> bool:
        # a local re-offer, not a metered control-plane call
        return self.delegate.requeue_disruption(notice)

    # webhook hooks + name pass through unmetered, as in the reference
    def default(self, constraints: Constraints) -> None:
        return self.delegate.default(constraints)

    def validate(self, constraints: Constraints) -> List[str]:
        return self.delegate.validate(constraints)

    def name(self) -> str:
        return self.delegate.name()


def decorate(provider: CloudProvider, resilience: bool = True) -> CloudProvider:
    """Idempotent wrap (reference: metrics.Decorate)."""
    if isinstance(provider, MeteredCloudProvider):
        return provider
    return MeteredCloudProvider(provider, resilience=resilience)
