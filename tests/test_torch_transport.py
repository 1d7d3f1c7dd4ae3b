"""The port's kube transport (``kube/transport.py``) against the JAX
package's: the flow limiter's mutation-priority reserve, and the policy
ladder over fake attempts on a fake clock — retries by verb class, no retry
of a create, ``Retry-After`` on a 429, a 429 as a breaker success, the
breaker's open and half-open states, the lease class past an open breaker,
the round budget's cap, the events class's drop counter and the
unreachable classification.

Mirrors ``tests/test_partition.py`` (``TestFlowLimiter``,
``TestKubeTransport``). Each case runs on both packages and compares
exactly: the attempts paid, the sleeps, the answers, the exceptions and the
metric deltas.
"""

import random

import pytest

from torch_parity import PACKAGES, fresh_router, kube, sample  # noqa: F401


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def transport(M, clock=None, **kw):
    """A ``KubeTransport`` of package ``M`` on a fake clock whose sleeps
    advance it and are recorded: (transport, clock, sleeps)."""
    clock = clock or FakeClock()
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clock.advance(s)

    kw.setdefault("qps", 1000.0)
    kw.setdefault("burst", 1000)
    return M.transport.KubeTransport(clock=clock, sleep=sleep, **kw), clock, sleeps


def both(fn):
    """``fn(M)`` on each package, the process's ``random`` (the jitter's
    draws) seeded alike; the port's result, once it equals the
    reference's."""
    out = []
    for pkg in PACKAGES:
        random.seed(11)
        out.append(fn(kube(pkg)))
    assert out[1] == out[0]
    return out[1]


def outcome(fn):
    """(``fn()``'s value, None) or (None, (exception name, retry_after))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001
        return None, (type(e).__name__, getattr(e, "retry_after", None))


def scripted(answers):
    """An attempt that returns ``answers`` in turn (raising those that are
    exceptions), and the list of its calls."""
    calls = []

    def attempt():
        answer = answers[min(len(calls), len(answers) - 1)]
        calls.append(1)
        if isinstance(answer, BaseException):
            raise answer
        return answer

    return attempt, calls


# -- TestFlowLimiter ---------------------------------------------------------------


def test_mutation_priority_reserve():
    def run(M):
        clock = FakeClock()
        limiter = M.transport.FlowLimiter(qps=0.000001, burst=10, clock=clock,
                                          sleep=lambda s: None)
        reads = 0
        while limiter.try_take(False):
            reads += 1
            assert reads < 100
        mutation = limiter.try_take(True)
        while limiter.try_take(True):
            pass
        return reads, mutation, limiter.try_take(True), limiter.reserve

    reads, mutation, empty, reserve = both(run)
    assert reads < 10 and mutation and not empty and reserve == 1.0


def test_take_reports_waits():
    def run(M):
        clock = FakeClock()

        def sleep(s):
            clock.advance(s)

        limiter = M.transport.FlowLimiter(qps=100.0, burst=1, clock=clock, sleep=sleep)
        first = limiter.take(True, timeout=1.0)
        second = limiter.take(True, timeout=1.0)
        starved = M.transport.FlowLimiter(qps=0.000001, burst=1, clock=clock, sleep=sleep)
        return first, second, starved.try_take(True), starved.take(True, timeout=0.05), clock.t

    first, second, took, refused, _ = both(run)
    assert first == (True, False) and second == (True, True)
    assert took and refused == (False, True)


# -- TestKubeTransport -------------------------------------------------------------


def test_read_retries_5xx_then_succeeds():
    def run(M):
        t, _, sleeps = transport(M)
        attempt, calls = scripted([(503, {}, None), (503, {}, None), (200, {"ok": 1}, None)])
        labels = {"verb_class": "read"}
        before = sample(M, "karpenter_kube_request_retries_total", labels)
        out = t.request(M.transport.VERB_READ, "GET", "pods", attempt)
        return (out, len(calls), sleeps,
                sample(M, "karpenter_kube_request_retries_total", labels) - before)

    out, calls, sleeps, retries = both(run)
    assert out == (200, {"ok": 1}, None) and calls == 3 and len(sleeps) == 2 and retries == 2


def test_connection_errors_retry_then_raise():
    def run(M):
        t, _, sleeps = transport(M)
        attempt, calls = scripted([ConnectionRefusedError("down")])
        return (outcome(lambda: t.request(M.transport.VERB_MUTATE, "PATCH", "nodes", attempt)),
                len(calls), len(sleeps))

    (_, error), calls, sleeps = both(run)
    assert error[0] == "ConnectionRefusedError" and calls == 3 and sleeps == 2


def test_create_is_never_retried():
    def run(M):
        t, _, sleeps = transport(M)
        attempt, calls = scripted([(503, {"kind": "Status"}, None)])
        return t.request(M.transport.VERB_CREATE, "POST", "nodes", attempt), len(calls), sleeps

    (status, _, _), calls, sleeps = both(run)
    assert status == 503 and calls == 1 and sleeps == []


def test_429_retry_after_is_honored():
    def run(M):
        t, _, sleeps = transport(M)
        attempt, calls = scripted([(429, {}, 0.07), (200, {}, None)])
        return t.request(M.transport.VERB_MUTATE, "PATCH", "pods", attempt)[0], sleeps

    assert both(run) == (200, [0.07])


def test_429_on_create_surfaces_the_hint():
    def run(M):
        t, _, sleeps = transport(M)
        return outcome(lambda: t.request(M.transport.VERB_CREATE, "POST", "pods",
                                         lambda: (429, {}, 0.35))), sleeps

    (_, error), sleeps = both(run)
    assert error == ("KubeThrottled", pytest.approx(0.35)) and sleeps == []


def test_429_counts_as_breaker_success():
    def run(M):
        t, _, _ = transport(M)
        labels = {"source": "server"}
        before = sample(M, "karpenter_kube_throttled_total", labels)
        errors = [outcome(lambda: t.request(M.transport.VERB_CREATE, "POST", "pods",
                                            lambda: (429, {}, 0.01)))[1] for _ in range(20)]
        return errors, t.degraded(), sample(M, "karpenter_kube_throttled_total", labels) - before

    errors, degraded, throttled = both(run)
    assert all(e[0] == "KubeThrottled" for e in errors) and not degraded and throttled == 20


def test_breaker_opens_then_half_open_recovers():
    def run(M):
        t, clock, _ = transport(M)
        failing, calls = scripted([(503, {}, None)])
        seen = []
        for _ in range(4):
            answer = outcome(lambda: t.request(M.transport.VERB_READ, "GET", "pods", failing))
            seen.append(answer)
            if answer[1] is not None:
                break
        degraded, paid = t.degraded(), len(calls)
        fast = outcome(lambda: t.request(M.transport.VERB_READ, "GET", "pods", failing))
        after_fast = len(calls)
        clock.advance(t.breaker.open_seconds + 0.1)
        probe = t.request(M.transport.VERB_READ, "GET", "pods", lambda: (200, {}, None))
        return seen, degraded, paid, fast, after_fast, probe[0], t.degraded()

    seen, degraded, paid, fast, after_fast, probe, recovered = both(run)
    assert degraded and fast[1][0] == "ApiUnavailable" and after_fast == paid
    assert probe == 200 and not recovered


def test_lease_class_bypasses_an_open_breaker():
    def run(M):
        t, _, _ = transport(M)
        t.breaker.trip()
        read = outcome(lambda: t.request(M.transport.VERB_READ, "GET", "pods",
                                         lambda: (200, {}, None)))
        lease = t.request(M.transport.VERB_LEASE, "PUT", "leases", lambda: (200, {}, None))
        return t.degraded(), read[1][0], lease[0]

    assert both(run) == (True, "ApiUnavailable", 200)


def test_round_budget_caps_retries():
    def run(M):
        t, clock, _ = transport(M)
        attempt, calls = scripted([(503, {}, None)])
        budget = M.resilience.Budget(0.01, clock=clock)
        with budget.activate():
            status = t.request(M.transport.VERB_READ, "GET", "pods", attempt)[0]
        return status, len(calls)

    assert both(run) == (503, 1)


def test_events_drop_counter():
    def run(M):
        t, _, sleeps = transport(M)
        before = sample(M, "karpenter_kube_events_dropped_total")
        error = outcome(lambda: t.request(M.transport.VERB_EVENTS, "POST", "events",
                                          scripted([ConnectionResetError("slow")])[0]))[1]
        return error[0], sleeps, sample(M, "karpenter_kube_events_dropped_total") - before

    assert both(run) == ("ConnectionResetError", [], 1.0)


def test_events_5xx_also_counts_as_dropped():
    def run(M):
        t, _, _ = transport(M)
        before = sample(M, "karpenter_kube_events_dropped_total")
        status = t.request(M.transport.VERB_EVENTS, "POST", "events", lambda: (503, {}, None))[0]
        return status, sample(M, "karpenter_kube_events_dropped_total") - before

    assert both(run) == (503, 1.0)


def test_unreachable_classification():
    def run(M):
        T, client = M.transport, M.client
        cases = [T.ApiUnavailable("open"), T.KubeThrottled("429", 1.0), ConnectionRefusedError(),
                 TimeoutError(), M.api.ApiError(503, "storm"), M.api.ApiError(429, "brownout"),
                 M.api.ApiError(403, "rbac"), client.Conflict("409"), client.NotFound("404"),
                 ValueError("bug")]
        return [T.is_unreachable(e) for e in cases]

    assert both(run) == [True] * 6 + [False] * 4


def test_request_latency_and_span_per_logical_call():
    """One ``kube.request`` span per logical call with its final code and
    retry count, and one latency observation per attempt, in both."""
    def run(M):
        M.obs.reset_for_tests()
        t, _, _ = transport(M)
        attempt, _ = scripted([(503, {}, None), (200, {}, None)])
        labels = {"verb": "GET", "kind": "pods", "code": "503"}
        before = sample(M, "karpenter_kube_request_duration_seconds_count", labels)
        t.request(M.transport.VERB_READ, "GET", "pods", attempt)
        spans = [(tree["name"], dict(tree["attrs"])) for tree in M.obs.exporter().trees()
                 if tree["name"] == "kube.request"]
        M.obs.reset_for_tests()
        return spans, sample(M, "karpenter_kube_request_duration_seconds_count", labels) - before

    spans, observed = both(run)
    assert observed == 1.0
    assert spans == [("kube.request", {"verb": "GET", "kind": "pods", "class": "read",
                                       "code": 200, "retries": 1})]
