"""The port's transport, ``ApiCluster`` and ``ApiServerChaos`` end to end
against the JAX package's, over each package's in-repo API server: a patch
riding through injected 503s, conflicts that stay loud under chaos, a 429
storm paced by ``Retry-After``, degraded reads from the informer cache
while the breaker is open, the bind-409 ladder, the eviction's
``Retry-After`` and the eviction queue honouring it, event writes that
never block, the watch loop's backoff under a blackout, and the chaos
harness itself (seeded draws, blackouts, ``fail_next``).

Mirrors ``tests/test_partition.py`` (``TestTransportE2E``,
``TestApiServerChaos``). Each case runs on both packages, each client
against its own server, and compares exactly: the answers, the exceptions,
the chaos counters and the metric deltas.
"""

import time

import pytest

from torch_parity import (PACKAGES, both_at_once, both_canon, fresh_router, kube,  # noqa: F401
                          kube_env, sample)


def both(fn):
    return both_canon(fn, ns=kube)


def failure(M, fn):
    """None when ``fn()`` returns, else (exception name, whether package
    ``M``'s transport reads it as an unreachable apiserver)."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, M.transport.is_unreachable(e)


def connect(env, **kw):
    """A client without informers (``kinds=()``) and with 10-50 ms retry
    pacing, as the reference's partition fixture."""
    kw.setdefault("kinds", ())
    return env.connect(start=False, fast_retries=True, **kw)


# -- TestTransportE2E -------------------------------------------------------------------


def test_patch_rides_through_transient_5xx():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.create("provisioners", M.f.make_provisioner(name="p1"))
            chaos = env.chaos = M.chaos.ApiServerChaos(seed=7)
            chaos.fail_next("PATCH", 2)
            labels = {"verb_class": "mutate"}
            before = sample(M, "karpenter_kube_request_retries_total", labels)
            fresh = cluster.patch_status("provisioners", "p1",
                                         {"lastScaleTime": "2026-08-03T00:00:00Z"}, namespace="")
            return (fresh is not None, chaos.counts(chaos.injected),
                    sample(M, "karpenter_kube_request_retries_total", labels) - before)

    assert both(run) == (True, 2, 2.0)


def test_conflicts_stay_loud_under_chaos():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.create("provisioners", M.f.make_provisioner(name="dup"))
            env.chaos = M.chaos.ApiServerChaos(seed=3)
            env.chaos.fail_next("PUT", 1)
            live = cluster.get_live("provisioners", "dup", namespace="")
            live.metadata.resource_version = 999999  # stale: a racer's write won
            return (failure(M, lambda: cluster.update("provisioners", live)),
                    failure(M, lambda: cluster.create("provisioners",
                                                   M.f.make_provisioner(name="dup"))),
                    env.chaos.counts(env.chaos.injected))

    assert both(run) == (("Conflict", False), ("Conflict", False), 1)


def test_server_429_retry_after_paces_the_mutate_ladder():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.create("provisioners", M.f.make_provisioner(name="throttled"))
            env.chaos = M.chaos.ApiServerChaos(throttle_rate=1.0, retry_after=0.05, seed=1)
            labels = {"source": "server"}
            before = sample(M, "karpenter_kube_throttled_total", labels)
            t0 = time.perf_counter()
            try:
                cluster.patch_status("provisioners", "throttled", {"lastScaleTime": "x"},
                                     namespace="")
                hint = None
            except M.transport.KubeThrottled as e:
                hint = e.retry_after
            return (time.perf_counter() - t0 >= 0.1, hint,
                    sample(M, "karpenter_kube_throttled_total", labels) - before,
                    env.chaos.counts(env.chaos.throttled))

    paced, hint, throttled, injected = both_at_once(run)
    assert paced and hint == pytest.approx(0.05) and throttled == injected == 3


def test_degraded_reads_serve_the_cache():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env, kinds=("pods",))
            cluster.transport.breaker = M.resilience.CircuitBreaker(
                dependency="kube-apiserver", min_volume=2, failure_rate=0.5, open_seconds=60.0)
            cluster.create("pods", M.f.make_pod(name="cached-pod"))
            env.chaos = M.chaos.ApiServerChaos()
            env.chaos.blackout(120.0)
            for _ in range(3):
                failure(M, lambda: cluster.get_live("provisioners", "nope", namespace=""))
            before = sample(M, "karpenter_kube_degraded_reads_total")
            got = cluster.get_live("pods", "cached-pod").metadata.name
            return (cluster.degraded(), got,
                    sample(M, "karpenter_kube_degraded_reads_total") - before,
                    failure(M, lambda: cluster.get_live("leases", "some-lease",
                                                     namespace="kube-system"))[1],
                    failure(M, lambda: cluster.list_live("leases", namespace="kube-system"))[1])

    assert both(run) == (True, "cached-pod", 1.0, True, True)


def test_bind_409_same_node_is_idempotent():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            pod = M.f.make_pod(name="bound-once")
            cluster.create("pods", pod)
            cluster.bind(pod, "node-a")
            replay = M.f.make_pod(name="bound-once")
            replay.spec.node_name = ""
            cluster.bind(replay, "node-a")
            return replay.spec.node_name, cluster.get("pods", "bound-once").spec.node_name

    assert both(run) == ("node-a", "node-a")


def test_bind_409_different_node_raises():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            pod = M.f.make_pod(name="contested")
            cluster.create("pods", pod)
            cluster.bind(pod, "node-a")
            rival = M.f.make_pod(name="contested")
            rival.spec.node_name = ""
            return failure(M, lambda: cluster.bind(rival, "node-b")), rival.spec.node_name

    assert both(run) == (("Conflict", False), "")


def test_bind_409_pod_gone_raises():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            pod = M.f.make_pod(name="vanishing")
            cluster.create("pods", pod)
            cluster.bind(pod, "node-a")
            env.cluster.delete("pods", "vanishing")
            ghost = M.f.make_pod(name="vanishing")
            ghost.spec.node_name = ""
            return failure(M, lambda: cluster.bind(ghost, "node-b"))[0]

    assert both(run) in ("Conflict", "NotFound")


def test_evict_surfaces_retry_after():
    def run(M):
        with kube_env(M) as env:
            env.server.eviction_retry_after = 0.35
            cluster = connect(env)
            pod = M.f.make_pod(name="protected", labels={"app": "guarded"})
            pod.spec.node_name = "node-a"
            env.cluster.seed("pods", pod)
            env.cluster.create("pdbs", M.f.make_pdb(name="guard", labels={"app": "guarded"},
                                                    min_available=1))
            return cluster.evict_with_hint(pod), cluster.evict(pod)

    (ok, hint), plain = both(run)
    assert not ok and hint == pytest.approx(0.35) and plain is False


def test_eviction_queue_honors_the_hint():
    def run(M):
        with kube_env(M) as env:
            env.server.eviction_retry_after = 0.3
            cluster = connect(env)
            pod = M.f.make_pod(name="queued", labels={"app": "guarded"})
            pod.spec.node_name = "node-a"
            env.cluster.seed("pods", pod)
            cluster.seed("pods", pod)  # the queue's pre-check reads the client's cache
            env.cluster.create("pdbs", M.f.make_pdb(name="guard", labels={"app": "guarded"},
                                                    min_available=1))
            q = M.term.EvictionQueue(cluster, start=False)
            q.add([pod])
            key = q.queue.get(timeout=1.0)
            processed = q.process_one(key)
            with q.queue._lock:
                delayed = list(q.queue._delayed)
            ready_at, _, requeued = delayed[0]
            delay = ready_at - time.monotonic()
            return processed, len(delayed), requeued == key, 0.15 < delay <= 0.31

    assert both(run) == (False, 1, True, True)


def test_event_write_never_blocks_a_reconcile():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.events_timeout = 0.2
            env.chaos = M.chaos.ApiServerChaos(latency_floor=1.0)
            before = sample(M, "karpenter_kube_events_dropped_total")
            t0 = time.perf_counter()
            out = M.kevents.recorder_for(cluster).event("Node", "slow-node", "Launched",
                                                        "latency chaos", type="Normal")
            return (time.perf_counter() - t0 < 0.9, out,
                    sample(M, "karpenter_kube_events_dropped_total") - before)

    assert both_at_once(run) == (True, None, 1.0)


def test_watch_relist_backs_off_under_blackout():
    def run(M):
        with kube_env(M) as env:
            cluster = env.connect(start=False, kinds=("pods",))
            cluster.transport._backoff_base = 0.01
            cluster.transport._backoff_cap = 0.02
            cluster.watch_backoff_base = 0.05
            cluster.watch_backoff_cap = 0.4
            env.chaos = M.chaos.ApiServerChaos()
            env.chaos.blackout(1.0)
            cluster.start()
            time.sleep(1.0)
            attempts = cluster.relist_attempts.get("pods", 0)
            return 1 <= attempts <= 8, cluster.wait_for_sync(10.0)

    assert both_at_once(run) == (True, True)


# -- TestApiServerChaos -------------------------------------------------------------------


def test_seeded_injection_is_deterministic():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            for i in range(6):
                cluster.create("pods", M.f.make_pod(name=f"seeded-{i}"))

            def draws(seed):
                chaos = env.chaos = M.chaos.ApiServerChaos(per_verb={"GET": 0.5}, seed=seed)
                outcomes = []
                for i in range(6):
                    try:
                        status, _, _ = cluster.transport.request(
                            M.transport.VERB_CREATE, "GET", "pods",
                            lambda i=i: cluster._attempt(
                                "GET", f"/api/v1/namespaces/default/pods/seeded-{i}",
                                None, "application/json", None))
                        outcomes.append("ok" if status == 200 else "err")
                    except Exception:  # noqa: BLE001
                        outcomes.append("err")
                env.chaos = None
                return outcomes, dict(chaos.injected)

            return draws(42), draws(42), draws(7)

    a, b, c = both(run)
    assert a == b and "err" in a[0] and "ok" in a[0]


def test_blackout_window_drops_connections():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            chaos = env.chaos = M.chaos.ApiServerChaos(blackouts=[M.chaos.ChaosWindow(0.0, 30.0)])
            unreachable = failure(M, lambda: cluster.get_live("provisioners", "anything",
                                                           namespace=""))[1]
            return unreachable, chaos.counts(chaos.dropped) >= 1, chaos.in_blackout()

    assert both(run) == (True, True, True)


def test_fail_next_is_exact():
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.create("pods", M.f.make_pod(name="exact"))
            chaos = env.chaos = M.chaos.ApiServerChaos(seed=0)
            chaos.fail_next("GET", 2)
            got = cluster.get_live("pods", "exact").metadata.name
            return got, chaos.counts(chaos.injected), dict(chaos.injected)

    assert both(run) == ("exact", 2, {"GET": 2})


def test_latency_and_throttle_counters_by_verb():
    """The latency floor and tail are drawn, counted by verb, and a
    throttled answer carries ``Retry-After``, in the reference's order."""
    def run(M):
        with kube_env(M) as env:
            cluster = connect(env)
            cluster.create("pods", M.f.make_pod(name="slow"))
            chaos = env.chaos = M.chaos.ApiServerChaos(
                latency_floor=0.01, latency_p95=0.01, throttle_rate=0.5, retry_after=0.01,
                seed=5)
            for _ in range(4):
                failure(M, lambda: cluster.get_live("pods", "slow"))
            return dict(chaos.delayed), dict(chaos.throttled), dict(chaos.injected)

    delayed, throttled, injected = both(run)
    assert delayed["GET"] >= 4 and throttled.get("GET", 0) >= 1 and injected == {}
