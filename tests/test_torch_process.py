"""The port's process assembly (``options.py``, ``main.py``, ``webhook.py``,
the retry budget, the leases) against the JAX package's.

Mirrors ``tests/test_webhook_metrics_main.py`` (``TestWebhook``,
``TestOptionsRegistry``, ``TestServedEndpoints``, ``TestRuntime``),
``tests/test_overload.py`` (``TestRetryBudget``, ``TestRuntimeWiring``),
``tests/test_webhook_server_lease.py`` (``TestWebhookServer``,
``TestLease``), the ``Options`` case of ``tests/test_disruption_budget.py``
and the ``_freeze_gc_when_warm`` cases of ``tests/test_gcpolicy.py``. Each
case runs on both packages (the port's runtimes with ``device="cpu"``) and
compares exactly under ``torch_parity.canon``. The port's own cases: the
``--device`` option and its threading into every controller that solves,
the three settings the port refused until its apiserver client and its
fleet landed (``--kube-api-server``, ``--shard-lease``, a ``kube:`` leader
lease), the webhook over HTTPS from given cert files, and two electors on
one lease.
"""

import gc
import importlib
import json
import subprocess
import threading
import time
import types
import urllib.request

import pytest

from torch_parity import PACKAGES, both_canon, fresh_router, on_cpu, proc  # noqa: F401

PORT = "karpenter_tpu_torch"


def both(fn):
    return both_canon(fn, ns=proc)


def options(M, **kw):
    return M.options.Options(**on_cpu(M, kw))


def wait(predicate, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


def raised(fn):
    """The name of the exception ``fn()`` raised, or None."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — SystemExit from argparse too
        return type(e).__name__
    return None


# -- TestWebhook ------------------------------------------------------------------


WEBHOOK = ["vendor default", "bad spec", "vendor errors", "good spec", "default solver",
           "restricted op"]


@pytest.mark.parametrize("case", WEBHOOK)
def test_webhook_admission(case):
    def run(M):
        sim = M.sim.SimulatedCloudProvider
        fake = lambda: M.fake.FakeCloudProvider(M.fake.instance_types(2))  # noqa: E731
        if case == "vendor default":
            prov = M.f.make_provisioner()
            M.webhook.Webhook(sim()).default(prov)
            r = prov.spec.constraints.requirements
            return sorted(r.capacity_types()), sorted(r.architectures())
        if case == "bad spec":
            prov = M.f.make_provisioner(ttl_after_empty=-1)
            return raised(lambda: M.webhook.Webhook(fake()).validate(prov))
        if case == "vendor errors":
            prov = M.f.make_provisioner(provider={"imageFamily": "bogus"})
            try:
                M.webhook.Webhook(sim()).admit(prov)
            except M.webhook.AdmissionError as e:
                return e.errors
        if case == "good spec":
            prov = M.f.make_provisioner()
            return M.webhook.Webhook(sim()).admit(prov) is prov
        if case == "default solver":
            webhook = M.webhook.Webhook(fake(), default_solver="tpu")
            prov = M.prov_api.Provisioner()
            before = prov.spec.solver
            webhook.default(prov)
            prov2 = M.f.make_provisioner(solver="ffd")
            webhook.default(prov2)
            return before, prov.spec.solver, prov2.spec.solver
        prov = M.f.make_provisioner(requirements=[M.O.NodeSelectorRequirement(
            key=M.lbl.TOPOLOGY_ZONE, operator="DoesNotExist")])
        return raised(lambda: M.webhook.Webhook(fake()).validate(prov))

    out = both(run)
    want = {"vendor default": (["on-demand"], ["amd64"]), "bad spec": "AdmissionError",
            "good spec": True, "default solver": ("", "tpu", "ffd"),
            "restricted op": "AdmissionError"}
    if case == "vendor errors":
        assert any("imageFamily" in e for e in out)
    else:
        assert out == want[case]


# -- TestOptionsRegistry, the Options case of test_disruption_budget.py ---------


def test_options_and_registry():
    def run(M):
        overrides = M.options.parse_args(["--cloud-provider", "simulated", "--default-solver",
                                          "tpu", "--consolidation-budget", "20%"])
        return (options(M).validate(),
                (overrides.cloud_provider, overrides.default_solver,
                 overrides.consolidation_budget),
                raised(lambda: M.options.parse_args(["--default-solver", "quantum"])),
                M.registry.new_cloud_provider("fake").name(),
                M.registry.new_cloud_provider("simulated").name(),
                raised(lambda: M.registry.new_cloud_provider("gcp")),
                [e for e in options(M, consolidation_budget="banana").validate()
                 if "consolidation budget" in e],
                [e for e in options(M, consolidation_budget="3").validate()
                 if "consolidation budget" in e])

    out = both(run)
    assert out[0] == [] and out[1] == ("simulated", "tpu", "20%")
    assert out[2] == "SystemExit" and out[3:6] == ("fake", "simulated", "ValueError")
    assert len(out[6]) == 1 and out[7] == []


def test_options_fields_and_flags_match_the_reference():
    """Every reference option is in the port with the same default, and
    ``parse_args`` takes the same flags; the port adds ``device``."""
    import dataclasses
    import os

    env = {k: os.environ.pop(k) for k in list(os.environ) if k == "KARPENTER_DEVICE"}
    try:
        fields = {pkg: {f.name: getattr(proc(pkg).options.Options(), f.name)
                        for f in dataclasses.fields(proc(pkg).options.Options)}
                  for pkg in PACKAGES}
    finally:
        os.environ.update(env)
    port = fields[PORT]
    assert port.pop("device") == "cuda"
    assert port == fields["karpenter_tpu"]
    argv = ["--no-trace", "--profile-hz", "0", "--telemetry-peers", "a=http://x:1",
            "--no-sentinel", "--sentinel-dir", "/s", "--decision-dir", "/d", "--no-explain",
            "--warm-pool", "--launch-journal", "memory:", "--solver-delta"]
    parsed = {pkg: dataclasses.asdict(proc(pkg).options.parse_args(argv)) for pkg in PACKAGES}
    assert parsed[PORT].pop("device") == "cuda"
    assert parsed[PORT] == parsed["karpenter_tpu"]


def test_device_option():
    """``--device`` defaults to ``cuda`` and accepts ``cpu`` and ``cuda:<n>``;
    anything else fails validation."""
    O = proc(PORT).options
    assert O.parse_args([]).device == "cuda"
    assert O.parse_args(["--device", "cpu"]).device == "cpu"
    assert O.parse_args(["--device", "cuda:1"]).device == "cuda:1"
    assert raised(lambda: O.parse_args(["--device", "tpu"])) == "SystemExit"
    assert any("device" in e for e in O.Options(device="gpu").validate())


def test_build_runtime_threads_the_device_into_every_solving_controller():
    M = proc(PORT)
    for device in ("cuda", "cpu"):
        rt = M.main.build_runtime(M.options.Options(device=device), start_workers=False)
        try:
            assert rt.provisioning.device == device and rt.consolidation.device == device
            assert rt.options.device == device
        finally:
            rt.stop()


# -- the API server settings, and the one the port still refuses --------------------


def test_kube_api_server_is_refused(monkeypatch):
    """``--kube-api-server`` was refused until the API server client was
    ported; now ``build_runtime`` runs over an ``ApiCluster`` with the
    client QPS knobs, and ``in-cluster`` reads the service-account
    environment, as in the reference."""
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")

    def run(M):
        api = importlib.import_module(f"{M.pkg}.kube.apiserver")
        out = []
        for url in ("http://127.0.0.1:6443", "in-cluster"):
            rt = M.main.build_runtime(options(M, kube_api_server=url, kube_client_qps=50,
                                              kube_client_burst=60), start_workers=False)
            try:
                c = rt.cluster
                out.append((type(c) is api.ApiCluster, c._scheme, c._host, c._port,
                            c.transport.limiter.qps, c.transport.limiter.burst,
                            rt.consolidation.migration))
            finally:
                rt.stop()
        return out

    assert both(run) == [(True, "http", "127.0.0.1", 6443, 50.0, 60, "evict"),
                         (True, "https", "10.0.0.1", 6443, 50.0, 60, "evict")]


def test_shard_lease_is_refused(tmp_path):
    """``--shard-lease`` was refused until the fleet was ported; now
    ``build_runtime`` builds a ``ShardManager`` under the given identity,
    hands it to every controller (the terminator gets its fence), wires
    its hooks, and its first tick owns a created provisioner; ``stop``
    releases the shard."""
    def run(M):
        lease = M.lease.FileLeaseSet(str(tmp_path / f"s-{M.pkg}"), identity="probe")
        rt = M.main.build_runtime(
            options(M, shard_lease=str(tmp_path / f"s-{M.pkg}"), shard_lease_duration=30.0),
            cluster=M.Cluster(), start_workers=False, shard_identity="replica-0")
        try:
            own = rt.ownership
            wired = (type(own).__name__, own.identity, own.leases.duration,
                     rt.provisioning.ownership is own, rt.interruption.ownership is own,
                     rt.consolidation.ownership is own, rt.garbage_collection.ownership is own,
                     rt.termination.fenced == own.fenced,
                     own.on_lost == rt.provisioning.release_shard)
            rt.cluster.create("provisioners", M.f.make_provisioner(name="p1"))
            own.tick()
            owned = sorted(own.owned())
            held = lease.holder("p1")
        finally:
            rt.stop()
        return wired, owned, held, lease.holder("p1"), sorted(lease.members())

    assert both(run) == (("ShardManager", "replica-0", 30.0, True, True, True, True, True, True),
                         ["__unassigned__", "p1"], "replica-0", None, [])


def test_kube_leader_election_lease_is_refused():
    """A ``kube:`` leader-election lease was refused until the leases over
    the API were ported; now ``run_controller_process`` over an API server
    syncs its informers, leads through a Lease object, keeps its launch
    journal on the server (``kube:``), binds pods created server-side, and
    releases the Lease on stop. Without an API server the reference's
    ValueError stands."""
    def run(M):
        ts = importlib.import_module(f"{M.pkg}.kube.testserver")
        server = ts.TestApiServer()
        server.start()
        rt = M.main.run_controller_process(options(
            M, kube_api_server=server.url, leader_election_lease="kube:kube-system/lead",
            launch_journal="kube:kube-system/launch", cloud_provider="fake"), serve=False)
        try:
            leader = server.cluster.get("leases", "lead", namespace="kube-system")
            led = (leader.holder_identity == rt.elector.lease.identity, rt.elector.is_leader)
            server.cluster.create("provisioners", M.f.make_provisioner())
            assert wait(lambda: "default" in rt.provisioning.workers, 30)
            rt.provisioning.workers["default"].batcher.idle_duration = 0.1
            for i in range(3):
                server.cluster.create("pods", M.f.make_pod(name=f"app-{i}",
                                                           requests={"cpu": "1"}))
            bound = wait(lambda: all(p.spec.node_name for p in server.cluster.pods()), 30)
            settled = wait(lambda: not rt.journal.unresolved(), 10)
            nodes = len(server.cluster.nodes())
        finally:
            rt.stop()
            stopped = server.cluster.get("leases", "lead", namespace="kube-system")
            server.stop()
        return led, bound, settled, nodes, stopped.holder_identity, type(rt.journal).__name__

    assert both(run) == ((True, True), True, True, 1, "", "KubeLaunchJournal")
    M = proc(PORT)
    with pytest.raises(ValueError, match="kube: leader election requires --kube-api-server"):
        try:
            M.main.run_controller_process(
                M.options.Options(device="cpu", leader_election_lease="kube:kube-system/lead"),
                serve=False)
        finally:
            importlib.import_module(f"{PORT}.obs").reset_for_tests()


# -- TestServedEndpoints ----------------------------------------------------------


def get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_metrics_health_and_debug_served():
    """Both servers on ports the kernel picks (port 0), read back from the
    runtime's servers: no free-port probe to race other tests' binds."""
    def run(M):
        rt = M.main.run_controller_process(options(M, metrics_port=0, health_probe_port=0))
        try:
            metrics_port, health_port = (s.server_address[1] for s in rt.servers)
            health = f"http://127.0.0.1:{health_port}"
            metrics = get(f"http://127.0.0.1:{metrics_port}/metrics")[2].decode()
            slo = json.loads(get(f"{health}/debug/slo")[2])["slo"]
            traces = json.loads(get(f"{health}/debug/traces?limit=1")[2])
            out = {
                "metrics": "karpenter" in metrics,
                "healthz": get(f"{health}/healthz")[:1], "readyz": get(f"{health}/readyz")[:1],
                "solve_p99": slo["objectives"]["solve_p99"]["ok"],
                "traces": ("stats" in traces, len(traces["traces"]) <= 1),
            }
            for route in ("profile", "fleet", "incidents", "decisions", "forecast", "flight"):
                status, ctype, _ = get(f"{health}/debug/{route}")
                out[route] = (status, ctype)
            try:
                get(f"{health}/nope")
            except urllib.error.HTTPError as e:
                out["missing"] = e.code
            return out
        finally:
            rt.stop()

    out = both(run)
    assert out["metrics"] and out["healthz"] == out["readyz"] == (200,)
    assert out["solve_p99"] is None and out["traces"] == (True, True)
    assert out["incidents"][0] == out["fleet"][0] == out["profile"][0] == 200
    assert out["missing"] == 404


# -- TestRuntime -------------------------------------------------------------------


def test_full_runtime_end_to_end():
    """Start everything, create a provisioner and pods, watch them bind and
    the counter fill status; delete the node and watch termination drain
    it."""
    def run(M):
        rt = M.main.build_runtime(options(M),
                                  cloud_provider=M.fake.FakeCloudProvider(
                                      M.fake.instance_types(10)), start_workers=True)
        rt.manager.start()
        try:
            cluster = rt.cluster
            cluster.create("provisioners", rt.webhook.admit(M.f.make_provisioner()))
            assert wait(lambda: rt.provisioning.list_workers(), 10)
            for w in rt.provisioning.list_workers():
                w.batcher.idle_duration = 0.05
            for i in range(3):
                cluster.create("pods", M.f.make_pod(name=f"e2e-{i}", requests={"cpu": "1"}))
            assert wait(lambda: all(p.spec.node_name for p in cluster.pods()), 15)
            assert wait(lambda: cluster.get("provisioners", "default",
                                            namespace="").status.resources, 5)
            node = cluster.nodes()[0].metadata.name
            cluster.delete("nodes", node, namespace="")
            assert wait(lambda: cluster.try_get("nodes", node, namespace="") is None, 15)
            return (sorted(type(c).__name__ for c in (
                rt.provisioning, rt.selection, rt.termination, rt.interruption,
                rt.garbage_collection, rt.consolidation, rt.brownout)),
                rt.journal, rt.warmpool, rt.cloud_provider.name())
        finally:
            rt.stop()

    controllers, journal, warmpool, name = both(run)
    assert journal is None and warmpool is None and name == "fake"
    assert "BrownoutController" in controllers


@pytest.mark.parametrize("warm_pool", [False, True])
def test_build_runtime_registers_every_controller(warm_pool):
    """The Manager holds the reference's controllers under its names, and
    the runtime's fields are the same kinds of objects."""
    def run(M):
        rt = M.main.build_runtime(options(M, warm_pool=warm_pool, launch_journal="memory:"),
                                  start_workers=False)
        try:
            names = {n: reg.concurrency for n, reg in rt.manager._controllers.items()}
            # the port's Runtime has no ``ownership`` until fleet/ownership.py
            kinds = {k: type(v).__name__ for k, v in vars(rt).items()
                     if k not in ("options", "_gc_freeze_cancel", "servers", "ownership")}
            return names, kinds
        finally:
            rt.stop()

    names, kinds = both(run)
    assert names["selection"] == 32 and ("warmpool" in names) == warm_pool and len(names) == 11 + warm_pool
    assert kinds["warmpool"] == ("WarmPoolController" if warm_pool else "NoneType")
    assert kinds["journal"] == "MemoryLaunchJournal"


# -- TestRuntimeWiring (test_overload.py) ------------------------------------------


def test_build_runtime_wires_brownout_and_stop_reverses():
    def run(M):
        rt = M.main.build_runtime(options(M), start_workers=False)
        try:
            wired = rt.brownout is not None and rt.brownout.provisioning is rt.provisioning
            rt.brownout._level = 2
            rt.brownout._apply(2)
        finally:
            rt.stop()
        opts = M.options.parse_args(["--no-brownout"] + (["--device", "cpu"]
                                                          if M.pkg == PORT else []))
        off = M.main.build_runtime(opts, start_workers=False)
        try:
            return wired, rt.brownout.level(), opts.brownout_enabled, off.brownout
        finally:
            off.stop()

    assert both(run) == (True, 0, False, None)


# -- TestRetryBudget ----------------------------------------------------------------


def test_retry_budget_bucket():
    def run(M):
        RB = M.overload.RetryBudget
        rb = RB(capacity=2, refill_per_success=0.5)
        drain = [rb.try_spend("dep") for _ in range(3)]
        rb.record_success("dep")
        rb.record_success("dep")
        refill = [rb.try_spend("dep") for _ in range(2)]
        capped = RB(capacity=3, refill_per_success=10.0)
        capped.record_success("dep")
        per = RB(capacity=1)
        split = [per.try_spend("a"), per.try_spend("a"), per.try_spend("b")]
        return drain, refill, capped.remaining("dep"), split, per.snapshot()

    assert both(run) == ([True, True, False], [True, False], 3.0, [True, False, True],
                         {"a": 0.0, "b": 0.0})


def test_policy_spends_and_refills_the_budget():
    def run(M):
        RB, RP = M.overload.RetryBudget, M.policy.RetryPolicy
        labels = {"dependency": "flaky", "outcome": "budget_exhausted"}
        before = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                     labels) or 0.0
        rb = RB(capacity=1, refill_per_success=0.0)
        calls = []

        def down():
            calls.append(1)
            raise ConnectionError("down")

        dry = raised(lambda: RP(max_attempts=5, base=0.0001, cap=0.0001, dependency="flaky",
                                retry_budget=rb, sleep=lambda s: None).call(down))
        exhausted = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                        labels) - before
        refilled = RB(capacity=1, refill_per_success=1.0)
        refilled.try_spend("dep")
        ok = RP(max_attempts=2, dependency="dep", retry_budget=refilled,
                sleep=lambda s: None).call(lambda: "ok")
        tries = []

        def flaky():
            tries.append(1)
            if len(tries) < 3:
                raise ConnectionError("down")
            return "ok"

        unlabeled = RP(max_attempts=3, base=0.0001, cap=0.0001, sleep=lambda s: None).call(flaky)
        return dry, len(calls), exhausted, ok, refilled.remaining("dep"), unlabeled, len(tries)

    assert both(run) == ("ConnectionError", 2, 1.0, "ok", 1.0, "ok", 3)


def test_labelled_policy_draws_from_the_default_budget():
    """A labelled policy without its own budget spends the process-shared
    one: ten retries drain it, the eleventh failure propagates at once."""
    def run(M):
        M.overload.reset_default_retry_budget()
        calls = []

        def down():
            calls.append(1)
            raise ConnectionError("down")

        policy = M.policy.RetryPolicy(max_attempts=2, base=0.0001, cap=0.0001,
                                      dependency="shared-dep", sleep=lambda s: None)
        outcomes = [raised(lambda: policy.call(down)) for _ in range(12)]
        left = M.overload.default_retry_budget().remaining("shared-dep")
        M.overload.reset_default_retry_budget()
        return outcomes, len(calls), left

    outcomes, calls, left = both(run)
    assert outcomes == ["ConnectionError"] * 12 and calls == 12 * 2 - 2 and left == 0.0


def test_shed_verdicts_are_never_retried():
    def run(M):
        out = []
        for exc in (M.overload.OverloadedError("full", retry_after=2.0),
                    M.overload.DeadlineExceededError("expired")):
            calls = []

            def fn(e=exc):
                calls.append(1)
                raise e

            out.append((raised(lambda: M.policy.RetryPolicy(
                max_attempts=5, sleep=lambda s: None).call(fn)), len(calls)))
        hint = M.overload.OverloadedError("full", retry_after=3.5).retry_after
        return out, hint, M.overload.OverloadedError("full", retry_after=-1).retry_after

    assert both(run) == ([("OverloadedError", 1), ("DeadlineExceededError", 1)], 3.5, 0.0)


# -- TestWebhookServer ----------------------------------------------------------------


def post(url, doc, context=None):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5, context=context) as resp:
        return json.loads(resp.read())


def test_round_trip_serialization():
    def run(M):
        prov = M.f.make_provisioner(labels={"team": "a"}, ttl_after_empty=30,
                                    limits={"cpu": "100"}, solver="tpu")
        doc = M.webhook.serialize_provisioner(prov)
        back = M.webhook.deserialize_provisioner(doc)
        return doc, M.webhook.serialize_provisioner(back)

    doc, again = both(run)
    assert doc == again and doc["spec"]["limits"] == {"cpu": 100}


def webhook_calls(M, base, context=None):
    doc = M.webhook.serialize_provisioner(M.f.make_provisioner())
    doc["spec"]["solver"] = ""
    defaulted = post(f"{base}/default-resource", doc, context)
    good = post(f"{base}/validate-resource",
                M.webhook.serialize_provisioner(M.f.make_provisioner()), context)
    bad_doc = M.webhook.serialize_provisioner(M.f.make_provisioner())
    bad_doc["spec"]["ttlSecondsAfterEmpty"] = -5
    bad = post(f"{base}/validate-resource", bad_doc, context)
    review = post(f"{base}/validate-resource", {
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {"uid": "u-1", "object": M.serde.to_wire("provisioners",
                                                            M.f.make_provisioner())}}, context)
    with urllib.request.urlopen(f"{base}/healthz", timeout=5, context=context) as resp:
        health = resp.status
    return defaulted, good, bad, review, health


def test_webhook_server_endpoints():
    def run(M):
        srv = M.webhook.serve(M.webhook.Webhook(M.sim.SimulatedCloudProvider(),
                                                default_solver="tpu"), "127.0.0.1:0")
        try:
            return webhook_calls(M, f"http://127.0.0.1:{srv.server_address[1]}")
        finally:
            srv.shutdown()

    defaulted, good, bad, review, health = both(run)
    assert defaulted["spec"]["solver"] == "tpu"
    assert "karpenter.sh/capacity-type" in {r["key"] for r in defaulted["spec"]["requirements"]}
    assert good["allowed"] is True and bad["allowed"] is False and bad["errors"]
    assert review["response"] == {"uid": "u-1", "allowed": True} and health == 200


def test_webhook_serves_https_from_given_cert_files(tmp_path):
    """``serve`` with a cert and key made outside the package (here by the
    ``openssl`` command line) speaks HTTPS."""
    import ssl

    cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                    "-subj", "/CN=127.0.0.1", "-keyout", str(key), "-out", str(cert)],
                   check=True, capture_output=True)
    context = ssl.create_default_context(cafile=str(cert))
    context.check_hostname = False

    def run(M):
        srv = M.webhook.serve(M.webhook.Webhook(M.sim.SimulatedCloudProvider(),
                                                default_solver="tpu"), "127.0.0.1:0",
                              tls_cert=str(cert), tls_key=str(key))
        address = f"127.0.0.1:{srv.server_address[1]}"
        try:
            out = webhook_calls(M, f"https://{address}", context)
            plain = raised(lambda: urllib.request.urlopen(f"http://{address}/healthz", timeout=5))
            return out, plain is not None
        finally:
            srv.shutdown()

    (defaulted, good, bad, review, health), plain_refused = both(run)
    assert defaulted["spec"]["solver"] == "tpu" and good["allowed"] and not bad["allowed"]
    assert health == 200 and plain_refused


# -- TestLease, and two electors on one lease ----------------------------------------


def test_file_lease(tmp_path):
    def run(M):
        L = M.lease.FileLease
        path = str(tmp_path / f"lease-{M.pkg}")
        a, b = L(path, identity="a", duration=10), L(path, identity="b", duration=10)
        single = (a.try_acquire(), b.try_acquire(), a.holder())
        a.release()
        now = [100.0]
        path2 = str(tmp_path / f"lease2-{M.pkg}")
        c = L(path2, identity="c", duration=10, clock=lambda: now[0])
        d = L(path2, identity="d", duration=10, clock=lambda: now[0])
        first = c.try_acquire()
        now[0] += 11
        takeover = (d.try_acquire(), d.holder(), c.renew())
        return single, a.holder(), first, takeover

    assert both(run) == ((True, False, "a"), None, True, (True, "d", False))


def test_elector_acquires_and_releases(tmp_path):
    def run(M):
        path = str(tmp_path / f"elect-{M.pkg}")
        elector = M.lease.LeaderElector(M.lease.FileLease(path, identity="x"),
                                        renew_interval=0.05)
        elector.start()
        led = elector.wait_for_leadership(timeout=5) and elector.is_leader
        elector.stop()
        return led, M.lease.FileLease(path, identity="y").try_acquire()

    assert both(run) == (True, True)


def test_two_electors_one_leader_and_takeover(tmp_path):
    """Two electors on one file lease: exactly one leads; when it stops,
    the other leads within the lease's duration."""
    def run(M):
        path = str(tmp_path / f"pair-{M.pkg}")
        duration = 1.0
        electors = [M.lease.LeaderElector(M.lease.FileLease(path, identity=n, duration=duration),
                                          renew_interval=0.05) for n in ("a", "b")]
        for e in electors:
            e.start()
        try:
            assert wait(lambda: any(e.is_leader for e in electors), 5)
            time.sleep(0.3)
            leaders = [e.is_leader for e in electors]
            leader = electors[leaders.index(True)]
            other = electors[1 - leaders.index(True)]
            t0 = time.monotonic()
            leader.stop()
            took = other.wait_for_leadership(timeout=duration + 2.0)
            return sum(leaders), took, time.monotonic() - t0 < duration + 1.0
        finally:
            for e in electors:
                e.stop()

    assert both(run) == (1, True, True)


def test_file_lease_set(tmp_path):
    """``FileLeaseSet``: membership with expiry, per-key holds, batch
    renewal, takeover after expiry, release."""
    def run(M):
        now = [100.0]
        path = str(tmp_path / f"set-{M.pkg}")
        S = M.lease.FileLeaseSet
        a = S(path, identity="a", duration=10, clock=lambda: now[0])
        b = S(path, identity="b", duration=10, clock=lambda: now[0])
        members = (sorted(a.heartbeat()), sorted(b.heartbeat()))
        holds = (a.try_acquire("p1"), a.try_acquire("p2"), b.try_acquire("p1"),
                 b.try_acquire("p3"))
        renewed = sorted(a.renew_many(["p1", "p2", "p3"]))
        now[0] += 11
        taken = (b.try_acquire("p1"), sorted(a.renew_many(["p1", "p2"])), b.holder("p1"))
        b.release("p1")
        b.release_all()
        a.resign()
        return members, holds, renewed, taken, b.snapshot(), sorted(b.members())

    assert both(run) == ((["a"], ["a", "b"]), (True, True, False, True), ["p1", "p2"],
                         (True, [], "b"), {}, [])


# -- _freeze_gc_when_warm (test_gcpolicy.py) ------------------------------------------


@pytest.mark.parametrize("cancel_first", [True, False])
def test_freeze_gc_when_warm(cancel_first):
    """A worker warming after ``Runtime.stop`` cancelled the wait never
    freezes the heap; one warming while it waits does."""
    def run(M):
        before = gc.get_threshold()
        warmed = threading.Event()
        runtime = types.SimpleNamespace(
            provisioning=types.SimpleNamespace(workers={"p": types.SimpleNamespace(
                warmed=warmed)}),
            _gc_freeze_cancel=None)
        try:
            M.main._freeze_gc_when_warm(runtime, timeout=5.0)
            if cancel_first:
                runtime._gc_freeze_cancel.set()
            warmed.set()
            froze = wait(lambda: gc.get_threshold() != before, 0.5 if cancel_first else 5)
        finally:
            runtime._gc_freeze_cancel.set()
            M.gcpolicy.restore()
        return froze, gc.get_threshold() == before

    assert both(run) == (not cancel_first, True)
