"""The port's HTTP wire to the simulated clouds (``cloudprovider/httpapi.py``)
against the JAX package's.

Mirrors every class of ``tests/test_cloud_httpapi.py`` (``TestPagination``,
``TestRetries``, ``TestFleetWire``, ``TestGkeWire``, ``TestRegistryWiring``,
``TestRuntimeOverWire``, ``TestProviderOverWire``) and the ``http``
parametrizations of the simulated cloud's tests: the reference's
``test_simulated_provider.py`` suite over the wire (the port's
``tests/test_torch_simulated.py`` cases re-run with ``env`` serving the
double through ``CloudAPIServer``), the idempotent creates and the crash
recovery of ``test_launch_journal.py`` over ``CloudAPIServer`` and
``GkeAPIServer``, and the disruption-event routes of
``test_interruption.py``. Each case runs on both packages, each over its own
localhost server, and the results compare exactly under
``torch_parity.canon``: what came back, the double's call counts, the
client's retries, the typed errors. Both packages' process-shared retry
budgets are reset around each test (the wire spends from them).
"""

import contextlib
import dataclasses
import time

import pytest

import test_torch_simulated as simcases
from torch_parity import PACKAGES, both_canon, fresh_router, on_cpu, proc, wire_doc  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_budgets():
    for pkg in PACKAGES:
        proc(pkg).overload.reset_default_retry_budget()
    yield
    for pkg in PACKAGES:
        proc(pkg).overload.reset_default_retry_budget()


def both(fn):
    return both_canon(fn, ns=proc)


@contextlib.contextmanager
def wire(M, page_size=None):
    """(api, server, client): a SimCloudAPI served over localhost and the
    wire client at a short backoff."""
    api = M.sim.SimCloudAPI()
    kw = {} if page_size is None else {"page_size": page_size}
    server = M.http.CloudAPIServer(api, **kw).start()
    try:
        yield api, server, M.http.HttpCloudAPI(server.url, backoff_base=0.01)
    finally:
        server.stop()


@contextlib.contextmanager
def gke_wire(M):
    api = M.gke.SimGkeAPI()
    server = M.http.GkeAPIServer(api).start()
    try:
        yield api, server, M.http.HttpGkeAPI(server.url, backoff_base=0.01)
    finally:
        server.stop()


def asdicts(items) -> list:
    return [dataclasses.asdict(i) for i in items]


def outcome(fn):
    """``fn()``'s value, or the name of the exception it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the class
        return (type(e).__name__, None)


# -- TestPagination -------------------------------------------------------------


@pytest.mark.parametrize("page_size", [None, 100])
def test_instance_types_span_pages(page_size):
    def run(M):
        with wire(M) as (api, server, client):
            client.page_size = page_size
            got = client.describe_instance_types()
            assert [i.name for i in got] == [i.name for i in api.catalog]
            return asdicts(got), dict(api.calls)

    got, calls = both(run)
    # 11 catalog entries at the server's page size 3: four paged GETs
    assert calls["describe_instance_types"] == (4 if page_size is None else 1)


# -- TestRetries ----------------------------------------------------------------

RETRIES = ["throttle", "5xx", "exhausted", "ice", "unknown route"]


@pytest.mark.parametrize("case", RETRIES)
def test_retries(case):
    def run(M):
        with wire(M) as (api, server, client):
            if case == "throttle":
                api.inject_error("describe_subnets", M.http.ThrottlingError(retry_after=0.01))
                got = outcome(lambda: asdicts(client.describe_subnets({"purpose": "nodes"})))
            elif case == "5xx":
                api.inject_error("describe_security_groups",
                                 M.sim.CloudAPIError("control plane down"))
                got = outcome(lambda: asdicts(client.describe_security_groups(
                    {"purpose": "nodes"})))
            elif case == "exhausted":
                for _ in range(10):
                    api.inject_error("describe_subnets", M.sim.CloudAPIError("still down"))
                got = outcome(lambda: client.describe_subnets({}))
            elif case == "ice":
                api.inject_error("create_fleet", M.sim.InsufficientCapacityError("no pool"))
                got = outcome(lambda: client.create_fleet(
                    "on-demand", [("lt", "sim.gp-4x", "sim-zone-1a")]))
            else:
                got = outcome(lambda: client._request("GET", "/v1/no-such-thing"))
            return got, client.retries, client.max_attempts, dict(api.calls)

    got, retries, attempts, _ = both(run)
    want = {"throttle": ("ok", 1), "5xx": ("ok", 1),
            "exhausted": ("CloudAPIError", attempts - 1),
            "ice": ("InsufficientCapacityError", 0), "unknown route": ("CloudAPIError", 0)}
    assert (got[0], retries) == want[case]


def test_retry_budget_dry_stops_the_wire_retrying():
    """A dry ``wire`` budget makes a retryable 5xx final on its first
    attempt, and the metric says so (``budget_exhausted``)."""
    def run(M):
        labels = {"dependency": "wire", "outcome": "budget_exhausted"}
        before = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                     labels) or 0.0
        budget = M.overload.default_retry_budget()
        while budget.try_spend("wire"):
            pass
        with wire(M) as (api, server, client):
            api.inject_error("describe_subnets", M.sim.CloudAPIError("down"))
            got = outcome(lambda: client.describe_subnets({}))
            after = M.metrics.REGISTRY.get_sample_value("karpenter_resilience_retries_total",
                                                        labels)
            return got, client.retries, after - before, budget.remaining("wire")

    got, retries, exhausted, left = both(run)
    assert (got[0], retries, exhausted) == ("CloudAPIError", 0, 1.0) and left < 1.0


# -- TestFleetWire --------------------------------------------------------------


def test_retried_fleet_post_does_not_double_launch():
    import json
    import urllib.request

    def run(M):
        with wire(M) as (api, server, client):
            body = json.dumps({
                "capacityType": "on-demand",
                "overrides": [{"launchTemplate": "lt", "instanceType": "sim.gp-4x",
                               "zone": "sim-zone-1a"}],
                "clientToken": "tok-1",
            }).encode()

            def post():
                req = urllib.request.Request(server.url + "/v1/fleet", data=body, method="POST",
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    return json.loads(r.read())

            first, second = post(), post()
            return first == second, len(api.instances), _no_created_at(first)

    same, n, _ = both(run)
    assert same and n == 1


FLEET = ["blank tag", "missing field", "per-override ice", "terminate", "template quoting"]


@pytest.mark.parametrize("case", FLEET)
def test_fleet_wire(case):
    def run(M):
        with wire(M) as (api, server, client):
            if case == "blank tag":
                got = (sorted(s.id for s in client.describe_subnets({"Name": ""})),
                       client.describe_security_groups({"Name": ""}))
            elif case == "missing field":
                got = (outcome(lambda: client._request("POST", "/v1/fleet", {"overrides": []})),
                       api.calls.get("create_fleet"))
            elif case == "per-override ice":
                api.insufficient_capacity_pools.add(("on-demand", "sim.gp-4x", "sim-zone-1a"))
                instances, errors = client.create_fleet(
                    "on-demand",
                    [("lt", "sim.gp-4x", "sim-zone-1a"), ("lt", "sim.gp-8x", "sim-zone-1b")])
                described = client.describe_instances([instances[0].id])
                got = (_no_created_at(asdicts(instances)), errors, [i.id for i in described])
            elif case == "terminate":
                instances, _ = client.create_fleet("on-demand",
                                                   [("lt", "sim.gp-2x", "sim-zone-1b")])
                client.terminate_instances([instances[0].id])
                got = api.instances[instances[0].id].state
            else:
                name = "karpenter/lt: weird name+chars"
                made = client.ensure_launch_template(name, {"k": "v"})
                present = name in api.launch_templates
                client.delete_launch_template(name)
                got = (made == name, present, name in api.launch_templates)
            return got, client.retries

    got, retries = both(run)
    assert retries == 0
    if case == "blank tag":
        assert got == (["subnet-1", "subnet-2", "subnet-3"], [])
    elif case == "missing field":
        assert got == (("CloudAPIError", None), None)
    elif case == "per-override ice":
        assert got[1] == [("on-demand", "sim.gp-4x", "sim-zone-1a")]
        assert [i["instance_type"] for i in got[0]] == ["sim.gp-8x"] and len(got[2]) == 1
    elif case == "terminate":
        assert got == "terminated"
    else:
        assert got == (True, True, False)


# -- TestGkeWire ----------------------------------------------------------------

GKE = ["round trip", "stockout", "bad request", "multi-host atomic", "provider ice"]


@pytest.mark.parametrize("case", GKE)
def test_gke_wire(case):
    def run(M):
        with gke_wire(M) as (api, server, client):
            if case == "round trip":
                pool = client.create_node_pool("ct5lp-hightpu-4t", "us-central1-a", False, 2)
                made = dataclasses.asdict(pool)
                client.delete_instance(pool.instances[0].name)
                left = len(api.node_pools[pool.name].instances)
                client.delete_node_pool(pool.name)
                got = (made, left, pool.name in api.node_pools)
            elif case == "stockout":
                api.set_stockout("ct5lp-hightpu-4t", "us-central1-a")
                got = outcome(lambda: client.create_node_pool(
                    "ct5lp-hightpu-4t", "us-central1-a", False, 4))
            elif case == "bad request":
                got = outcome(lambda: client.create_node_pool(
                    "ct5lp-hightpu-4t", "us-central1-a", False, 0))
            elif case == "multi-host atomic":
                pool = client.create_node_pool("ct5lp-hightpu-4t", "us-central1-a", False, 4,
                                               tpu_topology="4x4")
                api.set_stockout("ct5lp-hightpu-4t", "us-central1-b")
                second = outcome(lambda: client.create_node_pool(
                    "ct5lp-hightpu-4t", "us-central1-b", False, 4))
                got = (dataclasses.asdict(pool), len(api.node_pools[pool.name].instances),
                       second, len(api.node_pools))
            else:
                provider = M.gke.GkeCloudProvider(api=client)
                c = M.prov_api.Constraints(requirements=M.Requirements.new())
                provider.default(c)
                catalog = provider.get_instance_types()
                c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
                node = provider.create(M.ctypes.NodeRequest(template=c,
                                                            instance_type_options=catalog))
                got = wire_doc(M, "nodes", node)
            # created_at is the double's wall clock
            return _no_created_at(got), client.retries

    got, retries = both(run)
    assert retries == 0
    if case == "round trip":
        assert len(got[0]["instances"]) == 2 and got[1:] == [1, False]
    elif case in ("stockout",):
        assert got[0] == "GkeStockoutError"
    elif case == "bad request":
        assert got[0] == "GkeApiError"
    elif case == "multi-host atomic":
        pool, hosts, second, pools = got
        assert pool["tpu_topology"] == "4x4" and len(pool["instances"]) == 4 and hosts == 4
        assert {i["node_pool"] for i in pool["instances"]} == {pool["name"]}
        assert second[0] == "GkeStockoutError" and pools == 1
    else:
        assert got["metadata"]["name"].startswith("gke-")


def _no_created_at(value):
    """``value`` without the doubles' wall-clock ``created_at`` stamps, and
    with the wire's random per-call client tokens shown as ``<wire>``."""
    import re

    if isinstance(value, dict):
        return {k: _no_created_at(v) for k, v in value.items() if k != "created_at"}
    if isinstance(value, (list, tuple)):
        return [_no_created_at(v) for v in value]
    if isinstance(value, str) and re.fullmatch(r"[0-9a-f]{32}", value):
        return "<wire>"
    return value


# -- TestRegistryWiring, TestProviderOverWire, TestRuntimeOverWire -------------


def test_http_backed_providers_constructible_by_name(monkeypatch):
    def run(M):
        with wire(M) as (api, server, client):
            provider = M.registry.new_cloud_provider("simulated-http", url=server.url)
            got = (provider.name(), len(provider.get_instance_types()), len(api.catalog))
        monkeypatch.delenv("KARPENTER_CLOUD_API_URL", raising=False)
        return got, outcome(lambda: M.registry.new_cloud_provider("simulated-http"))

    (name, n, catalog), missing = both(run)
    assert name == "simulated" and n == catalog - 1  # metal filtered
    assert missing[0] == "ValueError"


def test_provider_survives_transient_throttle_during_launch():
    def run(M):
        with wire(M) as (api, server, client):
            provider = M.sim.SimulatedCloudProvider(client)
            c = M.prov_api.Constraints(requirements=M.Requirements.new())
            provider.default(c)
            catalog = provider.get_instance_types()
            c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
            api.inject_error("create_fleet", M.http.ThrottlingError(retry_after=0.01))
            node = provider.create(M.ctypes.NodeRequest(template=c, instance_type_options=catalog))
            return wire_doc(M, "nodes", node), client.retries

    node, retries = both(run)
    assert node["metadata"]["name"].startswith("i-") and retries >= 1


def wait(predicate, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


def test_full_control_plane_provisions_over_the_wire(monkeypatch):
    """``build_runtime`` with ``--cloud-provider simulated-http`` (the
    provider built by registry name from ``KARPENTER_CLOUD_API_URL``):
    selection, batcher, solve, launch and bind, every cloud call over
    HTTP."""
    def run(M):
        with wire(M) as (api, server, client):
            monkeypatch.setenv("KARPENTER_CLOUD_API_URL", server.url)
            cluster = M.Cluster()
            rt = M.main.build_runtime(
                M.options.Options(**on_cpu(M, {"cloud_provider": "simulated-http",
                                               "default_solver": "ffd"})),
                cluster=cluster)
            rt.manager.start()
            try:
                cluster.create("provisioners", M.f.make_provisioner(solver="ffd"))
                assert wait(lambda: rt.provisioning.workers, 10)
                for w in rt.provisioning.workers.values():
                    w.batcher.idle_duration = 0.1
                for i in range(4):
                    cluster.create("pods", M.f.make_pod(name=f"wire-{i}", requests={"cpu": "1"}))
                assert wait(lambda: all(cluster.get("pods", f"wire-{i}").spec.node_name
                                        for i in range(4)), 30)
                return (rt.cloud_provider.name(), api.calls.get("create_fleet", 0) >= 1,
                        sorted(i.state for i in api.instances.values()))
            finally:
                rt.stop()

    name, fleet, states = both(run)
    assert name == "simulated" and fleet and "running" in states


# -- the simulated cloud's suite over the wire -----------------------------------


@pytest.fixture
def over_http(monkeypatch):
    """``test_torch_simulated.env`` serving its SimCloudAPI through
    ``CloudAPIServer`` (one page), the provider over ``HttpCloudAPI``: the
    reference's ``http`` parametrization of ``test_simulated_provider.py``.
    A token-less create crosses the wire with a fresh random client token
    (``HttpCloudAPI.create_fleet``), so ``instances`` shows such a token as
    ``<wire>``."""
    import re

    servers = []
    listed = simcases.instances

    def instances(api, tokens=True):
        return [i[:-1] + ("<wire>" if isinstance(i[-1], str)
                          and re.fullmatch(r"[0-9a-f]{32}", i[-1]) else i[-1],)
                for i in listed(api, tokens)]

    def env(M, now=None):
        now = now if now is not None else [1000.0]
        api = M.s.SimCloudAPI()
        http = proc(M.pkg).http
        server = http.CloudAPIServer(api, page_size=10_000).start()
        servers.append(server)
        provider = M.s.SimulatedCloudProvider(http.HttpCloudAPI(server.url, backoff_base=0.01),
                                              clock=lambda: now[0])
        return api, provider, now

    monkeypatch.setattr(simcases, "env", env)
    monkeypatch.setattr(simcases, "instances", instances)
    yield
    for server in servers:
        server.stop()


@pytest.mark.parametrize("cfg", [None, {"subnetSelector": {"Name": "private-a"}},
                                 {"subnetSelector": {"Name": "nope"}}])
def test_simulated_catalog_over_http(over_http, cfg):
    simcases.test_catalog_forms_and_cache(cfg)


@pytest.mark.parametrize("case", simcases.LAUNCH)
def test_simulated_launch_over_http(over_http, case):
    simcases.test_launch(case)


@pytest.mark.parametrize("case", ["falls through", "all exhausted"])
def test_simulated_ice_over_http(over_http, case):
    simcases.test_ice_overrides_and_cache(case)


@pytest.mark.parametrize("case", list(simcases.TEMPLATES))
def test_simulated_launch_templates_over_http(over_http, case):
    simcases.test_launch_templates(case)


@pytest.mark.parametrize("storage", ["1Gi", "1Pi"])
@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_simulated_ephemeral_storage_over_http(over_http, storage, solver):
    simcases.test_ephemeral_storage_plan(storage, solver)


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_simulated_end_to_end_over_http(over_http, solver):
    simcases.test_end_to_end_provisioning(solver)


# "tokenless" stays in process: over the wire each token-less create carries
# a fresh random client token, which the case lists as it is
@pytest.mark.parametrize("case", ["same token", "terminate releases", "metered retry"])
def test_simulated_token_ledger_over_http(over_http, case):
    simcases.test_token_ledger(case)


def test_simulated_disruption_bus_over_http(over_http):
    simcases.test_disruption_bus_and_requeue()



# -- test_launch_journal.py / test_interruption.py over the wire -----------------


@contextlib.contextmanager
def cloud_over_http(M, kind):
    """``sim``: SimulatedCloudProvider over CloudAPIServer; ``gke``:
    GkeCloudProvider over GkeAPIServer. Yields (double, provider)."""
    if kind == "sim":
        api = M.sim.SimCloudAPI()
        server = M.http.CloudAPIServer(api, page_size=10_000).start()
        provider = M.sim.SimulatedCloudProvider(M.http.HttpCloudAPI(server.url,
                                                                    backoff_base=0.01))
    else:
        api = M.gke.SimGkeAPI()
        server = M.http.GkeAPIServer(api).start()
        provider = M.gke.GkeCloudProvider(api=M.http.HttpGkeAPI(server.url, backoff_base=0.01))
    try:
        yield api, provider
    finally:
        server.stop()


def request_for(M, provider, token):
    c = M.prov_api.Constraints(requirements=M.Requirements.new())
    provider.default(c)
    catalog = provider.get_instance_types()
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    return M.ctypes.NodeRequest(template=c, instance_type_options=catalog, launch_token=token)


def live(provider) -> list:
    return sorted((i.id, i.launch_token, i.instance_type, i.zone, i.capacity_type)
                  for i in provider.list_instances())


@pytest.mark.parametrize("kind", ["sim", "gke"])
@pytest.mark.parametrize("case", ["same token", "tokens listed", "terminate releases token"])
def test_idempotent_create_over_http(kind, case):
    """``TestIdempotentCreateSimulated`` / ``TestIdempotentCreateGke`` over
    the wire: a replayed token returns the committed host, the inventory
    crosses with its tokens, a terminated host's token launches fresh."""
    def run(M):
        with cloud_over_http(M, kind) as (api, provider):
            if case == "tokens listed":
                provider.create(request_for(M, provider, "tok-a"))
                provider.create(request_for(M, provider, "tok-b"))
                return live(provider), all(i.created_at > 0 for i in provider.list_instances())
            req = request_for(M, provider, "tok-x")
            n1 = provider.create(req)
            if case == "terminate releases token":
                provider.delete(n1)
            n2 = provider.create(req)
            return (wire_doc(M, "nodes", n1), n1.metadata.name == n2.metadata.name, live(provider),
                    n1.metadata.annotations[M.lbl.LAUNCH_TOKEN_ANNOTATION])

    out = both(run)
    if case == "tokens listed":
        assert [i[1] for i in out[0]] == ["tok-a", "tok-b"] and out[1]
    else:
        assert out[1] == (case == "same token") and out[3] == "tok-x" and len(out[2]) == 1


@pytest.mark.parametrize("kind", ["sim", "gke"])
def test_disruption_events_and_requeue_over_http(kind):
    """``TestDisruptionSources``' HTTP routes and ``TestWireRequeue``: a
    notice sent on the double's bus is polled over the wire with every
    field, drained once; a requeued notice crosses back."""
    def run(M):
        with cloud_over_http(M, kind) as (api, provider):
            api.send_disruption_notice(M.itypes.DisruptionNotice(
                kind=M.itypes.PREEMPTION, node_name="n-1", grace_period_seconds=45.0,
                reason="spot reclaim"))
            first = [n.to_wire() for n in provider.poll_disruptions()]
            again = provider.poll_disruptions()
            requeued = provider.requeue_disruption(M.itypes.DisruptionNotice(
                kind=M.itypes.MAINTENANCE, node_name="n-2", grace_period_seconds=60))
            return first, again, requeued, [n.to_wire() for n in provider.poll_disruptions()]

    first, again, requeued, back = both(run)
    assert len(first) == 1 and again == [] and requeued is True and len(back) == 1
