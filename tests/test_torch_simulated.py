"""The port's simulated cloud (``cloudprovider/simulated.py``) against the
JAX package's.

Mirrors ``tests/test_simulated_provider.py`` (``TestCatalog``,
``TestOverheadModel``, ``TestLaunch``, ``TestICE``, ``TestLaunchTemplates``,
``TestLaunchTemplateContents``, ``TestSecurityGroups``,
``TestValidationDefaults``, ``TestEphemeralStorage``, ``TestInstanceProfile``,
``TestEndToEnd``) over the in-process double (the reference's HTTP wire to
it is not ported). Each case runs both packages on the same inputs and a
fake clock and compares exactly: the catalog's ``to_instance_type`` forms,
the launched Node's wire form, the launch templates (names and user data
byte for byte), the ICE overrides and cache, the client-token ledger's
replay of a retried ``create_fleet``, and the ``instance_gone`` sequence.
Instance ids come from each double's own counter, so they compare as they
are.
"""

import importlib
import random
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, fresh_router, pinned, wire_doc  # noqa: F401


def sim(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, s=m("cloudprovider.simulated"), lbl=m("api.labels"), O=m("api.objects"),
        prov=m("api.provisioner"), Requirements=m("api.requirements").Requirements,
        catreq=m("cloudprovider.requirements"), ctypes=m("cloudprovider.types"),
        Cluster=m("kube.client").Cluster, f=m("testing.factories"), res=m("utils.resources"),
        serde=m("kube.serde"), pc=m("controllers.provisioning"),
        Scheduler=m("scheduling.scheduler").Scheduler, itypes=m("interruption.types"),
        cpm=m("cloudprovider.metrics"))


def both(fn):
    out = []
    for pkg in PACKAGES:
        with pinned(pkg):
            out.append(fn(sim(pkg)))
    assert out[1] == out[0]
    return out[1]


def env(M, now=None):
    now = now if now is not None else [1000.0]
    api = M.s.SimCloudAPI()
    return api, M.s.SimulatedCloudProvider(api, clock=lambda: now[0]), now


def constraints_for(M, provider, requirements=None, provider_cfg=None):
    c = M.prov.Constraints(requirements=M.Requirements.new(*(requirements or [])),
                           provider=provider_cfg)
    provider.default(c)
    catalog = provider.get_instance_types(provider_cfg)
    c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
    return c, catalog


def cheapest(catalog):
    return sorted(catalog, key=lambda it: it.effective_price())


def itype_form(it) -> tuple:
    """An InstanceType as ``to_instance_type`` built it."""
    return (it.name, [(o.capacity_type, o.zone) for o in it.offerings], it.architecture,
            sorted(it.operating_systems), sorted(it.resources.items()),
            sorted(it.overhead.items()), it.price, it.effective_price(), dict(it.labels))


def node_form(M, node) -> dict:
    return wire_doc(M, "nodes", node)


def instances(api, tokens=True) -> list:
    """The double's instances; a worker's launch tokens are random, so
    ``tokens=False`` keeps only whether one was stamped."""
    return sorted((i.id, i.instance_type, i.zone, i.capacity_type, i.launch_template, i.state,
                   i.launch_token if tokens else bool(i.launch_token))
                  for i in api.instances.values())


def create(M, provider, c, options, token=""):
    return provider.create(M.ctypes.NodeRequest(template=c, instance_type_options=options,
                                                launch_token=token))


# -- TestCatalog, TestOverheadModel ---------------------------------------------


@pytest.mark.parametrize("cfg", [None, {"subnetSelector": {"Name": "private-a"}},
                                 {"subnetSelector": {"Name": "nope"}}])
def test_catalog_forms_and_cache(cfg):
    """Every ``to_instance_type`` form (metal filtered, offerings from the
    selected subnets' zones), the describe calls across the 5-minute cache,
    or the error for a selector matching nothing."""
    def run(M):
        api, provider, now = env(M)
        try:
            first = [itype_form(it) for it in provider.get_instance_types(cfg)]
        except M.s.CloudAPIError as e:
            return str(e)
        provider.get_instance_types(cfg)
        calls = api.calls["describe_instance_types"]
        now[0] += 301
        provider.get_instance_types(cfg)
        return first, calls, dict(api.calls)

    out = both(run)
    if cfg and cfg["subnetSelector"]["Name"] == "nope":
        assert "no subnets matched" in out
    else:
        assert out[1] == 1 and out[2]["describe_instance_types"] == 2
        assert "sim.metal-96x" not in [f[0] for f in out[0]]


def test_overhead_model_over_shapes():
    def run(M):
        out = []
        for vcpus, mem, nics, ips in ((1, 2, 4, 15), (2, 4, 3, 10), (4, 8, 4, 15),
                                      (48, 192, 8, 30), (96, 384, 15, 50)):
            info = M.s.SimInstanceTypeInfo(name="t", vcpus=vcpus, memory_gib=mem,
                                           max_network_interfaces=nics, ips_per_interface=ips)
            out.append((M.s.network_limited_pods(info), sorted(M.s.compute_overhead(info).items())))
        return out

    out = both(run)
    assert out[2][1][0][1] == pytest.approx(0.18)


# -- TestLaunch, TestICE ---------------------------------------------------------

LAUNCH = ["cheapest", "spot requested", "gpu dropped", "gpu only", "delete terminates"]


@pytest.mark.parametrize("case", LAUNCH)
def test_launch(case):
    """The Node each launch returns (wire form), the double's instances and
    templates, the calls made."""
    def run(M):
        lbl = M.lbl
        api, provider, _ = env(M)
        reqs = [M.O.NodeSelectorRequirement(
            key=lbl.CAPACITY_TYPE, operator="In",
            values=[lbl.CAPACITY_TYPE_SPOT, lbl.CAPACITY_TYPE_ON_DEMAND])] \
            if case == "spot requested" else None
        c, catalog = constraints_for(M, provider, requirements=reqs)
        options = {"cheapest": cheapest(catalog), "gpu only": [
            it for it in catalog if it.resources.get(M.res.NVIDIA_GPU)]}.get(case, catalog)
        node = create(M, provider, c, options)
        if case == "delete terminates":
            provider.delete(node)
        return node_form(M, node), instances(api), api.launch_templates, dict(api.calls)

    node, live, templates, calls = both(run)
    labels = node["metadata"]["labels"]
    assert labels["karpenter.sh/capacity-type"] == ("spot" if case == "spot requested"
                                                     else "on-demand")
    assert ("gpu" in labels["node.kubernetes.io/instance-type"]) == (case == "gpu only")
    assert (live[0][5] == "terminated") == (case == "delete terminates")


@pytest.mark.parametrize("case", ["falls through", "all exhausted"])
def test_ice_overrides_and_cache(case):
    """Exhausted pools: the launch falls through to a healthy type and the
    next catalog read drops the ICE'd offerings; or every override is
    exhausted and the typed error carries them. Then the cache's 45 s
    expiry."""
    def run(M):
        lbl = M.lbl
        api, provider, now = env(M)
        c, catalog = constraints_for(M, provider)
        first = cheapest(catalog)[0]
        for z in ("sim-zone-1a", "sim-zone-1b", "sim-zone-1c"):
            api.insufficient_capacity_pools.add((lbl.CAPACITY_TYPE_ON_DEMAND, first.name, z))
        options = list(catalog) if case == "falls through" else [first]
        try:
            got = node_form(M, create(M, provider, c, options))
        except M.s.InsufficientCapacityError as e:
            got = (str(e), e.overrides)
        unavailable = provider.instance_type_provider.unavailable
        marked = [unavailable.is_unavailable(lbl.CAPACITY_TYPE_ON_DEMAND, first.name, z)
                  for z in ("sim-zone-1a", "sim-zone-1b", "sim-zone-1c")]
        refreshed = [itype_form(it) for it in provider.get_instance_types()]
        now[0] += 46
        expired = unavailable.is_unavailable(lbl.CAPACITY_TYPE_ON_DEMAND, first.name,
                                             "sim-zone-1a")
        return got, marked, refreshed, expired, instances(api)

    got, marked, refreshed, expired, live = both(run)
    assert marked == [True] * 3 and not expired
    if case == "all exhausted":
        assert len(got[1]) == 3 and live == []


# -- TestLaunchTemplates, TestLaunchTemplateContents, TestSecurityGroups,
#    TestInstanceProfile ---------------------------------------------------------

TEMPLATES = {
    "identical share one": None,
    "labels differ": None,
    "gpu image": None,
    "byo template": {"launchTemplate": "my-custom-lt"},
    "user data": None,
    "minimal toml": {"imageFamily": "minimal"},
    "bdm and metadata": {"blockDeviceMappings": [
        {"deviceName": "/dev/xvdb", "volumeSize": 100, "volumeType": "gp3"}],
        "metadataOptions": {"httpTokens": "optional"}},
    "extra groups": {"securityGroupSelector": {"purpose": "extra"}},
    "no groups": {"securityGroupSelector": {"purpose": "nope"}},
    "profile": {"instanceProfile": "overridden-profile"},
}


@pytest.mark.parametrize("case", list(TEMPLATES))
def test_launch_templates(case):
    """The double's launch templates after the case's launches: each name
    (a hash of the template's JSON) and its data, user data byte for byte,
    or the error of a selector matching no security group."""
    def run(M):
        api, provider, _ = env(M)
        cfg = TEMPLATES[case]
        c, catalog = constraints_for(M, provider, provider_cfg=cfg)
        c.provider = cfg
        options = cheapest(catalog)
        if case == "gpu image":
            options = [it for it in catalog if it.resources.get(M.res.NVIDIA_GPU)]
        if case in ("user data", "minimal toml"):
            c.labels = {"team": "infra"}
        if case == "user data":
            c.taints = [M.O.Taint(key="dedicated", value="gpu", effect="NoSchedule")]
            c.kubelet_configuration = M.prov.KubeletConfiguration(cluster_dns=["10.0.0.10"])
        try:
            nodes = [create(M, provider, c, options)]
            if case in ("identical share one", "labels differ"):
                c2, _ = constraints_for(M, provider)
                if case == "labels differ":
                    c2.labels = {"team": "a"}
                nodes.append(create(M, provider, c2, options))
        except Exception as e:
            return type(e).__name__, str(e)
        user_data = M.s.bootstrap_user_data((cfg or {}).get("imageFamily", "standard"), c)
        return api.launch_templates, [node_form(M, n) for n in nodes], instances(api), user_data

    out = both(run)
    if case == "no groups":
        assert "security groups" in out[1]
        return
    templates, _, live, user_data = out
    assert len(templates) == {"labels differ": 2, "byo template": 0}.get(case, 1)
    if case == "byo template":
        assert live[0][4] == "my-custom-lt"
    if case == "user data":
        assert user_data == ("/etc/bootstrap.sh --node-labels=team=infra "
                             "--register-with-taints=dedicated=gpu:NoSchedule "
                             "--cluster-dns=10.0.0.10")
    if case == "minimal toml":
        assert user_data == '[settings.kubernetes]\nnode-labels = "team=infra"'


# -- TestValidationDefaults and the config parse -----------------------------------

VALIDATE = [
    {"blockDeviceMappings": [{"volumeSize": -1}]},
    {"metadataOptions": {"httpTokens": "never"}},
    {"blockDeviceMappings": [{"volumeSize": "100Gi"}]},
    {"metadataOptions": None},
    {"blockDeviceMappings": "nope"},
    {"launchTemplate": "mine", "metadataOptions": {"httpTokens": "optional"}},
    {"launchTemplate": "mine", "blockDeviceMappings": [{"deviceName": "/dev/xvda"}]},
    {"launchTemplate": "mine", "securityGroupSelector": {"purpose": "nodes"}},
    {"imageFamily": "nope"},
    {"tags": {"karpenter.sh/provisioner-name": "x"}},
    {"subnetSelector": {}},
    {"blockDeviceMappings": [{"encrypted": "false", "volumeType": "io9"}]},
    None,
]


@pytest.mark.parametrize("i", range(len(VALIDATE)))
def test_validation_and_parse(i):
    def run(M):
        cfg = VALIDATE[i]
        parsed = M.s.SimProviderConfig.deserialize(cfg)
        return (M.s.SimulatedCloudProvider(M.s.SimCloudAPI()).validate(
            M.prov.Constraints(provider=cfg)),
            [vars(b) for b in parsed.block_device_mappings], vars(parsed.metadata_options),
            parsed.security_group_selector_specified, parsed.metadata_options_specified)

    errs = both(run)[0]
    assert (errs == []) == (VALIDATE[i] in (None, {"metadataOptions": None}))


@pytest.mark.parametrize("preset", [None, "spot"])
def test_defaults(preset):
    def run(M):
        lbl = M.lbl
        reqs = [M.O.NodeSelectorRequirement(key=lbl.CAPACITY_TYPE, operator="In",
                                            values=[lbl.CAPACITY_TYPE_SPOT])] if preset else []
        c = M.prov.Constraints(requirements=M.Requirements.new(*reqs))
        M.s.SimulatedCloudProvider(M.s.SimCloudAPI()).default(c)
        return sorted(c.requirements.capacity_types()), sorted(c.requirements.architectures())

    assert both(run) == ([preset or "on-demand"], ["amd64"])


# -- TestEphemeralStorage, TestEndToEnd ----------------------------------------------


@pytest.mark.parametrize("storage", ["1Gi", "1Pi"])
@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_ephemeral_storage_plan(storage, solver):
    """Pods asking for ephemeral storage against the simulated catalog: the
    plan (pods by index, the node's types) from both packages' schedulers,
    the port's on ``device="cpu"``. An oversized ask places nothing."""
    def run(M):
        api, provider, _ = env(M)
        prov = M.f.make_provisioner(solver=solver)
        c = prov.spec.constraints
        provider.default(c)
        catalog = provider.get_instance_types()
        c.requirements = c.requirements.merge(M.catreq.catalog_requirements(catalog))
        pods = [M.f.make_pod(requests={"cpu": "0.5", "ephemeral-storage": storage})
                for _ in range(4)]
        kw = {"device": "cpu"} if M.pkg == "karpenter_tpu_torch" else {}
        nodes = M.Scheduler(M.Cluster(), rng=random.Random(1), **kw).solve(prov, catalog, pods)
        index = {id(p): i for i, p in enumerate(pods)}
        return [([it.name for it in n.instance_type_options], [index[id(p)] for p in n.pods])
                for n in nodes]

    plan = both(run)
    assert sum(len(p) for _, p in plan) == (4 if storage == "1Gi" else 0)


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_end_to_end_provisioning(solver):
    """Pending pods -> solve -> fleet launch -> bind through the simulated
    cloud: the Nodes' wire forms, each pod's node, the instances."""
    def run(M):
        api, provider, _ = env(M)
        cluster = M.Cluster(clock=lambda: 1000.0)
        kw = {"device": "cpu"} if M.pkg == "karpenter_tpu_torch" else {}
        controller = M.pc.ProvisioningController(cluster, provider, start_workers=False, **kw)
        provisioner = M.f.make_provisioner(solver=solver)
        cluster.create("provisioners", provisioner)
        pods = [M.f.make_pod(name=f"p-{i}", requests={"cpu": "1"}) for i in range(5)]
        for p in pods:
            cluster.create("pods", p)
        controller.apply(provisioner)
        worker = controller.workers[provisioner.name]
        for p in pods:
            worker.batcher.add(p)
        worker.batcher.idle_duration = 0.01
        vnodes = worker.provision_once()
        controller.stop()
        return (len(vnodes), sorted(wire_doc(M, "nodes", n)["metadata"]["name"]
                                    for n in cluster.nodes()),
                [cluster.get("pods", p.metadata.name).spec.node_name for p in pods],
                instances(api, tokens=False))

    n, nodes, bound, live = both(run)
    assert n and all(bound) and nodes[0].startswith("i-")


# -- the token ledger, the disruption bus, liveness ------------------------------------


@pytest.mark.parametrize("case", ["same token", "tokenless", "terminate releases",
                                  "metered retry"])
def test_token_ledger(case):
    """A retried create with the same launch token replays the committed
    instance; token-less creates stay distinct; a terminated instance's
    token launches fresh; the metered provider's retry after a committed
    create whose answer was lost yields one instance."""
    def run(M):
        api, provider, _ = env(M)
        c, catalog = constraints_for(M, provider)
        token = "" if case == "tokenless" else "tok-sim"
        if case == "metered retry":
            # decorated first: the retry policy reads the create's marker then
            metered = M.cpm.decorate(provider)
            real, armed = provider.create, [True]

            def commit_then_die(request):
                node = real(request)
                if armed.pop() if armed else False:
                    raise ConnectionError("response lost after commit")
                return node

            provider.create = commit_then_die
            n1 = metered.create(M.ctypes.NodeRequest(template=c, instance_type_options=catalog,
                                                     launch_token=token))
            return node_form(M, n1), instances(api), [
                (i.id, i.launch_token) for i in metered.list_instances()]
        n1 = create(M, provider, c, catalog, token)
        if case == "terminate releases":
            api.terminate_instances([n1.metadata.name])
        n2 = create(M, provider, c, catalog, token)
        return (node_form(M, n1), node_form(M, n2), instances(api),
                [(i.id, i.launch_token, i.provider_id) for i in provider.list_instances()])

    out = both(run)
    if case == "same token":
        assert out[0] == out[1] and len(out[2]) == 1
    elif case == "metered retry":
        assert len(out[1]) == 1
    else:
        assert out[0] != out[1]


def test_disruption_bus_and_requeue():
    def run(M):
        I = M.itypes
        api, provider, _ = env(M)
        api.send_disruption_notice(I.DisruptionNotice(kind=I.PREEMPTION, node_name="i-0001",
                                                      grace_period_seconds=90.0))
        first = [(n.kind, n.node_name, n.grace_period_seconds) for n in provider.poll_disruptions()]
        again = provider.poll_disruptions()
        requeued = provider.requeue_disruption(I.DisruptionNotice(kind=I.MAINTENANCE,
                                                                  node_name="i-0002"))
        return first, again, requeued, [n.node_name for n in provider.poll_disruptions()]

    assert both(run) == ([("preemption", "i-0001", 90.0)], [], True, ["i-0002"])


def test_instance_gone_sequence():
    """``instance_gone`` over a live instance, then misses debounced to the
    third, an errored describe (unknown, no count), a typed NotFound and a
    terminated instance."""
    def run(M):
        api, provider, _ = env(M)
        c, catalog = constraints_for(M, provider)
        node = create(M, provider, c, catalog)
        other = create(M, provider, c, catalog)
        out = [provider.instance_gone(node)]
        del api.instances[node.metadata.name]
        out += [provider.instance_gone(node) for _ in range(2)]
        api.inject_error("describe_instances", M.s.CloudAPIError("flaky"))
        out.append(provider.instance_gone(node))
        out.append(provider.instance_gone(node))
        api.inject_error("describe_instances", M.s.InstanceNotFoundError("gone"))
        out.append(provider.instance_gone(other))
        api.terminate_instances([other.metadata.name])
        out.append(provider.instance_gone(other))
        return out, provider.name()

    assert both(run) == ([False, False, False, None, True, True, True], "simulated")
