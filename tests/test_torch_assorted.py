"""The port's solve over the upstream assorted catalog
(``instance_types_assorted()``: 1,344 types of one offering, one OS and one
arch each, 5 pods a type) with pods pinned by a node selector or by required
node affinity to an arch, an OS, a zone or a capacity type: the spans of
what such a batch works, ``pack.redispatch`` (a saturated first table's
full-table retry), ``decode.options`` (the surviving-type rows and their
options lists) and ``encode.closure`` (the signature closure), their
attributes and their clocks in the stage profile.

Every solve is pinned to ``KARPENTER_PACKER=fused`` (a ``device="cpu"``
scheduler's plain fused path), and the first table is cut with
``backend.N_MAX_FIRST`` where a test needs it to saturate.
"""

from __future__ import annotations

import random

import pytest

import karpenter_tpu_torch.obs as T_OBS
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
from karpenter_tpu_torch.cloudprovider.fake import instance_types_assorted
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.solver import backend
from karpenter_tpu_torch.testing.factories import make_pod, make_provisioner
from torch_parity import PORT_SPAN_ATTRS, packer, port_spans_sit

ZONE = "topology.kubernetes.io/zone"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
# the pod-side forms of the upstream cheapest-instance cases
# (scheduling/instance_selection_test.go:37-70)
FORMS = (
    {},
    {ARCH: "amd64"},
    {ARCH: "arm64"},
    {OS: "windows"},
    {OS: "linux"},
    {ZONE: "test-zone-2"},
    {CAPACITY_TYPE: "spot"},
    {CAPACITY_TYPE: "spot", ZONE: "test-zone-1"},
    {CAPACITY_TYPE: "spot", ZONE: "test-zone-2", ARCH: "amd64", OS: "linux"},
)
N_PODS = 270  # 54 nodes and more: each type holds 5 pods
SMALL_TABLE = 16


@pytest.fixture(autouse=True)
def _fresh_obs():
    T_OBS.reset_for_tests()
    with packer("fused"):
        yield
    T_OBS.reset_for_tests()


@pytest.fixture(scope="module")
def catalog():
    return instance_types_assorted()


def pinned_pods(n: int, seed: int) -> list:
    """``n`` pods, form ``i % len(FORMS)`` at position ``i``, each pinned
    form a selector or an affinity term of ``In`` expressions by the seed."""
    rng = random.Random(seed)
    pods = []
    for i in range(n):
        form = FORMS[i % len(FORMS)]
        kw = {}
        if form and rng.random() < 0.5:
            kw["node_selector"] = dict(form)
        elif form:
            kw["node_requirements"] = [NodeSelectorRequirement(k, "In", [v])
                                       for k, v in form.items()]
        requests = {"cpu": f"{rng.choice([100, 250, 500, 1000, 1500])}m",
                    "memory": f"{rng.choice([100, 256, 512, 1024, 2048])}Mi"}
        pods.append(make_pod(labels={"my-label": rng.choice("abc")}, requests=requests, **kw))
    return pods


def solve(catalog, pods, sched=None):
    """One solve; returns the plan, the profile, the decision context's
    batch, the round's span tree and the scheduler."""
    sched = sched or Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    T_OBS.exporter().clear()
    nodes = sched.solve(make_provisioner(solver="tpu"), catalog, pods)
    (tree,) = T_OBS.exporter().trees()
    index = {id(p): i for i, p in enumerate(pods)}
    plan = [([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
             n.requests) for n in nodes]
    batch = sched.last_decision_context()["batch"]
    return plan, sched.last_stage_profile(), batch, tree, sched


def spans(tree: dict, name: str) -> list:
    found = [tree] if tree["name"] == name else []
    for c in tree["children"]:
        found += spans(c, name)
    return found


def test_a_saturated_first_table_redispatches_under_its_span(monkeypatch, catalog):
    pods = pinned_pods(N_PODS, 7)
    want, whole, _, tree, _ = solve(catalog, pods)
    assert whole["pack_dispatches"] == 1 and whole["pack_redispatch_s"] == 0.0
    assert spans(tree, "pack.redispatch") == []
    monkeypatch.setattr(backend, "N_MAX_FIRST", SMALL_TABLE)
    got, prof, batch, tree, _ = solve(catalog, pods)
    assert got == want and len(got) > SMALL_TABLE
    assert prof["packer_backend"] == "pack_reference"
    assert prof["pack_dispatches"] == 2
    port_spans_sit(tree)
    fetch = tree["children"][4]
    (redispatch,) = spans(tree, "pack.redispatch")
    assert fetch["children"][-1] is redispatch
    p = len(batch.pod_valid)
    assert redispatch["attrs"] == {"n_max_first": SMALL_TABLE, "n_max": p,
                                   "n_nodes_first": SMALL_TABLE}
    assert [s["attrs"]["n_max"] for s in spans(tree, "pack.launch")] == [SMALL_TABLE, p]
    # the clock runs inside its span, which runs inside solve.pack_fetch
    assert 0 < prof["pack_redispatch_s"] * 1e3 <= redispatch["duration_ms"]
    assert redispatch["duration_ms"] <= fetch["duration_ms"]
    assert prof["pack_redispatch_s"] <= prof["pack_fetch_s"]


def test_each_split_unpacks_only_its_tables_live_rows(monkeypatch, catalog):
    """The saturated first table's split unpacks all its rows, the full
    table's only the plan's nodes, and the plan is the unpatched one."""
    pods = pinned_pods(N_PODS, 8)
    want, _, _, _, _ = solve(catalog, pods)
    monkeypatch.setattr(backend, "N_MAX_FIRST", SMALL_TABLE)
    got, prof, batch, tree, _ = solve(catalog, pods)
    assert got == want and prof["pack_dispatches"] == 2
    assert [s["attrs"] for s in spans(tree, "pack.split")] == [
        {"rows": SMALL_TABLE, "n_max": SMALL_TABLE},
        {"rows": len(got), "n_max": len(batch.pod_valid)},
    ]


def test_decode_options_counts_the_plans_nodes_over_the_whole_catalog(catalog):
    plan, prof, _, tree, _ = solve(catalog, pinned_pods(N_PODS, 9))
    port_spans_sit(tree)
    (options,) = spans(tree, "decode.options")
    assert tuple(sorted(options["attrs"])) == PORT_SPAN_ATTRS["decode.options"]
    assert options["attrs"]["nodes"] == len(plan)
    assert options["attrs"]["types"] == len(catalog) == 1344
    distinct = {tuple(types) for _, types, _ in plan}
    assert options["attrs"]["distinct"] == len(distinct) <= len(plan)
    assert 0 < prof["decode_options_s"] <= prof["decode_s"]
    assert prof["decode_options_s"] * 1e3 <= options["duration_ms"]


def test_encode_closure_is_the_batchs_and_hits_its_memo_on_a_repeat(catalog):
    """The closure's span and profile keys are the batch's signatures and
    cores; a second batch of new pod objects with the same cores reuses
    the memoized closure."""
    _, first, batch, tree, sched = solve(catalog, pinned_pods(N_PODS, 10))
    port_spans_sit(tree)
    (closure,) = spans(tree, "encode.closure")
    assert closure["attrs"] == {"signatures": len(batch.signatures),
                                "cores": len(batch.cores), "memo_hit": False}
    assert (first["closure_signatures"], first["closure_cores"]) == (
        len(batch.signatures), len(batch.cores))
    _, again, batch2, tree, _ = solve(catalog, pinned_pods(N_PODS, 10), sched)
    (closure,) = spans(tree, "encode.closure")
    assert closure["attrs"] == {"signatures": len(batch2.signatures),
                                "cores": len(batch2.cores), "memo_hit": True}
    assert (again["closure_signatures"], again["closure_cores"]) == (
        first["closure_signatures"], first["closure_cores"])


def test_selector_and_affinity_forms_share_one_core_each(catalog):
    """Each form is one core whether a selector or an affinity term carries
    it, and the closure of the nine stays inside 54 signatures (zone
    unset, z1 or z2; capacity type unset or spot; arch and OS unset or
    one of two)."""
    pods = []
    for form in FORMS:
        pods.append(make_pod(requests={"cpu": "250m"}, node_selector=dict(form)))
        pods.append(make_pod(requests={"cpu": "250m"}, node_requirements=[
            NodeSelectorRequirement(k, "In", [v]) for k, v in form.items()]))
    _, prof, batch, _, _ = solve(catalog, pods)
    assert prof["closure_cores"] == len(batch.cores) == len(FORMS)
    assert prof["closure_signatures"] <= 3 * 2 * 3 * 3


def test_the_redispatch_mirrors_into_the_profilers_trace(monkeypatch, catalog):
    """Under ``torch.profiler`` (CPU activity) the re-dispatch is one event
    of its name under ``solve.pack_fetch``, with the full table's launch
    under it."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(backend, "N_MAX_FIRST", SMALL_TABLE)
    pods = pinned_pods(N_PODS, 11)
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    sched.solve(make_provisioner(solver="tpu"), catalog, pinned_pods(N_PODS, 12))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.solve(make_provisioner(solver="tpu"), catalog, pods)
    events = prof.events()
    (redispatch,) = [e for e in events if e.name == "pack.redispatch"]
    assert redispatch.cpu_parent.name == "solve.pack_fetch"
    launches = [e for e in events if e.name == "pack.launch"]
    assert len(launches) == 2
    assert sum(e.cpu_parent.name == "pack.redispatch" for e in launches) == 1
