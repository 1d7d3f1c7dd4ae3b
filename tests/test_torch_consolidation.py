"""The port's consolidation against the JAX package's.

The reference's ``tests/test_consolidation.py`` classes ``TestPlanning``,
``TestExecution``, ``TestEvictWavePacing``, ``TestMinimalMove``,
``TestPDBScreening`` and ``TestWaveSettleHardening`` run on both packages,
and each result is compared between them by name: the plan (candidates,
pods, each proposed node's types and pods in order, keep / retire in
retirement order / launch, moves, prices, worthwhile), what execute
leaves in the cluster, the waves. The port's controller runs on
``device="cpu"``; a ``solver: tpu`` re-pack is pinned to each package's
plain rung (``torch_parity.pinned``), the full-width plans (BASELINE
config 5 and its team-mix twin) to the native packer on both sides.
``TestWaveSettleHardening`` runs without an orchestrator or a journal (the
wave's victims take the plain delete path); ``TestJournaledWave`` wires the
interruption orchestrator and a ``MemoryLaunchJournal`` as the reference's
``main.py`` does, and ``TestCrashedWaveReplay`` replays a crashed wave's
entry through both packages' recovery ladders.
"""

import time

import pytest

from torch_parity import (  # noqa: F401
    PACKAGES, both_canon, deprov, fleet, fresh_router, live_fleet, packer, pinned, plan_view, stop,
    wire_all, wire_doc,
)
from torch_parity import journal_docs as docs

PORT = "karpenter_tpu_torch"


def both(fn):
    """``fn(M)`` on each package; the port's result, once it equals the
    reference's."""
    ref, out = (fn(deprov(pkg)) for pkg in PACKAGES)
    assert out == ref
    return out


def planned(M, ctl, provisioner):
    with pinned(M.pkg):
        return ctl.plan(provisioner)


# -- TestPlanning ------------------------------------------------------------


def test_plan_finds_cheaper_packing():
    def run(M):
        cluster, _, prov, ctl = fleet(M, 4, finalizers=True)
        return plan_view(planned(M, ctl, prov))

    view = both(run)
    assert (len(view["nodes"]), len(view["pods"])) == (4, 4)
    assert view["proposed"] and view["proposed_price"] < view["current_price"]
    assert view["worthwhile"] and len(view["retire"]) == 4


@pytest.mark.parametrize("case", ["empty", "do-not-evict", "deleting and cordoned",
                                  "unplaceable", "marginal"])
def test_plan_gates(case):
    def run(M):
        lbl, f = M.lbl, M.f
        catalog = None
        if case == "unplaceable":
            catalog = [M.fake.new_instance_type("tiny",
                                                resources={M.res.CPU: 1.0, M.res.PODS: 2.0})]
        n = {"empty": 0, "do-not-evict": 2, "deleting and cordoned": 3}.get(case, 0)
        cluster, _, prov, ctl = fleet(M, n, catalog=catalog, finalizers=True)
        if case == "do-not-evict":
            pod = cluster.get("pods", "pod-0-0")
            pod.metadata.annotations[lbl.DO_NOT_EVICT_ANNOTATION] = "true"
        if case == "deleting and cordoned":
            cluster.get("nodes", "big-0", namespace="").spec.unschedulable = True
            cluster.delete("nodes", "big-1", namespace="")
        if case in ("unplaceable", "marginal"):
            itype, cpu, req = ("huge-legacy", "64", "32") if case == "unplaceable" else (
                "fake-it-0", "1", "0.5")
            cluster.create("nodes", f.make_node(
                name="old", capacity={"cpu": cpu, "memory": "2Gi", "pods": "10"},
                provisioner_name="default",
                labels={lbl.INSTANCE_TYPE: itype, lbl.TOPOLOGY_ZONE: "test-zone-1",
                        lbl.CAPACITY_TYPE: "on-demand"}))
            cluster.create("pods", f.make_pod(name="lone", requests={"cpu": req}, node_name="old",
                                              unschedulable=False))
        return plan_view(planned(M, ctl, prov))

    view = both(run)
    assert view["nodes"] == {"empty": [], "do-not-evict": ["big-1"],
                             "deleting and cordoned": ["big-2"]}.get(case, ["old"])
    assert view["worthwhile"] == (case in ("do-not-evict", "deleting and cordoned"))
    if case == "unplaceable":
        assert sum(len(pods) for _, pods in view["proposed"]) == 0


# -- TestExecution -----------------------------------------------------------


def executed(M, cluster, provider, launched):
    """What execute left: each launched node's type and its pods by name,
    and the old nodes' state."""
    live = [n for n in cluster.nodes() if n.metadata.deletion_timestamp is None]
    assert {n.metadata.name for n in live} == {n.metadata.name for n in launched}
    names = {n.metadata.name for n in launched}
    assert all(p.spec.node_name in names for p in cluster.pods())
    old = {}
    for i in range(4):
        node = cluster.try_get("nodes", f"big-{i}", namespace="")
        old[i] = ("gone" if node is None
                  else "deleting" if node.metadata.deletion_timestamp else "live")
    return ([(n.metadata.labels[M.lbl.INSTANCE_TYPE],
              sorted(p.metadata.name for p in cluster.pods_on_node(n.metadata.name)))
             for n in launched], old, len(provider.create_calls))


@pytest.mark.parametrize("solver", ["ffd", "tpu"])
def test_execute_migrates_pods_and_retires_nodes(solver):
    def run(M):
        cluster, provider, prov, ctl = fleet(M, 4, solver=solver, finalizers=True)
        plan = planned(M, ctl, prov)
        assert plan.worthwhile
        return executed(M, cluster, provider, ctl.execute(plan)), ctl.waves_executed

    (launched, old, creates), waves = both(run)
    assert 1 <= len(launched) < 4 and creates == len(launched) and waves == 1
    assert set(old.values()) == {"deleting"}


def test_reconcile_runs_plan_and_requeues():
    def run(M):
        cluster, _, _, ctl = fleet(M, 4)
        requeue = ctl.reconcile("default")
        return requeue, sorted(n.metadata.labels[M.lbl.INSTANCE_TYPE] for n in cluster.nodes())

    requeue, types = both(run)
    assert requeue == 300.0 and len(types) < 4


def test_disabled_controller_noop():
    def run(M):
        cluster, _, _, ctl = fleet(M, 4, enabled=False)
        return ctl.reconcile("default"), len(cluster.nodes())

    assert both(run) == (None, 4)


def test_anti_affinity_workload_can_consolidate():
    """The candidates' own live pods must not block their re-pack: two
    anti-affinity pods on two huge nodes re-seat on two cheap nodes."""
    def run(M):
        lbl, O = M.lbl, M.O
        cluster, _, prov, ctl = fleet(M, 0)
        sel = {"app": "ha"}
        for i, zone in enumerate(["test-zone-1", "test-zone-2"]):
            cluster.create("nodes", M.f.make_node(
                name=f"huge-{i}", capacity={"cpu": "20", "memory": "40Gi", "pods": "200"},
                provisioner_name="default",
                labels={lbl.INSTANCE_TYPE: "fake-it-19", lbl.TOPOLOGY_ZONE: zone,
                        lbl.CAPACITY_TYPE: "on-demand"},
                finalizers=[lbl.TERMINATION_FINALIZER]))
            cluster.create("pods", M.f.make_pod(
                name=f"ha-{i}", labels=sel, requests={"cpu": "0.5"}, node_name=f"huge-{i}",
                unschedulable=False, pod_anti_requirements=[O.PodAffinityTerm(
                    label_selector=O.LabelSelector(match_labels=sel),
                    topology_key=lbl.TOPOLOGY_ZONE)]))
        return plan_view(planned(M, ctl, prov))

    view = both(run)
    assert sum(len(pods) for _, pods in view["proposed"]) == 2 and view["worthwhile"]


def consolidated_under_manager(M):
    """The reference's live-manager case, wired by hand as main.py wires
    the ported controllers: consolidation reconciles through the Manager,
    migrates the pods to cheaper capacity, and termination drains the old
    nodes to completion."""
    cluster = M.Cluster()
    provider = M.fake.FakeCloudProvider(M.fake.instance_types(20))
    ctl = M.cons.ConsolidationController(cluster, provider, **({"device": "cpu"} if M.pkg == PORT
                                                               else {}))
    wired = wire_all(M, cluster, provider, consolidation=ctl)
    cluster.create("provisioners", M.f.make_provisioner())
    for i in range(4):
        cluster.create("nodes", M.f.make_node(
            name=f"big-{i}", capacity={"cpu": "20", "memory": "40Gi", "pods": "200"},
            provisioner_name="default", finalizers=[M.lbl.TERMINATION_FINALIZER],
            labels={M.lbl.INSTANCE_TYPE: "fake-it-19", M.lbl.TOPOLOGY_ZONE: "test-zone-1",
                    M.lbl.CAPACITY_TYPE: "on-demand"}))
        cluster.create("pods", M.f.make_pod(name=f"pod-{i}-0", requests={"cpu": "0.5"},
                                            node_name=f"big-{i}", unschedulable=False))
    wired.manager.start()
    try:
        wired.manager.enqueue("consolidation", "default")
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if all(cluster.try_get("nodes", f"big-{i}", namespace="") is None for i in range(4)):
                break
            time.sleep(0.05)
        live = [n for n in cluster.nodes() if n.metadata.deletion_timestamp is None]
        pods = cluster.pods()
        return (sorted(n.metadata.labels[M.lbl.INSTANCE_TYPE] for n in live),
                [cluster.try_get("nodes", f"big-{i}", namespace="") for i in range(4)],
                len(pods), all(p.spec.node_name in {n.metadata.name for n in live} for p in pods),
                sorted(provider.delete_calls))
    finally:
        stop(wired)


def test_consolidation_under_live_manager():
    types, old, n_pods, seated, deleted = both(consolidated_under_manager)
    assert 1 <= len(types) < 4 and old == [None] * 4
    assert (n_pods, seated) == (4, True)
    assert deleted == [f"big-{i}" for i in range(4)]


def test_tpu_solver_consolidation():
    def run(M):
        cluster, provider, prov, ctl = fleet(M, 4, solver="tpu", finalizers=True)
        plan = planned(M, ctl, prov)
        return plan_view(plan), len(ctl.execute(plan))

    view, launched = both(run)
    assert view["worthwhile"] and 1 <= launched < 4


# -- the full-width plans ----------------------------------------------------


@pytest.mark.parametrize("teams", [False, True], ids=["config5", "team-mix"])
def test_full_width_plan_equals_the_reference(teams):
    """BASELINE config 5 (1,000 live nodes, 1,993 pods, instance_types(400))
    and its team-mix twin (64 team selectors, the tradeoff catalog) through
    both packages' controllers on their native packers: the same plan,
    name for name, every pod re-seated."""
    def run(M):
        cluster, _, prov, ctl = live_fleet(M, teams=teams)
        with packer("native"):
            return plan_view(ctl.plan(prov))

    view = both(run)
    assert len(view["nodes"]) == 1000 and len(view["pods"]) == (2008 if teams else 1993)
    assert sum(len(pods) for _, pods in view["proposed"]) == len(view["pods"])
    assert len(view["proposed"]) == (64 if teams else 6) and view["worthwhile"]
    assert (len(view["keep"]), len(view["retire"])) == (0, 1000)


# -- TestEvictWavePacing -----------------------------------------------------


@pytest.mark.parametrize("n", [40, 1000])
def test_waves_bound_concurrent_disruption(n):
    def run(M):
        cluster, _, prov, ctl = fleet(M, n, owned=True, migration="evict")
        before = {x.metadata.name for x in cluster.nodes()}
        requeue = ctl.reconcile(prov.metadata.name)
        return sorted(before - {x.metadata.name for x in cluster.nodes()}), requeue

    gone, requeue = both(run)
    assert len(gone) == 5 and requeue == 10.0


def test_next_wave_gated_on_reseating():
    def run(M):
        cluster, _, prov, ctl = fleet(M, 20, owned=True, migration="evict")
        ctl.reconcile("default")
        first = sorted(n.metadata.name for n in cluster.nodes())
        pending = M.f.make_pod(name="recreated-0", requests={"cpu": "0.5"})
        cluster.create("pods", pending)
        gated = ctl.wave_settled("default")
        ctl.reconcile("default")
        held = sorted(n.metadata.name for n in cluster.nodes())
        cluster.bind(pending, cluster.nodes()[0].metadata.name)
        opened = ctl.wave_settled("default")
        ctl.reconcile("default")
        return first, gated, held, opened, sorted(n.metadata.name for n in cluster.nodes())

    first, gated, held, opened, second = both(run)
    assert (gated, opened) == (False, True) and held == first
    assert 0 < len(first) - len(second) <= 5


def test_preexisting_pending_pod_does_not_gate_waves():
    def run(M):
        cluster, _, _, ctl = fleet(M, 20, owned=True, migration="evict")
        cluster.create("pods", M.f.make_pod(name="stuck-forever", requests={"cpu": "999"}))
        ctl.reconcile("default")
        n1 = len(cluster.nodes())
        settled = ctl.wave_settled("default")
        ctl.reconcile("default")
        return n1, settled, len(cluster.nodes())

    n1, settled, n2 = both(run)
    assert n1 < 20 and settled and n2 < n1


def test_wave_settle_timeout_releases_the_gate():
    def run(M):
        now = [1000.0]
        cluster, _, _, ctl = fleet(M, 12, owned=True, migration="evict", clock=lambda: now[0])
        ctl.reconcile("default")
        cluster.create("pods", M.f.make_pod(name="new-stuck", requests={"cpu": "999"}))
        held = ctl.wave_settled("default")
        now[0] += M.cons.WAVE_SETTLE_TIMEOUT + 1
        return held, ctl.wave_settled("default"), ctl.ledger.in_flight("default")

    assert both(run) == (False, True, 0)


# -- TestMinimalMove ---------------------------------------------------------


def minimal_move(M, case):
    lbl, f = M.lbl, M.f

    def node(name, itype, capacity_type="on-demand"):
        return f.make_node(name=name, provisioner_name="default", labels={
            lbl.INSTANCE_TYPE: itype, lbl.CAPACITY_TYPE: capacity_type,
            lbl.TOPOLOGY_ZONE: "test-zone-1"})

    def vnode(itype, pods):
        return M.ffd.VirtualNode(constraints=None,
                                 instance_type_options=[M.fake.new_instance_type(itype)], pods=pods)

    p1, p2, p3 = (f.make_pod(name=f"p{i}") for i in (1, 2, 3))
    a, b = node("a", "it-big"), node("b", "it-big")
    if case == "exact":
        m = M.repack.minimal_move_match(
            [a, b], {"a": [p1, p2], "b": [p3]},
            [vnode("it-big", [p1, p2]), vnode("it-small", [p3])])
    elif case == "downsize":
        m = M.repack.minimal_move_match([a], {"a": [p1]}, [vnode("it-small", [p1])])
    elif case == "duplicates":
        m = M.repack.minimal_move_match(
            [a, b], {"a": [p1], "b": [p1]}, [vnode("it-big", [p1]), vnode("it-big", [p2])])
    else:
        order = {
            "cheapest": ([node("pricey", "it-big"), node("cheap", "it-small")], {},
                         {"it-small": 0.1, "it-big": 2.0}, lambda ct, z: 0.0),
            "risk": ([node("stable", "it-big"), node("doomed", "it-big", "spot")], {},
                     {"it-big": 1.0}, lambda ct, z: 0.9 if ct == "spot" else 0.0),
            "moves": ([node("crowded", "it-big"), node("empty", "it-big")],
                      {"crowded": [f.make_pod(name=f"c{i}") for i in range(5)], "empty": []},
                      {"it-big": 1.0}, lambda ct, z: 0.0),
        }[case]
        return [n.metadata.name for n in M.repack.order_retirement(*order)]
    return ([n.metadata.name for n in m.keep], [n.metadata.name for n in m.retire],
            [[p.metadata.name for p in v.pods] for v in m.launch],
            [p.metadata.name for p in m.moves])


@pytest.mark.parametrize("case,want", [
    ("exact", (["a"], ["b"], [["p3"]], ["p3"])),
    ("downsize", ([], ["a"], [["p1"]], ["p1"])),
    ("duplicates", (["a"], ["b"], [["p2"]], ["p1"])),
    ("cheapest", ["cheap", "pricey"]),
    ("risk", ["doomed", "stable"]),
    ("moves", ["empty", "crowded"]),
])
def test_minimal_move(case, want):
    assert both(lambda M: minimal_move(M, case)) == want


def test_disruption_cost_clamps_risk():
    def run(M):
        node, cost = M.f.make_node(name="n"), M.repack.disruption_cost
        return (cost(node, [], 2.0, 5.0), cost(node, [M.f.make_pod()], 2.0, 5.0),
                cost(node, [], 2.0, -1.0), cost(node, [M.f.make_pod()] * 3, 1.5, 0.25),
                M.repack.MOVE_COST)

    assert both(run) == (0.0, 0.01, 2.0, 1.155, 0.01)


# -- TestPDBScreening --------------------------------------------------------


@pytest.mark.parametrize("pdb,candidates", [
    ({"labels": {"app": "db"}, "min_available": 2}, 0),
    ({"labels": {"app": "db"}, "min_available": 1}, 2),
    ({"labels": {"app": "db"}, "max_unavailable": 0}, 0),
    ({"labels": {"app": "other"}, "min_available": 5}, 2),
])
def test_pdb_screens_candidates_at_plan_time(pdb, candidates):
    def run(M):
        cluster, _, prov, ctl = fleet(M, 2, owned=True, migration="evict")
        for p in cluster.pods():
            p.metadata.labels["app"] = "db"
        cluster.create("pdbs", M.f.make_pdb(**pdb))
        return plan_view(planned(M, ctl, prov))["nodes"]

    assert len(both(run)) == candidates


# -- TestWaveSettleHardening (no orchestrator, no journal) -------------------


def test_out_of_band_victim_delete_settles_cleanly():
    """A victim force-deleted mid-wave settles the wave and releases the
    budget; every victim counts as reclaimed."""
    def run(M):
        cluster, _, _, ctl = fleet(M, 12, owned=True, migration="evict", finalizers=True)
        ctl.reconcile("default")
        victims = ctl._pending_waves["default"][0]
        held = ctl.wave_settled("default")
        for name in victims:
            cluster.remove_finalizer("nodes", cluster.get("nodes", name, namespace=""),
                                     M.lbl.TERMINATION_FINALIZER)
        return (victims, held, ctl.wave_settled("default"), ctl.ledger.in_flight("default"),
                ctl.nodes_reclaimed)

    victims, held, settled, in_flight, reclaimed = both(run)
    assert len(victims) == 5 and (held, settled, in_flight, reclaimed) == (False, True, 0, 5)


def test_timeout_uncordons_stranded_victims(monkeypatch):
    """Victims whose handoff cordoned them and then died (cordoned, NOT
    deleting) are un-cordoned when the settle timeout finishes the wave."""
    def run(M):
        now = [1000.0]
        cluster, _, _, ctl = fleet(M, 12, owned=True, migration="evict", clock=lambda: now[0])
        Taint = M.O.Taint

        def cordon_only(kind, name, namespace="default"):
            node = cluster.get(kind, name, namespace=namespace)
            node.spec.unschedulable = True
            node.spec.taints.append(Taint(key=M.lbl.INTERRUPTION_TAINT_KEY,
                                          value="consolidation", effect="NoSchedule"))
            node.spec.taints.append(Taint(key="dedicated", value="gpu", effect="NoSchedule"))

        monkeypatch.setattr(cluster, "delete", cordon_only)
        ctl.reconcile("default")
        stranded = ctl._pending_waves["default"][0]
        held = ctl.wave_settled("default")
        now[0] += M.cons.WAVE_SETTLE_TIMEOUT + 1
        settled = ctl.wave_settled("default")
        nodes = [cluster.get("nodes", n, namespace="") for n in stranded]
        return (stranded, held, settled, [n.spec.unschedulable for n in nodes],
                [[t.key for t in n.spec.taints] for n in nodes], ctl.ledger.in_flight("default"))

    stranded, held, settled, cordoned, taints, in_flight = both(run)
    assert len(stranded) == 5 and (held, settled, in_flight) == (False, True, 0)
    assert cordoned == [False] * 5 and taints == [["dedicated"]] * 5


# -- TestJournaledWave -------------------------------------------------------


def orchestrated(M, n_nodes, journal=None):
    """An evict-mode controller with the interruption orchestrator and a
    launch journal, as the reference's ``main.py`` wires them."""
    cluster, provider, prov, ctl = fleet(M, n_nodes, owned=True, migration="evict",
                                         clock=lambda: 1000.0)
    ctl.orchestrator = M.orch.Orchestrator(cluster, provider, None, None)
    ctl.journal = journal if journal is not None else M.launch.MemoryLaunchJournal(
        clock=lambda: 0.0)
    return cluster, ctl


def test_wave_journaled_before_first_victim_is_touched():
    def run(M):
        cordoned_at_record = []

        class SpyJournal(M.launch.MemoryLaunchJournal):
            def record_intent(self, *args, **kwargs):
                cordoned_at_record.append(sum(1 for n in cluster.nodes() if n.spec.unschedulable))
                return super().record_intent(*args, **kwargs)

        cluster, ctl = orchestrated(M, 12, journal=SpyJournal(clock=lambda: 0.0))
        ctl.reconcile("default")
        (entry,) = ctl.journal.unresolved()
        victims = [wire_doc(M, "nodes", cluster.get("nodes", n, namespace="")) for n in entry.victims]
        doc = {k: v for k, v in entry.to_doc().items() if k not in ("token", "decision_id", "trace")}
        return cordoned_at_record, doc, bool(entry.decision_id), victims

    cordoned, doc, has_decision, victims = both_canon(run)
    assert cordoned == [0] and has_decision and doc["marker"] == "consolidation"
    assert len(doc["victims"]) == 5
    for node in victims:
        assert node["metadata"]["deletionTimestamp"] and node["spec"]["unschedulable"]
        assert {"key": "karpenter.sh/interruption", "value": "consolidation",
                "effect": "NoSchedule"} in node["spec"]["taints"]


def test_settled_wave_resolves_journal_and_counts_reclaimed():
    def run(M):
        cluster, ctl = orchestrated(M, 12)
        ctl.reconcile("default")
        (entry,) = ctl.journal.unresolved()
        released = sorted(p.metadata.name for p in cluster.pods() if not p.spec.node_name)
        for name in entry.victims:
            cluster.remove_finalizer("nodes", cluster.get("nodes", name, namespace=""),
                                     M.lbl.TERMINATION_FINALIZER)
        survivor = next(n for n in cluster.nodes() if n.metadata.name not in entry.victims)
        for p in cluster.pods():
            if not p.spec.node_name:
                cluster.bind(p, survivor.metadata.name)
        return (released, ctl.wave_settled("default"), ctl.journal.unresolved(),
                ctl.nodes_reclaimed, ctl.ledger.in_flight("default"), ctl.moves_executed)

    released, settled, left, reclaimed, in_flight, moves = both_canon(run)
    assert len(released) == 5 and (settled, left, reclaimed, in_flight, moves) == (
        True, [], 5, 0, 5)


def test_events_carry_the_decision_id():
    def run(M):
        cluster, ctl = orchestrated(M, 12)
        ctl.reconcile("default")
        (entry,) = ctl.journal.unresolved()
        stamped = sorted(e.reason for e in cluster.list("events")
                         if e.metadata.annotations.get("karpenter.sh/decision-id")
                         == entry.decision_id)
        return stamped, [wire_doc(M, "events", e) for e in cluster.list("events")]

    stamped, _ = both_canon(run)
    assert stamped == ["Consolidated"] + ["ConsolidationDrain"] * 5


# -- TestCrashedWaveReplay ---------------------------------------------------

CRASHED_WAVE = ["replayed", "unrelated taints", "deleted victim", "young", "failed uncordon"]


@pytest.mark.parametrize("case", CRASHED_WAVE)
def test_crashed_consolidation_wave_replay(case):
    """A wave entry whose replica died after cordoning two of three victims:
    the ladder's marker branch un-cordons the survivors and resolves,
    keeps unrelated taints, skips a deleted victim, leaves a young entry
    and retries a failed un-cordon."""
    def run(M):
        cluster = M.Cluster(clock=lambda: 1000.0)
        journal = M.launch.MemoryLaunchJournal(clock=lambda: 0.0)
        for i in range(3):
            cluster.create("nodes", M.f.make_node(name=f"victim-{i}", provisioner_name="default"))
        for i in range(2):
            node = cluster.get("nodes", f"victim-{i}", namespace="")
            node.spec.unschedulable = True
            node.spec.taints.append(M.O.Taint(key=M.lbl.INTERRUPTION_TAINT_KEY,
                                              value="consolidation", effect="NoSchedule"))
        if case == "unrelated taints":
            cluster.get("nodes", "victim-0", namespace="").spec.taints.append(
                M.O.Taint(key="dedicated", value="gpu", effect="NoSchedule"))
        if case == "deleted victim":
            cluster.delete("nodes", "victim-2", namespace="")
        if case == "failed uncordon":
            def failing_patch(*args, **kwargs):
                raise RuntimeError("store blip")

            cluster.merge_patch = failing_patch
        journal.record_intent("consolidation-deadbeef", "default",
                              marker=M.recovery.CONSOLIDATION_MARKER,
                              victims=["victim-0", "victim-1", "victim-2"], decision_id="d-123")
        (entry,) = journal.unresolved()
        outcome = M.recovery.replay_entry(journal, cluster, None, entry, {},
                                          now=5.0 if case == "young" else 100.0,
                                          replay_after=10.0)
        return outcome, docs(journal), [wire_doc(M, "nodes", n) for n in cluster.nodes()]

    outcome, left, nodes = both_canon(run)
    if case in ("young", "failed uncordon"):
        assert outcome == "pending" and len(left) == 1
    else:
        assert outcome == "consolidation_replayed" and left == []
        assert not any(n["spec"].get("unschedulable") for n in nodes)
        keys = [[t["key"] for t in n["spec"].get("taints", [])] for n in nodes]
        assert keys[0] == (["dedicated"] if case == "unrelated taints" else [])



# -- brownout and the decision record ----------------------------------------


def test_brownout_rung_one_pauses_new_waves():
    def run(M):
        cluster, _, _, ctl = fleet(M, 20, owned=True, migration="evict")
        state = {"burning": True}
        ladder = M.brownout.BrownoutController(burning_fn=lambda: state["burning"],
                                               consolidation=ctl, escalate_after=1,
                                               recover_after=1)
        ladder.tick()
        paused = ctl.paused(), ladder.level()
        requeue, n_paused = ctl.reconcile("default"), len(cluster.nodes())
        state["burning"] = False
        ladder.tick()
        resumed = ctl.paused(), ladder.level()
        ctl.reconcile("default")
        return paused, requeue, n_paused, resumed, len(cluster.nodes())

    assert both(run) == ((True, 1), 10.0, 20, (False, 0), 15)


def test_evict_wave_records_its_decision():
    def run(M):
        import importlib

        log = importlib.import_module(f"{M.pkg}.obs.decisions").DecisionLog()
        cluster, _, _, ctl = fleet(M, 20, owned=True, migration="evict", budget="3",
                                   decisions=log)
        ctl.reconcile("default")
        (rec,) = log.recent(limit=1)
        ids = {e.metadata.annotations.get("karpenter.sh/decision-id")
               for e in cluster.list("events")}
        return ({k: v for k, v in rec.items() if k not in ("id", "recorded_at")},
                ids == {rec["id"]})

    rec, stamped = both(run)
    assert rec["kind"] == "consolidation" and stamped
    assert rec["state"]["budget"] == 3 and rec["state"]["budget_blocked"] == 2
    assert len(rec["state"]["victims"]) == 3 and rec["state"]["kept_nodes"] == 0
