"""The port's predictive provisioning against the JAX package's: the
warm-pool wave (``controllers/warmpool.py``), the worker's warm-hit steal
(``controllers/provisioning.py``), the speculative rungs of the replay
ladder and the garbage collector, fencing and brownout.

Mirrors ``tests/test_warmpool.py`` (``TestWarmPoolWave``, ``TestWarmSteal``,
``TestSpeculativeReplayLadder``, ``TestFencing``, ``TestBrownoutInteraction``)
over ``SimulatedCloudProvider`` in both packages, with the forecaster on a
fake clock and the cluster's and journal's clocks pinned. Each case
compares exactly: the wave's launches and the Nodes' wire forms (labels,
annotations, taints, finalizers; random tokens and trace ids by presence),
the open speculative journal entries, the steal by pod index with the
remainder's plan (``solver: tpu``: the JAX scheduler's lax.scan on the CPU
against the port's ``device="cpu"`` plain version), the decision records,
the ladder's outcomes and the metric deltas. Warm nodes of one wave are
identical but for their instance ids, which threads draw in any order, so
they compare as a sorted list; a node the solver launched is named by the
lowest index of the pods it holds.
"""

import importlib
import json
import re
import threading
from types import SimpleNamespace

import pytest

from torch_parity import PACKAGES, FakeClock, fresh_router, pinned, wire_doc  # noqa: F401


def wp(pkg: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(
        pkg=pkg, lbl=m("api.labels"), metrics=m("metrics"), obs=m("obs"),
        Span=m("obs.trace").Span, s=m("cloudprovider.simulated"),
        pc=m("controllers.provisioning"), warmpool=m("controllers.warmpool"),
        gc=m("controllers.garbage_collection"), Cluster=m("kube.client").Cluster,
        recovery=m("launch.recovery"), launch=m("launch"), f=m("testing.factories"),
        brownout=m("resilience.brownout"), res=m("utils.resources"), serde=m("kube.serde"))


@pytest.fixture(autouse=True)
def fresh_obs():
    """A memory-only decision ring and no forecaster in both packages
    around each test."""
    for pkg in PACKAGES:
        wp(pkg).obs.configure_decisions("")
    yield
    for pkg in PACKAGES:
        obs = wp(pkg).obs
        obs.shutdown_forecast()
        obs.configure_decisions("")


class Env:
    """One provisioner ('wp'), a simulated cloud, a memory journal, the
    provisioning controller (warm_pool=True; the port's on the CPU), the
    wave controller and a forecaster on a fake clock (bucket 1 s, alpha 1)
    — the reference's ``_Env``, with the cluster's and journal's clocks
    pinned so wire timestamps and entry ages compare."""

    def __init__(self, M, max_nodes=10, ttl=600.0, ownership=None, provisioner=None):
        self.M = M
        self.now = [1000.0]  # the cluster's and the journal's clock
        self.cluster = M.Cluster(clock=lambda: self.now[0])
        self.api = M.s.SimCloudAPI()
        self.provider = M.s.SimulatedCloudProvider(self.api)
        self.journal = M.launch.MemoryLaunchJournal(clock=lambda: self.now[0])
        self.prov = provisioner or M.f.make_provisioner(name="wp", solver="tpu")
        self.cluster.create("provisioners", self.prov)
        kw = {"device": "cpu"} if M.pkg == "karpenter_tpu_torch" else {}
        self.controller = M.pc.ProvisioningController(
            self.cluster, self.provider, start_workers=False, journal=self.journal,
            warm_pool=True, **kw)
        self.controller.apply(self.prov)
        self.worker = self.controller.workers[self.prov.metadata.name]
        self.worker.batcher.idle_duration = 0.01
        self.wp = M.warmpool.WarmPoolController(
            self.cluster, self.provider, self.controller, journal=self.journal,
            ownership=ownership, warm_pool_ttl=ttl, max_nodes=max_nodes)
        self.clock = FakeClock()
        self.eng = M.obs.configure_forecast(bucket_s=1.0, alpha=1.0,
                                            default_horizon_s=5.0, clock=self.clock)
        self.standing = set()

    def mark(self):
        """Remember the Nodes standing now (``view`` keeps their names)."""
        self.standing = {n.metadata.name for n in self.cluster.nodes()}

    def forecast_demand(self, pods_per_s, pods_per_node=1.0):
        """One closed 1 s bucket of ``pods_per_s`` arrivals packing at
        ``pods_per_node`` (the reference's round span)."""
        self.eng(self.M.Span(name="provision.round", trace_id="t" * 32, span_id="s" * 16,
                             parent_id=None, parent=None,
                             attrs={"provisioner": "wp", "batch": pods_per_s,
                                    "nodes": pods_per_s / pods_per_node}))
        self.clock.t += 1.0

    def warm_nodes(self):
        return [n for n in self.cluster.nodes()
                if self.M.lbl.WARM_POOL_ANNOTATION in n.metadata.annotations]

    def seat(self, pods):
        for p in pods:
            self.cluster.create("pods", p)
            self.worker.batcher.add(p)
        self.worker.provision_once()

    def stop(self):
        self.controller.stop()


METRICS = (("WARMPOOL_HITS", {"provisioner": "wp"}), ("WARMPOOL_MISSES", {"provisioner": "wp"}),
           ("WARMPOOL_SPECULATIVE_LAUNCHES", {"provisioner": "wp"}), ("WARMPOOL_EXPIRED", None),
           ("WARMPOOL_SIZE", {"provisioner": "wp"}), ("WARMPOOL_PAUSED", None),
           ("FLEET_DUPLICATE_LAUNCH_GUARD", {"reason": "fenced"}),
           ("FLEET_DUPLICATE_LAUNCH_GUARD", {"reason": "lost_ownership"}))


def sample(M) -> list:
    out = []
    for name, labels in METRICS:
        family = getattr(M.metrics, name)
        out.append((family.labels(**labels) if labels else family)._value.get())
    return out


def deltas(before, after) -> dict:
    return {f"{name}{labels or ''}": a - b
            for (name, labels), b, a in zip(METRICS, before, after) if a != b}


def decisions(M) -> list:
    """The decision ring, oldest first, without ids, times, trace ids and
    what-served fields (a record's ``route`` names the package's packer)."""
    keep = ("provisioner", "state", "pods_considered", "nodes", "unschedulable_count")
    return [{k: r.get(k) for k in keep} for r in reversed(M.obs.decision_log().recent(limit=64))]


def journal_view(journal) -> list:
    """Open entries without their random tokens and trace ids."""
    docs = []
    for e in journal.unresolved():
        d = e.to_doc()
        d["token"] = bool(d["token"])
        d["trace"] = bool(d["trace"])
        docs.append(d)
    return sorted(docs, key=lambda d: json.dumps(d, sort_keys=True))


def view(env, pods=()) -> str:
    """The cluster's Nodes (wire forms), each pod's node by index, the open
    journal entries, the instances and the decisions, as JSON. A node that
    was not standing when ``env.mark()`` ran (one the solver launched) is
    renamed ``holds-<i>`` after the lowest index of its pods."""
    M = env.M
    bound = [env.cluster.get("pods", p.metadata.name).spec.node_name for p in pods]
    rename = {}
    for i, name in enumerate(bound):
        if name and name not in env.standing:
            rename.setdefault(name, f"holds-{i}")
    out = {
        "nodes": [wire_doc(M, "nodes", n) for n in env.cluster.nodes()],
        "bound": bound, "journal": journal_view(env.journal),
        "instances": [(i.id, i.instance_type, i.zone, i.state, bool(i.launch_token))
                      for i in env.api.instances.values()],
        "decisions": decisions(M),
    }
    text = re.sub(r"i-[0-9a-f]{8}", lambda m: rename.get(m.group(0), m.group(0)),
                  json.dumps(out, sort_keys=True))
    out = json.loads(text)
    for key in ("nodes", "instances", "journal"):
        out[key].sort(key=lambda d: json.dumps(d, sort_keys=True))
    return json.dumps(out, sort_keys=True)


def both(fn):
    """``fn(M)`` on each package under its pinned packer; the port's
    result, once it equals the reference's."""
    out = []
    for pkg in PACKAGES:
        with pinned(pkg):
            out.append(fn(wp(pkg)))
    assert out[1] == out[0]
    return out[1]


# -- TestWarmPoolWave, TestFencing ----------------------------------------------

WAVES = ["forecast deficit", "fractional deficit rounds up", "standing counts against want",
         "max nodes caps",
         "no forecaster", "zero forecast", "paused then resumed", "limits block",
         "fenced replica", "worker fenced per create", "ownership lost per create"]

# arrivals per second and pods per node each case forecasts (4 and 1 else)
DEMAND = {"forecast deficit": (2, 2.0), "fractional deficit rounds up": (2, 3.0),
          "standing counts against want": (2, 2.0), "max nodes caps": (40, 1.0)}


@pytest.mark.parametrize("case", WAVES)
def test_wave(case):
    """One or two waves: the reconcile's requeue, the launches, the Nodes,
    the open speculative entries, the wave's decision record, the
    instances and the metric deltas."""
    def run(M):
        class Fenced:
            def fenced(self):
                return True

            def owns(self, name):
                return True

        prov = None
        if case == "limits block":
            prov = M.f.make_provisioner(name="wp", limits={"cpu": "4"})
            prov.status.resources = {M.res.CPU: 4.0}
        env = Env(M, max_nodes=3 if case == "max nodes caps" else 10,
                  ownership=Fenced() if case == "fenced replica" else None, provisioner=prov)
        before = sample(M)
        try:
            if case != "zero forecast":
                env.forecast_demand(*DEMAND.get(case, (4, 1.0)))
            if case == "no forecaster":
                M.obs.shutdown_forecast(env.eng)
            if case == "paused then resumed":
                env.wp.set_paused(True)
            if case == "worker fenced per create":
                env.worker.fenced = lambda: True
            if case == "ownership lost per create":
                env.worker.owned = lambda: False
            requeues = [env.wp.reconcile(M.warmpool.WARM_POOL_KEY)]
            first = (len(env.warm_nodes()), env.wp.speculative_launches)
            if case in ("standing counts against want", "paused then resumed"):
                env.wp.set_paused(False)
                requeues.append(env.wp.reconcile(M.warmpool.WARM_POOL_KEY))
            return (requeues, first, env.wp.speculative_launches, env.wp.waves, env.wp.paused(),
                    view(env), deltas(before, sample(M)), env.wp.reconcile("not-the-key"))
        finally:
            env.stop()

    requeues, first, launches, waves, paused, _, moved, other = both(run)
    assert requeues == [10.0] * waves and other is None and not paused
    want = {"forecast deficit": 5, "fractional deficit rounds up": 4,
            "standing counts against want": 5, "max nodes caps": 3,
            "paused then resumed": 10}.get(case, 0)
    assert launches == want
    if case == "paused then resumed":
        assert first == (0, 0)
    if case in ("fenced replica", "worker fenced per create"):
        assert moved.get("FLEET_DUPLICATE_LAUNCH_GUARD{'reason': 'fenced'}", 0) >= 1


# -- TestWarmSteal ------------------------------------------------------------------

STEALS = ["hit binds claims and resolves", "stolen round records a decision",
          "selector mismatch misses", "lost claim falls back to solver", "mixed batch"]


def batch_for(M, case) -> list:
    make = M.f.make_pod
    if case == "hit binds claims and resolves":
        return [make(name=f"p-{i}", requests={"cpu": "0.25"}) for i in range(2)]
    # small enough for a warm node and admitted by the provisioner: only
    # its selector keeps it off the warm nodes, which stand in sim-zone-1a
    elsewhere = {M.lbl.TOPOLOGY_ZONE: "sim-zone-1b"}
    if case == "selector mismatch misses":
        return [make(name="p-0", requests={"cpu": "0.25"}, node_selector=elsewhere)]
    if case == "mixed batch":
        # more than the standing pool holds, some too big for a warm node,
        # one that no node can take: hits, a solved remainder, a miss
        sizes = ["0.25", "0.5", "1", "0.25", "2", "0.25", "0.5", "0.25", "0.25", "4",
                 "0.25", "0.5", "0.25", "0.25", "1", "0.25", "0.25", "0.5", "0.25", "0.25"]
        pods = [make(name="p-0", requests={"cpu": "0.25"}, node_selector=elsewhere)]
        return pods + [make(name=f"p-{i + 1}", requests={"cpu": c}) for i, c in enumerate(sizes)]
    return [make(name="p-0", requests={"cpu": "0.25"})]


@pytest.mark.parametrize("case", STEALS)
def test_warm_steal(case):
    """A standing pool (5 warm nodes of the cheapest type), then one round
    of the case's batch: each pod's node by index (warm claims by name, the
    solver's nodes by their lowest pod index), the claimed nodes' wire
    forms, the entries left open, the instances, the decisions (the
    claim's ``warm_claim`` record before the solver's), the events and the
    hit and miss counts."""
    def run(M):
        env = Env(M)
        try:
            env.forecast_demand(pods_per_s=2, pods_per_node=2.0)
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            env.mark()
            before = sample(M)
            pods = batch_for(M, case)
            orig = env.cluster.merge_patch
            if case == "lost claim falls back to solver":
                def failing_patch(kind, name, patch, namespace=""):
                    if kind == "nodes":
                        raise RuntimeError("node raced away")
                    return orig(kind, name, patch, namespace=namespace)

                env.cluster.merge_patch = failing_patch
            env.seat(pods)
            env.cluster.merge_patch = orig
            if M.pkg == "karpenter_tpu_torch":  # the remainder's solve: the plain version
                prof = env.worker.scheduler.last_stage_profile()
                assert prof.get("packer_backend") in (None, "pack_reference"), prof
            events = sorted((e.reason, e.involved_kind, e.involved_name, e.message)
                            for e in env.cluster.list("events"))
            return view(env, pods), deltas(before, sample(M)), events, len(env.warm_nodes())
        finally:
            env.stop()

    out, moved, events, standing = both(run)
    hits = moved.get("WARMPOOL_HITS{'provisioner': 'wp'}", 0)
    want_hits = {"hit binds claims and resolves": 2, "stolen round records a decision": 1,
                 "selector mismatch misses": 0, "lost claim falls back to solver": 0}
    if case in want_hits:
        assert hits == want_hits[case]
    else:
        assert hits >= 10 and moved["WARMPOOL_MISSES{'provisioner': 'wp'}"] >= 2
    assert (standing == 5) == (case in ("selector mismatch misses",
                                        "lost claim falls back to solver"))


# -- TestSpeculativeReplayLadder ------------------------------------------------------

LADDER = {  # case: (ttl, what happens to the node, seconds after the entry, outcome)
    "standing within ttl stays open": (600.0, None, 10, "pending"),
    "claimed entry resolves": (600.0, "claim", 10, "node_exists"),
    "expired standing reaped despite live instance": (60.0, None, 61, "speculation_expired"),
    "expired untracked reaped": (60.0, "forget", 61, "speculation_expired"),
    "untracked within ttl adopted back": (600.0, "forget", 10, "adopted"),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_speculative_replay_ladder(case):
    """One warm node (one pod per horizon at 5 pods per node), its entry
    through both packages' ``replay_entry``: the outcome, the entry, the
    Nodes, the instances."""
    ttl, action, after, want = LADDER[case]

    def run(M):
        env = Env(M, ttl=ttl)
        try:
            env.forecast_demand(pods_per_s=1, pods_per_node=5.0)
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            (entry,) = env.journal.unresolved()
            if action == "claim":
                env.cluster.merge_patch("nodes", entry.node_name, {"metadata": {"annotations": {
                    M.lbl.WARM_POOL_ANNOTATION: None}}}, namespace="")
            if action == "forget":
                node = env.cluster.get("nodes", entry.node_name, "")
                node.metadata.finalizers = []
                env.cluster.delete("nodes", entry.node_name, namespace="")
            by_token = {i.launch_token: i for i in env.provider.list_instances()
                        if i.launch_token}
            outcome = M.recovery.replay_entry(
                env.journal, env.cluster, env.provider, entry, by_token,
                now=entry.created_at + after, replay_after=0.0, warm_pool_ttl=env.wp.warm_pool_ttl)
            return (outcome, env.journal.get(entry.token) is None, view(env),
                    [i.id for i in env.provider.list_instances()])
        finally:
            env.stop()

    outcome, resolved, _, live = both(run)
    assert outcome == want
    assert resolved == (want in ("node_exists", "speculation_expired"))
    assert (live == []) == (want == "speculation_expired")


def test_gc_sweep_reaps_expired_speculation():
    """The collector's sweep once the clock has passed the TTL: the warm
    node reclaimed, the journal closed, the outcome counter
    and ``WARMPOOL_EXPIRED`` moved once, the event written."""
    def run(M):
        env = Env(M, ttl=0.05)
        try:
            env.forecast_demand(pods_per_s=1, pods_per_node=5.0)
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            env.now[0] += 1.0
            gc = M.gc.GarbageCollectionController(
                env.cluster, env.provider, journal=env.journal, gc_interval=0.01,
                replay_after=0.0, warm_pool_ttl=0.05)
            expired = M.metrics.LAUNCH_JOURNAL_REPLAYS.labels(outcome="speculation_expired")
            before, counter = sample(M), expired._value.get()
            requeue = gc.reconcile(M.gc.GC_POLL_KEY)
            return (requeue, gc.speculation_reclaimed, gc.replays, view(env),
                    deltas(before, sample(M)), expired._value.get() - counter,
                    sorted(e.reason for e in env.cluster.list("events")))
        finally:
            env.stop()

    requeue, reclaimed, replays, _, moved, outcome, events = both(run)
    assert (requeue, reclaimed, replays, outcome) == (0.01, 1, 1, 1.0)
    assert moved["WARMPOOL_EXPIRED"] == 1.0


# -- TestBrownoutInteraction -------------------------------------------------------------


def test_brownout_freezes_a_wave_midflight_and_resumes():
    """Rung 1 arriving during a wave of 12 freezes the launches not yet
    started; rung 0 lets the next wave top the pool up to the same 12
    Nodes in both. The wave runs on 8 threads, so how many creates pass
    the pause check before the first tick depends on thread timing: the
    creates wait on a barrier of 8 before they tick, so exactly the 8
    first tasks launch and the other 4 freeze in both packages."""
    def run(M):
        env = Env(M, max_nodes=12)
        try:
            env.forecast_demand(pods_per_s=12, pods_per_node=1.0)
            ctl = M.brownout.BrownoutController(burning_fn=lambda: True, warmpool=env.wp,
                                                escalate_after=1)
            orig = env.provider.create
            first_eight = threading.Barrier(8, timeout=30.0)

            def create_then_brownout(request):
                first_eight.wait()
                node = orig(request)
                ctl.tick()
                return node

            env.provider.create = create_then_brownout
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            frozen = env.wp.speculative_launches
            assert frozen == 8 and len(env.warm_nodes()) == frozen and env.wp.paused()
            env.provider.create = orig
            ctl.stop()
            paused = env.wp.paused()
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            return paused, len(env.warm_nodes()), view(env)
        finally:
            env.stop()

    paused, standing, _ = both(run)
    assert (paused, standing) == (False, 12)


def test_standing_nodes_survive_brownout_and_stay_claimable():
    def run(M):
        env = Env(M)
        try:
            env.forecast_demand(pods_per_s=2, pods_per_node=2.0)
            env.wp.reconcile(M.warmpool.WARM_POOL_KEY)
            standing = len(env.warm_nodes())
            ctl = M.brownout.BrownoutController(burning_fn=lambda: True, warmpool=env.wp,
                                                escalate_after=1)
            ctl.tick()
            paused = env.wp.paused()
            pods = [M.f.make_pod(name="p-0", requests={"cpu": "0.25"})]
            env.mark()
            env.seat(pods)
            left = len(env.warm_nodes())
            ctl.stop()
            return standing, paused, left, view(env, pods)
        finally:
            env.stop()

    standing, paused, left, _ = both(run)
    assert (standing, paused, left) == (5, True, 4)
