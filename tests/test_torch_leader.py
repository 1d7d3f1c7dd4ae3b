"""The port's leases over the API (``kube/leader.py``) against the JAX
package's: two contenders on one Lease, takeover after expiry, the
REJECTED-vs-UNREACHABLE split with its fence (a sub-expiry blip keeps the
hold, silence past expiry less the margin fences, an answer lifts the
fence, a peer's takeover is an instant loss, the hold stamped before the
round trip), the keyed ``KubeLeaseSet`` (membership, per-key leases, the
one-LIST snapshot, the stale-member collection, the shared fence), and the
fenced guards of the worker, the terminator and the garbage collector.

Mirrors ``tests/test_apiserver.py`` (``TestKubeLeaderElection``) and
``tests/test_partition.py`` (``TestLeaseFencing``, ``TestFencedGuards``;
the two cases that need the fleet's ``ShardManager`` wait for its port).
Each case runs on both packages and compares exactly.
"""

from torch_parity import (PACKAGES, both_canon, fresh_router, kube, kube_env, on_cpu,  # noqa: F401
                          sample)


def both(fn):
    return both_canon(fn, ns=kube)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Partitioned:
    """An in-memory ``Cluster`` whose lease surface can be cut: while
    ``down``, every read and write raises a connection error, as the
    transport does when the apiserver is gone."""

    CUT = frozenset({"try_get", "get", "list", "create", "update", "delete", "bind"})

    def __init__(self, cluster):
        self._cluster = cluster
        self.down = False

    def __getattr__(self, name):
        attr = getattr(self._cluster, name)
        if not callable(attr) or name not in self.CUT:
            return attr

        def guarded(*args, **kwargs):
            if self.down:
                raise ConnectionRefusedError("apiserver partitioned")
            return attr(*args, **kwargs)

        return guarded


def partitioned_lease(M, duration=10.0):
    clock = FakeClock()
    cluster = Partitioned(M.client.Cluster(clock=clock))
    lease = M.leader.KubeLease(cluster, name="shard-a", identity="r1", duration=duration)
    return lease, cluster, clock


# -- TestKubeLeaderElection ------------------------------------------------------------


def test_two_contenders_one_leader():
    def run(M):
        with kube_env(M) as env:
            a, b = env.connect(), env.connect()
            la = M.leader.KubeLease(a, identity="a", duration=120)
            lb = M.leader.KubeLease(b, identity="b", duration=120)
            steps = [la.try_acquire(), lb.try_acquire(), lb.holder(), la.renew()]
            la.release()
            steps += [lb.try_acquire(), lb.holder(), la.renew()]
            lease = env.cluster.get("leases", "karpenter-leader-election", namespace="kube-system")
            return steps, (lease.holder_identity, lease.lease_transitions,
                           lease.lease_duration_seconds)

    steps, lease = both(run)
    assert steps == [True, False, "a", True, True, "b", False]
    assert lease == ("b", 1, 120)


def test_takeover_after_expiry():
    def run(M):
        now = [1000.0]
        with kube_env(M) as env:
            a = env.connect(clock=lambda: now[0])
            la = M.leader.KubeLease(a, identity="a", duration=2)
            lb = M.leader.KubeLease(a, identity="b", duration=2)
            first = la.try_acquire()
            now[0] += 3
            return first, lb.try_acquire(), lb.holder(), la.renew()

    assert both(run) == (True, True, "b", False)


# -- TestLeaseFencing --------------------------------------------------------------------


def test_sub_expiry_blip_keeps_the_hold():
    def run(M):
        lease, cluster, clock = partitioned_lease(M)
        out = [lease.try_acquire()]
        cluster.down = True
        clock.advance(3.0)
        out += [lease.renew(), lease.status.fenced]
        cluster.down = False
        out.append(lease.renew())
        clock.advance(9.0)
        cluster.down = True
        return out + [lease.status.fenced, lease._held_until]

    assert both(run) == [True, True, False, True, False, 1013.0]


def test_fences_past_expiry_margin():
    def run(M):
        lease, cluster, clock = partitioned_lease(M, duration=10.0)
        out = [lease.try_acquire()]
        cluster.down = True
        margin = M.leader.FENCE_MARGIN_FRACTION * lease.duration
        clock.advance(10.0 - margin - 0.5)
        out.append(lease.renew())
        clock.advance(1.0)
        return out + [lease.renew(), lease.status.fenced]

    assert both(run) == [True, True, False, True]


def test_recovery_lifts_the_fence():
    def run(M):
        lease, cluster, clock = partitioned_lease(M)
        out = [lease.try_acquire()]
        cluster.down = True
        clock.advance(50.0)
        out += [lease.renew(), lease.status.fenced]
        cluster.down = False
        return out + [lease.try_acquire(), lease.status.fenced]

    assert both(run) == [True, False, True, True, False]


def test_rejected_is_still_instant_loss():
    def run(M):
        lease, cluster, clock = partitioned_lease(M, duration=10.0)
        out = [lease.try_acquire()]
        clock.advance(11.0)
        rival = M.leader.KubeLease(cluster, name="shard-a", identity="r2", duration=10.0)
        return out + [rival.try_acquire(), lease.renew(), lease.status.fenced]

    assert both(run) == [True, True, False, False]


class ScriptedTicks:
    """An elector's stop event, scripted: each wait advances the lease's
    clock by what the elector asked for, and the API server is cut for the
    renewals numbered in ``down`` (the acquire is number 0). The loop ends
    after ``ticks`` waits."""

    def __init__(self, clock, cluster, down, ticks):
        self.clock, self.cluster, self.down, self.ticks = clock, cluster, down, ticks
        self.waits = []

    def is_set(self):
        return len(self.waits) >= self.ticks

    def wait(self, seconds):
        self.waits.append(seconds)
        self.clock.advance(seconds)
        self.cluster.down = len(self.waits) in self.down

    def set(self):
        pass


def test_unreachable_renewal_is_retried_before_the_hold_expires():
    """A deliberate difference: the port's elector retries a renewal that
    found the API server unreachable after its retry interval (2 s), not
    its renew interval (5 s). Two failed renewals in a row are a blip to
    the port; the reference's next renewal comes 15 s after its last and
    finds its own Lease expired, and leadership is lost (then re-acquired,
    with the controllers already stopped)."""
    def run(M):
        lease, cluster, clock = partitioned_lease(M, duration=15.0)
        lost = []
        elector = M.lease.LeaderElector(lease, renew_interval=5.0,
                                        on_lost=lambda: lost.append(clock()))
        elector._stop = ScriptedTicks(clock, cluster, down={1, 2}, ticks=5)
        elector._run()
        return elector._stop.waits, lost, elector.is_leader, lease.status.fenced

    assert run(kube(PACKAGES[1])) == ([5.0, 2.0, 2.0, 5.0, 5.0], [], True, False)
    assert run(kube(PACKAGES[0])) == ([5.0] * 5, [1015.0], True, False)


def test_acquire_hold_is_timestamped_before_the_round_trip(monkeypatch):
    def run(M):
        lease, cluster, clock = partitioned_lease(M, duration=10.0)
        t0 = clock()
        orig = M.leader.KubeLease._try_acquire

        def slow_acquire(self):
            out = orig(self)
            clock.advance(5.0)  # the round trip took 5 s
            return out

        monkeypatch.setattr(M.leader.KubeLease, "_try_acquire", slow_acquire)
        return lease.try_acquire(), lease._held_until - t0

    assert both(run) == (True, 10.0)


# -- KubeLeaseSet ------------------------------------------------------------------------


def test_lease_set_membership_keys_and_snapshot():
    """Two replicas' sets over one store: each heartbeats its member
    Lease, wins disjoint keys, and a one-LIST snapshot names every holder;
    a release hands a key over; resign deletes the member Lease."""
    def run(M):
        clock = FakeClock()
        cluster = M.client.Cluster(clock=clock)
        a = M.leader.KubeLeaseSet(cluster, identity="ra", duration=10.0)
        b = M.leader.KubeLeaseSet(cluster, identity="rb", duration=10.0)
        out = {"members": [sorted(a.heartbeat()), sorted(b.heartbeat())]}
        out["acquire"] = [a.try_acquire("p1"), b.try_acquire("p1"), b.try_acquire("p2")]
        out["names"] = [a._name_for("p1"), a._name_for("Team/P 1"), a._name_for("team-p-1")]
        stale = a.snapshot({"p1", "p2", "p3"})  # the heartbeat's LIST, from before the acquires
        clock.advance(2.0)
        out["snapshot"] = [stale, a.snapshot({"p1", "p2", "p3"}), b.snapshot()]
        out["renew"] = [sorted(a.renew_many({"p1", "p2"})), sorted(b.renew_many({"p2"}))]
        a.release("p1")
        out["handover"] = [b.try_acquire("p1"), b.holder("p1"), a.holder("p1")]
        a.resign()
        out["after_resign"] = [sorted(b.members()),
                               sorted(lease.metadata.name for lease in cluster.list("leases"))]
        b.release_all()
        out["released"] = b.snapshot({"p1", "p2"})
        out["fenced"] = [a.fenced(), b.fenced()]
        return out

    out = both(run)
    assert out["members"] == [["ra"], ["ra", "rb"]]
    assert out["acquire"] == [True, False, True]
    assert out["snapshot"][:2] == [{}, {"p1": "ra", "p2": "rb"}]
    assert out["handover"] == [True, "rb", "rb"]
    assert out["after_resign"][0] == ["rb"] and out["released"] == {}


def test_lease_set_collects_stale_members():
    """A crashed replica's member Lease is deleted by a live replica's tick
    once it is four durations past its expiry, and not before."""
    def run(M):
        clock = FakeClock()
        cluster = M.client.Cluster(clock=clock)
        dead = M.leader.KubeLeaseSet(cluster, identity="dead", duration=10.0)
        live = M.leader.KubeLeaseSet(cluster, identity="live", duration=10.0)
        dead.heartbeat()
        clock.advance(20.0)
        early = (sorted(live.heartbeat()), len(cluster.list("leases")))
        clock.advance(40.0)
        late = (sorted(live.heartbeat()), sorted(l.metadata.name for l in cluster.list("leases")))
        return early, late

    early, late = both(run)
    assert early == (["live"], 2)
    assert late == (["live"], ["karpenter-shard-member-live"])


def test_lease_set_shares_one_fence():
    """A blackout past a held key's expiry fences the whole set; one
    answered round trip on any lease lifts it."""
    def run(M):
        clock = FakeClock()
        cluster = Partitioned(M.client.Cluster(clock=clock))
        leases = M.leader.KubeLeaseSet(cluster, identity="r1", duration=10.0)
        out = [leases.try_acquire("p1"), leases.try_acquire("p2")]
        cluster.down = True
        clock.advance(3.0)
        out += [sorted(leases.renew_many({"p1", "p2"})), leases.fenced(), leases.snapshot({"p1"})]
        clock.advance(20.0)
        out += [sorted(leases.renew_many({"p1", "p2"})), leases.fenced(),
                sorted(leases.members())]
        cluster.down = False
        out += [leases.try_acquire("p1"), leases.fenced(), leases.snapshot({"p1", "p2"})]
        return out

    out = both(run)
    assert out[2:5] == [["p1", "p2"], False, {}]
    assert out[5:8] == [[], True, ["r1"]]
    assert out[8:] == [True, False, {"p1": "r1"}]


def test_lease_set_over_the_api_server():
    """The set over an ``ApiCluster``: member and shard Leases land on the
    server, and the snapshot lists them live (leases are not watched)."""
    def run(M):
        clock = FakeClock()
        with kube_env(M) as env:
            c = env.connect(clock=clock)
            leases = M.leader.KubeLeaseSet(c, identity="r1", duration=30.0)
            members = sorted(leases.heartbeat())
            acquired = leases.try_acquire("p1")
            names = sorted(l.metadata.name for l in env.cluster.list("leases"))
            clock.advance(2.0)  # past the heartbeat LIST's reuse window
            return members, acquired, names, leases.snapshot({"p1"}), "leases" in c._watch_kinds

    members, acquired, names, snapshot, watched = both(run)
    assert members == ["r1"] and acquired and len(names) == 2
    assert snapshot == {"p1": "r1"} and not watched


# -- TestFencedGuards --------------------------------------------------------------------


def fenced_worker(M, fenced):
    cluster = M.client.Cluster()
    worker = M.prov.ProvisionerWorker(
        M.f.make_provisioner(), cluster, M.fake.FakeCloudProvider(M.fake.instance_types(5)),
        **on_cpu(M, {"owned": lambda: True, "fenced": fenced}))
    worker.batcher.idle_duration = 0.01
    return cluster, worker


GUARD = ("karpenter_fleet_duplicate_launch_guard_total", {"reason": "fenced"})


def test_fenced_worker_refuses_the_launch():
    def run(M):
        fenced = {"v": False}
        cluster, worker = fenced_worker(M, lambda: fenced["v"])
        pod = M.f.make_pod(name="fenced-pod", requests={"cpu": "0.5"})
        cluster.create("pods", pod)
        worker.add(pod)
        fenced["v"] = True
        before = sample(M, *GUARD)
        worker.provision_once()
        return pod.spec.node_name, cluster.nodes(), sample(M, *GUARD) - before

    assert both(run) == ("", [], 1.0)


def test_unfenced_worker_launches():
    def run(M):
        cluster, worker = fenced_worker(M, lambda: False)
        pod = M.f.make_pod(name="free-pod", requests={"cpu": "0.5"})
        cluster.create("pods", pod)
        worker.add(pod)
        worker.provision_once()
        return bool(pod.spec.node_name), len(cluster.nodes())

    assert both(run) == (True, 1)


def test_fenced_termination_defers_the_cloud_delete():
    def run(M):
        class Provider:
            deletes = 0

            def delete(self, node):
                self.deletes += 1

        fenced = {"v": True}
        cluster, provider = M.client.Cluster(), Provider()
        tc = M.term.TerminationController(cluster, provider, start_queue=False,
                                          fenced=lambda: fenced["v"])
        node = M.f.make_node(name="draining")
        node.metadata.deletion_timestamp = cluster.clock()
        node.metadata.finalizers = [M.lbl.TERMINATION_FINALIZER]
        cluster.seed("nodes", node)
        before = sample(M, *GUARD)
        out = [tc.reconcile("draining") == tc.DRAIN_REQUEUE, provider.deletes,
               sample(M, *GUARD) - before]
        fenced["v"] = False
        return out + [tc.reconcile("draining"), provider.deletes]

    assert both(run) == [True, 0, 1.0, None, 1]


def test_gc_sweep_skips_while_fenced():
    def run(M):
        class Fenced:
            def owns(self, key):
                return True

            def fenced(self):
                return True

        class Provider:
            calls = 0

            def list_instances(self):
                self.calls += 1
                return []

        provider = Provider()
        gc = M.gc.GarbageCollectionController(M.client.Cluster(), provider, ownership=Fenced(),
                                              gc_interval=0.1)
        before = sample(M, *GUARD)
        gc.reconcile(M.gc.GC_POLL_KEY)
        return provider.calls, sample(M, *GUARD) - before

    assert both(run) == (0, 1.0)
