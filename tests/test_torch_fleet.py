"""The port's fleet (``fleet/ownership.py``, ``ReplicaChaos``, ``--shard-lease``
in ``build_runtime``) against the JAX package's.

Exact equality on the same inputs: ``rendezvous_owner`` over 1,000 seeded
keys and member sets of one to five; ``ShardManager`` ticks driven
synchronously on a fake clock (each package its own lease file) — the owned
sets after every step, the ordered ``on_acquired`` / ``on_lost`` calls and
the ``FLEET_*`` metric deltas — over join, crash, handback, wedged-winner
steal, deleted key and clean stop; ``cheapest_fitting_type`` (int32, exact)
on seeded inputs with unopened nodes; ``CircuitBreaker.call``.

Twins, each on both packages: ``tests/test_fleet.py`` (the lease satellites
and ``TestFileLeaseSet`` that ``tests/test_torch_process.py`` does not
already hold, ``TestShardManager``, ``TestBuildLeaseSet``,
``Test{Provisioning,Interruption,Selection,Consolidation}Ownership`` and
``TestReplicaKillEndToEnd`` with ``device="cpu"`` and ``solver: ffd``, as
the reference's); ``tests/test_launch_journal.py``'s ``TestWatchedShardKeys``
and the GC's shard routing; ``tests/test_partition.py``'s two fleet fencing
cases; ``tests/test_resilience.py``'s ``CircuitBreaker.call``.
"""

import importlib
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_launch_journal import launch
from test_torch_leader import FakeClock, Partitioned
from torch_parity import PACKAGES, both_canon, fresh_router, kube, on_cpu, sample  # noqa: F401

PORT = "karpenter_tpu_torch"
FLEET_COUNTERS = ("karpenter_fleet_shard_rebalances_total", "karpenter_fleet_shard_losses_total")


def ns(pkg: str) -> SimpleNamespace:
    """``kube(pkg)`` plus the fleet and the breaker."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return SimpleNamespace(**vars(kube(pkg)), fleet=m("fleet"), breaker=m("resilience.breaker"))


def both(fn):
    return both_canon(fn, ns=ns)


def wait(predicate, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not predicate():
        time.sleep(0.02)
    return predicate()


class FixedOwnership:
    """A ``ShardManager`` stand-in with a fixed owned set."""

    def __init__(self, owned=()):
        self.owned_set = set(owned)

    def owns(self, key):
        return key in self.owned_set


# -- exact equality: placement, tick scripts, cheapest type ------------------------------


def test_rendezvous_owner_places_every_key_alike():
    rng = np.random.default_rng(0)
    keys = [f"prov-{int(k)}" for k in rng.integers(0, 10**9, 1000)]
    pool = [f"replica-{int(i)}" for i in rng.integers(0, 10**6, 40)]
    sets = [list(rng.choice(pool, size=int(rng.integers(1, 6)), replace=False)) for _ in keys]

    def run(M):
        return [M.fleet.rendezvous_owner(k, s) for k, s in zip(keys, sets)]

    owners = both(run)
    assert all(o in s for o, s in zip(owners, sets))
    assert both(lambda M: M.fleet.rendezvous_owner("p0", [])) is None


def tick_script(M, tmp_path, script):
    """Drive ``ShardManager``s by hand over one lease file on a fake clock.
    Returns every step's owned sets, the hooks' calls in order, the
    counters' deltas and the two gauges at the end."""
    now = [0.0]
    path = str(tmp_path / f"shards-{M.pkg}")
    calls, steps = [], []

    def leases(ident):
        return M.lease.FileLeaseSet(path, identity=ident, duration=10, clock=lambda: now[0])

    def manager(ident, keys, lease_set=None):
        return M.fleet.ShardManager(
            lease_set or leases(ident), keys_fn=lambda: keys,
            on_acquired=lambda k: calls.append((ident, "acquired", k)),
            on_lost=lambda k: calls.append((ident, "lost", k)))

    def snap(label, *managers):
        steps.append((label, [sorted(m.owned()) for m in managers]))

    before = {n: sample(M, n) for n in FLEET_COUNTERS}
    if script == "join":
        keys = [f"p{i}" for i in range(12)]
        a = manager("a", keys)
        a.tick()
        snap("alone", a)
        b = manager("b", keys)
        for i in range(3):
            b.tick()
            a.tick()
            snap(f"round {i}", a, b)
    elif script == "crash":
        keys = [f"p{i}" for i in range(8)]
        a, b = manager("a", keys), manager("b", keys)
        for _ in range(3):
            a.tick()
            b.tick()
        snap("both", a, b)
        b.crash()
        now[0] += 5.0
        a.tick()
        snap("holds live", a, b)
        now[0] += 6.0
        a.tick()
        a.tick()
        snap("expired", a, b)
    elif script == "handback":
        keys = [f"p{i}" for i in range(12)]
        a = manager("a", keys)
        a.tick()
        b_leases = leases("b")
        b_leases.heartbeat()
        a.tick()
        snap("handed back", a)
        a.tick()
        snap("winner slow", a)
        b = manager("b", keys, b_leases)
        b.tick()
        snap("winner claims", a, b)
        for _ in range(3):
            a.tick()
            b.tick()
        snap("settled", a, b)
    elif script == "wedged steal":
        keys = [f"p{i}" for i in range(8)]
        a = manager("a", keys)
        wedged = leases("b")
        for label in ("stolen", "stable"):
            for _ in range(4):
                wedged.heartbeat()
                a.tick()
                snap(label, a)
        now[0] += 11.0
        a.tick()
        snap("winner gone", a)
    elif script == "deleted key":
        keys = ["p0", "p1"]
        a = manager("a", keys)
        a.tick()
        keys.remove("p1")
        a.tick()
        snap("deleted", a)
        steps.append(("holder", a.leases.holder("p1")))
    elif script == "clean stop":
        a = manager("a", ["p0"])
        a.tick()
        a.stop()
        snap("stopped", a)
        steps.append(("holder", a.leases.holder("p0")))
    return {"steps": steps, "calls": calls,
            "deltas": {n: sample(M, n) - before[n] for n in FLEET_COUNTERS},
            "owned_gauge": sample(M, "karpenter_fleet_shards_owned"),
            "fenced_gauge": sample(M, "karpenter_fleet_fenced")}


@pytest.mark.parametrize("script", ["join", "crash", "handback", "wedged steal", "deleted key",
                                    "clean stop"])
def test_tick_scripts_match(tmp_path, script):
    out = both(lambda M: tick_script(M, tmp_path, script))
    if script == "crash":
        assert out["deltas"]["karpenter_fleet_shard_rebalances_total"] > 0
        assert out["steps"][-1][1][0] == sorted([f"p{i}" for i in range(8)] + ["__unassigned__"])
    if script in ("deleted key", "clean stop"):
        assert out["steps"][-1] == ("holder", None)
        assert ("a", "lost", "p1" if script == "deleted key" else "p0") in out["calls"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cheapest_fitting_type_matches(seed):
    import jax.numpy as jnp
    import torch

    from karpenter_tpu.solver import kernel as jk
    from karpenter_tpu_torch.solver import kernel as tk

    rng = np.random.default_rng(seed)
    N, R, S, T = 96, 3, 7, 40
    node_req = rng.uniform(0.0, 8.0, (N, R)).astype(np.float32)
    node_sig = rng.integers(-1, S, N).astype(np.int32)
    mask = rng.random((S, T)) < 0.5
    usable = np.sort(rng.uniform(1.0, 9.0, (T, R)).astype(np.float32), axis=0)
    usable[rng.integers(0, T, 5)] = node_req[:5]  # exact ties: <= must hold
    ref = np.asarray(jk.cheapest_fitting_type(
        jnp.asarray(node_req), jnp.asarray(node_sig), jnp.asarray(mask), jnp.asarray(usable)))
    out = tk.cheapest_fitting_type(torch.from_numpy(node_req), torch.from_numpy(node_sig),
                                   torch.from_numpy(mask), torch.from_numpy(usable))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[node_sig < 0] == -1).all() and (ref >= 0).any() and (ref[node_sig >= 0] == -1).any()


def test_circuit_breaker_call_raises_breaker_open_without_calling():
    """``tests/test_resilience.py``'s ``test_call_raises_breaker_open_without_calling``."""
    def run(M):
        clock = FakeClock(0.0)
        b = M.breaker.CircuitBreaker("dep", clock=clock, window=4, min_volume=2,
                                     failure_rate=0.5, open_seconds=10.0)
        raised = []
        for _ in range(2):
            try:
                b.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
            except ConnectionError:
                raised.append("ConnectionError")
        calls = [0]
        try:
            b.call(lambda: calls.__setitem__(0, calls[0] + 1))
        except M.breaker.BreakerOpen as e:
            raised.append(("BreakerOpen", e.dependency, e.retry_in))
        clock.advance(10.1)
        answer = b.call(lambda: 42)
        return raised, calls[0], answer, b.state

    assert both(run) == (["ConnectionError", "ConnectionError", ("BreakerOpen", "dep", 10.0)],
                         0, 42, "closed")


# -- test_fleet.py: the lease satellites and TestFileLeaseSet -------------------------------


def test_holder_reads_under_the_flock(tmp_path, monkeypatch):
    def run(M):
        lease = M.lease.FileLease(str(tmp_path / f"lease-{M.pkg}"), identity="a", duration=10)
        acquired = lease.try_acquire()
        entered = []
        orig = M.lease.FileLease._locked

        def spying_locked(self):
            entered.append(True)
            return orig(self)

        monkeypatch.setattr(M.lease.FileLease, "_locked", spying_locked)
        holder = lease.holder()
        monkeypatch.undo()
        return acquired, holder, bool(entered)

    assert both(run) == (True, "a", True)


def test_stale_tmp_files_swept_on_acquire(tmp_path):
    def run(M):
        path = str(tmp_path / f"lease-{M.pkg}")
        stale, fresh = f"{path}.dead-writer.tmp", f"{path}.live-writer.tmp"
        for name in (stale, fresh):
            with open(name, "w") as f:
                f.write("{")
        old = time.time() - 3600
        os.utime(stale, (old, old))
        M.lease.FileLease(path, identity="a", duration=10).try_acquire()
        return os.path.exists(stale), os.path.exists(fresh)

    assert both(run) == (False, True)


@pytest.mark.parametrize("case", ["once per epoch", "clean stop", "raising backend"])
def test_elector_on_lost_at_most_once(tmp_path, case):
    def run(M):
        calls = []
        lost = lambda: calls.append(1)  # noqa: E731
        if case == "once per epoch":
            elector = M.lease.LeaderElector(
                M.lease.FileLease(str(tmp_path / f"l-{M.pkg}"), identity="x"), on_lost=lost)
            elector._acquired()
            elector._fire_lost()
            elector._fire_lost()
            first = list(calls)
            elector._acquired()
            elector._fire_lost()
            return first, calls
        if case == "clean stop":
            lease = M.lease.FileLease(str(tmp_path / f"l-{M.pkg}"), identity="x")
            elector = M.lease.LeaderElector(lease, on_lost=lost)
            acquired = lease.try_acquire()
            elector._acquired()
            elector.stop()
            elector._fire_lost()
            return acquired, calls

        class RaisingLease:
            def __init__(self):
                self.raising = False

            def try_acquire(self):
                return not self.raising

            def renew(self):
                if self.raising:
                    raise RuntimeError("backend down")
                return True

            def release(self):
                pass

        lease = RaisingLease()
        elector = M.lease.LeaderElector(lease, renew_interval=0.02, on_lost=lost)
        elector.start()
        try:
            led = wait(lambda: elector.is_leader, 5)
            lease.raising = True
            wait(lambda: calls, 5)
            time.sleep(0.1)
            return led, calls
        finally:
            elector.stop()

    out = both(run)
    assert out == {"once per epoch": ([1], [1, 1]), "clean stop": (True, []),
                   "raising backend": (True, [1])}[case]


@pytest.mark.parametrize("case", ["roundtrip", "expired takeover", "membership",
                                  "renew_many one section"])
def test_file_lease_set_cases(tmp_path, case):
    def run(M):
        now = [0.0]
        path = str(tmp_path / f"shards-{M.pkg}")

        def S(ident):
            return M.lease.FileLeaseSet(path, identity=ident, duration=10, clock=lambda: now[0])

        a, b = S("a"), S("b")
        if case == "roundtrip":
            out = [a.try_acquire("p0"), b.try_acquire("p0"), a.holder("p0"),
                   sorted(a.renew_many(["p0"]))]
            a.release("p0")
            return out + [b.try_acquire("p0")]
        if case == "expired takeover":
            out = [a.try_acquire("p0")]
            now[0] = 11.0
            return out + [a.holder("p0"), b.try_acquire("p0"), sorted(a.renew_many(["p0"]))]
        if case == "membership":
            out = [sorted(a.heartbeat()), sorted(b.heartbeat())]
            now[0] = 11.0
            out.append(sorted(b.heartbeat()))
            b.resign()
            now[0] = 12.0
            return out + [sorted(a.heartbeat())]
        keys = [f"p{i}" for i in range(20)]
        held = [a.try_acquire(k) for k in keys]
        renewed = sorted(a.renew_many(keys))
        snap = sorted(a.snapshot())
        a.release_all()
        return all(held), renewed == sorted(keys), snap == sorted(keys), a.snapshot()

    assert both(run) == {
        "roundtrip": [True, False, "a", ["p0"], True],
        "expired takeover": [True, None, True, []],
        "membership": [["a"], ["a", "b"], ["b"], ["a"]],
        "renew_many one section": (True, True, True, {}),
    }[case]


# -- TestShardManager ------------------------------------------------------------------------


def managers(M, tmp_path, idents, keys, now, **kw):
    path = str(tmp_path / f"shards-{M.pkg}")
    return [M.fleet.ShardManager(
        M.lease.FileLeaseSet(path, identity=i, duration=10, clock=lambda: now[0]),
        keys_fn=lambda: keys, **kw) for i in idents]


def test_single_replica_owns_everything(tmp_path):
    def run(M):
        (m,) = managers(M, tmp_path, "a", ["p0", "p1"], [0.0])
        m.tick()
        return sorted(m.owned())

    assert both(run) == ["__unassigned__", "p0", "p1"]


def test_fleet_partitions_disjoint_and_complete(tmp_path):
    keys = [f"p{i}" for i in range(16)]

    def run(M):
        ms = managers(M, tmp_path, "abc", keys, [0.0])
        for _ in range(4):
            for m in ms:
                m.tick()
        return [sorted(m.owned()) for m in ms]

    owned = [set(o) for o in both(run)]
    assert set().union(*owned) == set(keys) | {"__unassigned__"}
    assert all(not (owned[i] & owned[j]) for i in range(3) for j in range(i + 1, 3))
    assert all(owned)


def test_rendezvous_is_deterministic_and_minimal():
    keys = [f"p{i}" for i in range(64)]

    def run(M):
        before = {k: M.fleet.rendezvous_owner(k, ["a", "b", "c"]) for k in keys}
        after = {k: M.fleet.rendezvous_owner(k, ["a", "c"]) for k in keys}
        return before, after

    before, after = both(run)
    assert all(after[k] == before[k] for k in keys if before[k] != "b")


def test_crash_takeover_within_two_lease_durations(tmp_path):
    keys = [f"p{i}" for i in range(8)]

    def run(M):
        now = [0.0]
        ma, mb = managers(M, tmp_path, "ab", keys, now)
        for _ in range(3):
            ma.tick()
            mb.tick()
        dead = mb.owned()
        mb.crash()
        now[0] += 5.0
        ma.tick()
        early = sorted(ma.owned() & dead)
        now[0] += 6.0
        ma.tick()
        ma.tick()
        return bool(dead), early, sorted(ma.owned())

    assert both(run) == (True, [], sorted(keys + ["__unassigned__"]))


def test_on_lost_fires_when_renewal_fails(tmp_path):
    def run(M):
        now, lost = [0.0], []
        (ma,) = managers(M, tmp_path, "a", ["p0"], now, on_lost=lost.append)
        ma.tick()
        owned = ma.owns("p0")
        now[0] = 11.0
        b = M.lease.FileLeaseSet(str(tmp_path / f"shards-{M.pkg}"), identity="b", duration=10,
                                 clock=lambda: now[0])
        took = b.try_acquire("p0")
        ma.tick()
        return owned, took, lost, ma.owns("p0")

    owned, took, lost, still = both(run)
    assert owned and took and "p0" in lost and not still


def test_handback_to_joining_replica(tmp_path):
    keys = [f"p{i}" for i in range(12)]

    def run(M):
        now = [0.0]
        (ma,) = managers(M, tmp_path, "a", keys, now)
        ma.tick()
        alone = len(ma.owned())
        (mb,) = managers(M, tmp_path, "b", keys, now)
        for _ in range(3):
            mb.tick()
            ma.tick()
        return alone, sorted(ma.owned()), sorted(mb.owned())

    alone, a, b = both(run)
    assert alone == 13 and b and not (set(a) & set(b))


def test_renew_interval_derives_from_duration(tmp_path):
    def run(M):
        out = []
        for ident, duration in (("a", 3), ("b", 60)):
            leases = M.lease.FileLeaseSet(str(tmp_path / f"shards-{M.pkg}"), identity=ident,
                                          duration=duration)
            out.append(M.fleet.ShardManager(leases, keys_fn=lambda: ["p0"]).renew_interval)
        return out

    assert both(run) == pytest.approx([1.0, 5.0])


def test_steal_from_wedged_winner_does_not_oscillate(tmp_path):
    keys = [f"p{i}" for i in range(8)]
    everything = sorted(keys + ["__unassigned__"])

    def run(M):
        now = [0.0]
        (ma,) = managers(M, tmp_path, "a", keys, now)
        b = M.lease.FileLeaseSet(str(tmp_path / f"shards-{M.pkg}"), identity="b", duration=10,
                                 clock=lambda: now[0])
        seen = []
        for _ in range(8):
            b.heartbeat()
            ma.tick()
            seen.append(sorted(ma.owned()))
        stolen = sorted(k for k in ma.owned()
                        if M.fleet.rendezvous_owner(k, {"a", "b"}) == "b")
        now[0] += 11.0
        ma.tick()
        return seen[3:], stolen, sorted(ma.owned())

    stable, stolen, last = both(run)
    assert stolen and last == everything and all(s == everything for s in stable)


def test_handback_gives_the_winner_two_full_ticks(tmp_path):
    keys = [f"p{i}" for i in range(12)]

    def run(M):
        now = [0.0]
        (ma,) = managers(M, tmp_path, "a", keys, now)
        ma.tick()
        b = M.lease.FileLeaseSet(str(tmp_path / f"shards-{M.pkg}"), identity="b", duration=10,
                                 clock=lambda: now[0])
        b.heartbeat()
        ma.tick()
        share = sorted(k for k in keys + ["__unassigned__"]
                       if M.fleet.rendezvous_owner(k, {"a", "b"}) == "b")
        after_handback = sorted(ma.owned() & set(share))
        ma.tick()
        after_slow = sorted(ma.owned() & set(share))
        mb = M.fleet.ShardManager(b, keys_fn=lambda: keys)
        mb.tick()
        claimed = sorted(mb.owned())
        for _ in range(3):
            ma.tick()
            mb.tick()
        return share, after_handback, after_slow, claimed, sorted(mb.owned())

    share, after_handback, after_slow, claimed, settled = both(run)
    assert share and after_handback == after_slow == [] and claimed == settled == share


def test_stop_fires_on_lost_before_releasing_the_lease(tmp_path):
    def run(M):
        events = []
        leases = M.lease.FileLeaseSet(str(tmp_path / f"shards-{M.pkg}"), identity="a",
                                      duration=10, clock=lambda: 0.0)
        release = leases.release
        leases.release = lambda key: (events.append(("release", key)), release(key))
        m = M.fleet.ShardManager(leases, keys_fn=lambda: ["p0"],
                                 on_lost=lambda key: events.append(("on_lost", key)),
                                 include_default_shard=False)
        m.tick()
        owned = m.owns("p0")
        m.stop()
        return owned, events

    assert both(run) == (True, [("on_lost", "p0"), ("release", "p0")])


def test_deleted_key_released(tmp_path):
    def run(M):
        keys = ["p0", "p1"]
        (ma,) = managers(M, tmp_path, "a", keys, [0.0])
        ma.tick()
        owned = ma.owns("p1")
        keys.remove("p1")
        ma.tick()
        return owned, ma.owns("p1"), ma.leases.holder("p1")

    assert both(run) == (True, False, None)


def test_clean_stop_releases_and_fires_on_lost(tmp_path):
    def run(M):
        lost = []
        (ma,) = managers(M, tmp_path, "a", ["p0"], [0.0], on_lost=lost.append)
        ma.tick()
        ma.stop()
        return lost, ma.leases.holder("p0"), sorted(ma.owned())

    lost, holder, owned = both(run)
    assert "p0" in lost and holder is None and owned == []


# -- TestBuildLeaseSet -----------------------------------------------------------------------


def test_build_lease_set_file_spec(tmp_path):
    def run(M):
        ls = M.fleet.build_lease_set(str(tmp_path / f"s-{M.pkg}"), identity="x", duration=7)
        return type(ls).__name__, ls.identity, ls.duration, isinstance(ls, M.lease.FileLeaseSet)

    assert both(run) == ("FileLeaseSet", "x", 7, True)


def test_build_lease_set_kube_spec():
    def run(M):
        out = []
        for spec in ("kube:karpenter/shards", "kube:shards", "kube:/"):
            ls = M.fleet.build_lease_set(spec, cluster=M.Cluster(), identity="x")
            out.append((isinstance(ls, M.leader.KubeLeaseSet), ls.namespace, ls.prefix,
                        ls.duration))
        return out

    assert both(run) == [(True, "karpenter", "shards", 15.0),
                         (True, "kube-system", "shards", 15.0),
                         (True, "kube-system", "karpenter-shard", 15.0)]


def test_kube_member_lease_deleted_on_resign_and_stale_gc():
    def run(M):
        now = [0.0]
        cluster = M.Cluster(clock=lambda: now[0])
        a = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="a", duration=10)
        b = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="b", duration=10)
        a.heartbeat()
        b.heartbeat()
        n = [len(cluster.list("leases", namespace="kube-system"))]
        a.resign()
        n.append(len(cluster.list("leases", namespace="kube-system")))
        now[0] += 10 * 4 + 11
        members = sorted(a.heartbeat())
        names = sorted(lease.metadata.name
                       for lease in cluster.list("leases", namespace="kube-system"))
        return n, members, names

    n, members, names = both(run)
    assert n == [2, 1] and members == ["a"] and not any("member-b" in x for x in names)


def test_kube_snapshot_resolves_untouched_keys_via_one_list():
    def run(M):
        cluster = M.Cluster()
        a = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="a", duration=10)
        b = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="b", duration=10)
        return a.try_acquire("p0"), a.try_acquire("p1"), b.snapshot(["p0", "p1", "p2"])

    assert both(run) == (True, True, {"p0": "a", "p1": "a"})


def test_kube_lease_set_prefers_uncached_list_live():
    def run(M):
        calls = {"live": 0, "cached": 0}
        now = [0.0]

        class SpyCluster(M.Cluster):
            def list_live(self, kind, namespace=None):
                calls["live"] += 1
                return M.Cluster.list(self, kind, namespace)

            def list(self, kind, namespace=None):
                calls["cached"] += 1
                return M.Cluster.list(self, kind, namespace)

        cluster = SpyCluster(clock=lambda: now[0])
        a = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="a", duration=10)
        b = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="b", duration=10)
        a.heartbeat()
        members = sorted(b.heartbeat())
        took = a.try_acquire("p0")
        now[0] += 2.0
        return members, took, b.snapshot(["p0"]), calls["live"], calls["cached"]

    members, took, snap, live, cached = both(run)
    assert members == ["a", "b"] and took and snap == {"p0": "a"} and live >= 3 and cached == 0


def test_kube_one_list_serves_heartbeat_and_snapshot():
    def run(M):
        calls = {"live": 0}

        class SpyCluster(M.Cluster):
            def list_live(self, kind, namespace=None):
                calls["live"] += 1
                return M.Cluster.list(self, kind, namespace)

        a = M.fleet.build_lease_set("kube:shards", cluster=SpyCluster(), identity="a",
                                    duration=10)
        a.try_acquire("p0")
        a.heartbeat()
        before = calls["live"]
        return a.snapshot(["p0"]), calls["live"] - before

    assert both(run) == ({"p0": "a"}, 0)


def test_kube_lease_set_coordinates():
    def run(M):
        cluster = M.Cluster()
        a = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="a", duration=10)
        b = M.fleet.build_lease_set("kube:shards", cluster=cluster, identity="b", duration=10)
        out = [sorted(a.heartbeat()), sorted(b.heartbeat()), a.try_acquire("p0"),
               b.try_acquire("p0"), sorted(a.renew_many(["p0"])), b.holder("p0")]
        a.release("p0")
        return out + [b.try_acquire("p0")]

    assert both(run) == [["a"], ["a", "b"], True, False, ["p0"], "a", True]


# -- Test{Provisioning,Interruption,Selection,Consolidation}Ownership -----------------------


def provisioning(M, ownership, cluster=None):
    cluster = cluster or M.Cluster()
    pc = M.prov.ProvisioningController(
        cluster, M.fake.FakeCloudProvider(M.fake.instance_types(5)),
        **on_cpu(M, {"start_workers": False, "ownership": ownership}))
    return cluster, pc


def test_unowned_provisioner_runs_no_worker():
    def run(M):
        cluster, pc = provisioning(M, FixedOwnership())
        cluster.create("provisioners", M.f.make_provisioner())
        requeue = pc.reconcile("default")
        return sorted(pc.workers), requeue

    workers, requeue = both(run)
    assert workers == [] and requeue is not None


def test_owned_provisioner_runs_worker_and_loss_tears_down():
    def run(M):
        ownership = FixedOwnership({"default"})
        cluster, pc = provisioning(M, ownership)
        cluster.create("provisioners", M.f.make_provisioner())
        pc.reconcile("default")
        out = [sorted(pc.workers)]
        ownership.owned_set.clear()
        pc.release_shard("default")
        out.append(sorted(pc.workers))
        pc.reconcile("default")
        return out + [sorted(pc.workers)]

    assert both(run) == [["default"], [], []]


def test_launch_guard_blocks_after_ownership_loss():
    def run(M):
        ownership = FixedOwnership({"default"})
        cluster, pc = provisioning(M, ownership)
        cluster.create("provisioners", M.f.make_provisioner())
        pc.reconcile("default")
        worker = pc.workers["default"]
        worker.batcher.idle_duration = 0.01
        pod = M.f.make_pod(name="guarded", requests={"cpu": "0.5"})
        cluster.create("pods", pod)
        worker.add(pod)
        ownership.owned_set.clear()
        before = sample(M, "karpenter_fleet_duplicate_launch_guard_total",
                        {"reason": "lost_ownership"})
        worker.provision_once()
        return pod.spec.node_name, cluster.nodes(), sample(
            M, "karpenter_fleet_duplicate_launch_guard_total",
            {"reason": "lost_ownership"}) - before

    assert both(run) == ("", [], 1.0)


def test_bind_recheck_never_duplicates():
    def run(M):
        cluster, pc = provisioning(M, FixedOwnership({"default"}))
        cluster.create("provisioners", M.f.make_provisioner())
        pc.reconcile("default")
        worker = pc.workers["default"]
        pod = M.f.make_pod(name="dup-bind", requests={"cpu": "0.5"})
        cluster.create("pods", pod)
        cluster.bind(pod, "other-replicas-node")
        labels = {"reason": "already_bound"}
        before = sample(M, "karpenter_fleet_duplicate_launch_guard_total", labels)
        worker._bind([pod], "my-node")
        return pod.spec.node_name, sample(
            M, "karpenter_fleet_duplicate_launch_guard_total", labels) - before

    assert both(run) == ("other-replicas-node", 1.0)


def interruption(M, ownership, provisioner="default", labelled=True, create_prov=False):
    provider = M.sim.SimulatedCloudProvider(api=M.sim.SimCloudAPI())
    cluster = M.Cluster()
    controller = M.intr.InterruptionController(cluster, provider, ownership=ownership)
    if create_prov:
        cluster.create("provisioners", M.f.make_provisioner())
    labels = {M.lbl.PROVISIONER_NAME_LABEL: provisioner} if labelled else {}
    cluster.create("nodes", M.O.Node(
        metadata=M.O.ObjectMeta(name="n-1", namespace="", labels=labels),
        spec=M.O.NodeSpec(provider_id="sim:///z/n-1")))
    notice = M.itypes.DisruptionNotice(kind=M.itypes.PREEMPTION, node_name="n-1")
    controller.handle_notice(notice)
    polled = [(n.kind, n.node_name) for n in provider.poll_disruptions()]
    return controller.foreign_notices, controller.notices_handled, polled


@pytest.mark.parametrize("case", ["foreign requeued", "owned handled", "deleted provisioner",
                                  "unlabeled node"])
def test_interruption_ownership(case):
    def run(M):
        shard = M.fleet.DEFAULT_SHARD
        if case == "foreign requeued":
            return interruption(M, FixedOwnership())
        if case == "owned handled":
            return interruption(M, FixedOwnership({"default"}), create_prov=True)
        if case == "deleted provisioner":
            return interruption(M, FixedOwnership({shard}), provisioner="long-gone")
        return interruption(M, FixedOwnership({shard}), labelled=False)

    foreign, handled, polled = both(run)
    if case == "foreign requeued":
        assert (foreign, handled, [n for _, n in polled]) == (1, 0, ["n-1"])
    else:
        assert foreign == 0 and polled == []


def test_foreign_pod_requeues_quietly_without_relaxing():
    def run(M):
        ownership = FixedOwnership()
        cluster, pc = provisioning(M, ownership)
        selection = M.sel.SelectionController(cluster, pc, wait=False)
        cluster.create("provisioners", M.f.make_provisioner())
        pod = M.f.make_pod(
            name="foreign", requests={"cpu": "0.5"},
            node_preferences=[M.O.PreferredSchedulingTerm(
                weight=1, preference=M.O.NodeSelectorTerm(match_expressions=[
                    M.O.NodeSelectorRequirement(key="zone-pref", operator="In",
                                                values=["a"])]))])
        cluster.create("pods", pod)
        before = len(pod.spec.affinity.node_affinity.preferred)
        requeue = selection.reconcile("foreign", "default")
        after = len(pod.spec.affinity.node_affinity.preferred)
        ownership.owned_set.add("default")
        pc.reconcile("default")
        selection.reconcile("foreign", "default")
        return requeue is not None, before, after, pc.workers["default"].is_pending(pod.key)

    assert both(run) == (True, 1, 1, True)


def test_overlapping_shards_resolve_by_priority_exactly_once():
    def run(M):
        cluster = M.Cluster()
        cluster.create("provisioners", M.f.make_provisioner(name="aa"))
        cluster.create("provisioners", M.f.make_provisioner(name="zz"))
        _, pc_a = provisioning(M, FixedOwnership({"aa"}), cluster)
        _, pc_z = provisioning(M, FixedOwnership({"zz"}), cluster)
        sel_a = M.sel.SelectionController(cluster, pc_a, wait=False)
        sel_z = M.sel.SelectionController(cluster, pc_z, wait=False)
        pc_a.reconcile("aa")
        pc_z.reconcile("zz")
        pod = M.f.make_pod(name="both", requests={"cpu": "0.5"})
        cluster.create("pods", pod)
        sel_z.reconcile("both", "default")
        z = pc_z.workers["zz"].is_pending(pod.key)
        sel_a.reconcile("both", "default")
        return z, pc_a.workers["aa"].is_pending(pod.key)

    assert both(run) == (False, True)


@pytest.mark.parametrize("owned", [False, True])
def test_consolidation_ownership(owned):
    def run(M):
        cluster = M.Cluster()
        cluster.create("provisioners", M.f.make_provisioner())
        controller = M.cons.ConsolidationController(
            cluster, M.fake.FakeCloudProvider(M.fake.instance_types(5)),
            **on_cpu(M, {"enabled": True,
                         "ownership": FixedOwnership({"default"} if owned else ())}))
        planned = []
        if not owned:
            controller.plan = lambda p: planned.append(p)
        return controller.reconcile("default") is not None, planned

    assert both(run) == (True, [])


# -- test_launch_journal.py: TestWatchedShardKeys and the GC's shard routing ----------------


def test_watched_keys_seed_and_track_watch_events():
    def run(M):
        cluster = M.Cluster()
        cluster.create("provisioners", M.f.make_provisioner(name="pre-existing"))
        keys = M.fleet.WatchedShardKeys(cluster)
        out = [sorted(keys.keys())]
        changes = []
        keys.on_change = lambda: changes.append(1)
        cluster.create("provisioners", M.f.make_provisioner(name="added"))
        out += [sorted(keys.keys()), len(changes)]
        cluster.delete("provisioners", "added", namespace="")
        return out + [sorted(keys.keys()), len(changes)]

    assert both(run) == [["pre-existing"], ["added", "pre-existing"], 1, ["pre-existing"], 2]


def test_request_tick_wakes_the_manager_loop(tmp_path):
    def run(M):
        cluster = M.Cluster()
        leases = M.fleet.build_lease_set(str(tmp_path / f"s-{M.pkg}"), identity="r1",
                                         duration=30.0)
        keys = M.fleet.WatchedShardKeys(cluster)
        mgr = M.fleet.ShardManager(leases, keys_fn=keys.keys, renew_interval=3600.0)
        keys.on_change = mgr.request_tick
        mgr.start()
        try:
            first = wait(lambda: mgr.owns(M.fleet.DEFAULT_SHARD), 5)
            cluster.create("provisioners", M.f.make_provisioner(name="hot-add"))
            return first, wait(lambda: mgr.owns("hot-add"), 5)
        finally:
            mgr.stop()

    assert both(run) == (True, True)


def test_build_runtime_uses_watched_keys(tmp_path):
    def run(M):
        rt = M.main.build_runtime(
            M.options.Options(**on_cpu(M, {"shard_lease": str(tmp_path / f"l-{M.pkg}")})),
            cluster=M.Cluster(), start_workers=False)
        try:
            rt.cluster.create("provisioners", M.f.make_provisioner(name="p1"))
            rt.ownership.tick()
            return rt.ownership.owns("p1")
        finally:
            rt.stop()

    assert both(run) is True


def test_gc_shard_routing_skips_foreign_entries():
    class OwnNothing:
        def owns(self, key):
            return False

    def run(M):
        journal = M.launch.MemoryLaunchJournal(clock=lambda: 0.0)
        cluster = M.Cluster(clock=lambda: 1e10)
        provider = M.sim.SimulatedCloudProvider(M.sim.SimCloudAPI())
        gc = M.gc.GarbageCollectionController(
            cluster, provider, journal=journal,
            termination=M.term.TerminationController(cluster, provider, start_queue=False),
            ownership=OwnNothing(), gc_interval=5.0, grace_period=0.0, replay_after=0.0)
        cluster.create("provisioners", M.f.make_provisioner(name="prov-a"))
        journal.record_intent("tok-1", "prov-a")
        launch(M, provider, "tok-1")
        launch(M, provider)  # an unjournaled leak on the default shard
        gc.reconcile(M.gc.GC_POLL_KEY)
        return gc.adopted, gc.leaks_terminated, len(provider.list_instances()), len(
            journal.unresolved())

    assert both(run) == (0, 0, 2, 1)


# -- test_partition.py: the fleet's fencing ---------------------------------------------------


def test_shard_manager_fences_end_to_end():
    def run(M):
        clock = FakeClock()
        cluster = Partitioned(M.Cluster(clock=clock))
        leases = M.leader.KubeLeaseSet(cluster, identity="r1", duration=10.0)
        gained, lost, out = [], [], []
        mgr = M.fleet.ShardManager(leases, keys_fn=lambda: {"p1"}, on_acquired=gained.append,
                                   on_lost=lost.append, include_default_shard=False)

        def step(label):
            out.append((label, mgr.owns("p1"), list(gained), list(lost), mgr.fenced(),
                        sample(M, "karpenter_fleet_fenced")))

        mgr.tick()
        step("claimed")
        cluster.down = True
        clock.advance(3.0)
        mgr.tick()
        step("blip")
        clock.advance(20.0)
        mgr.tick()
        step("blackout")
        cluster.down = False
        mgr.tick()
        mgr.tick()
        step("healed")
        return out

    assert both(run) == [("claimed", True, ["p1"], [], False, 0.0),
                         ("blip", True, ["p1"], [], False, 0.0),
                         ("blackout", False, ["p1"], ["p1"], True, 1.0),
                         ("healed", True, ["p1", "p1"], ["p1"], False, 0.0)]


def test_file_lease_backends_never_fence(tmp_path):
    def run(M):
        leases = M.fleet.build_lease_set(str(tmp_path / f"s-{M.pkg}"), identity="r1")
        return M.fleet.ShardManager(leases, keys_fn=lambda: set()).fenced()

    assert both(run) is False


# -- TestReplicaKillEndToEnd -------------------------------------------------------------------


def replica_kill(M, tmp_path, lease_duration=1.5, n_prov=6, n_pods=36):
    """Three replicas over one cluster and one lease file; mid-storm the
    owner of a shard is crashed. Every pod binds once and the orphaned
    shards re-home within 2 × the lease duration (+ 2 s of in-process
    scheduling margin, the reference's)."""
    cluster = M.Cluster()
    api = M.sim.SimCloudAPI()
    fleet = M.chaos.ReplicaChaos()
    rebinds, last_node, mu = [], {}, threading.Lock()

    def on_pod(event, pod):
        if event == "DELETED" or not pod.spec.node_name:
            return
        with mu:
            prev = last_node.get(pod.metadata.name)
            if prev and prev != pod.spec.node_name:
                rebinds.append((pod.metadata.name, prev, pod.spec.node_name))
            last_node[pod.metadata.name] = pod.spec.node_name

    cluster.watch("pods", on_pod)
    lease_path = str(tmp_path / f"shards-{M.pkg}")
    try:
        for i in range(3):
            rt = M.main.build_runtime(
                M.options.Options(**on_cpu(M, {"shard_lease": lease_path,
                                               "shard_lease_duration": lease_duration})),
                cluster=cluster, cloud_provider=M.sim.SimulatedCloudProvider(api=api),
                shard_identity=f"replica-{i}")
            rt.ownership.renew_interval = 0.15
            rt.ownership.start()
            rt.manager.start()
            fleet.add(f"replica-{i}", rt)
        names = [f"fleet-{i}" for i in range(n_prov)]
        for name in names:
            cluster.create("provisioners", M.f.make_provisioner(
                name=name, solver="ffd", requirements=[M.O.NodeSelectorRequirement(
                    key="fleet", operator="In", values=[name])]))
        owned = wait(lambda: all(
            rt is not None and n in rt.provisioning.workers
            for n, (_, rt) in ((n, fleet.owner_named(n)) for n in names)), 20)
        for rt in fleet.replicas.values():
            for w in rt.provisioning.workers.values():
                w.batcher.idle_duration = 0.05
        pods = [M.f.make_pod(name=f"ha-{i}", requests={"cpu": "0.25"},
                             node_selector={"fleet": names[i % n_prov]}) for i in range(n_pods)]
        for p in pods:
            cluster.create("pods", p)
        time.sleep(0.2)
        victim, victim_rt = fleet.owner_named(names[0])
        victim_shards = frozenset(victim_rt.ownership.owned())
        t_kill = time.perf_counter()
        fleet.kill(victim)
        rebalanced_at = None
        deadline = time.time() + lease_duration * 6
        while time.time() < deadline:
            survivors = set().union(*(rt.ownership.owned() for rt in fleet.replicas.values()))
            if victim_shards <= survivors:
                rebalanced_at = time.perf_counter() - t_kill
                break
            time.sleep(0.05)
        bound = wait(lambda: all(p.spec.node_name for p in pods), 60)
        return {"owned": owned, "bound": bound, "rebinds": rebinds, "killed": sorted(fleet.killed),
                "rebalanced": rebalanced_at is not None,
                "within_bar": rebalanced_at is not None
                and rebalanced_at <= 2 * lease_duration + 2.0,
                "replicas": sorted(fleet.owned_shards())}
    finally:
        fleet.stop_all()


def test_three_replicas_survive_owner_crash_no_duplicate_binds(tmp_path):
    out = both(lambda M: replica_kill(M, tmp_path))
    assert out["owned"] and out["bound"] and out["rebinds"] == []
    assert out["rebalanced"] and out["within_bar"] and len(out["replicas"]) == 2
