"""The sidecar pool (``karpenter_tpu_torch.solver.pool``) against the JAX
package's, on the CPU.

- ``HashRing``: ``route`` and ``ordered`` equal the reference's for the
  same members and keys (hypothesis), and the ring's own properties hold
  in both packages;
- twins of the reference's failover, soft-breaker and scheduler tests over
  the port's ``serve()`` with ``SolverService(device="cpu")`` members (the
  soft-breaker tests run both packages' pools over the same fake clients);
- a mixed pool of one JAX sidecar and one port sidecar gives the plans of
  either alone.

Small sizes; every sidecar pins ``KARPENTER_PACKER=scan``.
"""

import importlib
import random
import socket

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from karpenter_tpu.solver import pool as JP
from karpenter_tpu.solver import service as J
from karpenter_tpu_torch.solver import pool as TP
from karpenter_tpu_torch.solver import service as T
from karpenter_tpu_torch.solver.pool import HashRing, PoolExhausted, SolverPool
from torch_parity import encode_scenario, fresh_router, mods, packer, scenario  # noqa: F401

N = T.N_POD_ARRAYS


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def serve_port(address):
    return T.serve(address, service=T.SolverService(device="cpu"))


def pack_args(n_pods=8, n_types=8):
    prov, cat, _ = scenario("karpenter_tpu", "diverse", 0, n_types=n_types)
    pods = [mods("karpenter_tpu").factories.make_pod(requests={"cpu": "0.5"})
            for _ in range(n_pods)]
    batch = encode_scenario("karpenter_tpu", prov, cat, pods)
    return tuple(np.asarray(a) for a in batch.pack_args())


def local_pack(args, n_max):
    import torch

    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
    from karpenter_tpu_torch.solver.kernel import pack_reference

    return pack_reference(*(torch.tensor(a, dtype=dt) for a, (_, dt) in
                            zip(args, PACK_ARG_DTYPES)), n_max=n_max)


def assert_results_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture
def scan():
    with packer("scan"):
        yield


# -- the ring -------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(
    members=hst.lists(hst.text(min_size=1, max_size=12), min_size=1, max_size=6),
    keys=hst.lists(hst.binary(min_size=0, max_size=24), min_size=1, max_size=8),
    vnodes=hst.sampled_from([1, 8, 64]),
)
def test_ring_routes_equal_the_reference(members, keys, vnodes):
    ring, ref = HashRing(members, vnodes), JP.HashRing(members, vnodes)
    assert ring.members == ref.members
    for key in keys:
        assert ring.route(key) == ref.route(key)
        assert ring.ordered(key) == ref.ordered(key)


def test_pool_constants_match():
    assert (TP.RING_VNODES, TP.MEMBER_BREAKER_SECONDS) == (JP.RING_VNODES, JP.MEMBER_BREAKER_SECONDS)
    assert TP.SolverPool.KEY_MEMO_MAX == JP.SolverPool.KEY_MEMO_MAX


@pytest.mark.parametrize("pool_mod", [JP, TP], ids=["jax", "port"])
def test_ring_properties(pool_mod):
    ring = pool_mod.HashRing(["a:1", "b:1", "c:1"])
    key = b"\x07" * 16
    order = ring.ordered(key)
    assert order == ring.ordered(key) and order[0] == ring.route(key)
    assert len(order) == len(set(order)) == 3
    # removing a member moves only its keys
    smaller = pool_mod.HashRing(["a:1", "c:1"])
    for k in (bytes([i]) * 16 for i in range(64)):
        if ring.route(k) != "b:1":
            assert smaller.route(k) == ring.route(k)
    counts = {"a:1": 0, "b:1": 0}
    two = pool_mod.HashRing(["a:1", "b:1"])
    for i in range(512):
        counts[two.route(i.to_bytes(4, "little") * 4)] += 1
    assert min(counts.values()) > 512 * 0.25
    with pytest.raises(ValueError):
        pool_mod.HashRing([])


# -- failover over live sidecars ----------------------------------------------


def test_routes_by_session_affinity_and_solves(scan):
    addrs = [free_address(), free_address()]
    servers = {a: serve_port(a) for a in addrs}
    pool = SolverPool(addrs, timeout=30)
    try:
        args = pack_args()
        n_max = len(args[0])
        assert_results_equal(pool.pack(*args, n_max=n_max), local_pack(args, n_max))
        primary = pool.ring.route(pool._catalog_key(args[N:]))
        # the same member the reference's pool routes this session to
        assert primary == JP.HashRing(addrs).route(J.catalog_session_key(*args[N:]))
        for a, s in servers.items():
            assert s.solver_service.session_count() == (1 if a == primary else 0)
        assert pool.health()
    finally:
        pool.close()
        for s in servers.values():
            s.stop(grace=0)


def test_dead_member_fails_over_through_the_ring(scan):
    addrs = [free_address(), free_address()]
    servers = {a: serve_port(a) for a in addrs}
    pool = SolverPool(addrs, timeout=5)
    try:
        args = pack_args()
        n_max = len(args[0])
        pool.pack(*args, n_max=n_max)
        primary = pool.ring.route(pool._catalog_key(args[N:]))
        survivor = next(a for a in addrs if a != primary)
        servers[primary].stop(grace=0)
        assert_results_equal(pool.pack(*args, n_max=n_max), local_pack(args, n_max))
        assert pool.failovers == 1
        assert servers[survivor].solver_service.session_count() == 1
        assert not pool._breaker(primary).available()
        assert pool.available_members() == [survivor]
    finally:
        pool.close()
        for s in servers.values():
            s.stop(grace=0)


def test_needs_catalog_on_failover_member_reuploads_transparently(scan):
    """The failover member's client remembers the session but its store
    is empty (a restart): NEEDS_CATALOG re-uploads there, one miss for the
    logical solve, and the dead primary's breaker stays its own."""
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.solver import session_stats

    addrs = [free_address(), free_address()]
    servers = {a: serve_port(a) for a in addrs}
    pool = SolverPool(addrs, timeout=5)
    try:
        args = pack_args()
        n_max = len(args[0])
        key = pool._catalog_key(args[N:])
        primary = pool.ring.route(key)
        survivor = next(a for a in addrs if a != primary)
        pool.pack(*args, n_max=n_max)
        pool._client(survivor)._open_session(key, args[N:], timeout=30)
        servers[survivor].stop(grace=0)
        servers[survivor] = serve_port(survivor)
        assert servers[survivor].solver_service.session_count() == 0
        uploads = "karpenter_solver_session_catalog_uploads_total"
        before = session_stats.snapshot()
        uploaded = metrics.REGISTRY.get_sample_value(uploads) or 0.0
        servers[primary].stop(grace=0)
        assert_results_equal(pool.pack(*args, n_max=n_max), local_pack(args, n_max))
        after = session_stats.snapshot()
        assert servers[survivor].solver_service.session_count() == 1
        assert metrics.REGISTRY.get_sample_value(uploads) == uploaded + 1
        assert after["misses"] == before["misses"] + 1
        for _ in range(3):
            pool.pack(*args, n_max=n_max)
        assert pool._breaker(survivor).available()
    finally:
        pool.close()
        for s in servers.values():
            s.stop(grace=0)


def test_all_members_dead_raises_pool_exhausted(scan):
    addrs = [free_address(), free_address()]
    servers = [serve_port(a) for a in addrs]
    pool = SolverPool(addrs, timeout=2)
    try:
        args = pack_args()
        n_max = len(args[0])
        pool.pack(*args, n_max=n_max)
        for s in servers:
            s.stop(grace=0)
        with pytest.raises(Exception):
            pool.pack(*args, n_max=n_max)
        # both breakers open: refused without an RPC
        with pytest.raises(PoolExhausted):
            pool.pack(*args, n_max=n_max)
    finally:
        pool.close()


# -- the soft breaker, both packages over the same fake clients -----------------


POOLS = [JP, TP]
ERRORS = {
    JP: importlib.import_module("karpenter_tpu.resilience.overload"),
    TP: importlib.import_module("karpenter_tpu_torch.resilience.overload"),
}


def fake_inputs():
    return tuple(np.full(4, i, np.float32) for i in range(N + 3))


def fake_pool(pool_mod, behaviors, clock):
    """Clients whose dispatch succeeds and whose ``wait`` runs
    ``behaviors[address](address)``."""
    calls = {a: 0 for a in behaviors}

    class FakeClient:
        def __init__(self, address):
            self.address = address

        def pack_begin(self, *inputs, n_max, prof=None, record=True):
            calls[self.address] += 1
            return lambda: behaviors[self.address](self.address)

        def close(self):
            pass

    pool = pool_mod.SolverPool(list(behaviors), client_factory=FakeClient,
                               clock=lambda: clock[0])
    return pool, calls


@pytest.mark.parametrize("pool_mod", POOLS, ids=["jax", "port"])
def test_overloaded_member_sat_out_for_hint_window(pool_mod):
    err = ERRORS[pool_mod]
    clock = [0.0]

    def overloaded(addr):
        raise err.OverloadedError(f"{addr} full", retry_after=5.0)

    inputs = fake_inputs()
    behaviors = {"a:1": overloaded, "b:1": lambda addr: ("ok", addr)}
    pool, calls = fake_pool(pool_mod, behaviors, clock)
    order = pool.ring.ordered(pool._catalog_key(inputs[N:]))
    first, survivor = order
    if first == "b:1":
        behaviors["b:1"], behaviors["a:1"] = behaviors["a:1"], behaviors["b:1"]
    assert pool.pack_begin(*inputs, n_max=4)() == ("ok", survivor)
    assert pool._breaker(first).available() and pool.overload_skips == 1
    calls_before = calls[first]
    assert pool.pack_begin(*inputs, n_max=4)() == ("ok", survivor)
    assert calls[first] == calls_before and pool.overload_skips == 2
    clock[0] = 6.0
    behaviors[first] = lambda addr: ("recovered", addr)
    assert pool.pack_begin(*inputs, n_max=4)() == ("recovered", first)
    pool.close()


@pytest.mark.parametrize("pool_mod", POOLS, ids=["jax", "port"])
def test_all_members_overloaded_raises_typed_verdict(pool_mod):
    err = ERRORS[pool_mod]

    def full(hint):
        def raise_(addr):
            raise err.OverloadedError(f"{addr} full", retry_after=hint)
        return raise_

    pool, _ = fake_pool(pool_mod, {"a:1": full(2.0), "b:1": full(7.0)}, [0.0])
    with pytest.raises(err.OverloadedError) as ei:
        pool.pack_begin(*fake_inputs(), n_max=4)()
    assert ei.value.retry_after == 2.0
    assert set(pool.available_members()) == {"a:1", "b:1"}


@pytest.mark.parametrize("pool_mod", POOLS, ids=["jax", "port"])
def test_real_failure_then_overloaded_survivor_is_exhaustion(pool_mod):
    err = ERRORS[pool_mod]

    def hard_fail(addr):
        raise RuntimeError(f"{addr} segfaulted mid-solve")

    def overloaded(addr):
        raise err.OverloadedError(f"{addr} full", retry_after=3.0)

    inputs = fake_inputs()
    behaviors = {"a:1": hard_fail, "b:1": overloaded}
    pool, _ = fake_pool(pool_mod, behaviors, [0.0])
    if pool.ring.route(pool._catalog_key(inputs[N:])) != "a:1":
        behaviors["a:1"], behaviors["b:1"] = behaviors["b:1"], behaviors["a:1"]
    with pytest.raises(pool_mod.PoolExhausted, match="segfaulted"):
        pool.pack_begin(*inputs, n_max=4)()


@pytest.mark.parametrize("pool_mod", POOLS, ids=["jax", "port"])
def test_deadline_exceeded_propagates_without_failover(pool_mod):
    err = ERRORS[pool_mod]

    def doomed(addr):
        raise err.DeadlineExceededError("round budget expired")

    inputs = fake_inputs()
    pool, calls = fake_pool(pool_mod, {"a:1": doomed, "b:1": doomed}, [0.0])
    primary = pool.ring.route(pool._catalog_key(inputs[N:]))
    with pytest.raises(err.DeadlineExceededError):
        pool.pack_begin(*inputs, n_max=4)()
    assert calls[next(a for a in ("a:1", "b:1") if a != primary)] == 0
    assert set(pool.available_members()) == {"a:1", "b:1"}


@pytest.mark.parametrize("pool_mod", POOLS, ids=["jax", "port"])
def test_dispatch_time_overload_skips_to_next_member(pool_mod):
    err = ERRORS[pool_mod]
    primary_box = [None]

    class DispatchOverloaded:
        def __init__(self, address):
            self.address = address

        def pack_begin(self, *a, **kw):
            if self.address == primary_box[0]:
                raise err.OverloadedError("full at dispatch", retry_after=3.0)
            return lambda: ("ok", self.address)

        def close(self):
            pass

    inputs = fake_inputs()
    pool = pool_mod.SolverPool(["a:1", "b:1"], client_factory=DispatchOverloaded,
                               clock=lambda: 0.0)
    primary_box[0] = pool.ring.route(pool._catalog_key(inputs[N:]))
    survivor = next(a for a in ("a:1", "b:1") if a != primary_box[0])
    assert pool.pack_begin(*inputs, n_max=4)() == ("ok", survivor)
    assert pool._breaker(primary_box[0]).available()
    assert (pool.overload_skips, pool.failovers) == (1, 0)


def test_integrity_error_quarantines_and_fires_the_hook():
    from karpenter_tpu_torch.resilience.integrity import IntegrityError
    from karpenter_tpu_torch.solver import integrity

    def corrupt(addr):
        raise IntegrityError(f"{addr} bad frame", address=addr, kind="checksum")

    inputs = fake_inputs()
    behaviors = {"a:1": corrupt, "b:1": lambda addr: ("ok", addr)}
    pool, _ = fake_pool(TP, behaviors, [0.0])
    primary = pool.ring.route(pool._catalog_key(inputs[N:]))
    if primary != "a:1":
        behaviors["a:1"], behaviors["b:1"] = behaviors["b:1"], behaviors["a:1"]
    events = []
    pool.on_quarantine = lambda *a: events.append(a)
    assert pool.pack_begin(*inputs, n_max=4)()[0] == "ok"
    assert not pool._breaker(primary).available() and pool.failovers == 1
    assert events == [("checksum", primary, f"{primary} bad frame")]
    assert integrity.snapshot()["quarantines"] == {primary: 1}


# -- the scheduler -------------------------------------------------------------


def run(pkg, address, rounds=1, **kw):
    M = mods(pkg)
    Scheduler = importlib.import_module(f"{pkg}.scheduling.scheduler").Scheduler
    extra = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    sched = Scheduler(M.Cluster(), rng=random.Random(1), solver_service_address=address,
                      **extra, **kw)
    prov, catalog, pods = scenario(pkg, "diverse", 300, n_types=50)
    plans, profs = [], []
    with packer("device" if pkg == "karpenter_tpu" else "fused"):
        for _ in range(rounds):
            nodes = sched.solve(prov, catalog, pods)
            plans.append(sorted(sorted(pods.index(p) for p in n.pods) for n in nodes))
            profs.append(sched.last_stage_profile())
    return sched, plans, profs


def test_scheduler_solves_through_pool_and_degrades_to_ffd():
    a, b = free_address(), free_address()
    servers = [serve_port(a), serve_port(b)]
    try:
        sched, plans, profs = run("karpenter_tpu_torch", f"{a},{b}", rounds=2, solver_stream=True)
        assert isinstance(sched.torch._remote_or_init(), SolverPool)
        assert [p["packer_backend"] for p in profs] == ["sidecar", "sidecar"]
        assert profs[1]["solver_transport"] == "stream" and plans[0] == plans[1]
        assert sum(len(p) for p in plans[0]) == 300
        sched.torch._remote.close()
    finally:
        for s in servers:
            s.stop(grace=0)
    # a dead pool: the outer breaker, then the floor on a cpu scheduler
    dead = f"{free_address()},{free_address()}"
    sched, plans, profs = run("karpenter_tpu_torch", dead)
    assert profs[0]["packer_backend"] in ("native", "pack_reference")
    assert sched.torch._remote_breaker.state == "open"
    assert sum(len(p) for p in plans[0]) == 300


@pytest.mark.parametrize("floor", [True, False], ids=["cpu-floor", "no-floor"])
def test_dead_pool_and_failed_local_pack_take_the_floor_or_raise(floor, monkeypatch):
    """Every member dead and the in-process pack failing too: a cpu
    scheduler serves the batch from the FFD floor; one without the floor
    (as on the card) raises."""
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    def broken(self, *a, **k):
        raise RuntimeError("in-process pack down (test)")

    monkeypatch.setattr(TorchScheduler, "_pack_local_begin", broken)
    dead = f"{free_address()},{free_address()}"
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_service_address=dead)
    sched.torch._floor_serves = floor
    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 100, n_types=50)
    with packer("fused"):
        if floor:
            nodes = sched.solve(prov, catalog, pods)
            assert sched.last_stage_profile()["packer_backend"] == "ffd-degraded"
            assert sum(len(n.pods) for n in nodes) == 100
        else:
            with pytest.raises(RuntimeError, match="in-process pack down"):
                sched.solve(prov, catalog, pods)
    assert isinstance(sched.torch._remote, SolverPool)
    assert sched.torch._remote_breaker.state == "open"


def test_overloaded_pool_packs_in_process():
    a = free_address()
    server = T.serve(a, service=T.SolverService(device="cpu", max_inflight=1, queue_depth=0))
    b = free_address()
    server_b = T.serve(b, service=T.SolverService(device="cpu", max_inflight=1, queue_depth=0))
    try:
        sched, plans, _ = run("karpenter_tpu_torch", f"{a},{b}")
        gates = [s.solver_service.admission for s in (server, server_b)]
        for g in gates:
            assert g.enter() == "admitted"
        prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 300, n_types=50)
        try:
            with packer("fused"):
                nodes = sched.solve(prov, catalog, pods)
        finally:
            for g in gates:
                g.leave()
        prof = sched.last_stage_profile()
        assert prof["packer_backend"] in ("native", "pack_reference")
        assert sorted(sorted(pods.index(p) for p in n.pods) for n in nodes) == plans[0]
        assert sched.torch._remote_breaker.state == "closed"
        assert sched.torch._remote.overload_skips >= 1
        sched.torch._remote.close()
    finally:
        server.stop(grace=0)
        server_b.stop(grace=0)


def test_mixed_pool_plans_equal_either_alone():
    """One JAX sidecar and one port sidecar in one pool: whichever member
    the ring picks, and after the other is killed, the plan is the one
    either sidecar gives alone."""
    ja, ta = free_address(), free_address()
    servers = {ja: J.serve(ja), ta: serve_port(ta)}
    try:
        _, alone_j, _ = run("karpenter_tpu_torch", ja)
        _, alone_t, _ = run("karpenter_tpu_torch", ta)
        assert alone_j == alone_t
        sched, plans, profs = run("karpenter_tpu_torch", f"{ja},{ta}", rounds=2,
                                  solver_stream=True)
        assert plans == alone_j * 2
        served_by = profs[0]["solver_address"]
        servers.pop(served_by).stop(grace=0)
        prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 300, n_types=50)
        with packer("fused"):
            nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert prof["packer_backend"] == "sidecar" and prof["solver_address"] != served_by
        assert sorted(sorted(pods.index(p) for p in n.pods) for n in nodes) == alone_j[0]
        assert sched.torch._remote.failovers == 1
        assert sched.torch._remote_breaker.state == "closed"
        sched.torch._remote.close()
    finally:
        for s in servers.values():
            s.stop(grace=0)


def test_streamed_pool_fails_over_through_needs_catalog():
    """A pool over streams: the session's member dies; the survivor, whose
    client holds the session as open while its restarted store is empty,
    re-opens it over its own new stream and serves the round."""
    a, b = free_address(), free_address()
    servers = {a: serve_port(a), b: serve_port(b)}
    try:
        sched, plans, profs = run("karpenter_tpu_torch", f"{a},{b}", rounds=2, solver_stream=True)
        owner = profs[0]["solver_address"]
        key = bytes.fromhex(profs[0]["session_key"])
        assert owner == JP.HashRing([a, b]).route(key) == profs[1]["solver_address"]
        survivor = b if owner == a else a
        pool = sched.torch._remote
        catalog_side = next(arrays for arrays, k in pool._key_memo._memo.values() if k == key)
        pool._client(survivor)._open_session(key, catalog_side, timeout=30)
        servers.pop(survivor).stop(grace=None)
        servers[survivor] = serve_port(survivor)
        servers.pop(owner).stop(grace=None)
        uploads = pool._client(survivor).session_uploads
        prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 300, n_types=50)
        sched.torch.topology.rng = random.Random(1)
        with packer("fused"):
            nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert (prof["packer_backend"], prof["solver_address"]) == ("sidecar", survivor)
        assert prof["solver_transport"] == "stream"
        assert sorted(sorted(pods.index(p) for p in n.pods) for n in nodes) == plans[0]
        assert pool.failovers == 1 and pool._client(survivor).session_uploads == uploads + 1
        assert servers[survivor].stream_server_box[0].snapshot()["stream_opens"] == 1
        assert sched.torch._remote_breaker.state == "closed"
        pool.close()
    finally:
        for s in servers.values():
            s.stop(grace=0)
