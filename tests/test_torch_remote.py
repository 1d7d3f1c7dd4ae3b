"""The solver sidecar over real gRPC on localhost, across packages.

- the port's ``RemoteSolver`` against the JAX package's ``serve()``, and
  the JAX ``RemoteSolver`` (``stream=True`` included: the port's sidecar
  advertises the stream, which opens and carries the solves) against the
  port's ``serve()``: results equal the in-process pack, with checksums on
  and off and with delta frames; session LRU eviction and a restart
  re-open;
- scheduler level: ``Scheduler(..., solver_service_address=...)`` of both
  packages give equal plans; the remote breaker after a killed sidecar; the
  deadline and overload sheds; a canary mismatch on a sidecar round trips
  the remote breaker, as in the reference.

Small sizes; every side pins its packer (``torch_parity.pinned``; the
sidecars read ``KARPENTER_PACKER`` in this same process).
"""

import random
import socket

import numpy as np
import pytest

from karpenter_tpu.solver import service as J
from karpenter_tpu_torch.solver import service as T
from torch_parity import (  # noqa: F401
    encode_scenario,
    fresh_router,
    mods,
    packer,
    scenario,
    team_mix,
)

FEATURES = J.PROTO_FEATURES
# what packs in process on a cpu scheduler's unfused ladder
HOST_RUNGS = ("native", "pack_reference")


def free_address() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def start(side, address=None, **kw):
    """A sidecar of ``side``'s package on ``address`` (a free one)."""
    address = address or free_address()
    svc = side.SolverService(**({"device": "cpu"} if side is T else {}), **kw)
    return address, side.serve(address, service=svc)


def client(side, address, **kw):
    return side.RemoteSolver(address, timeout=30, cold_timeout=60, **kw)


def batch_args(name="diverse", n_pods=200, seed=42):
    prov, cat, pods = scenario("karpenter_tpu", name, n_pods, seed=seed, n_types=50)
    batch = encode_scenario("karpenter_tpu", prov, cat, pods)
    return [np.asarray(a) for a in batch.pack_args()]


def local_pack(args, n_max):
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
    import torch

    out = pack_reference(*(torch.tensor(a, dtype=dt) for a, (_, dt) in
                           zip(args, PACK_ARG_DTYPES)), n_max=n_max)
    return [np.asarray(x) for x in out]


def assert_result(remote, args, n_max):
    for want, got in zip(local_pack(args, n_max), remote):
        np.testing.assert_array_equal(want, np.asarray(got))


@pytest.fixture
def scan():
    with packer("scan"):
        yield


PAIRS = [("port->jax", T, J, {}), ("jax->port", J, T, {}),
         ("jax(stream)->port", J, T, {"stream": True})]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("name,cli,srv,extra", PAIRS, ids=[p[0] for p in PAIRS])
def test_cross_package_pack_equals_in_process(scan, name, cli, srv, extra, checksum):
    address, server = start(srv)
    try:
        rs = client(cli, address, checksum=checksum, **extra)
        for args in (batch_args(), batch_args("teams", 300)):
            n_max = max(256, len(args[0]) // 4)
            prof = {}
            out = rs.pack_begin(*args, n_max=n_max, prof=prof)()
            assert_result(out, args, n_max)
            assert prof["wire_ser_s"] >= 0 and prof["solver_address"] == address
            assert prof["solver_transport"] == ("stream" if extra else "unary")
        assert rs.session_uploads == 2
        if srv is T:
            assert server.solver_service.served == {"pack_reference": 2}
            assert rs._server_features == FEATURES
            if extra:
                # the port's sidecar advertises PROTO_STREAM: the stream
                # opened and carried both solves
                assert rs._stream is not None and rs._stream.up
                assert server.stream_server_box[0].snapshot()["stream_solves"] == 2
        rs.close()
    finally:
        server.stop(grace=None)


@pytest.mark.parametrize("name,cli,srv,extra", PAIRS[:2], ids=[p[0] for p in PAIRS[:2]])
def test_cross_package_delta_frames(scan, name, cli, srv, extra):
    address, server = start(srv)
    try:
        rs = client(cli, address, delta=True, checksum=True)
        args = batch_args()
        n_max = 256
        kinds = []
        pods = [a.copy() for a in args[:7]]
        for r in range(4):
            if r == 2:
                pods = [a.copy() for a in pods]
                pods[6][0] *= 2  # one changed row: a patch
            cur = pods + args[7:]
            prof = {}
            assert_result(rs.pack_begin(*cur, n_max=n_max, prof=prof)(), cur, n_max)
            kinds.append(prof["delta_kind"])
        assert kinds == ["establish", "elide", "patch", "elide"]
        stats = server.solver_service.delta_stats
        assert (stats["established"], stats["elided"], stats["patched"]) == (1, 2, 1)
        rs.close()
    finally:
        server.stop(grace=None)


@pytest.mark.parametrize("cli", [T, J], ids=["port", "jax"])
def test_lru_eviction_and_restart_reopen_against_port(scan, cli):
    address, server = start(T, session_max=1)
    try:
        rs = client(cli, address)
        a, b = batch_args(), batch_args("teams", 200)
        for args in (a, b, a):
            assert_result(rs.pack(*args, n_max=256), args, 256)
        # every solve after the first met an evicted session: re-opened
        assert rs.session_uploads == 3
        server.stop(grace=None)
        address, server = start(T, address)
        assert server.solver_service.session_count() == 0
        assert_result(rs.pack(*a, n_max=256), a, 256)
        assert rs.session_uploads == 4 and server.solver_service.dispatches == 1
        rs.close()
    finally:
        server.stop(grace=None)


def test_port_client_against_jax_restart(scan):
    address, server = start(J)
    try:
        rs = client(T, address, checksum=True)
        a = batch_args()
        assert_result(rs.pack(*a, n_max=256), a, 256)
        server.stop(grace=None)
        address, server = start(J, address)
        assert_result(rs.pack(*a, n_max=256), a, 256)
        assert rs.session_uploads == 2
        rs.close()
    finally:
        server.stop(grace=None)


def test_port_client_typed_verdicts(scan):
    from karpenter_tpu_torch.resilience import (
        Budget, DeadlineExceededError, OverloadedError,
    )

    address, server = start(T, max_inflight=1, queue_depth=0, overload_retry_after=0.5)
    try:
        rs = client(T, address)
        a = batch_args()
        rs.pack(*a, n_max=256)
        gate = server.solver_service.admission
        assert gate.enter() == "admitted"
        try:
            with pytest.raises(OverloadedError) as e:
                rs.pack(*a, n_max=256)
            assert e.value.retry_after == 0.5
        finally:
            gate.leave()
        with Budget(0.0).activate():
            with pytest.raises(DeadlineExceededError, match="before solver dispatch"):
                rs.pack(*a, n_max=256)
        with pytest.raises(RuntimeError, match="unknown solver status word 9"):
            rs._check_status(9, [])
        rs.close()
    finally:
        server.stop(grace=None)


# -- scheduler level -----------------------------------------------------------


def run_scheduler(pkg, address, pods_fn, rounds=1, **kw):
    M = mods(pkg)
    Scheduler = __import__(f"{pkg}.scheduling.scheduler", fromlist=["Scheduler"]).Scheduler
    extra = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    sched = Scheduler(M.Cluster(), rng=random.Random(1), solver_service_address=address,
                      **extra, **kw)
    prov, catalog, pods = pods_fn(pkg)
    plans, profs = [], []
    # the JAX side pins its device path ("device"), the port its own
    # ("fused"), so neither routes to native and both reach the sidecar
    with packer("device" if pkg == "karpenter_tpu" else "fused"):
        for _ in range(rounds):
            nodes = sched.solve(prov, catalog, pods)
            plans.append(sorted(sorted(pods.index(p) for p in n.pods) for n in nodes))
            profs.append(sched.last_stage_profile())
    return sched, plans, profs


def diverse(pkg):
    return scenario(pkg, "diverse", 300, n_types=50)


def teams(pkg):
    return team_mix(pkg, 300, n_types=50)


@pytest.mark.parametrize("pods_fn", [diverse, teams], ids=["diverse", "team-mix"])
def test_scheduler_plans_equal_through_either_sidecar(pods_fn):
    j_addr, j_server = start(J)
    t_addr, t_server = start(T)
    try:
        plans = {}
        for pkg, addr in (("karpenter_tpu", j_addr), ("karpenter_tpu_torch", t_addr),
                          ("karpenter_tpu_torch", j_addr)):
            _, p, profs = run_scheduler(pkg, addr, pods_fn, rounds=2)
            assert p[0] == p[1]
            plans[(pkg, addr)] = p[0]
            want = "device" if pkg == "karpenter_tpu" else "sidecar"
            assert [pr["packer_backend"] for pr in profs] == [want, want]
            assert all(pr["solver_address"] == addr for pr in profs)
        assert len({str(v) for v in plans.values()}) == 1
        assert t_server.solver_service.dispatches == 2
    finally:
        j_server.stop(grace=None)
        t_server.stop(grace=None)


def test_killed_sidecar_opens_the_breaker_and_packs_in_process():
    address, server = start(T)
    sched, plans, profs = run_scheduler("karpenter_tpu_torch", address, diverse)
    assert profs[0]["packer_backend"] == "sidecar"
    server.stop(grace=None)
    prov, catalog, pods = diverse("karpenter_tpu_torch")
    with packer("fused"):
        nodes = sched.solve(prov, catalog, pods)
        prof = sched.last_stage_profile()
        assert prof["packer_backend"] in HOST_RUNGS
        assert sched.torch._remote_breaker.state == "open"
        # the open breaker: the fused route is back, no RPC is attempted
        sched.solve(prov, catalog, pods)
        assert sched.last_stage_profile()["pack_route"] == "fused"
    assert sorted(sorted(pods.index(p) for p in n.pods) for n in nodes) == plans[0]


def test_deadline_shed_floor_on_cpu_raises_on_card_scheduler():
    from karpenter_tpu_torch.resilience import Budget, DeadlineExceededError

    address, server = start(T)
    try:
        sched, _, _ = run_scheduler("karpenter_tpu_torch", address, diverse)
        prov, catalog, pods = diverse("karpenter_tpu_torch")
        with packer("fused"), Budget(0.0).activate():
            nodes = sched.solve(prov, catalog, pods)
            assert sched.last_stage_profile()["packer_backend"] == "ffd-degraded"
            assert sum(len(n.pods) for n in nodes) > 0
            sched.torch._floor_serves = False
            with pytest.raises(DeadlineExceededError):
                sched.solve(prov, catalog, pods)
        assert sched.torch._remote_breaker.state == "closed"
        assert not sched.torch._pack_breakers.open_dependencies()
    finally:
        server.stop(grace=None)


def test_overload_shed_packs_in_process_without_breaker_trip():
    address, server = start(T, max_inflight=1, queue_depth=0)
    try:
        sched, plans, _ = run_scheduler("karpenter_tpu_torch", address, diverse)
        gate = server.solver_service.admission
        assert gate.enter() == "admitted"
        prov, catalog, pods = diverse("karpenter_tpu_torch")
        try:
            with packer("fused"):
                nodes = sched.solve(prov, catalog, pods)
        finally:
            gate.leave()
        assert sched.last_stage_profile()["packer_backend"] in HOST_RUNGS
        assert sorted(sorted(pods.index(p) for p in n.pods) for n in nodes) == plans[0]
        assert sched.torch._remote_breaker.state == "closed"
        assert server.solver_service.shed["queue_full"] == 1
    finally:
        server.stop(grace=None)


@pytest.mark.parametrize("pkg", ["karpenter_tpu", "karpenter_tpu_torch"])
def test_canary_mismatch_on_a_sidecar_round_trips_the_remote_breaker(pkg, monkeypatch):
    import importlib

    integ = importlib.import_module(f"{pkg}.solver.integrity")
    native = importlib.import_module(f"{pkg}.solver.native")
    assert native.native_available(wait=180)
    monkeypatch.setattr(integ, "compare_results", lambda *a, **k: "forced (test)")
    address, server = start(T)
    try:
        sched, _, profs = run_scheduler(pkg, address, diverse, canary_rate=1.0)
        backend = sched._tpu if pkg == "karpenter_tpu" else sched.torch
        backend._canary_thread.join(timeout=120)
        assert not backend._canary_thread.is_alive()
        assert profs[0]["solver_address"] == address
        assert backend._remote_breaker.state == "open"
        totals = integ.totals()
        assert (totals["canary_mismatches"], totals["quarantines"]) == (1, 1)
        assert integ.snapshot()["quarantines"] == {address: 1}
        events = [e for e in sched.cluster.list("events") if e.reason == "IntegrityQuarantine"]
        assert [e.involved_name for e in events] == [address]
    finally:
        server.stop(grace=None)


def test_pool_address_is_not_ported():
    """A comma-separated address is a pool of sidecars now: the round is
    served through ``SolverPool`` with the plan of one sidecar."""
    from karpenter_tpu_torch.solver.pool import SolverPool

    (a, sa), (b, sb) = start(T), start(T)
    try:
        sched, plans, profs = run_scheduler("karpenter_tpu_torch", f"{a},{b}", diverse)
        _, single, _ = run_scheduler("karpenter_tpu_torch", a, diverse)
        assert isinstance(sched.torch._remote, SolverPool)
        assert plans == single and profs[0]["packer_backend"] == "sidecar"
        assert profs[0]["solver_address"] in (a, b)
        sched.torch._remote.close()
    finally:
        sa.stop(grace=None)
        sb.stop(grace=None)


def test_health_over_grpc_and_http():
    import urllib.error
    import urllib.request

    address = free_address()
    health_port = int(free_address().rsplit(":", 1)[1])
    svc = T.SolverService(device="cpu")
    server = T.serve(address, health_port=health_port, warmup=True, service=svc)
    try:
        assert svc.ready.wait(timeout=120)
        jax_client = J.RemoteSolver(address, timeout=30)
        assert jax_client.health()

        def get(path):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{health_port}{path}",
                                            timeout=10) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        # /metrics is served since the port has its metric registry
        assert (get("/healthz"), get("/readyz"), get("/metrics")) == (200, 200, 200)
        assert get("/debug/nothing") == 404
        svc.ready.clear()
        assert not jax_client.health() and get("/readyz") == 503
        jax_client.close()
    finally:
        server.health_server.shutdown()
        server.stop(grace=None)
