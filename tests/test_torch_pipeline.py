"""The solve lock's double-buffered pipeline on the port's scheduler.

Twins of the reference's ``tests/test_pipeline_smoke.py`` over the port's
chaos-wrapped ``SolverService(device="cpu")``: the sidecar's solves are
slowed by a deterministic ``latency_floor``, two batches go through ONE
``TorchScheduler`` on two threads, and the wall clock shows that the
second batch's host stages ran while the first solve was in flight (a
serial scheduler pays at least two floors). Also: each thread reads its
own ``completed_profile()``, and the decode memo's hit flag is per thread,
in both packages.
"""

import random
import socket
import threading
import time

import pytest

from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.solver.backend import TorchScheduler
from karpenter_tpu_torch.testing import make_pod, make_provisioner
from torch_parity import fresh_router, packer  # noqa: F401

# long enough to dwarf warm host stages (a 32-pod encode is milliseconds)
FLOOR_S = 0.5


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture(params=["unary", "stream"])
def sidecar_env(request):
    """A chaos-slowed cpu sidecar and the transport the scheduler takes.

    KARPENTER_PACKER=fused keeps the device path (with a sidecar
    configured the fused route yields to it), so the router cannot send a
    timed solve to the native packer."""
    from karpenter_tpu_torch.solver.service import SolverService, serve
    from karpenter_tpu_torch.testing.chaos import ChaosPolicy, chaos_wrap

    policy = ChaosPolicy(
        latency_floor=FLOOR_S, methods=frozenset({"solve_bytes", "solve_stream_group"}),
    )
    service = chaos_wrap(SolverService(device="cpu"), policy)
    address = free_address()
    server = serve(address, service=service)
    with packer("fused"):
        yield address, service, request.param == "stream"
    server.stop(grace=1)


def constraints_for(catalog):
    constraints = make_provisioner(solver="tpu").spec.constraints
    constraints.requirements = constraints.requirements.merge(catalog_requirements(catalog))
    return constraints


def batch(tag, n=32):
    return [make_pod(name=f"{tag}-{i}", requests={"cpu": "0.25"}) for i in range(n)]


def test_encode_overlaps_inflight_solve(sidecar_env):
    address, service, stream = sidecar_env
    catalog = instance_types(8)
    constraints = constraints_for(catalog)
    sched = TorchScheduler(Cluster(), rng=random.Random(0), device="cpu",
                           service_address=address, solver_stream=stream)
    # warm serially: session open, stream, statics
    warm = sched.solve(constraints, catalog, batch("warm-a"))
    assert sum(len(v.pods) for v in warm) == 32
    assert sched.last_profile.get("packer_backend") == "sidecar"
    sched.solve(constraints, catalog, batch("warm-b"))
    assert sched.last_profile["solver_transport"] == ("stream" if stream else "unary")
    assert sched._remote is not None and sched._remote.session_uploads == 1
    delayed = service.delayed.get("solve_stream_group" if stream else "solve_bytes", 0)
    assert delayed >= 1  # chaos fired

    results = {}

    def run(tag):
        results[tag] = sched.solve(constraints, catalog, batch(tag))

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in ("i", "i+1")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t0
    for tag in ("i", "i+1"):
        assert tag in results, f"solve {tag} never finished"
        assert sum(len(v.pods) for v in results[tag]) == 32
    # serialized, the two solves pay at least 2 floors; overlapped, about
    # one floor plus the host stages
    assert wall < 2 * FLOOR_S, (
        f"two concurrent solves took {wall:.3f}s: the second encode did not "
        f"overlap the first solve in flight ({FLOOR_S}s floor each)"
    )
    assert sched._remote.session_uploads == 1


def test_stage_timings_split_wire_from_fetch(sidecar_env):
    """The profile keeps the wire's serialization apart from the in-flight
    wait, and the wait dominates under the chaos floor."""
    address, _service, stream = sidecar_env
    catalog = instance_types(8)
    constraints = constraints_for(catalog)
    sched = TorchScheduler(Cluster(), rng=random.Random(0), device="cpu",
                           service_address=address, solver_stream=stream)
    pods = [make_pod(requests={"cpu": "0.25"}) for _ in range(16)]
    sched.solve(constraints, catalog, list(pods))
    sched.solve(constraints, catalog, list(pods))
    prof = sched.last_profile
    assert prof.get("packer_backend") == "sidecar"
    assert "wire_ser_s" in prof and "wire_deser_s" in prof
    assert prof["pack_fetch_s"] >= FLOOR_S * 0.9
    assert prof["wire_ser_s"] < FLOOR_S / 2 and prof["wire_deser_s"] < FLOOR_S / 2


def test_completed_profile_is_per_thread(sidecar_env):
    """Two threads on one scheduler, each with its own catalog: each reads
    its own solve's profile, never the other's."""
    address, _service, stream = sidecar_env
    sched = TorchScheduler(Cluster(), rng=random.Random(0), device="cpu",
                           service_address=address, solver_stream=stream)
    catalogs = {"a": instance_types(8), "b": instance_types(6)}
    seen, barrier = {}, threading.Barrier(2, timeout=30)

    def run(tag):
        catalog = catalogs[tag]
        barrier.wait()
        sched.solve(constraints_for(catalog), catalog, batch(tag, 16))
        seen[tag] = sched.completed_profile()

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in catalogs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert set(seen) == {"a", "b"}
    assert seen["a"]["session_key"] != seen["b"]["session_key"]
    for tag, prof in seen.items():
        assert prof["packer_backend"] == "sidecar" and prof["pack_fetch_s"] >= FLOOR_S * 0.9
    assert sched.last_completed_profile["session_key"] in {
        p["session_key"] for p in seen.values()}
    # the main thread solved nothing: it reads the latest of any thread
    assert sched.completed_profile()["session_key"] == sched.last_completed_profile["session_key"]


@pytest.mark.parametrize("pkg", ["karpenter_tpu", "karpenter_tpu_torch"])
def test_decode_hit_flag_is_per_thread(pkg):
    """A resident decode-memo hit on one thread leaves another thread's flag
    alone, in both packages."""
    import importlib

    from torch_parity import mods, pinned

    M = mods(pkg)
    backend = importlib.import_module(f"{pkg}.solver.backend")
    cls = backend.TpuScheduler if pkg == "karpenter_tpu" else backend.TorchScheduler
    extra = {} if pkg == "karpenter_tpu" else {"device": "cpu"}
    sched = cls(M.Cluster(), rng=random.Random(0), solver_delta=True, **extra)
    catalog = M.fake.instance_types(8)
    constraints = M.factories.make_provisioner(solver="tpu").spec.constraints
    constraints.requirements = constraints.requirements.merge(
        M.catreq.catalog_requirements(catalog))
    pods = [M.factories.make_pod(requests={"cpu": "0.25"}) for _ in range(24)]
    other = [M.factories.make_pod(requests={"cpu": "0.5"}) for _ in range(24)]
    with pinned(pkg):
        sched.solve(constraints, catalog, pods)
        sched.solve(constraints, catalog, pods)
        assert sched._dec_tl.hit is True
        flags = {}

        def elsewhere():
            sched.solve(constraints, catalog, other)
            flags["thread"] = sched._dec_tl.hit

        t = threading.Thread(target=elsewhere, daemon=True)
        t.start()
        t.join(timeout=60)
    assert flags == {"thread": False}
    assert sched._dec_tl.hit is True  # this thread's flag untouched


def test_many_threads_on_one_scheduler_keep_their_plans():
    """A stress test of the state shared under and off the solve lock: 8
    threads, each with its own batch and catalog, solve 3 rounds each on
    one resident cpu scheduler with a short switch interval; every round
    returns the plan its batch gets alone."""
    import sys

    def make(i):
        catalog = instance_types(6 + i % 3)
        pods = [make_pod(requests={"cpu": f"{0.25 * (1 + (i + j) % 4)}"}) for j in range(20 + i)]
        return catalog, pods

    def plan(sched, catalog, pods):
        nodes = sched.solve(constraints_for(catalog), catalog, pods)
        return sorted(sorted(pods.index(p) for p in n.pods) for n in nodes)

    cases = [make(i) for i in range(8)]
    with packer("fused"):
        alone = [plan(TorchScheduler(Cluster(), rng=random.Random(0), device="cpu"), *c)
                 for c in cases]
        shared = TorchScheduler(Cluster(), rng=random.Random(0), device="cpu", solver_delta=True)
        got, errs = {}, []

        def run(i):
            try:
                got[i] = [plan(shared, *cases[i]) for _ in range(3)]
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert got == {i: [alone[i]] * 3 for i in range(8)}
