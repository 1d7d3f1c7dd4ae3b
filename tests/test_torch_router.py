"""The port's measured-cost router (``solver/router.py``) and the routed
``TorchScheduler._pack`` against the JAX package's.

- ``CostRouter``: every case of the reference's own router tests, run on
  both packages' routers (parametrised by package), and a seeded random
  sequence of ``record`` / ``record_failure`` / ``choose`` /
  ``should_probe`` that must get the same answers from both;
- ``_route_key`` equal to the reference's on the same encoded batches;
- only a ``device="cpu"`` scheduler under ``auto`` consults the router: on
  the card ``auto`` is the device path;
- the routed scheduler on ``device="cpu"`` under ``KARPENTER_PACKER=auto``:
  it converges to the cheaper backend with every round's plan equal to the
  JAX package's, a shadow probe refreshes the loser off the critical path,
  and a broken native pack is served by the device path and records
  ``FAILURE_PENALTY_S``.

The port's process-shared router is reset around every test
(``torch_parity.fresh_router``; ``tests/conftest.py`` resets the JAX
package's). Every comparison is exact.
"""

import importlib
import random

import pytest
import torch

from torch_parity import PACKAGES, encode_scenario, fresh_router, packer, pinned, scenario  # noqa: F401


def router_mod(pkg):
    return importlib.import_module(f"{pkg}.solver.router")


@pytest.fixture(params=PACKAGES)
def Router(request):
    return router_mod(request.param).CostRouter


KEY = (1024, 5, 1)
BOTH = ["device", "native"]


def test_cold_start_tries_every_candidate_in_order(Router):
    r = Router()
    assert r.choose(KEY, BOTH) == "device"
    r.record(KEY, "device", 0.100)
    assert r.choose(KEY, BOTH) == "native"
    r.record(KEY, "native", 0.001)
    r._solves[KEY] = 2
    assert all(r.choose(KEY, BOTH) == "native" for _ in range(10))


@pytest.mark.parametrize("probe_every,solves,picks,fires", [(4, 16, 16, 4), (64, 64, 64, 1)])
def test_exploits_and_probes_on_cadence(Router, probe_every, solves, picks, fires):
    # choose() always exploits; probing is signalled out of band
    # (should_probe) every probe_every-th solve of a clear race
    r = Router(probe_every=probe_every)
    r.record(KEY, "device", 0.100)
    r.record(KEY, "native", 0.001)
    got, fired = [], 0
    for _ in range(solves):
        got.append(r.choose(KEY, BOTH))
        fired += r.should_probe(KEY)
    assert got.count("native") == picks and fired == fires


def test_environment_drift_re_wins_the_route(Router):
    r = Router(probe_every=2, alpha=0.5)
    key = (2048, 9, 1)
    r.record(key, "device", 0.500)  # a first sample with the build in it
    r.record(key, "native", 0.010)
    for _ in range(8):  # probes keep measuring a now-fast device
        r.record(key, "device", 0.001)
    assert r.choose(key, BOTH) == "device"


def test_single_candidate_short_circuits(Router):
    r = Router()
    assert r.choose((1, 1, 1), ["device"]) == "device"
    assert r.report() == {}  # no bookkeeping spent


def test_shape_classes_are_independent(Router):
    r = Router()
    small, large = (256, 3, 1), (10240, 40, 1)
    r.record(small, "device", 0.001)
    r.record(small, "native", 0.010)
    r.record(large, "device", 0.200)
    r.record(large, "native", 0.002)
    r._solves[small] = r._solves[large] = 2
    assert r.choose(small, BOTH) == "device"
    assert r.choose(large, BOTH) == "native"


def test_near_tie_raises_probe_cadence_not_route(Router):
    r = Router(probe_every=64)
    key = (2048, 9, 1)
    r.record(key, "device", 0.0105)
    r.record(key, "native", 0.0100)  # within the 1.25x near-tie band
    picks, fires = [], 0
    for _ in range(32):
        picks.append(r.choose(key, BOTH))
        fires += r.should_probe(key)
    assert picks.count("native") == 32  # every solve exploits
    assert fires == 4  # probes every 8th instead of every 64th


def test_near_tie_probes_recover_a_stale_winner(Router):
    r = Router(probe_every=64)
    r.record(KEY, "device", 0.010)
    r.record(KEY, "native", 0.011)  # near-tie, device nominally ahead
    for _ in range(40):
        pick = r.choose(KEY, BOTH)
        # the world changed: device now takes 3x, native got faster
        r.record(KEY, pick, 0.030 if pick == "device" else 0.008)
        if r.should_probe(KEY):
            loser = "native" if pick == "device" else "device"
            r.record(KEY, loser, 0.008 if loser == "native" else 0.030)
    assert r.choose(KEY, BOTH) == "native"


def test_failure_penalty_and_report(Router):
    pkg = Router.__module__.split(".")[0]
    r = Router()
    r.record_failure(KEY, "native")
    assert r.ema(KEY, "native") == router_mod(pkg).FAILURE_PENALTY_S == 60.0
    r.record(KEY, "device", 0.0123456789)
    assert r.report() == {"device@1024x5x1": 0.012346, "native@1024x5x1": 60.0}
    assert r.ema(KEY, "missing") is None


@pytest.mark.parametrize("seed", range(3))
def test_random_sequence_matches_reference(seed):
    rng = random.Random(seed)
    probe_every = rng.choice([0, 4, 8, 64])
    routers = [router_mod(pkg).CostRouter(probe_every=probe_every) for pkg in PACKAGES]
    keys = [(512, 8, 1, 0), (1024, 128, 512, 0), (10240, 8, 1, 1)]
    answers = [[], []]
    for _ in range(400):
        op, key = rng.random(), rng.choice(keys)
        backend = rng.choice(BOTH)
        seconds = rng.choice([1e-4, 2e-3, 0.0105, 0.011, 0.25])
        cands = rng.choice([BOTH, ["device"], ["native", "device"]])
        for out, r in zip(answers, routers):
            if op < 0.35:
                r.record(key, backend, seconds)
            elif op < 0.4:
                r.record_failure(key, backend)
            elif op < 0.8:
                out.append(r.choose(key, cands))
            else:
                out.append(r.should_probe(key))
    assert answers[0] == answers[1] and len(answers[0]) > 200
    assert routers[0].report() == routers[1].report()


def test_default_router_is_process_shared():
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.solver import router
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    first = router.default_router()
    assert router.default_router() is first
    assert TorchScheduler(Cluster(), device="cpu").router is first
    router.reset_default()
    assert router.default_router() is not first


# -- the route key ------------------------------------------------------------


def route_key(pkg, name, n_pods, seed, n_types):
    if pkg == "karpenter_tpu":
        from karpenter_tpu.solver.backend import TpuScheduler as S
    else:
        from karpenter_tpu_torch.solver.backend import TorchScheduler as S
    return S._route_key(encode_scenario(pkg, *scenario(pkg, name, n_pods, seed, n_types)))


@pytest.mark.parametrize(
    "name,n_pods,n_types,pinned_hosts",
    [("diverse", 700, 400, 1), ("teams", 512, 16, 0), ("one_per_node", 600, 50, 1),
     ("config2", 300, 50, 0)],
)
def test_route_key_matches_reference(name, n_pods, n_types, pinned_hosts):
    ref, out = (route_key(pkg, name, n_pods, 42, n_types) for pkg in PACKAGES)
    assert out == ref and out[3] == pinned_hosts


# -- which schedulers route ------------------------------------------------------


@pytest.mark.parametrize(
    "device,value,routed",
    [("cuda", None, False), ("cuda", "auto", False), ("cuda", "fused", False),
     ("cpu", None, True), ("cpu", "AUTO", True), ("cpu", "fused", False)],
)
def test_only_a_cpu_scheduler_consults_the_router(monkeypatch, device, value, routed):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.solver import native
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    tb = TorchScheduler(Cluster(), device="cpu")
    tb.device = torch.device(device)  # as a scheduler on that device: nothing launches
    chosen, packers = [], []
    monkeypatch.setattr(native, "native_available", lambda wait=None: True)
    monkeypatch.setattr(tb.router, "choose", lambda key, cands: chosen.append(cands) or "device")
    monkeypatch.setattr(tb, "_pack_device", lambda batch, prof, packer: packers.append(packer) or "finish")
    pkg = "karpenter_tpu_torch"
    batch = encode_scenario(pkg, *scenario(pkg, "diverse", 64, 7, 8))
    with packer(value):
        finish = tb._pack(batch, {})
    assert packers == [(value or "auto").lower()]
    assert chosen == ([["device", "native"]] if routed else [])
    assert (finish == "finish") is not routed  # a routed solve wraps the device finish


# -- the routed scheduler on device="cpu" --------------------------------------


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         dict(n.requests), [(r.key, r.operator, tuple(r.values))
                            for r in n.constraints.requirements.requirements])
        for n in nodes
    ]


@pytest.fixture
def native_built():
    for pkg in PACKAGES:
        if not importlib.import_module(f"{pkg}.solver.native").native_available(wait=180):
            pytest.fail(f"{pkg}'s native packer did not build")


def jax_plan(n_pods=512):
    from karpenter_tpu.kube.client import Cluster
    from karpenter_tpu.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu", "diverse", n_pods, 7, 50)
    with pinned("karpenter_tpu"):
        nodes = Scheduler(Cluster(), rng=random.Random(1)).solve(prov, catalog, pods)
    return plan_of(nodes, pods)


class Routed:
    """The port's scheduler on device="cpu" under auto, each round a replay
    of the same solve (the topology rng reseeded, as a new scheduler's)."""

    def __init__(self, n_pods=512):
        from karpenter_tpu_torch.kube.client import Cluster
        from karpenter_tpu_torch.scheduling.scheduler import Scheduler

        self.prov, self.catalog, self.pods = scenario("karpenter_tpu_torch", "diverse", n_pods, 7, 50)
        self.sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
        self.backend = self.sched.torch

    def solve(self):
        self.backend.topology.rng = random.Random(1)
        with packer("auto"):
            nodes = self.sched.solve(self.prov, self.catalog, self.pods)
        prof = self.sched.last_stage_profile()
        return plan_of(nodes, self.pods), prof["packer_backend"], prof["pack_route"]


def test_auto_converges_with_plans_identical_to_jax(native_built):
    want = jax_plan()
    env = Routed()
    rounds = [env.solve() for _ in range(4)]
    assert [b for _, b, _ in rounds] == ["pack_reference", "native", "native", "native"]
    assert [r for _, _, r in rounds] == ["fused", "native", "native", "native"]
    for i, (plan, _, _) in enumerate(rounds):
        assert plan == want, f"round {i}"
    report = env.backend.router.report()
    assert sorted(k.split("@")[0] for k in report) == ["device", "native"]


def test_shadow_probe_refreshes_the_loser(native_built):
    env = Routed()
    env.solve()
    env.backend.router.probe_every = 2
    firsts = dict(env.backend.router.report())
    for _ in range(5):
        plan, served, _ = env.solve()
        assert served == "native"
    probe = env.backend._probe_thread
    assert probe is not None, "the shadow probe never started"
    probe.join(timeout=120)
    assert not probe.is_alive()
    now = env.backend.router.report()
    (dev_key,) = [k for k in now if k.startswith("device@")]
    assert now[dev_key] != firsts[dev_key]  # re-measured off the critical path
    assert env.sched.last_stage_profile()["packer_backend"] == "native"


def test_broken_native_is_served_by_the_device_path(native_built, monkeypatch):
    from karpenter_tpu_torch.solver import native, router

    want = jax_plan()
    env = Routed()
    assert env.solve()[0] == want  # device: cold start

    def broken(*a, **kw):
        raise RuntimeError("libffd_pack.so corrupt (test)")

    monkeypatch.setattr(native, "pack_native", broken)
    plan, served, route = env.solve()  # native cold start: fails, device serves
    assert plan == want and (served, route) == ("pack_reference", "fused")
    rt = env.backend.router
    (key,) = {k for (b, k) in rt._ema}
    assert rt.ema(key, "native") == router.FAILURE_PENALTY_S
    plan, served, _ = env.solve()  # the penalty keeps native off the route
    assert plan == want and served == "pack_reference"
