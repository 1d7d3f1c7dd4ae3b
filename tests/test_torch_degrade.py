"""The port's degrade ladder against the JAX package's.

Everything runs on the CPU: the port on ``device="cpu"`` through its fused
route (``KARPENTER_PACKER=fused`` around its solves), the JAX package
through its lax.scan packer (``scan`` around its solves), from the same
seeded inputs (pods compared by their index in the input list):

- ``CircuitBreaker`` / ``BreakerBoard``: the same outcome sequences under a
  fake clock give the same states, trips and open dependencies;
- ``screen_result`` / ``compare_results``: the same verdict strings on
  clean and corrupted results;
- every trigger of the ladder — a pack that fails at begin or at finish,
  the breaker open on the third round, the NaN/bounds screen, an invalid
  plan, a signature overflow, a canary mismatch — injected the same way
  into both schedulers: the same plan round by round, the same
  ``packer_backend`` (or its absence), integrity totals, open breakers and
  Warning events;
- the same triggers on a scheduler set up as a card's, which has no floor:
  each round the reference serves from its floor raises instead, after the
  reference's bookkeeping (totals, open breakers, Warning events);
- the round after a quarantine re-injects on the resident path (creating
  the event moves ``Cluster.version()``) in both packages;
- canary sampling: rate 0 starts no thread, native packs are never
  canaried, and for every ``KARPENTER_PACKER`` value a canary runs exactly
  when the device path served, in both packages (what serves on a CPU host
  differs under ``auto`` and ``fused``: the reference's device ladder ends
  in native there, the port's in its plain version); 100 seeded small
  batches through the port's plain versions give no false positive.

Tolerance: none, except the comparator's own (rtol = atol = 1e-5 on node
totals, the reference's).
"""

import importlib
import random
import re

import numpy as np
import pytest

from karpenter_tpu_torch.resilience.breaker import OPEN
from karpenter_tpu_torch.solver import integrity
from karpenter_tpu_torch.solver.backend import DEVICE_BACKENDS
from torch_parity import (  # noqa: F401
    PACKAGES, fresh_router, mods, packer, pinned, scenario, synth_fields, team_mix,
)

PORT, REF = "karpenter_tpu_torch", "karpenter_tpu"
ABSENT = "<absent>"


@pytest.fixture
def native_built():
    for pkg in PACKAGES:
        if not importlib.import_module(f"{pkg}.solver.native").native_available(wait=180):
            pytest.fail(f"{pkg}'s native packer did not build")


# -- the breaker ---------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def run_breaker_ops(pkg: str, ops: str) -> list:
    """Drive one package's BreakerBoard through ``ops`` (one token per op:
    ``s``/``f`` record success/failure, ``t`` trip, ``a`` allow, ``+``
    advance the clock 31 s, ``-`` advance it 10 s, uppercase = the same op
    on a second dependency) and record every observable after each op,
    the open breaker's retry time included (the reference keeps it
    private)."""
    breaker = importlib.import_module(f"{pkg}.resilience.breaker")
    clock = FakeClock()
    board = breaker.BreakerBoard(
        clock=clock, window=6, min_volume=2, failure_rate=0.5, open_seconds=30.0
    )
    seen = []
    for op in ops:
        b = board.get("pack:two" if op.isupper() else "pack:one")
        out = None
        op = op.lower()
        if op == "s":
            b.record_success()
        elif op == "f":
            out = b.record_failure()
        elif op == "t":
            b.trip()
        elif op == "a":
            out = b.allow()
        elif op == "+":
            clock.t += 31.0
        elif op == "-":
            clock.t += 10.0
        retry_in = (
            b.retry_in() if pkg == PORT
            else b._retry_in() if b.state == OPEN else 0.0
        )
        seen.append((op, out, b.state, b.trips, b.available(), board.open_dependencies(),
                     retry_in))
    return seen


@pytest.mark.parametrize("ops", [
    "ff", "sfsf", "fsfsff", "sssssf", "ff+as", "ff+af", "ff+aa", "ff+a+af",
    "tt", "t+as", "tas", "afafa", "afaf-a+as", "afaf+af", "asasasafafaf", "fFfF+aAsf",
    "tT+aAfs", "sf+fs+ff",
])
def test_breaker_sequences_match_the_reference(ops):
    assert run_breaker_ops(PORT, ops) == run_breaker_ops(REF, ops)


# -- screen and comparator -----------------------------------------------------


def base_result():
    """A PackResult over numpy arrays: the port's plain version on a seeded
    synthetic batch with several open nodes."""
    from karpenter_tpu_torch.solver import carry
    from karpenter_tpu_torch.solver.kernel import pack_reference

    f = synth_fields(P=256, S=12, F=3, R=3, C=6, n_hosts=7, seed=2)
    out = pack_reference(*carry.tensors_from_reference(f, "cpu")["pack_args"], n_max=64)
    res = [np.array(a.numpy(), copy=True) for a in out]
    assert int(res[4]) > 3 and (res[0][:200] >= 0).any()
    return res


def corrupt(kind: str, res: list) -> list:
    a, sig, host, req, n = (np.array(x, copy=True) for x in res)
    nn = int(n)
    placed = int(np.flatnonzero(a >= 0)[0])
    if kind == "nan_req":
        req[0, 0] = np.nan
    elif kind == "inf_req":
        req[nn - 1, -1] = np.inf
    elif kind == "negative_req":
        req[1, 0] = -0.5
    elif kind == "assignment_past_n_nodes":
        a[placed] = nn
    elif kind == "assignment_below_minus_one":
        a[placed] = -2
    elif kind == "nan_bits_in_assignment":
        a[placed:placed + 1].view(np.float32)[0] = np.nan
    elif kind == "n_nodes_past_n_max":
        n = np.int32(sig.shape[0] + 1)
    elif kind == "n_nodes_negative":
        n = np.int32(-1)
    elif kind == "req_past_n_nodes":
        req[nn:, :] = np.nan  # outside the node table's live rows: clean
    elif kind != "clean":
        raise ValueError(kind)
    return [a, sig, host, req, n]


@pytest.mark.parametrize("kind", [
    "clean", "nan_req", "inf_req", "negative_req", "assignment_past_n_nodes",
    "assignment_below_minus_one", "nan_bits_in_assignment", "n_nodes_past_n_max",
    "n_nodes_negative", "req_past_n_nodes",
])
def test_screen_verdicts_match_the_reference(kind):
    ref_integrity = importlib.import_module(f"{REF}.solver.integrity")
    res = corrupt(kind, base_result())
    want = ref_integrity.screen_result(res, n_pods=200)
    assert integrity.screen_result(res, n_pods=200) == want
    assert (want is None) == (kind in ("clean", "req_past_n_nodes"))


def change(field: str, res: list) -> list:
    a, sig, host, req, n = (np.array(x, copy=True) for x in res)
    placed = int(np.flatnonzero(a >= 0)[0])
    if field == "n_nodes":
        n = np.int32(int(n) - 1)
    elif field == "assignment":
        a[placed] = (a[placed] + 1) % int(n)
    elif field == "node_sig":
        sig[0] += 1
    elif field == "node_host":
        host[1] = 99
    elif field == "node_req":
        req[0, 0] += 1.0
    elif field == "node_req_within_tolerance":
        req[0, 0] += 1e-7
    elif field == "past_n_nodes":
        sig[int(n):] = 7  # slots past n_nodes are not compared
    elif field == "past_n_pods":
        a[200:] = 5  # padded pods are not compared
    elif field != "same":
        raise ValueError(field)
    return [a, sig, host, req, n]


@pytest.mark.parametrize("field", [
    "same", "n_nodes", "assignment", "node_sig", "node_host", "node_req",
    "node_req_within_tolerance", "past_n_nodes", "past_n_pods",
])
def test_comparator_verdicts_match_the_reference(field):
    ref_integrity = importlib.import_module(f"{REF}.solver.integrity")
    served = base_result()
    native = change(field, served)
    want = ref_integrity.compare_results(served, native, n_pods=200)
    assert integrity.compare_results(served, native, n_pods=200) == want
    clean = ("same", "node_req_within_tolerance", "past_n_nodes", "past_n_pods")
    assert (want is None) == (field in clean)


# -- the ladder's triggers through Scheduler.solve ------------------------------


def make_scheduler(pkg: str, cluster=None, **kw):
    M = mods(pkg)
    sched_mod = importlib.import_module(f"{pkg}.scheduling.scheduler")
    extra = {"device": "cpu"} if pkg == PORT else {}
    return sched_mod.Scheduler(
        cluster if cluster is not None else M.Cluster(), rng=random.Random(1), **extra, **kw
    )


def backend_of(pkg: str, sched):
    return sched.torch if pkg == PORT else sched._tpu_scheduler()


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         dict(n.requests), [(r.key, r.operator, tuple(r.values))
                            for r in n.constraints.requirements.requirements])
        for n in nodes
    ]


def inject(trigger: str, pkg: str, b, monkeypatch, calls: list) -> None:
    """The same failure injected into one package's scheduler backend
    ``b``; ``calls`` counts the pack (or encode) attempts it saw."""
    if trigger in ("begin", "breaker"):
        def pack(*a, **k):
            calls.append("pack")
            raise RuntimeError("pack begin failed (test)")
        monkeypatch.setattr(b, "_pack", pack, raising=False)
    elif trigger == "finish":
        def pack(*a, **k):
            calls.append("pack")

            def finish():
                raise RuntimeError("pack fetch failed (test)")
            return finish
        monkeypatch.setattr(b, "_pack", pack, raising=False)
    elif trigger in ("screen", "canary"):
        real = b._pack

        def pack(*a, **k):
            calls.append("pack")
            finish = real(*a, **k)

            def corrupted():
                result, typemask = finish()
                req = np.array(result[3], np.float32, copy=True)
                req[0, 0] = np.nan if trigger == "screen" else req[0, 0] + 1.0
                return tuple(result[:3]) + (req,) + tuple(result[4:]), typemask
            return corrupted
        monkeypatch.setattr(b, "_pack", pack, raising=False)
    elif trigger == "invalid":
        real = b._decode

        def decode(*a, **k):
            nodes = real(*a, **k)
            nodes[1].pods.append(nodes[0].pods[0])  # one pod on two nodes
            return nodes
        monkeypatch.setattr(b, "_decode", decode, raising=False)
    elif trigger == "overflow":
        enc = importlib.import_module(f"{pkg}.solver.encode")
        sig = importlib.import_module(f"{pkg}.solver.signature")

        def encode(*a, **k):
            calls.append("encode")
            raise sig.SignatureOverflow("forced signature overflow (test)")
        monkeypatch.setattr(enc, "encode", encode)
    else:
        raise ValueError(trigger)


# trigger -> (rounds, packer_backend per round on the port, integrity totals)
TRIGGERS = {
    "begin": (3, ["ffd-degraded"] * 3, {}),
    "finish": (3, ["ffd-degraded"] * 3, {}),
    "breaker": (3, ["ffd-degraded"] * 3, {}),
    "screen": (2, ["ffd-degraded"] * 2, {"screen_failures": 1, "quarantines": 1}),
    "invalid": (2, ["ffd-degraded"] * 2, {"quarantines": 1}),
    "overflow": (2, [ABSENT] * 2, {}),
    "canary": (2, [None, "ffd-degraded"],
               {"canary_solves": 1, "canary_mismatches": 1, "quarantines": 1}),
}
SHAPES = {"v1": ("diverse", 150, 20), "v2": ("teams", 512, 16)}


def drive(pkg: str, trigger: str, shape: str, monkeypatch, card: bool = False) -> dict:
    """One package through a trigger's rounds; everything the ladder
    records. ``card``: the port's scheduler set up as a card's, with no
    floor; each round's exception (or None) lands in ``raised``."""
    name, n_pods, n_types = SHAPES[shape]
    prov, catalog, pods = scenario(pkg, name, n_pods, 42, n_types)
    cluster = mods(pkg).Cluster()
    sched = make_scheduler(pkg, cluster, canary_rate=1.0 if trigger == "canary" else 0.0)
    b = backend_of(pkg, sched)
    if card:
        b._floor_serves = False
    calls: list = []
    out = {"plans": [], "backends": [], "raised": []}
    with monkeypatch.context() as mp:
        inject(trigger, pkg, b, mp, calls)
        rounds = TRIGGERS[trigger][0]
        for rnd in range(rounds):
            if trigger == "breaker" and rnd == rounds - 1:
                # the pack works again, but the open breaker must keep
                # the round off it
                mp.undo()
                real = b._pack

                def spy(*a, **k):
                    calls.append("pack")
                    return real(*a, **k)
                mp.setattr(b, "_pack", spy, raising=False)
            with pinned(pkg):
                try:
                    nodes = sched.solve(prov, catalog, pods)
                except Exception as e:
                    if not card:
                        raise
                    out["raised"].append(type(e).__name__)
                    continue
            out["raised"].append(None)
            if b._canary_thread is not None:
                b._canary_thread.join(timeout=120)
                assert not b._canary_thread.is_alive()
            out["plans"].append(plan_of(nodes, pods))
            out["backends"].append(sched.last_stage_profile().get("packer_backend", ABSENT))
            assert sum(len(n.pods) for n in nodes) > 0
    out["calls"] = calls
    totals = importlib.import_module(f"{pkg}.solver.integrity").totals()
    # the port keeps the in-process counters; the reference's remote-only
    # ones (checksum, session) stay 0 on this path
    port_kinds = integrity.totals()
    assert not any(v for k, v in totals.items() if k not in port_kinds)
    out["totals"] = {k: totals[k] for k in port_kinds}
    out["open"] = b._pack_breakers.open_dependencies()
    # pods of the two packages get different names (separate factory
    # counters, advanced by whatever ran before in the process): a message
    # naming a pod names it by its index in the input list
    index = {p.key: f"pod#{i}" for i, p in enumerate(pods)}

    def by_index(message: str) -> str:
        return re.sub(r"[\w.-]+/pod-\d+", lambda m: index.get(m.group(0), m.group(0)), message)

    out["events"] = [
        (e.type, e.reason, by_index(e.message), e.involved_kind, e.involved_name, e.count)
        for e in cluster.list("events")
    ]
    return out


TRIGGER_CASES = [
    *((t, "v1") for t in TRIGGERS),
    ("begin", "v2"), ("screen", "v2"), ("invalid", "v2"), ("canary", "v2"),
]


@pytest.mark.parametrize("trigger,shape", TRIGGER_CASES)
def test_trigger_matches_the_reference(native_built, monkeypatch, trigger, shape):
    ref = drive(REF, trigger, shape, monkeypatch)
    out = drive(PORT, trigger, shape, monkeypatch)
    assert out["plans"] == ref["plans"]
    assert all(len(p) > 0 for p in out["plans"])
    assert out["totals"] == ref["totals"]
    assert out["open"] == ref["open"]
    assert out["events"] == ref["events"]
    assert out["calls"] == ref["calls"]
    # the reference names the device path "device"; the port the kernel
    # (here its plain version) that served
    kernel = "pack_reference" if shape == "v1" else "pack_v2_reference"
    _, backends, totals = TRIGGERS[trigger]
    assert out["backends"] == [kernel if b is None else b for b in backends]
    assert ref["backends"] == ["device" if b is None else b for b in backends]
    assert {k: v for k, v in out["totals"].items() if v} == totals
    quarantined = totals.get("quarantines", 0) > 0
    assert len(out["events"]) == int(quarantined)
    if quarantined:
        kind, reason, message, *_ = out["events"][0]
        assert (kind, reason) == ("Warning", "IntegrityQuarantine")
        reason = {"screen": "screen", "invalid": "invalid_pack", "canary": "canary"}[trigger]
        assert message.startswith(f"pack integrity violation ({reason})")
    opened = trigger not in ("overflow",)
    assert bool(out["open"]) == opened
    # the last round found the breaker open: no pack was attempted
    if trigger in ("begin", "finish", "breaker"):
        assert out["calls"] == ["pack", "pack"]
    elif trigger == "overflow":
        assert out["calls"] == ["encode", "encode"] * 2  # both attempts, each round
    elif trigger in ("screen", "canary"):
        assert out["calls"] == ["pack"]


# trigger -> what each round raises on a card's scheduler (None: served)
CARD_RAISES = {
    "begin": ["RuntimeError", "RuntimeError", "BreakerOpen"],
    "finish": ["RuntimeError", "RuntimeError", "BreakerOpen"],
    "breaker": ["RuntimeError", "RuntimeError", "BreakerOpen"],
    "screen": ["InvalidPackError", "BreakerOpen"],
    "invalid": ["InvalidPackError", "BreakerOpen"],
    "overflow": ["SignatureOverflow", "SignatureOverflow"],
    "canary": [None, "BreakerOpen"],
}


@pytest.mark.parametrize("trigger,shape", TRIGGER_CASES)
def test_card_ladder_raises_with_the_reference_bookkeeping(
    native_built, monkeypatch, trigger, shape
):
    """A card's scheduler has no floor: every round the reference serves
    from its floor raises instead, and the ladder records what the
    reference records (the same pack or encode attempts, integrity totals,
    open breakers and Warning events). A round the card serves (the
    canary's first) gives the reference's plan."""
    ref = drive(REF, trigger, shape, monkeypatch)
    out = drive(PORT, trigger, shape, monkeypatch, card=True)
    assert out["raised"] == CARD_RAISES[trigger]
    served = [r for r, e in enumerate(out["raised"]) if e is None]
    assert out["plans"] == [ref["plans"][r] for r in served]
    assert out["totals"] == ref["totals"]
    assert out["open"] == ref["open"]
    assert out["events"] == ref["events"]
    assert out["calls"] == ref["calls"]


def test_round_after_a_quarantine_reinjects_in_both_packages(monkeypatch):
    """Creating the quarantine's Warning event moves ``Cluster.version()``
    in both packages, so the resident path's next topology round injects
    anew (``inject_s``) where a steady round reuses the plan."""
    keys = {}
    for pkg in PACKAGES:
        prov, catalog, pods = scenario(pkg, "diverse", 150, 42, 20)
        cluster = mods(pkg).Cluster()
        sched = make_scheduler(pkg, cluster, solver_delta=True)
        b = backend_of(pkg, sched)
        seen = []
        for rnd in range(4):
            with monkeypatch.context() as mp:
                if rnd == 2:
                    # the screen runs every round; a steady round's memo
                    # hit skips validation, so an invalid plan would not
                    inject("screen", pkg, b, mp, [])
                version = cluster.version()
                with pinned(pkg):
                    nodes = sched.solve(prov, catalog, pods)
            prof = sched.last_stage_profile()
            seen.append((
                "inject_s" in prof, "inject_delta_s" in prof,
                prof.get("packer_backend", ABSENT) == "ffd-degraded",
                cluster.version() - version, plan_of(nodes, pods),
            ))
        keys[pkg] = seen
    assert keys[PORT] == keys[REF]
    # warm-up injects, round 1 reuses the plan, round 2 is quarantined (and
    # its event bumps the version), round 3 re-injects and takes the floor
    assert [s[:4] for s in keys[PORT]] == [
        (True, False, False, 0), (False, True, False, 0),
        (False, True, True, 1), (True, False, True, 0),
    ]


# -- canary sampling -----------------------------------------------------------


def test_rate_zero_starts_no_canary():
    for pkg in PACKAGES:
        prov, catalog, pods = scenario(pkg, "diverse", 60, 3, 10)
        sched = make_scheduler(pkg, canary_rate=0.0)
        with pinned(pkg):
            sched.solve(prov, catalog, pods)
        assert backend_of(pkg, sched)._canary_thread is None, pkg


def test_canary_rate_reads_its_env_twin(monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    monkeypatch.setenv("KARPENTER_CANARY_RATE", " 0.25 ")
    assert TorchScheduler(Cluster(), device="cpu").canary_rate == 0.25
    assert TorchScheduler(Cluster(), device="cpu", canary_rate=0.5).canary_rate == 0.5
    monkeypatch.setenv("KARPENTER_CANARY_RATE", "")
    assert TorchScheduler(Cluster(), device="cpu").canary_rate == 0.0


# KARPENTER_PACKER value -> what served on a CPU host, (port, reference).
# The rule is one: the canary runs exactly when the device path served
# (the port names its kernel or plain version, the reference "device"),
# never after native or the floor. Under auto and fused the reference's
# device ladder ends in native on a host without a TPU, where the port's
# runs its plain version, so only the port canaries those rounds.
SERVED_ON_CPU = {
    None: ("pack_reference", "native"),
    "auto": ("pack_reference", "native"),
    "fused": ("pack_reference", "native"),
    "scan": ("pack_reference", "device"),
    "native": ("native", "native"),
    "pallas": ("ffd-degraded", "ffd-degraded"),
}


@pytest.mark.parametrize("value", sorted(SERVED_ON_CPU, key=str))
def test_canary_runs_where_the_reference_runs_it(native_built, value):
    from karpenter_tpu.solver import router as ref_router

    device_path = {PORT: DEVICE_BACKENDS, REF: {"device"}}
    seen = {}
    for pkg in PACKAGES:
        ref_router.reset_default()  # both routers cold: round 0 is the device path
        prov, catalog, pods = scenario(pkg, "diverse", 80, 7, 10)
        sched = make_scheduler(pkg, canary_rate=1.0)
        with packer(value):
            sched.solve(prov, catalog, pods)
        served = sched.last_stage_profile()["packer_backend"]
        thread = backend_of(pkg, sched)._canary_thread
        if thread is not None:
            thread.join(timeout=120)
            assert not thread.is_alive()
        totals = importlib.import_module(f"{pkg}.solver.integrity").totals()
        ran = thread is not None
        assert ran == (served in device_path[pkg]), (pkg, served)
        assert totals["canary_solves"] == int(ran) and totals["canary_mismatches"] == 0
        seen[pkg] = served
    assert (seen[PORT], seen[REF]) == SERVED_ON_CPU[value]
    ref_router.reset_default()


def test_native_packs_are_never_canaried(native_built, monkeypatch):
    monkeypatch.setenv("KARPENTER_PACKER", "native")
    prov, catalog, pods = scenario(PORT, "teams", 256, 5, 16)
    sched = make_scheduler(PORT, canary_rate=1.0)
    for _ in range(3):
        sched.solve(prov, catalog, pods)
        assert sched.last_stage_profile()["packer_backend"] == "native"
    assert sched.torch._canary_thread is None
    assert integrity.totals()["canary_solves"] == 0


def test_hundred_seeded_batches_give_no_false_positive(native_built, monkeypatch):
    """The canary over the port's plain versions on 100 seeded small
    batches (both routes): every one re-solved on native, none differs."""
    from karpenter_tpu_torch.testing import diverse_pods

    monkeypatch.setenv("KARPENTER_PACKER", "fused")
    M = mods(PORT)
    catalog = M.fake.instance_types(10)
    prov = M.factories.make_provisioner(solver="tpu")
    sched = make_scheduler(PORT, canary_rate=1.0)
    served = set()
    for seed in range(100):
        rng = random.Random(seed)
        if seed % 4 == 3:
            prov_t, cat_t, pods = team_mix(PORT, rng.randrange(96, 200), seed, 16)
            nodes = sched.solve(prov_t, cat_t, pods)
        else:
            pods = diverse_pods(rng.randrange(12, 90), rng)
            nodes = sched.solve(prov, catalog, pods)
        assert nodes
        served.add(sched.last_stage_profile()["packer_backend"])
        sched.torch._canary_thread.join(timeout=120)
        assert not sched.torch._canary_thread.is_alive()
    assert served == {"pack_reference", "pack_v2_reference"}
    totals = integrity.totals()
    assert totals["canary_solves"] == 100
    assert totals["canary_mismatches"] == totals["quarantines"] == 0
    assert sched.torch._pack_breakers.open_dependencies() == []
