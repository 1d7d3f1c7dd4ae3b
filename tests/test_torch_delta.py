"""The port's resident delta path against the JAX package's.

Covers the in-process half of the resident plane, each layer held against
``karpenter_tpu`` on the same seeded inputs (the JAX side solves with its
lax.scan packer, ``KARPENTER_PACKER=scan`` around its solves; the port on
``device="cpu"`` through its fused route, ``KARPENTER_PACKER=fused`` for
the whole test, so the router never moves a round off the fused
typemask and ``PodResidency``):

- host: ``ResidentEncoder`` churn fuzz — every round's batch equals the JAX
  package's resident batch and a cold full encode byte for byte, with the
  same sequence of rungs (``full`` / ``delta`` / ``reuse``); the epoch and
  the identity-keyed sort;
- plan reuse through ``Scheduler(solver_delta=True)``: profile keys round
  for round, every ``Cluster`` mutation and a constraints edit invalidating
  the cached topology plan, plans equal to the JAX package's;
- decode and validation memos;
- device: ``fused.PodResidency``'s reuse / patch / upload ladder;
- the whole slice: churn sequences on the ``teams`` and ``diverse``
  scenarios, knob on against the JAX package and against knob off.

Pods of the two packages are compared by their index in the input list.
"""

import random

import numpy as np
import pytest
import torch

from torch_parity import PACKAGES, fresh_router, mods, pinned, scenario  # noqa: F401

STAGE_KEYS = (
    "sort_s", "sort_delta_s", "inject_s", "inject_delta_s",
    "encode_s", "encode_delta_s", "decode_s", "decode_delta_s",
)


@pytest.fixture(autouse=True)
def fused_port(monkeypatch):
    """The port's side pinned to its fused route; the JAX package's solves
    switch to lax.scan inside ``pinned``."""
    monkeypatch.setenv("KARPENTER_PACKER", "fused")


def delta_mod(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.solver.delta")


# ---------------------------------------------------------------------------
# host layer: ResidentEncoder
# ---------------------------------------------------------------------------


def host_env(pkg, n_types=8):
    M = mods(pkg)
    catalog = sorted(M.fake.instance_types(n_types), key=lambda it: it.effective_price())
    constraints = M.factories.make_provisioner(solver="tpu").spec.constraints
    constraints.requirements = constraints.requirements.merge(
        M.catreq.catalog_requirements(catalog)
    )
    daemon = M.ffd.daemon_overhead(M.Cluster(), constraints)
    return catalog, constraints, daemon


def generic_pod(pkg, rng, i):
    """A topology-free pod — the delta-eligible shape."""
    return mods(pkg).factories.make_pod(
        name=f"delta-{i}-{rng.randrange(10**6)}",
        requests={
            "cpu": str(rng.choice([1, 2, 3])),
            "memory": f"{rng.choice([1, 2, 4, 6])}Gi",
        },
    )


def cold_encode(pkg, constraints, catalog, pods, daemon):
    """A COLD full encode — fresh cache, the non-resident pipeline."""
    M = mods(pkg)
    spods, ssts = M.ffd.sort_pods_ffd_with_statics(pods)
    plan = M.topology.DomainPlan(spods)
    plan.sts = ssts
    return M.encode.encode(
        constraints, catalog, spods, daemon, cache=M.encode.EncodeCache(), plan=plan
    )


def arg_bytes(batch):
    return [(a.dtype.str, a.shape, a.tobytes()) for a in map(np.asarray, batch.pack_args())]


def churn_fuzz(pkg, seed):
    """Randomized arrival/depart churn over 10 rounds through ``pkg``'s
    ResidentEncoder. Returns per round (kind, batch bytes, cold bytes)."""
    M = mods(pkg)
    rng = random.Random(seed)
    catalog, constraints, daemon = host_env(pkg)
    res = delta_mod(pkg).ResidentEncoder(M.encode.EncodeCache())
    pods = [generic_pod(pkg, rng, i) for i in range(6)]
    rounds = []
    for rnd in range(10):
        op = rng.choice(["arrive", "depart", "mixed", "none"])
        if op == "arrive" or (op == "mixed" and len(pods) > 2):
            pods = pods + [generic_pod(pkg, rng, 100 * rnd + j) for j in range(rng.randrange(1, 3))]
        if op in ("depart", "mixed") and len(pods) > 3:
            doomed = rng.sample(range(len(pods)), rng.randrange(1, 3))
            pods = [p for i, p in enumerate(pods) if i not in doomed]
        spods, ssts, _ = res.sort(pods)
        assert res.eligible(ssts)
        plan = res.empty_plan(spods, ssts)
        batch, kind = res.encode(constraints, catalog, spods, ssts, daemon, plan)
        kinds = [kind]
        if op == "none" and rnd > 0:
            # identical input objects → the whole round is a reuse
            batch2, kind2 = res.encode(constraints, catalog, spods, ssts, daemon, plan)
            assert batch2 is batch
            kinds.append(kind2)
        rounds.append((kinds, arg_bytes(batch),
                       arg_bytes(cold_encode(pkg, constraints, catalog, pods, daemon))))
    return rounds


@pytest.mark.parametrize("seed", range(4))
def test_churn_fuzz_matches_reference(seed):
    ref, out = (churn_fuzz(pkg, seed) for pkg in PACKAGES)
    assert [r[0] for r in out] == [r[0] for r in ref]
    for rnd, ((_, want, _), (_, got, cold)) in enumerate(zip(ref, out)):
        assert got == want, f"round {rnd}: port batch != JAX resident batch"
        assert got == cold, f"round {rnd}: port batch != cold full encode"
    kinds = {k for r in out for k in r[0]}
    assert {"full", "delta"} <= kinds


def test_daemon_churn_mints_new_epoch():
    """A changed daemon overhead mints a new epoch → a full re-encode,
    never a patch of tensors built under the old overhead."""
    pkg = "karpenter_tpu_torch"
    M = mods(pkg)
    rng = random.Random(7)
    catalog, constraints, daemon = host_env(pkg)
    res = delta_mod(pkg).ResidentEncoder(M.encode.EncodeCache())
    pods = [generic_pod(pkg, rng, i) for i in range(4)]
    spods, ssts, _ = res.sort(pods)
    plan = res.empty_plan(spods, ssts)
    assert res.encode(constraints, catalog, spods, ssts, daemon, plan)[1] == "full"
    assert res.encode(constraints, catalog, spods, ssts, daemon, plan)[1] == "reuse"
    retired = dict(daemon)
    retired["cpu"] = retired.get("cpu", 0.0) + 0.25
    batch, kind = res.encode(constraints, catalog, spods, ssts, retired, plan)
    assert kind == "full"
    jrng = random.Random(7)
    jpods = [generic_pod("karpenter_tpu", jrng, i) for i in range(4)]
    jcat, jcon, jdaemon = host_env("karpenter_tpu")
    jretired = dict(jdaemon)
    jretired["cpu"] = jretired.get("cpu", 0.0) + 0.25
    assert arg_bytes(batch) == arg_bytes(cold_encode("karpenter_tpu", jcon, jcat, jpods, jretired))


def test_sort_fast_path_is_identity_keyed():
    """The resident sort serves the cached order only for the SAME pod
    objects; a changed list re-sorts, in the JAX package's order."""
    pkg = "karpenter_tpu_torch"
    M = mods(pkg)
    res = delta_mod(pkg).ResidentEncoder(M.encode.EncodeCache())
    sorted_names, inputs = {}, {}
    for p in PACKAGES:
        rng = random.Random(3)
        pods = [generic_pod(p, rng, i) for i in range(8)]
        inputs[p] = pods, pods[1:] + [generic_pod(p, rng, 99)]
        sorted_names[p] = [x.metadata.name for x in mods(p).ffd.sort_pods_ffd(inputs[p][1])]
    pods, churned = inputs[pkg]
    s1, _, hit1 = res.sort(pods)
    s2, _, hit2 = res.sort(pods)
    assert not hit1 and hit2 and s2 is s1
    s3, _, hit3 = res.sort(churned)
    assert not hit3
    assert [p.metadata.name for p in s3] == sorted_names["karpenter_tpu"] == sorted_names[pkg]


def test_topo_resident_rows_never_row_delta():
    """Pod churn under a topology-adopted vocabulary falls to a full
    re-encode in both packages: the resident rows embed the injected plan's
    decisions."""
    kinds = {}
    for pkg in PACKAGES:
        M = mods(pkg)
        catalog, constraints, daemon = host_env(pkg)
        res = delta_mod(pkg).ResidentEncoder(M.encode.EncodeCache())
        spods, ssts, _ = res.sort(M.scenarios.diverse_pods(21, random.Random(9)))
        assert not res.eligible(ssts)
        injector = M.topology.Topology(M.Cluster(), rng=random.Random(2))
        out = []
        for pods in (spods, spods[1:]):
            s, st, _ = res.sort(pods)
            cc = constraints.clone()
            plan = injector.inject_plan(cc, s, sts=st)
            batch, kind = res.encode(cc, catalog, s, st, daemon, plan, topo=True)
            out.append((kind, arg_bytes(batch)))
        kinds[pkg] = out
    assert [k for k, _ in kinds["karpenter_tpu_torch"]] == ["full", "full"]
    assert kinds["karpenter_tpu_torch"] == kinds["karpenter_tpu"]


def test_plan_reuse_hands_out_fresh_clones():
    """The cached injected round survives a consumer mutating what it was
    handed: reuse returns a fresh constraints clone and daemon copy."""
    pkg = "karpenter_tpu_torch"
    M = mods(pkg)
    res = delta_mod(pkg).ResidentEncoder(M.encode.EncodeCache())
    _, constraints, daemon = host_env(pkg)
    sts = ["sentinel"]
    key = res.plan_key(constraints, 7)
    res.remember_plan(key, sts, constraints, M.topology.DomainPlan([]), daemon)
    c1, _, d1 = res.plan_reuse(key, sts)
    c1.labels["poison"] = "yes"
    d1["poison"] = 1.0
    c2, _, d2 = res.plan_reuse(key, sts)
    assert "poison" not in c2.labels and "poison" not in d2
    assert res.plan_reuse(key, ["other"]) is None
    assert res.plan_reuse(res.plan_key(constraints, 8), sts) is None


# ---------------------------------------------------------------------------
# plan reuse and the memos through Scheduler(solver_delta=True)
# ---------------------------------------------------------------------------


def make_scheduler(pkg, cluster, delta=True):
    M = mods(pkg)
    sched_mod = __import__(f"{pkg}.scheduling.scheduler", fromlist=["Scheduler"])
    kw = {} if pkg == "karpenter_tpu" else {"device": "cpu"}
    return sched_mod.Scheduler(cluster or M.Cluster(), rng=random.Random(1),
                               solver_delta=delta, **kw)


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        (
            [index[id(p)] for p in n.pods],
            [it.name for it in n.instance_type_options],
            dict(n.requests),
            [(r.key, r.operator, tuple(r.values)) for r in n.constraints.requirements.requirements],
            [(k, vs.complement, sorted(vs.values)) for k, vs in n.constraints.requirements._sets],
        )
        for n in nodes
    ]


def stage_keys(sched):
    return sorted(k for k in sched.last_stage_profile() if k in STAGE_KEYS)


class Topo:
    """One package's topology env: a resident scheduler over diverse pods."""

    def __init__(self, pkg, n_pods=70, n_types=8, seed=5):
        M = mods(pkg)
        self.M = M
        self.pkg = pkg
        self.catalog = M.fake.instance_types(n_types)
        self.provisioner = M.factories.make_provisioner(solver="tpu")
        self.pods = M.scenarios.diverse_pods(n_pods, random.Random(seed))
        self.cluster = M.Cluster()
        self.sched = make_scheduler(pkg, self.cluster)
        self.backend = self.sched.torch if pkg == "karpenter_tpu_torch" else None

    def solve(self):
        with pinned(self.pkg):
            nodes = self.sched.solve(self.provisioner, self.catalog, self.pods)
        if self.backend is None:
            self.backend = self.sched._tpu
        return nodes, stage_keys(self.sched), self.sched.last_stage_profile()


def test_topology_steady_state_matches_reference():
    """A topology batch full-injects once; with cluster, constraints and
    batch unchanged, later rounds reuse the plan, hit the encode reuse rung
    and the decode memo, and skip validation — the same rungs as the
    reference, round for round, and the same plan."""
    envs = {pkg: Topo(pkg) for pkg in PACKAGES}
    for rnd in range(3):
        (ref, ref_keys, _), (out, keys, prof) = (envs[p].solve() for p in PACKAGES)
        assert keys == ref_keys, f"round {rnd}"
        assert plan_of(out, envs["karpenter_tpu_torch"].pods) == plan_of(
            ref, envs["karpenter_tpu"].pods
        )
        if rnd == 0:
            assert keys == ["decode_s", "encode_s", "inject_s", "sort_s"]
            assert "validate_s" in prof
        else:
            assert keys == ["decode_delta_s", "encode_delta_s", "inject_delta_s", "sort_delta_s"]
            assert "validate_delta_s" in prof and "validate_s" not in prof


def mutate(pkg, cluster, how):
    """One store mutation, with a pod created before the warm-up rounds
    (``resident-0``, carrying a finalizer) as its target."""
    f = mods(pkg).factories
    target = cluster.get("pods", "resident-0")
    if how == "create":
        cluster.create("pods", f.make_pod(name="late-arrival"))
    elif how == "update":
        cluster.update("pods", target)
    elif how == "delete":
        cluster.delete("pods", "resident-0")
    elif how == "bind":
        cluster.bind(target, "node-a")
    elif how == "seed":
        cluster.seed("pods", f.make_pod(name="seeded"))


@pytest.mark.parametrize("how", ["create", "update", "delete", "bind", "seed"])
def test_cluster_mutation_invalidates_the_plan(how):
    """Every store mutation bumps Cluster.version() and the next solve
    re-injects in full, as in the reference; the plans stay equal."""
    envs = {}
    for pkg in PACKAGES:
        env = Topo(pkg)
        pod = env.M.factories.make_pod(name="resident-0")
        pod.metadata.finalizers.append("example.com/hold")
        env.cluster.create("pods", pod)
        envs[pkg] = env
    for rnd in range(4):
        if rnd == 2:
            for pkg, env in envs.items():
                v0 = env.cluster.version()
                mutate(pkg, env.cluster, how)
                assert env.cluster.version() > v0, pkg
        (ref, ref_keys, _), (out, keys, _) = (envs[p].solve() for p in PACKAGES)
        assert keys == ref_keys, f"round {rnd}"
        assert ("inject_s" in keys) == (rnd in (0, 2)), f"round {rnd}: {keys}"
        assert plan_of(out, envs["karpenter_tpu_torch"].pods) == plan_of(
            ref, envs["karpenter_tpu"].pods
        )


def test_finalizer_free_delete_invalidates_the_plan():
    """A delete that removes the object outright bumps the version too (the
    port's store counts a removal as a mutation), so the next solve
    re-injects."""
    env = Topo("karpenter_tpu_torch")
    env.cluster.create("pods", env.M.factories.make_pod(name="doomed"))
    env.solve()
    assert "inject_delta_s" in env.solve()[1]
    v0 = env.cluster.version()
    env.cluster.delete("pods", "doomed")
    assert env.cluster.version() > v0
    assert env.cluster.try_get("pods", "doomed") is None
    assert "inject_s" in env.solve()[1]


def test_delete_keeps_finalizer_semantics():
    M = mods("karpenter_tpu_torch")
    cluster = M.Cluster()
    pod = M.factories.make_pod(name="held")
    pod.metadata.finalizers.append("example.com/hold")
    cluster.create("pods", pod)
    cluster.delete("pods", "held")
    assert cluster.get("pods", "held").metadata.deletion_timestamp is not None
    v = cluster.version()
    cluster.delete("pods", "held")  # already terminating: a no-op
    assert cluster.version() == v
    from karpenter_tpu_torch.kube.client import NotFound

    with pytest.raises(NotFound):
        cluster.update("pods", M.factories.make_pod(name="never-created"))
    with pytest.raises(NotFound):
        cluster.delete("pods", "never-created")


def test_constraints_change_invalidates_the_plan():
    """The plan key holds the PRE-inject requirements content: a
    provisioner constraints edit re-injects, as in the reference."""
    envs = {pkg: Topo(pkg) for pkg in PACKAGES}
    for rnd in range(3):
        if rnd == 2:
            for env in envs.values():
                c = env.provisioner.spec.constraints
                c.requirements = c.requirements.add(env.M.objects.NodeSelectorRequirement(
                    key="example.com/tier", operator="NotIn", values=["spot-x"]))
        (ref, ref_keys, _), (out, keys, _) = (envs[p].solve() for p in PACKAGES)
        assert keys == ref_keys
        assert ("inject_s" in keys) == (rnd != 1)
        assert plan_of(out, envs["karpenter_tpu_torch"].pods) == plan_of(
            ref, envs["karpenter_tpu"].pods
        )


def test_result_bit_change_misses_the_decode_memo():
    env = Topo("karpenter_tpu_torch")
    env.solve()
    assert "decode_delta_s" in env.solve()[1]
    sched = env.backend
    memo = sched._dec_memo
    batch, its, n_nodes = memo[0], memo[1], memo[7]
    assert n_nodes > 1
    args = (batch, memo[3], memo[4], memo[5], memo[6], n_nodes, memo[8], memo[2], its)
    assert sched._decode_from_memo(*args) is not None
    assignment = memo[3].copy()
    i = int(np.flatnonzero(assignment >= 0)[0])
    assignment[i] = (assignment[i] + 1) % n_nodes
    assert sched._decode_from_memo(batch, assignment, *args[2:]) is None
    typemask = memo[8].copy()
    typemask[0, 0] = ~typemask[0, 0]
    assert sched._decode_from_memo(*args[:6], typemask, *args[7:]) is None


def test_memo_hit_nodes_are_independent_copies():
    """A consumer appending to a served node's pods must not leak into the
    next round's nodes."""
    env = Topo("karpenter_tpu_torch")
    env.solve()
    n1, keys, _ = env.solve()
    assert "decode_delta_s" in keys
    clean = plan_of(n1, env.pods)
    placed = [n for n in n1 if n.pods]
    placed[0].pods.append(placed[0].pods[0])
    placed[0].requests["poison"] = 1.0
    n2, keys, _ = env.solve()
    assert "decode_delta_s" in keys
    assert plan_of(n2, env.pods) == clean
    assert all("poison" not in n.requests for n in n2)


def test_failed_validation_raises_and_never_arms_the_skip_memo():
    """A bad plan is re-validated every round no matter how often it
    repeats bit for bit: the skip memo arms only on a pass. The scheduler
    is set up as a card's, which raises where the reference serves its
    floor; the quarantine is stubbed, as the reference's test stubs it, so
    the tripped breaker does not refuse later rounds before validation."""
    from karpenter_tpu_torch.solver.backend import InvalidPackError

    env = Topo("karpenter_tpu_torch")
    env.solve()
    sched = env.backend
    sched._validate_memo = None
    sched._floor_serves = False
    calls, quarantines = [], []

    def failing(nodes, pods, daemon):
        calls.append(1)
        return "forced violation (test)"

    sched._validate_pack = failing
    sched._quarantine_source = lambda reason, detail, batch, address="": quarantines.append(reason)
    for rnd in range(3):
        with pytest.raises(InvalidPackError, match="forced violation"):
            env.solve()
        assert len(calls) == rnd + 1
        assert quarantines == ["invalid_pack"] * (rnd + 1)
        assert sched._validate_memo is None
        assert "validate_s" in env.sched.last_stage_profile()
    assert "decode_delta_s" in env.sched.last_stage_profile()


def test_knob_off_validates_every_solve():
    M = mods("karpenter_tpu_torch")
    sched = make_scheduler("karpenter_tpu_torch", None, delta=False)
    assert sched.torch._resident is None and sched.torch._pod_residency is None
    prov = M.factories.make_provisioner(solver="tpu")
    catalog = M.fake.instance_types(8)
    pods = M.scenarios.diverse_pods(35, random.Random(4))
    sched.solve(prov, catalog, pods)
    calls = []
    real = sched.torch._validate_pack

    def counting(nodes, batch_pods, daemon):
        calls.append(1)
        return real(nodes, batch_pods, daemon)

    sched.torch._validate_pack = counting
    for _ in range(2):
        sched.solve(prov, catalog, pods)
        assert stage_keys(sched) == ["decode_s", "encode_s", "inject_s", "sort_s"]
    assert len(calls) == 2


def test_knob_reads_its_env_twin(monkeypatch):
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.solver.backend import TorchScheduler

    for value, on in (("true", True), (" TRUE ", True), ("1", False), ("", False)):
        monkeypatch.setenv("KARPENTER_SOLVER_DELTA", value)
        assert TorchScheduler(Cluster(), device="cpu").solver_delta is on
    monkeypatch.setenv("KARPENTER_SOLVER_DELTA", "true")
    assert TorchScheduler(Cluster(), device="cpu", solver_delta=False)._resident is None


# ---------------------------------------------------------------------------
# device layer: PodResidency on device="cpu"
# ---------------------------------------------------------------------------


def residency_batches(pkg, n_pods=8, swap=3, seed=11):
    """(batch, churned batch): one pod swapped, the count intact."""
    M = mods(pkg)
    catalog, constraints, daemon = host_env(pkg, 6)
    rng = random.Random(seed)
    pods = [generic_pod(pkg, rng, i) for i in range(n_pods)]

    def build(pod_list):
        spods, ssts = M.ffd.sort_pods_ffd_with_statics(pod_list)
        plan = M.topology.DomainPlan(spods)
        plan.sts = ssts
        return M.encode.encode(constraints, catalog, spods, daemon, plan=plan)

    churned = list(pods)
    churned[swap] = generic_pod(pkg, rng, 99)
    return build(pods), build(churned)


def port_residency():
    from karpenter_tpu_torch.solver import fused

    return fused.PodResidency("cpu")


def test_residency_ladder_matches_reference():
    from karpenter_tpu.solver import fused as jax_fused

    b1, b2 = residency_batches("karpenter_tpu_torch")
    j1, j2 = residency_batches("karpenter_tpu")
    res, jres = port_residency(), jax_fused.PodResidency()
    devs1 = res.get(b1)
    jres.get(j1)
    assert res.stats == {"reused": 0, "patched": 0, "uploaded": 1}
    again = res.get(b1)  # identity hit: no re-pack, no transfer
    jres.get(j1)
    assert again is devs1 and res.stats["reused"] == 1
    ptr = devs1[0].data_ptr()
    devs2 = res.get(b2)  # one-pod churn, same shape: column patch
    jdevs2 = jres.get(j2)
    assert res.stats == {"reused": 1, "patched": 1, "uploaded": 1} == jres.stats
    assert devs2[0] is devs1[0] and devs2[0].data_ptr() == ptr  # patched in place
    for got, want in zip(devs2, jdevs2):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patched_table_equals_fresh_pack():
    from karpenter_tpu_torch.solver import fused

    b1, b2 = residency_batches("karpenter_tpu_torch")
    res = port_residency()
    res.get(b1)
    tab, obc, bhh, uniq = res.get(b2)
    assert res.stats["patched"] == 1
    want_tab, want_obc, want_bhh = fused.pack_pod_table(b2)
    np.testing.assert_array_equal(tab.numpy(), want_tab)
    np.testing.assert_array_equal(obc.numpy(), want_obc)
    np.testing.assert_array_equal(bhh.numpy(), want_bhh)
    np.testing.assert_array_equal(uniq.numpy(), fused.pad_uniq_req(b2.uniq_req))
    assert tab.dtype == torch.int16 and uniq.dtype == torch.float32


def test_shape_change_full_upload():
    from karpenter_tpu_torch.solver import fused

    b1, _ = residency_batches("karpenter_tpu_torch")
    big, _ = residency_batches("karpenter_tpu_torch", n_pods=70, seed=5)
    assert fused.pack_pod_table(big)[0].shape != fused.pack_pod_table(b1)[0].shape
    res = port_residency()
    res.get(b1)
    tab, *_ = res.get(big)
    assert res.stats == {"reused": 0, "patched": 0, "uploaded": 2}
    np.testing.assert_array_equal(tab.numpy(), fused.pack_pod_table(big)[0])


def test_wide_churn_reuploads_the_table():
    """Churn past a quarter of the columns uploads a new table instead of
    patching; the side arrays upload again only where they changed."""
    from karpenter_tpu_torch.solver import fused

    b1, _ = residency_batches("karpenter_tpu_torch", n_pods=40, seed=2)
    b2, _ = residency_batches("karpenter_tpu_torch", n_pods=40, seed=3)
    t1, t2 = fused.pack_pod_table(b1)[0], fused.pack_pod_table(b2)[0]
    assert t1.shape == t2.shape and (t1 != t2).any(axis=0).sum() > t1.shape[1] // 4
    res = port_residency()
    devs1 = res.get(b1)
    devs2 = res.get(b2)
    assert res.stats == {"reused": 0, "patched": 1, "uploaded": 1}
    assert devs2[0] is not devs1[0]
    np.testing.assert_array_equal(devs2[0].numpy(), t2)
    np.testing.assert_array_equal(devs1[0].numpy(), t1)  # the old table untouched


def test_saturation_retry_hits_the_identity_rung():
    """The one-per-node batch saturates the 512-slot table: the retry packs
    the same batch again, and the second upload is the reuse rung."""
    prov, catalog, pods = scenario("karpenter_tpu_torch", "one_per_node", 600, 42, 50)
    sched = make_scheduler("karpenter_tpu_torch", None)
    sched.solve(prov, catalog, pods)
    assert sched.last_stage_profile()["pack_dispatches"] == 2
    assert sched.torch._pod_residency.stats == {"reused": 1, "patched": 0, "uploaded": 1}


# ---------------------------------------------------------------------------
# the whole slice: churn sequences through Scheduler.solve
# ---------------------------------------------------------------------------


def new_pods(pkg, name, k, rng):
    """``k`` arrivals drawn like the scenario's own pods."""
    M = mods(pkg)
    if name == "teams":
        return [
            M.factories.make_pod(
                requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                node_selector={"team": f"t{rng.randrange(64)}"},
            )
            for _ in range(k)
        ]
    return M.scenarios.diverse_pods(k, random.Random(rng.randrange(10**6)))


# (kind of round, ...): churn swaps 10 pods, same re-solves the same list,
# bind binds a cluster pod first and then re-solves the same list
SEQUENCE = ("first", "churn", "same", "bind", "churn", "same")


def run_sequence(pkg, name, n_pods, delta):
    M = mods(pkg)
    prov, catalog, pods = scenario(pkg, name, n_pods, 42, 16 if name == "teams" else 20)
    cluster = M.Cluster()
    held = cluster.create("pods", M.factories.make_pod(name="held"))
    sched = make_scheduler(pkg, cluster, delta)
    rng = random.Random(11)
    out = []
    for kind in SEQUENCE:
        if kind == "churn":
            leave = set(rng.sample(range(len(pods)), 10))
            pods = [p for i, p in enumerate(pods) if i not in leave] + new_pods(pkg, name, 10, rng)
        elif kind == "bind":
            cluster.bind(held, "node-x")
        with pinned(pkg):
            nodes = sched.solve(prov, catalog, pods)
        out.append((plan_of(nodes, pods), stage_keys(sched)))
    return out


@pytest.mark.parametrize("name,n_pods", [("teams", 400), ("diverse", 300)])
def test_churn_sequence_matches_reference(name, n_pods):
    ref = run_sequence("karpenter_tpu", name, n_pods, True)
    out = run_sequence("karpenter_tpu_torch", name, n_pods, True)
    off = run_sequence("karpenter_tpu_torch", name, n_pods, False)
    for rnd, ((want, ref_keys), (got, keys)) in enumerate(zip(ref, out)):
        assert keys == ref_keys, f"round {rnd} ({SEQUENCE[rnd]})"
        assert got == want, f"round {rnd} ({SEQUENCE[rnd]}): plan differs from the JAX package's"
        assert got, f"round {rnd}"
    # knob off draws new hostnames on every topology round; a topology-free
    # batch draws none, so there every round must match
    same_as_off = range(len(SEQUENCE)) if name == "teams" else range(1)
    for rnd in same_as_off:
        assert out[rnd][0] == off[rnd][0], f"round {rnd}: knob on != knob off"
    keys = [k for _, k in out]
    if name == "teams":
        # topology-free: the churn rounds take the row delta, the repeats
        # reuse; the facade's fresh requirements miss the decode memo
        assert keys[1] == keys[4] == ["decode_s", "encode_delta_s", "inject_delta_s", "sort_s"]
        assert keys[2] == ["decode_s", "encode_delta_s", "inject_delta_s", "sort_delta_s"]
    else:
        assert keys[2] == keys[5] == [
            "decode_delta_s", "encode_delta_s", "inject_delta_s", "sort_delta_s"]
        assert "inject_s" in keys[3] and "encode_s" in keys[3]  # the bind re-injects
