"""The port's unfused ladder (``backend.pack_unfused`` over the card's kernel
ladder ``pack_kernel.pack_best``), its callers and ``KARPENTER_PACKER``
forcing, against the JAX package's.

- the unfused v1 caller (``pack_first_fit`` over ``pack_args()`` tensors)
  against the JAX package's lax.scan kernel, and the unfused v2 caller
  (``pack_kernel_v2.pack_unfused_v2``) against ``pack_pallas_v2`` in Pallas
  interpret mode, on CPU tensors;
- every ``KARPENTER_PACKER`` value through ``Scheduler.solve`` on both
  packages: ``auto``, ``fused``, ``native`` and ``scan`` give the JAX
  package's plan under the same value; ``pallas`` raises on the CPU in the
  JAX package's ``pack_best`` and the port's ``pack_unfused``, and both
  schedulers then serve the reference's FFD floor plan (``ffd-degraded``);
- a batch whose ids do not fit the compact int16 table takes the unfused
  route with the JAX package's plan;
- the host typemask decode (``typemask None``) gives the fused typemask's
  surviving types, and the decode memo keeps the two apart;
- the failed-shape memos: the kernel ladder's rung order with the kernels
  made to raise, and a failed fused solve sending its shape to the unfused
  ladder.

Tolerance: none. Every comparison is bit for bit (plans by each pod's
index in the input list).
"""

import importlib
import random

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.solver import pallas_kernel as jax_pallas
from karpenter_tpu.solver import kernel as jax_kernel
from karpenter_tpu.solver import pallas_kernel_v2 as jax_v2
from karpenter_tpu_torch.solver import backend, carry, fused, native, pack_kernel, pack_kernel_v2
from karpenter_tpu_torch.solver.kernel import PackResult
from torch_parity import (  # noqa: F401
    PACKAGES, encode_scenario, fields, fresh_router, interpret, packer, scenario, synth_fields,
    team_mix,
)


def assert_same(ref, out):
    for name, a, b in zip(PackResult._fields, ref, out):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        a = np.asarray(a)
        np.testing.assert_array_equal(a.reshape(b.shape), b, err_msg=name)
        assert a.dtype == b.dtype, name


def kernel_args(f):
    return tuple(f[k] for k, _ in carry.PACK_ARG_DTYPES)


def cpu_args(f):
    return tuple(a.contiguous() for a in carry.tensors_from_reference(f, "cpu")["pack_args"])


def team_fields(n_pods=512, n_types=16):
    pkg = "karpenter_tpu"
    return fields(encode_scenario(pkg, *team_mix(pkg, n_pods, 9, n_types)))


def pinned_fields():
    return synth_fields(P=512, S=12, F=3, R=4, C=6, n_hosts=9, seed=5, pkg="karpenter_tpu")


# -- the unfused callers on CPU tensors ---------------------------------------


@pytest.mark.parametrize("case,n_max", [("teams", 256), ("teams", 16), ("pinned", 128), ("pinned", 8)])
def test_unfused_v1_caller_matches_lax_scan(case, n_max):
    f = team_fields() if case == "teams" else pinned_fields()
    ref = jax.device_get(tuple(jax_kernel.pack(*kernel_args(f), n_max=n_max)))
    assert_same(ref, pack_kernel.pack_first_fit(*cpu_args(f), n_max=n_max))


@pytest.mark.parametrize("case,n_max", [("teams", 256), ("teams", 16), ("pinned", 128), ("pinned", 8)])
def test_unfused_v2_caller_matches_pack_pallas_v2(interpret, case, n_max):
    f = team_fields() if case == "teams" else pinned_fields()
    ref = jax.device_get(tuple(jax_v2.pack_pallas_v2(*kernel_args(f), n_max=n_max)))
    before = pack_kernel_v2.launches
    assert_same(ref, pack_kernel_v2.pack_unfused_v2(*cpu_args(f), n_max=n_max))
    assert pack_kernel_v2.launches == before  # CPU tensors: the plain version, not counted


def test_v2_args_are_the_tables_of_the_reference():
    f = team_fields()
    out = pack_kernel_v2.v2_args(*cpu_args(f))
    want = carry.tensors_from_reference(f, "cpu")["pack_v2_args"]
    for a, b in zip(want, out):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- KARPENTER_PACKER through Scheduler.solve ---------------------------------


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         dict(n.requests), [(r.key, r.operator, tuple(r.values))
                            for r in n.constraints.requirements.requirements])
        for n in nodes
    ]


def solve(pkg, name, n_pods, n_types, value):
    prov, catalog, pods = scenario(pkg, name, n_pods, 42, n_types)
    sched_mod = importlib.import_module(f"{pkg}.scheduling.scheduler")
    client = importlib.import_module(f"{pkg}.kube.client")
    kw = {} if pkg == "karpenter_tpu" else {"device": "cpu"}
    sched = sched_mod.Scheduler(client.Cluster(), rng=random.Random(1), **kw)
    with packer(value):
        nodes = sched.solve(prov, catalog, pods)
    return plan_of(nodes, pods), sched.last_stage_profile()


SHAPES = {"v1": ("diverse", 300, 50), "v2": ("teams", 512, 16)}
# what serves on the port's device="cpu" per value: (packer_backend, pack_route)
SERVED = {
    ("auto", "v1"): ("pack_reference", "fused"), ("auto", "v2"): ("pack_v2_reference", "fused"),
    ("fused", "v1"): ("pack_reference", "fused"), ("fused", "v2"): ("pack_v2_reference", "fused"),
    ("native", "v1"): ("native", "unfused"), ("native", "v2"): ("native", "unfused"),
    ("scan", "v1"): ("pack_reference", "unfused"), ("scan", "v2"): ("pack_reference", "unfused"),
}


@pytest.fixture
def native_built():
    for pkg in PACKAGES:
        if not importlib.import_module(f"{pkg}.solver.native").native_available(wait=180):
            pytest.fail(f"{pkg}'s native packer did not build")


@pytest.mark.parametrize("value,route", sorted(SERVED))
def test_every_packer_value_gives_the_jax_plan(native_built, value, route):
    ref, _ = solve("karpenter_tpu", *SHAPES[route], value)
    out, prof = solve("karpenter_tpu_torch", *SHAPES[route], value)
    assert len(out) == len(ref) > 0
    assert out == ref
    assert (prof["packer_backend"], prof["pack_route"]) == SERVED[value, route]


@pytest.mark.parametrize("route", sorted(SHAPES))
def test_pallas_raises_without_a_card(route):
    """The forced rung raises without a card in both packages' unfused
    ladders; each scheduler then serves the batch from its FFD floor."""
    f = team_fields() if route == "v2" else pinned_fields()
    with packer("pallas"):
        with pytest.raises(RuntimeError, match="KARPENTER_PACKER=pallas"):
            jax_pallas.pack_best(*kernel_args(f), n_max=64)
    with pytest.raises(RuntimeError, match="KARPENTER_PACKER=pallas"):
        backend.pack_unfused(*cpu_args(f), n_max=64, packer="pallas")
    out, prof = solve("karpenter_tpu_torch", *SHAPES[route], "pallas")
    ref, ref_prof = solve("karpenter_tpu", *SHAPES[route], "pallas")
    assert ref_prof["packer_backend"] == prof["packer_backend"] == "ffd-degraded"
    assert len(out) == len(ref) > 0
    assert out == ref  # the reference's floor plan


def test_cpu_ladder_takes_native_when_built_else_the_plain_version(native_built, monkeypatch):
    f = pinned_fields()
    ref = pack_kernel.pack_reference(*cpu_args(f), n_max=64)
    served, out = backend.pack_unfused(*cpu_args(f), n_max=64)
    assert served == "native" and isinstance(out.assignment, np.ndarray)
    assert_same(tuple(t.numpy() for t in ref), out)
    monkeypatch.setattr(native, "native_available", lambda wait=None: False)
    served, out = backend.pack_unfused(*cpu_args(f), n_max=64)
    assert served == "pack_reference"
    assert_same(tuple(t.numpy() for t in ref), out)
    # the card's kernel ladder on CPU tensors: the plain version, no native
    monkeypatch.setattr(native, "pack_native", lambda *a, **kw: pytest.fail("native"))
    served, out = pack_kernel.pack_best(*cpu_args(f), n_max=64)
    assert served == "pack_reference"
    assert_same(tuple(t.numpy() for t in ref), out)


# -- ids past the compact int16 table -----------------------------------------


@pytest.mark.parametrize("route", sorted(SHAPES))
def test_ids_past_int16_take_the_unfused_route(monkeypatch, route):
    ref, _ = solve("karpenter_tpu", *SHAPES[route], "scan")
    # every batch's interned ids now overflow the compact table
    monkeypatch.setattr(fused, "I16_MAX", 1)
    pkg = "karpenter_tpu_torch"
    batch = encode_scenario(pkg, *scenario(pkg, SHAPES[route][0], SHAPES[route][1], 42,
                                           SHAPES[route][2]))
    assert not fused.ids_fit(batch)
    assert backend.TorchScheduler._fused_route(batch, "fused") is None
    out, prof = solve(pkg, *SHAPES[route], "fused")
    assert out == ref and prof["pack_route"] == "unfused"
    assert prof["packer_backend"] in ("native", "pack_reference")


# -- the host typemask decode -------------------------------------------------


@pytest.mark.parametrize("route", sorted(SHAPES))
def test_host_typemask_decode_equals_the_fused_typemask(route):
    fused_plan, fused_prof = solve("karpenter_tpu_torch", *SHAPES[route], "fused")
    host_plan, host_prof = solve("karpenter_tpu_torch", *SHAPES[route], "scan")
    assert fused_prof["pack_route"] == "fused" and host_prof["pack_route"] == "unfused"
    assert host_plan == fused_plan
    assert all(types for _, types, _, _ in host_plan)  # every node keeps a type


def test_decode_memo_keeps_typemask_none_apart():
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    prov, catalog, pods = scenario("karpenter_tpu_torch", "diverse", 70, 5, 8)
    sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_delta=True)
    keys = []
    with packer("scan"):
        for _ in range(2):
            sched.solve(prov, catalog, pods)
            keys.append(sched.last_stage_profile())
    assert "decode_delta_s" in keys[1] and "validate_delta_s" in keys[1]
    tb = sched.torch
    memo = tb._dec_memo
    assert memo[8] is None
    args = (memo[0], memo[3], memo[4], memo[5], memo[6], memo[7], None, memo[2], memo[1])
    assert tb._decode_from_memo(*args) is not None
    mask = np.ones((len(memo[4]), len(catalog)), bool)
    assert tb._decode_from_memo(*args[:6], mask, *args[7:]) is None  # a typemask never hits it


# -- the failed-shape memos ----------------------------------------------------


def _ladder_spy(monkeypatch, broken):
    """Record which kernel each ladder call tries; the kernels in
    ``broken`` raise."""
    tried = []

    def wrap(name, real):
        def run(*a, **kw):
            tried.append(name)
            if name in broken:
                raise RuntimeError(f"{name} launch failed (test)")
            return real(*a, **kw)
        return run

    monkeypatch.setattr(pack_kernel, "pack_first_fit", wrap("v1", pack_kernel.pack_first_fit))
    monkeypatch.setattr(pack_kernel_v2, "pack_first_fit_v2",
                        wrap("v2", pack_kernel_v2.pack_first_fit_v2))
    return tried


@pytest.mark.parametrize(
    "shape,broken,tried,served",
    [
        # P % 128 == 0 and S·F <= 1024: v1 first, then v2
        ((512, 12, 3), (), ["v1", "v1"], "pack_first_fit"),
        ((512, 12, 3), ("v1",), ["v1", "v2", "v2"], "pack_first_fit_v2"),
        # S·F past the v1 budget: v2 first, then v1
        ((512, 300, 4), (), ["v2", "v2"], "pack_first_fit_v2"),
        ((512, 300, 4), ("v2",), ["v2", "v1", "v1"], "pack_first_fit"),
        # P not a multiple of 128: the v2 rung first
        ((200, 12, 3), (), ["v2", "v2"], "pack_first_fit_v2"),
        # both fail: the ladder raises, never the plain version or native
        ((512, 12, 3), ("v1", "v2"), ["v1", "v2"], None),
    ],
    ids=["v1", "v1-failed", "v2", "v2-failed", "unaligned", "both-failed"],
)
def test_kernel_ladder_rung_order_and_memo(monkeypatch, shape, broken, tried, served):
    P, S, F = shape
    f = synth_fields(P=P, S=S, F=F, R=2, C=4, n_hosts=5, seed=3)
    args = cpu_args(f)
    spy = _ladder_spy(monkeypatch, broken)  # on CPU tensors each kernel runs its plain version
    monkeypatch.setattr(native, "pack_native", lambda *a, **kw: pytest.fail("native"))
    for _ in range(2 if served else 1):  # a failed rung is skipped on the second call
        if served is None:
            with pytest.raises(RuntimeError, match="no kernel served"):
                pack_kernel._kernel_ladder(*args, n_max=32)
        else:
            name, out = pack_kernel._kernel_ladder(*args, n_max=32)
            assert name == served
            assert_same(jax.device_get(tuple(jax_kernel.pack(*kernel_args(f), n_max=32))),
                        out)
    assert spy == tried
    memo = {"v1": (P, 32), "v2": ("v2", P, 32)}
    assert pack_kernel._failed_shapes == {memo[k] for k in broken}


@pytest.mark.parametrize(
    "shape,broken,tried,served",
    [
        ((512, 12, 3), (), ["v1"], "pack_first_fit"),
        ((512, 12, 3), ("v1",), ["v1", "v2"], "pack_first_fit_v2"),
        ((200, 12, 3), (), ["v2"], "pack_first_fit_v2"),
    ],
    ids=["v1", "v1-failed", "unaligned"],
)
def test_kernel_ladder_serves_a_stack_in_one_call(monkeypatch, shape, broken, tried, served):
    """A coalesced group's stack (three problems, two of them on one
    catalog) takes the ladder as one problem of its shape does: one call of
    each rung tried, the failed rung memoized, each problem's answer the
    JAX package's; the v2 rung builds its tables once per distinct
    catalog."""
    P, S, F = shape
    fs = [synth_fields(P=P, S=S, F=F, R=2, C=4, n_hosts=5, seed=seed) for seed in (3, 4)]
    third = dict(fs[0], pod_valid=fs[0]["pod_valid"].copy())
    third["pod_valid"][::7] = False
    fs.append(third)
    args = tuple(torch.stack(col) for col in zip(*(cpu_args(f) for f in fs)))
    spy = _ladder_spy(monkeypatch, broken)
    built = []
    real = pack_kernel_v2._precompute
    monkeypatch.setattr(pack_kernel_v2, "_precompute",
                        lambda *a: built.append(1) or real(*a))
    name, out = pack_kernel._kernel_ladder(*args, n_max=32)
    assert name == served and spy == tried
    assert len(built) == (2 if served == "pack_first_fit_v2" else 0)
    memo = {"v1": (P, 32), "v2": ("v2", P, 32)}
    assert pack_kernel._failed_shapes == {memo[k] for k in broken}
    for b, f in enumerate(fs):
        assert_same(jax.device_get(tuple(jax_kernel.pack(*kernel_args(f), n_max=32))),
                    PackResult(*(o[b] for o in out)))


def test_v2_tables_past_the_budget_leave_only_v1(monkeypatch):
    monkeypatch.setattr(pack_kernel_v2, "V2_TABLE_BUDGET", 1)
    f = synth_fields(P=512, S=300, F=4, R=2, C=4, n_hosts=5, seed=3)
    spy = _ladder_spy(monkeypatch, ("v1",))
    with pytest.raises(RuntimeError, match="pack_first_fit failed"):
        pack_kernel._kernel_ladder(*cpu_args(f), n_max=32)
    assert spy == ["v1"]


def test_failed_fused_solve_takes_the_unfused_ladder(monkeypatch):
    ref, _ = solve("karpenter_tpu", "diverse", 300, 50, "scan")

    def broken(*a, **kw):
        raise RuntimeError("fused launch failed (test)")

    monkeypatch.setattr(fused, "fused_solve", broken)
    out, prof = solve("karpenter_tpu_torch", "diverse", 300, 50, "fused")
    assert out == ref and prof["pack_route"] == "unfused"
    (shape,) = backend._fused_failed_shapes
    assert shape[3] == min(shape[0], backend.N_MAX_FIRST)
    # the next solve of the shape goes straight to the unfused ladder
    monkeypatch.undo()
    out, prof = solve("karpenter_tpu_torch", "diverse", 300, 50, "fused")
    assert out == ref and prof["pack_route"] == "unfused" and prof["pack_dispatches"] == 1
