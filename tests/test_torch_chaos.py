"""The sidecar chaos harness (``karpenter_tpu_torch.testing.chaos``) against
the JAX package's: a seeded policy makes the same decisions (failures,
throttles, delays, corruption modes) in the same order, each corrupter
changes the same bytes of the same frame, and ``SidecarChaos`` kills and
restarts a port sidecar on one address.
"""

import numpy as np
import pytest

from karpenter_tpu.solver import service as J
from karpenter_tpu.testing import chaos as JC
from karpenter_tpu_torch.solver import service as T
from karpenter_tpu_torch.testing import chaos as TC
from torch_parity import encode_scenario, fresh_router, packer, scenario  # noqa: F401

N = T.N_POD_ARRAYS


def test_method_sets_and_modes_match():
    assert TC.CHAOS_METHODS == JC.CHAOS_METHODS
    assert TC.CORRUPT_METHODS == JC.CORRUPT_METHODS
    assert TC.CORRUPTION_MODES == JC.CORRUPTION_MODES
    for f in ("error_rate", "latency_p95", "latency_floor", "throttle_fraction",
              "seed", "latency_cap_factor", "corrupt_rate"):
        assert getattr(TC.ChaosPolicy(), f) == getattr(JC.ChaosPolicy(), f), f
    assert TC.ChaosWindow(1.0, 2.0).contains(1.5) and not TC.ChaosWindow(1.0, 2.0).contains(2.0)


class Echo:
    """A delegate whose chaos-surface methods echo their frame."""

    def solve_bytes(self, frame):
        return frame

    def open_session_bytes(self, frame):
        return frame

    def solve_stream_group(self, entries):
        return len(entries)

    def create_fleet(self, *args):
        return "created"

    def session_count(self):  # outside the surface: passes through
        return 7


def outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as e:
        name = type(e).__name__
        return "throttle" if "Throttl" in name else "capacity" if "Capacity" in name else "error"
    return out


def frames():
    rng = np.random.default_rng(3)
    result = rng.integers(0, 1000, 64).astype(np.int32)
    key = T._key_array(bytes(range(16)))
    base = T.pack_arrays([np.array([0], np.int32), result, key])
    delta = T.pack_arrays([key, np.asarray([64, 1, T.PACK_FLAG_DELTA], np.int32),
                           T.delta_header(T.DELTA_ELIDE, 0, bytes(16), bytes(range(16)))])
    return [base, T.append_checksum(base), delta, T.append_checksum(delta), b"KTPU\x03\x00"]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_policy_makes_the_same_decisions(seed):
    kw = dict(error_rate=0.3, latency_p95=0.0004, throttle_fraction=0.4, seed=seed,
              corrupt_rate=0.5,
              blackouts=(), ice_storms=())
    proxies = [JC.chaos_wrap(Echo(), JC.ChaosPolicy(**kw)),
               TC.chaos_wrap(Echo(), TC.ChaosPolicy(**kw))]
    calls = []
    for i in range(60):
        frame = frames()[i % 5]
        method = ("solve_bytes", "open_session_bytes", "solve_stream_group", "create_fleet")[i % 4]
        arg = [frame] if method != "create_fleet" else ["lt", [("lt", "m5", "z1")]]
        calls.append((method, arg))
    seqs = [[outcome(getattr(p, m), *a) for m, a in calls] for p in proxies]
    assert seqs[0] == seqs[1]
    assert {"error", "throttle"} <= set(x for x in seqs[1] if isinstance(x, str))
    for table in ("injected", "delayed", "corrupted", "calls"):
        assert getattr(proxies[0], table) == getattr(proxies[1], table), table
    assert proxies[1].corrupted_total() > 0
    assert proxies[1].session_count() == 7


def test_blackout_and_ice_storm_windows():
    def run(mod):
        policy = mod.ChaosPolicy(blackouts=(mod.ChaosWindow(0.0, 60.0),),
                                 methods=frozenset({"solve_bytes"}))
        proxy = mod.chaos_wrap(Echo(), policy)
        storm = mod.chaos_wrap(Echo(), mod.ChaosPolicy(ice_storms=(mod.ChaosWindow(0.0, 60.0),)))
        return [outcome(proxy.solve_bytes, b"x"), outcome(proxy.open_session_bytes, b"y"),
                outcome(storm.create_fleet, "lt", [("lt", "m5", "z1")]),
                proxy.injected, storm.injected]

    assert run(JC) == run(TC) == ["error", b"y", "capacity", {"solve_bytes": 1},
                                  {"create_fleet": 1}]
    with pytest.raises(TC.ChaosCapacityError) as ei:
        TC.chaos_wrap(Echo(), TC.ChaosPolicy(ice_storms=(TC.ChaosWindow(0.0, 60.0),))
                      ).create_fleet("lt", [("lt", "m5", "z1")])
    assert ei.value.overrides == [("lt", "m5", "z1")]


@pytest.mark.parametrize("mode", JC.CORRUPTION_MODES)
def test_corrupters_change_the_same_bytes(mode):
    for frame in frames():
        for seed in range(12):
            want = JC._corrupt_frame(frame, mode, seed)
            got = TC.corrupt_frame(frame, mode, seed)
            assert got == want, (mode, seed)
    assert TC.corrupt_frame("not a frame", mode, 1) == "not a frame"


def test_structured_corruptions_stay_checksum_valid():
    sealed = frames()[1]
    for mode in ("stale_session", "nan_inject"):
        out = TC.corrupt_frame(sealed, mode, 5)
        assert out != sealed and T.verify_checksum(out) == "ok"
    delta = frames()[3]
    out = TC.corrupt_frame(delta, "stale_delta", 5)
    assert T.verify_checksum(out) == "ok"
    hdr = T.unpack_arrays(out)[2]
    assert hdr[:2].tolist() == [T.DELTA_ELIDE, 0] and hdr.tobytes() != T.unpack_arrays(delta)[2].tobytes()


def test_request_side_corruption_reaches_the_sidecar():
    """A bit flip on a checksummed request is refused STATUS_INTEGRITY by the
    port's sidecar, as the reference's would refuse it."""
    prov, cat, pods = scenario("karpenter_tpu", "diverse", 40, n_types=8)
    args = [np.asarray(a) for a in encode_scenario("karpenter_tpu", prov, cat, pods).pack_args()]
    key = T.catalog_session_key(*args[N:])
    policy = dict(corrupt_rate=1.0, corruption_modes=("bit_flip",), seed=3,
                  methods=frozenset({"solve_bytes"}))
    frame = T.append_checksum(T.pack_arrays(
        [T._key_array(key), np.asarray([16, 1], np.int32)] + args[:N]))
    out = []
    with packer("scan"):
        for mod, svc in ((JC, J.SolverService()), (TC, T.SolverService(device="cpu"))):
            svc.open_session_bytes(T.pack_arrays([T._key_array(key)] + args[N:]))
            proxy = mod.chaos_wrap(svc, mod.ChaosPolicy(**policy))
            out.append([proxy.solve_bytes(frame) for _ in range(6)])
    assert out[0] == out[1]
    assert any(int(T.unpack_arrays(r)[0][0]) == T.STATUS_INTEGRITY
               for r in out[1] if r[:4] == T.MAGIC)


def test_sidecar_chaos_kill_and_restart_on_one_address():
    from karpenter_tpu_torch.solver.service import RemoteSolver

    prov, cat, pods = scenario("karpenter_tpu", "diverse", 40, n_types=8)
    args = [np.asarray(a) for a in encode_scenario("karpenter_tpu", prov, cat, pods).pack_args()]
    fleet = TC.SidecarChaos(n=2, device="cpu",
                            policies={1: TC.ChaosPolicy(methods=frozenset({"solve_bytes"}))})
    try:
        assert len(set(fleet.addresses)) == 2 and fleet.address_spec.count(",") == 1
        address = fleet.addresses[0]
        with packer("scan"):
            rs = RemoteSolver(address, timeout=10)
            ref = rs.pack(*args, n_max=16)
            assert fleet.busiest() == address
            fleet.restart(address)  # killed, then served again on the address
            assert fleet.servers[address].solver_service.session_count() == 0
            out = rs.pack(*args, n_max=16)  # NEEDS_CATALOG, then re-opened
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a, b)
            assert rs.session_uploads == 2
            rs.close()
            other = fleet.addresses[1]
            assert isinstance(fleet.proxies[other], TC.ChaosProxy)
            rs2 = RemoteSolver(other, timeout=10)
            rs2.pack(*args, n_max=16)
            assert fleet.proxies[other].calls_total() == 1
            rs2.close()
            fleet.restart(other)  # no policy now: the proxy goes
            assert other not in fleet.proxies
    finally:
        fleet.stop_all()
    assert fleet.servers == {}
