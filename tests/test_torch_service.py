"""The port's solver sidecar (``karpenter_tpu_torch.solver.service``)
against the JAX package's, byte for byte, on the CPU.

- codec: the same arrays give the same frames from both packages and each
  unpacks the other's (checksum trailer, delta header, trailers, status
  responses, session keys);
- the sidecar: the same request frames to the JAX ``SolverService`` and the
  port's ``SolverService(device="cpu")`` give identical responses for every
  status and delta kind, and version skew raises in both;
- imports: with ``grpc`` hidden, every module of the port imports and a
  byte-level solve runs.

Small sizes (a few hundred pods, 50 types); both sidecars pin
``KARPENTER_PACKER=scan`` (the JAX lax.scan kernel, the port's plain
version), the same recurrence bit for bit.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from karpenter_tpu.solver import service as J
from karpenter_tpu_torch.solver import service as T
from torch_parity import encode_scenario, fresh_router, scenario  # noqa: F401

SIDES = (J, T)
FEATURES = J.PROTO_FEATURES


def rng_arrays(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 7))):
        ndim = int(rng.integers(0, 4))
        shape = tuple(int(x) for x in rng.integers(0, 5, ndim))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out.append(rng.random(shape) < 0.5)
        elif kind == 1:
            out.append(rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32))
        elif kind == 2:
            out.append(rng.standard_normal(shape).astype(np.float32))
        elif kind == 3:
            out.append(rng.integers(-9, 9, shape, dtype=np.int64))  # off-spec: i32
        else:
            out.append(rng.standard_normal(shape))  # off-spec: f32
    return out


def assert_same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# -- codec ------------------------------------------------------------------


def test_wire_constants_match():
    names = [n for n in dir(J) if n.isupper() and not n.startswith("_")]
    shared = [n for n in names if hasattr(T, n)]
    assert set(names) == set(shared)
    for n in shared:
        assert getattr(J, n) == getattr(T, n), n
    assert T.SIDECAR_FEATURES == FEATURES


@pytest.mark.parametrize("seed", range(12))
def test_frames_are_byte_equal_and_cross_unpack(seed):
    arrays = rng_arrays(seed)
    frame = J.pack_arrays(arrays)
    assert T.pack_arrays(arrays) == frame
    assert_same_arrays(T.unpack_arrays(frame), J.unpack_arrays(frame))
    for a in T.unpack_arrays(frame):
        assert a.dtype in (np.bool_, np.int32, np.float32)


@settings(max_examples=40, deadline=None)
@given(
    dtype=st.sampled_from([np.bool_, np.int32, np.float32, np.int64, np.float64]),
    shape=st.lists(st.integers(0, 4), max_size=3),
    seed=st.integers(0, 2**16),
)
def test_codec_hypothesis(dtype, shape, seed):
    a = (np.random.default_rng(seed).standard_normal(tuple(shape)) * 50).astype(dtype)
    frame = T.pack_arrays([a])
    assert frame == J.pack_arrays([a])
    assert_same_arrays(T.unpack_arrays(frame), J.unpack_arrays(frame))


@pytest.mark.parametrize("seed", range(6))
def test_checksum_trailer_byte_equal_and_verdicts(seed):
    frame = T.pack_arrays(rng_arrays(seed) + [np.arange(3, dtype=np.int32)])
    sealed = T.append_checksum(frame)
    assert sealed == J.append_checksum(frame)
    for side in SIDES:
        assert side.verify_checksum(sealed) == "ok"
        assert side.verify_checksum(frame) == "missing"
        verdict, arrays = side.verify_and_unpack(sealed)
        assert verdict == "ok" and not any(side.is_checksum_array(a) for a in arrays)
    rng = np.random.default_rng(seed)
    flipped = bytearray(sealed)
    flipped[int(rng.integers(8, len(frame)))] ^= 0x40
    flipped = bytes(flipped)
    verdicts = []
    for side in SIDES:
        try:
            verdicts.append(side.verify_checksum(flipped))
        except Exception as e:  # a flip in a header may break the framing
            verdicts.append(type(e).__name__)
    assert verdicts[0] == verdicts[1]
    assert T.is_checksum_array(T.unpack_arrays(sealed)[-1])


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_delta_header_and_span_match(kind):
    base, new = bytes(range(16)), bytes(range(16, 32))
    hdr = T.delta_header(kind, 5, base, new)
    assert hdr.tobytes() == J.delta_header(kind, 5, base, new).tobytes()
    body = {0: [np.zeros(4, np.int32)] * 7, 1: [], 2: [np.arange(6, dtype=np.int32)] * 8}[kind]
    arrays = T.unpack_arrays(T.pack_arrays(
        [np.zeros(4, np.int32), np.asarray([64, 1, 2], np.int32), hdr] + body
        + [np.zeros(6, np.int32)]))
    assert T._delta_span(arrays) == J._delta_span(arrays) == 1 + len(body)
    for bad in ([np.zeros(4, np.int32)] * 2, arrays[:2] + [np.zeros(9, np.int32)],
                arrays[:2] + [T.delta_header(7, 0, base, new)]):
        assert T._delta_span(bad) is None and J._delta_span(bad) is None


def test_keys_trailers_and_status_match():
    rng = np.random.default_rng(3)
    cat = (rng.integers(-1, 5, (5, 3)).astype(np.int32),
           rng.random((5, 2, 3)).astype(np.float32), rng.random(3).astype(np.float32))
    pods = rng_arrays(4)
    assert T.catalog_session_key(*cat) == J.catalog_session_key(*cat)
    assert T.pod_epoch_key(pods) == J.pod_epoch_key(pods)
    assert T.CatalogKeyMemo().key(cat) == J.CatalogKeyMemo().key(cat)
    ctx = T.TraceContext("ab" * 16, "cd" * 8)
    assert T._trace_ctx_array(ctx).tobytes() == J._trace_ctx_array(ctx).tobytes()
    trailer = [T._trace_ctx_array(ctx), np.asarray([2.5], np.float32)]
    (tctx, tdl), (jctx, jdl) = T._parse_trailers(trailer), J._parse_trailers(trailer)
    assert (tctx.trace_id, tctx.span_id, tdl) == (jctx.trace_id, jctx.span_id, jdl)
    for status in range(6):
        payload = [np.asarray([0.25], np.float32)] if status == 3 else []
        assert T._status_response(status, payload) == J._status_response(status, payload)


@pytest.mark.parametrize("version", [0, 1, 2, 4, 65535])
def test_version_skew_raises_in_both(version):
    frame = bytearray(T.pack_arrays([np.arange(4, dtype=np.int32)]))
    struct.pack_into("<H", frame, 4, version)
    for side in SIDES:
        with pytest.raises(ValueError, match=f"unsupported version {version}"):
            side.unpack_arrays(bytes(frame))
        with pytest.raises(ValueError, match="unsupported version"):
            side.SolverService(**({"device": "cpu"} if side is T else {})).solve_bytes(bytes(frame))


# -- the sidecar, byte level ---------------------------------------------------


@pytest.fixture
def scan(monkeypatch):
    monkeypatch.setenv("KARPENTER_PACKER", "scan")


def batch_args(name: str = "diverse", n_pods: int = 300):
    prov, cat, pods = scenario("karpenter_tpu", name, n_pods, n_types=50)
    batch = encode_scenario("karpenter_tpu", prov, cat, pods)
    args = [np.asarray(a) for a in batch.pack_args()]
    return args, J.catalog_session_key(*args[7:])


def open_frame(args, key, checksum=False):
    frame = J.pack_arrays([J._key_array(key)] + args[7:])
    return J.append_checksum(frame) if checksum else frame


def pack_frame(args, key, flags=0, trailers=(), checksum=False, n_max=None):
    n_max = n_max or max(256, len(args[0]) // 4)
    vals = [n_max, 1] + ([flags] if flags else [])
    frame = J.pack_arrays([J._key_array(key), np.asarray(vals, np.int32)]
                          + args[:7] + list(trailers))
    return J.append_checksum(frame) if checksum else frame


def pair(**kw):
    return (J.SolverService(features=FEATURES, **kw),
            T.SolverService(device="cpu", **kw))


def both(services, method, frame):
    out = [getattr(s, method)(frame) for s in services]
    assert out[0] == out[1]
    return J.unpack_arrays(out[0])


@pytest.mark.parametrize("mode", ["plain", "echo", "checksum", "team-mix"])
def test_ok_responses_identical(scan, mode):
    args, key = batch_args(*(("teams", 400) if mode == "team-mix" else ()))
    services = pair()
    checksum = mode == "checksum"
    opened = both(services, "open_session_bytes", open_frame(args, key, checksum))
    assert int(opened[0][0]) == 0 and int(opened[1][0]) == FEATURES
    flags = T.PACK_FLAG_ECHO_SESSION if mode in ("echo", "checksum") else 0
    out = both(services, "solve_bytes", pack_frame(args, key, flags, checksum=checksum))
    assert int(out[0][0]) == T.STATUS_OK
    assert services[1].served == {"pack_reference": 1}
    assert services[1].dispatches == 1
    if flags:
        assert out[2].tobytes() == key


def test_traced_response_differs_only_in_stage_seconds(scan):
    args, key = batch_args()
    services = pair()
    both(services, "open_session_bytes", open_frame(args, key))
    ctx = T._trace_ctx_array(T.TraceContext("12" * 16, "34" * 8))
    frame = pack_frame(args, key, T.PACK_FLAG_ECHO_SESSION, trailers=[ctx])
    jr, tr = (s.solve_bytes(frame) for s in services)
    assert len(jr) == len(tr)
    cut = len(tr) - 22 - 12  # the stage trailer's 12 bytes before the echo
    assert jr[:cut] == tr[:cut] and jr[cut + 12:] == tr[cut + 12:]
    stages = T.unpack_arrays(tr)[2]
    assert stages.dtype == np.float32 and stages.shape == (3,) and (stages >= 0).all()


def test_refusals_identical(scan):
    args, key = batch_args()
    services = pair()
    # NEEDS_CATALOG: a key neither sidecar holds
    out = both(services, "solve_bytes", pack_frame(args, bytes(16)))
    assert int(out[0][0]) == T.STATUS_NEEDS_CATALOG
    # INTEGRITY: an open whose tensors do not hash to its key
    bad = J.pack_arrays([J._key_array(bytes(16))] + args[7:])
    assert int(both(services, "open_session_bytes", bad)[0][0]) == T.STATUS_INTEGRITY
    both(services, "open_session_bytes", open_frame(args, key))
    # INTEGRITY: a flipped payload byte in a checksummed Pack
    frame = bytearray(pack_frame(args, key, checksum=True))
    frame[len(frame) // 2] ^= 0x01
    out = both(services, "solve_bytes", bytes(frame))
    assert int(out[0][0]) == T.STATUS_INTEGRITY
    # DEADLINE_EXCEEDED: a 0-second deadline trailer
    out = both(services, "solve_bytes",
               pack_frame(args, key, trailers=[np.asarray([0.0], np.float32)]))
    assert int(out[0][0]) == T.STATUS_DEADLINE_EXCEEDED
    for s in services:
        assert s.shed["deadline"] == 1 and s.dispatches == 0
    assert services[1].checksum_failures == services[0].checksum_failures


def test_overloaded_identical(scan):
    args, key = batch_args()
    services = pair(max_inflight=1, queue_depth=0, overload_retry_after=0.25)
    both(services, "open_session_bytes", open_frame(args, key))
    for s in services:
        assert s.admission.enter() == "admitted"
    try:
        out = both(services, "solve_bytes", pack_frame(args, key))
    finally:
        for s in services:
            s.admission.leave()
    assert int(out[0][0]) == T.STATUS_OVERLOADED and float(out[1][0]) == 0.25
    assert services[1].shed["queue_full"] == 1


def test_hbm_floor_refusal_identical(scan, monkeypatch):
    args, key = batch_args()
    monkeypatch.setattr(J, "publish_device_headroom", lambda: 100)
    monkeypatch.setattr(T, "publish_device_headroom", lambda device=None: 100)
    services = pair(hbm_floor_bytes=1 << 30)
    out = both(services, "open_session_bytes", open_frame(args, key))
    assert int(out[0][0]) == T.STATUS_OVERLOADED
    assert services[1].shed["hbm_pressure"] == 1 and services[1].session_count() == 0
    monkeypatch.undo()  # off the card the real headroom is None: no floor
    assert T.publish_device_headroom("cpu") is None


def delta_frame(args, key, kind, base, new, body, checksum=False):
    hdr = T.delta_header(kind, int(body[0].size) if kind == 2 else 0, base, new)
    frame = J.pack_arrays(
        [J._key_array(key), np.asarray([max(256, len(args[0]) // 4), 1, 2], np.int32), hdr]
        + body)
    return J.append_checksum(frame) if checksum else frame


def test_delta_ladder_identical(scan):
    args, key = batch_args()
    pods = args[:7]
    epoch = T.pod_epoch_key(pods)
    services = pair()
    both(services, "open_session_bytes", open_frame(args, key))
    # NEEDS_DELTA_BASE: an elide against an epoch neither holds
    out = both(services, "solve_bytes", delta_frame(args, key, 1, bytes(16), epoch, []))
    assert int(out[0][0]) == T.STATUS_NEEDS_DELTA_BASE
    full = both(services, "solve_bytes", delta_frame(args, key, 0, bytes(16), epoch, pods))
    assert int(full[0][0]) == T.STATUS_OK
    elided = both(services, "solve_bytes", delta_frame(args, key, 1, epoch, epoch, []))
    assert elided[1].tobytes() == full[1].tobytes()
    # a patch: the first valid pod's request doubled
    new_pods = [a.copy() for a in pods]
    new_pods[6][0] *= 2
    idx = np.asarray([0], np.int32)
    body = [idx] + [a[idx] for a in new_pods]
    new_epoch = T.pod_epoch_key(new_pods)
    patched = both(services, "solve_bytes",
                   delta_frame(args, key, 2, epoch, new_epoch, body, checksum=True))
    assert int(patched[0][0]) == T.STATUS_OK
    plain = both(services, "solve_bytes", pack_frame(args[:6] + [new_pods[6]] + args[7:], key))
    assert patched[1].tobytes() == plain[1].tobytes()
    # a patch that claims the wrong epoch: NEEDS_DELTA_BASE, base kept
    out = both(services, "solve_bytes", delta_frame(args, key, 2, epoch, bytes(16), body))
    assert int(out[0][0]) == T.STATUS_NEEDS_DELTA_BASE
    # an establish whose digest lies: INTEGRITY
    out = both(services, "solve_bytes", delta_frame(args, key, 0, bytes(16), bytes(16), pods))
    assert int(out[0][0]) == T.STATUS_INTEGRITY
    assert services[1].delta_stats == services[0].delta_stats
    assert services[1].pod_store_count() == services[0].pod_store_count() == 2


def test_session_lru_and_ttl_identical(scan):
    a, key_a = batch_args()
    b, key_b = batch_args("teams", 200)
    now = [0.0]
    for session_max in (1, 2):
        services = pair(session_max=session_max, clock=lambda: now[0], session_ttl=10.0)
        now[0] = 0.0
        both(services, "open_session_bytes", open_frame(a, key_a))
        both(services, "open_session_bytes", open_frame(b, key_b))
        if session_max == 2:
            now[0] = 11.0  # both past the TTL: the solve touches b, evicts a
        assert int(both(services, "solve_bytes", pack_frame(b, key_b))[0][0]) == T.STATUS_OK
        out = both(services, "solve_bytes", pack_frame(a, key_a))
        assert int(out[0][0]) == T.STATUS_NEEDS_CATALOG
        assert services[1].session_count() == services[0].session_count() == 1


def test_session_tensors_and_stats(scan):
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.solver import session_stats

    def counted():
        return {name: metrics.REGISTRY.get_sample_value(
                    f"karpenter_solver_session_{name}_total") or 0.0
                for name in ("catalog_uploads", "evictions")}

    args, key = batch_args()
    svc = T.SolverService(device="cpu")
    session_stats.reset()
    before = counted()
    svc.open_session_bytes(open_frame(args, key))
    svc.open_session_bytes(open_frame(args, key))  # idempotent: no re-upload
    import torch

    join, front, daemon = svc.session_tensors(key)
    assert (join.dtype, front.dtype, daemon.dtype) == (torch.int32, torch.float32, torch.float32)
    assert front.shape == args[8].shape and join.device.type == "cpu"
    assert svc.resident_bytes() == sum(a.nbytes for a in args[7:])
    for _ in range(2):
        svc.solve_bytes(pack_frame(args, key))
    assert session_stats.snapshot() == {"hits": 1, "misses": 1, "hit_rate": 0.5}
    after = counted()
    assert {k: after[k] - before[k] for k in after} == {"catalog_uploads": 1.0, "evictions": 0.0}


def test_warmup_sets_ready_and_the_card_rule():
    import torch

    svc = T.SolverService(device="cpu")
    assert svc.health_bytes(b"") == T.NOT_SERVING
    svc.warmup()
    assert svc.ready.is_set() and svc.health_bytes(b"") == T.SERVING
    assert sum(svc.served.values()) == 1
    card = torch.device("cuda")
    assert T.warmed_up("pack_first_fit", card) and T.warmed_up("pack_first_fit_v2", card)
    for name in ("pack_reference", "pack_v2_reference", "native", None):
        assert not T.warmed_up(name, card)
        assert T.warmed_up(name, torch.device("cpu"))


def test_default_service_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SolverService()


def test_main_rejects_unported_flags():
    # the sampling profiler is not ported (the flight and SLO flags are)
    with pytest.raises(SystemExit):
        T.main(["--profile-hz", "19"])


# -- imports without grpc --------------------------------------------------------

NO_GRPC = r"""
import importlib, pkgutil, sys
sys.modules["grpc"] = None
import numpy as np
import karpenter_tpu_torch
for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, "karpenter_tpu_torch."):
    importlib.import_module(m.name)
from karpenter_tpu_torch.solver import service as T
from karpenter_tpu_torch.cloudprovider.fake import instance_types
from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.testing import diverse_pods, make_provisioner
import random
catalog = instance_types(8)
c = make_provisioner(solver="tpu").spec.constraints
c.requirements = c.requirements.merge(catalog_requirements(catalog))
pods = sort_pods_ffd(diverse_pods(40, random.Random(1)))
batch = enc.encode(c, catalog, pods, daemon_overhead(Cluster(), c))
args = [np.asarray(a) for a in batch.pack_args()]
key = T.catalog_session_key(*args[7:])
svc = T.SolverService(device="cpu")
svc.open_session_bytes(T.pack_arrays([T._key_array(key)] + args[7:]))
out = T.unpack_arrays(svc.solve_bytes(T.pack_arrays(
    [T._key_array(key), np.asarray([len(args[0]), 1], np.int32)] + args[:7])))
assert int(out[0][0]) == 0, out[0]
try:
    T.serve("127.0.0.1:0", service=svc)
except ImportError:
    pass
else:
    raise AssertionError("serve ran without grpc")
bad = [m for m in sys.modules
       if m in ("jax", "karpenter_tpu") or m.startswith(("jax.", "karpenter_tpu."))]
assert not bad, bad
print("ok", len(out[1]))
"""


def test_port_imports_and_solves_without_grpc():
    env = dict(os.environ, KARPENTER_PACKER="scan")
    out = subprocess.run([sys.executable, "-c", NO_GRPC], capture_output=True, text=True,
                         timeout=240, env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
