"""The persistent solve stream (``karpenter_tpu_torch.solver.stream``) against
the JAX package's, on the CPU.

- envelopes: the same bytes from both packages (hypothesis over message
  types, correlation ids and payloads), each unpacks the other's, and bad
  magic, version skew, a flipped correlation id and truncation are loud in
  both;
- the shared-memory arena in both directions (a port writer with a JAX
  reader and the reverse), with the same verdicts on header corruption, a
  full arena and an out-of-bounds descriptor;
- twins of the reference's stream lifecycle, interop, shm, coalescing and
  stream-path parity tests over the port's ``serve()`` with a
  ``SolverService(device="cpu")``, and the cross-package pairs: the port's
  streaming client against the JAX ``serve()`` and the reverse;
- coalesced groups: the port's ``solve_stream_group`` under
  ``KARPENTER_PACKER=scan`` answers each entry with the bytes the JAX
  service's coalesced group answers, and each equals ``solve_bytes``.

Small sizes (``args16``: 6 diverse pods over 8 types; a 200-pod batch for
the coalesced groups). Every wait is bounded and every server and client
stopped in ``finally``.
"""

import importlib
import struct
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

from karpenter_tpu.solver import service as J
from karpenter_tpu.solver import stream as JS
from karpenter_tpu_torch.resilience.overload import OverloadedError
from karpenter_tpu_torch.solver import service as T
from karpenter_tpu_torch.solver import stream as TS
from torch_parity import encode_scenario, fresh_router, mods, packer, scenario  # noqa: F401

STREAMS = (JS, TS)
N = T.N_POD_ARRAYS


def free_address() -> str:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def wait_until(predicate, timeout=8.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def encoded_args(name="diverse", n_pods=6, n_types=8, seed=3):
    prov, cat, pods = scenario("karpenter_tpu", name, n_pods, seed=seed, n_types=n_types)
    batch = encode_scenario("karpenter_tpu", prov, cat, pods)
    return [np.asarray(a) for a in batch.pack_args()]


def assert_results_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def status_of(response: bytes) -> int:
    return int(T.unpack_arrays(response)[0].reshape(-1)[0])


@pytest.fixture
def scan():
    with packer("scan"):
        yield


@pytest.fixture
def args16():
    return encoded_args()


# -- envelopes ---------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(
    msg_type=hst.integers(0, 2**16 - 1),
    corr=hst.integers(0, 2**64 - 1),
    payload=hst.binary(max_size=96),
)
def test_envelope_bytes_equal_and_cross_unpack(msg_type, corr, payload):
    msg = TS.pack_stream_msg(msg_type, corr, payload)
    assert msg == JS.pack_stream_msg(msg_type, corr, payload)
    assert len(msg) == TS.ENVELOPE_BYTES + len(payload)
    for side in STREAMS:
        assert side.unpack_stream_msg(msg) == (msg_type, corr, payload)


def test_stream_constants_match():
    names = [n for n in dir(JS) if n.isupper() and not n.startswith("_")]
    assert names and all(getattr(JS, n) == getattr(TS, n) for n in names)
    assert T.STREAM_METHOD == J.STREAM_METHOD
    assert TS._BLOCK_HEADER.format == JS._BLOCK_HEADER.format
    assert {k: str(v) for k, v in TS._SHM_DTYPES.items()} == {
        k: str(v) for k, v in JS._SHM_DTYPES.items()}


def _mangle(kind: str, arg: int = 0) -> bytes:
    msg = bytearray(TS.pack_stream_msg(TS.MSG_RESULT, 7, b"payload"))
    if kind == "magic":
        msg[0] ^= 0xFF
    elif kind == "version":
        struct.pack_into("<H", msg, 4, arg)
    elif kind == "corr":
        msg[8 + arg] ^= 0x01
    elif kind == "truncate":
        msg = msg[:arg]
    return bytes(msg)


@pytest.mark.parametrize("kind,arg,match", [
    ("magic", 0, "magic"),
    ("version", 0, "stream version 0"),
    ("version", 2, "stream version 2"),
    ("version", 255, "stream version 255"),
    ("corr", 0, None),
    ("corr", 7, None),
    ("truncate", 10, "truncated"),
])
def test_envelope_refusals_loud_in_both(kind, arg, match):
    bad = _mangle(kind, arg)
    for side in STREAMS:
        if kind == "corr":
            with pytest.raises(side.EnvelopeCorrupt):
                side.unpack_stream_msg(bad)
        else:
            with pytest.raises(ValueError, match=match):
                side.unpack_stream_msg(bad)


# -- the arena ---------------------------------------------------------------


def _arena_arrays():
    rng = np.random.default_rng(5)
    return [
        np.array([True, False, True, True]),
        rng.integers(0, 100, (4, 3)).astype(np.int32),
        rng.random((2, 5)).astype(np.float32),
        np.array(3, np.int32),  # a scalar
    ]


@pytest.mark.parametrize("writer,reader", [(TS, JS), (JS, TS), (TS, TS)],
                         ids=["port->jax", "jax->port", "port->port"])
def test_arena_files_cross_packages(tmp_path, writer, reader):
    arena = writer.ShmArena(str(tmp_path), size=1 << 20, name="cross.shm")
    view = reader.ShmArenaReader(arena.path)
    try:
        arrays = _arena_arrays()
        for round_ in range(3):
            token, desc = arena.write(arrays)
            out = view.read(desc)
            assert len(out) == len(arrays)
            for a, b in zip(arrays, out):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            if round_:
                arena.free(token)
        assert arena.live_blocks() == 1
    finally:
        view.close()
        arena.close()


def test_arena_descriptors_and_bytes_identical(tmp_path):
    """The same writes give the same descriptors and the same file bytes in
    both packages (the header and the alignment are the reference's)."""
    arenas = [side.ShmArena(str(tmp_path / side.__name__.split(".")[0]), size=1 << 16,
                            name="a.shm") for side in STREAMS]
    try:
        for arrays in (_arena_arrays(), _arena_arrays()[:2], [np.zeros(7, np.float32)]):
            descs = [a.write(arrays) for a in arenas]
            assert descs[0][0] == descs[1][0]
            np.testing.assert_array_equal(descs[0][1], descs[1][1])
        assert bytes(arenas[0]._map) == bytes(arenas[1]._map)
    finally:
        for a in arenas:
            a.close()


def _verdict(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "ok"


@pytest.mark.parametrize("writer", STREAMS, ids=["jax-writer", "port-writer"])
def test_arena_refusals_identical(tmp_path, writer):
    arena = writer.ShmArena(str(tmp_path), size=1 << 16, name="r.shm")
    views = [side.ShmArenaReader(arena.path) for side in STREAMS]
    try:
        token, desc = arena.write(_arena_arrays())
        bad_token = desc.copy()
        bad_token[0] += 1
        out_of_bounds = np.asarray([1, 1 << 20, 0, 1, 2, 1, 4], np.int32)
        truncated = desc[:5]
        for d in (bad_token, out_of_bounds, truncated, desc.astype(np.int64)):
            verdicts = [_verdict(lambda v=v: v.read(d)) for v in views]
            assert verdicts[0] == verdicts[1] != "ok"
        # the in-arena header clobbered: both readers' CRC refuses it
        base = int(desc[1]) | (int(desc[2]) << 31)
        arena._map[base + 4:base + 8] = b"\xff\xff\xff\xff"
        verdicts = [_verdict(lambda v=v: v.read(desc)) for v in views]
        assert verdicts[0] == verdicts[1] != "ok"
    finally:
        for v in views:
            v.close()
        arena.close()


@pytest.mark.parametrize("side", STREAMS, ids=["jax", "port"])
def test_full_arena_returns_none(tmp_path, side):
    arena = side.ShmArena(str(tmp_path), size=4096)
    try:
        assert arena.write([np.zeros(8192, np.float32)]) is None  # past the arena
        small = [np.zeros(256, np.float32)]
        tokens = []
        while True:
            wrote = arena.write(small)
            if wrote is None:
                break
            tokens.append(wrote[0])
        assert len(tokens) == 3
        arena.free(tokens[0])  # room again, through the wraparound
        assert arena.write(small) is not None
    finally:
        arena.close()


# -- live streams --------------------------------------------------------------


class Harness:
    """One live sidecar of ``side``'s package and the clients of a test."""

    def __init__(self, side=T, service=None, shm_dir="", coalesce_window_s=None, checksum=True):
        self.side = side
        self.address = free_address()
        if service is None and side is T:
            service = T.SolverService(device="cpu")
        self.server = side.serve(self.address, service=service, shm_dir=shm_dir,
                                 coalesce_window_s=coalesce_window_s)
        self.checksum = checksum
        self.clients = []

    def client(self, side=None, stream=True, shm_dir="", checksum=None):
        side = side or T
        c = side.RemoteSolver(
            self.address, timeout=10.0, cold_timeout=60.0,
            checksum=self.checksum if checksum is None else checksum,
            stream=stream, shm_dir=shm_dir,
        )
        self.clients.append(c)
        return c

    def restart(self, service=None, **kw):
        self.server.stop(grace=0)
        if service is None and self.side is T:
            service = T.SolverService(device="cpu")
        self.server = self.side.serve(self.address, service=service, **kw)

    def stop(self):
        for c in self.clients:
            try:
                c.close()
            except Exception:
                pass
        self.server.stop(grace=0)


def stream_up(rs) -> bool:
    return wait_until(lambda: rs._stream is not None and rs._stream.up)


def test_streamed_solve_matches_unary(scan, args16):
    h = Harness()
    try:
        ref = h.client(stream=False).pack(*args16, n_max=16)
        rs = h.client()
        rs.pack(*args16, n_max=16)  # opens the session, establishes the stream
        assert stream_up(rs)
        prof = {}
        assert_results_equal(rs.pack_begin(*args16, n_max=16, prof=prof)(), ref)
        assert prof["solver_transport"] == "stream"
        assert h.server.solver_service.stream_stats["stream_solves"] >= 1
    finally:
        h.stop()


def test_out_of_order_completion_under_latency(scan, args16):
    """A slow solve sent first does not hold back a fast one sent after it."""
    sleeps = {24: 1.0, 16: 0.0}

    class Laggy(T.SolverService):
        def solve_stream_group(self, entries):
            time.sleep(sleeps.get(entries[0].n_max, 0.0))
            super().solve_stream_group(entries)

    h = Harness(service=Laggy(device="cpu"))
    try:
        rs = h.client()
        ref16 = h.client(stream=False).pack(*args16, n_max=16)
        ref24 = h.client(stream=False).pack(*args16, n_max=24)
        rs.pack(*args16, n_max=16)
        assert stream_up(rs)
        prof_a, prof_b = {}, {}
        t0 = time.perf_counter()
        wait_slow = rs.pack_begin(*args16, n_max=24, prof=prof_a)
        wait_fast = rs.pack_begin(*args16, n_max=16, prof=prof_b)
        out_fast = wait_fast()
        fast_done = time.perf_counter() - t0
        out_slow = wait_slow()
        assert prof_a["solver_transport"] == prof_b["solver_transport"] == "stream"
        assert fast_done < 0.9, fast_done
        assert_results_equal(out_fast, ref16)
        assert_results_equal(out_slow, ref24)
    finally:
        h.stop()


def test_midstream_restart_reopens_over_stream(scan, args16):
    """A sidecar restart: the stream re-establishes against the fresh
    service and the NEEDS_CATALOG re-open and retry ride the new stream."""
    h = Harness()
    try:
        rs = h.client()
        ref = h.client(stream=False).pack(*args16, n_max=16)
        rs.pack(*args16, n_max=16)
        assert stream_up(rs)
        uploads = rs.session_uploads
        established = rs._stream.established_count
        h.restart()
        assert wait_until(
            lambda: rs._stream.established_count > established and rs._stream.up,
            timeout=20.0,
        )
        assert_results_equal(rs.pack(*args16, n_max=16), ref)
        assert rs.session_uploads > uploads
        box = h.server.stream_server_box[0]
        assert box is not None and box.snapshot()["stream_opens"] >= 1
    finally:
        h.stop()


class Gated(T.SolverService):
    """A cpu sidecar whose streamed groups wait on ``gate``."""

    def __init__(self, gate, **kw):
        super().__init__(device="cpu", **kw)
        self.gate = gate

    def solve_stream_group(self, entries):
        self.gate.wait(timeout=20.0)
        super().solve_stream_group(entries)


def test_credit_exhaustion_typed_and_readmits(scan, args16):
    gate = threading.Event()
    h = Harness(service=Gated(gate, max_inflight=1, queue_depth=0, overload_retry_after=0.05))
    try:
        rs = h.client()
        gate.set()
        rs.pack(*args16, n_max=16)  # window of 1
        assert stream_up(rs)
        gate.clear()
        blocked = rs.pack_begin(*args16, n_max=16)  # holds the one credit
        with pytest.raises(OverloadedError) as ei:
            rs.pack_begin(*args16, n_max=16)
        assert ei.value.kind == "credits"
        assert ei.value.retry_after == pytest.approx(0.05)
        assert rs._stream.credit_stalls >= 1
        gate.set()
        blocked()
        assert wait_until(lambda: rs._stream.credits_available() >= 1)
        rs.pack(*args16, n_max=16)
    finally:
        gate.set()
        h.stop()


def test_credit_exhaustion_soft_backoff_in_pool(scan, args16):
    """A pool takes a credit stall as it takes an admission refusal: soft
    backoff, no breaker moved, the member re-admitted after the hint."""
    from karpenter_tpu_torch.solver.pool import SolverPool

    gate = threading.Event()
    h = Harness(service=Gated(gate, max_inflight=1, queue_depth=0, overload_retry_after=0.05))
    pool = SolverPool([h.address], timeout=10.0, client_factory=lambda addr: h.client())
    try:
        gate.set()
        pool.pack(*args16, n_max=16)
        member = h.clients[-1]
        assert stream_up(member)
        gate.clear()
        blocked = pool.pack_begin(*args16, n_max=16)
        with pytest.raises(OverloadedError):
            pool.pack_begin(*args16, n_max=16)
        assert pool._breaker(h.address).available()
        assert pool.failovers == 0 and pool.overload_skips >= 1
        gate.set()
        blocked()
        assert wait_until(lambda: member._stream.credits_available() >= 1)
        time.sleep(0.06)
        pool.pack(*args16, n_max=16)
    finally:
        gate.set()
        pool.close()
        h.stop()


def test_corrupt_streamed_response_quarantines(scan, args16):
    from karpenter_tpu_torch.resilience.integrity import IntegrityError
    from karpenter_tpu_torch.solver.pool import PoolExhausted, SolverPool

    corrupt = {"on": False}

    class Corrupting(T.SolverService):
        def solve_stream_group(self, entries):
            if corrupt["on"]:
                for e in entries:
                    orig = e.respond

                    def bad(b, _o=orig):
                        flipped = bytearray(b)
                        flipped[len(flipped) // 2] ^= 0x10
                        _o(bytes(flipped))

                    e.respond = bad
            super().solve_stream_group(entries)

    h = Harness(service=Corrupting(device="cpu"))
    pool = SolverPool([h.address], timeout=10.0, client_factory=lambda addr: h.client())
    try:
        pool.pack(*args16, n_max=16)
        assert stream_up(h.clients[-1])
        corrupt["on"] = True
        with pytest.raises((PoolExhausted, IntegrityError)):
            pool.pack(*args16, n_max=16)
        assert not pool._breaker(h.address).available()
    finally:
        pool.close()
        h.stop()


def test_corrupt_streamed_request_answers_integrity(scan, args16):
    h = Harness()
    try:
        rs = h.client()
        rs.pack(*args16, n_max=16)
        assert stream_up(rs)
        key = T.catalog_session_key(*args16[N:])
        frame = bytearray(T.append_checksum(T.pack_arrays(
            [T._key_array(key), np.asarray([16, 1], np.int32)] + list(args16[:N]))))
        frame[len(frame) // 2] ^= 0x04
        response = rs._stream.solve(bytes(frame)).result(timeout=10.0)
        assert status_of(response) == T.STATUS_INTEGRITY
        assert h.server.solver_service.checksum_failures == {"stream_pack": 1}
    finally:
        h.stop()


def test_new_client_old_server_stays_unary(scan, args16):
    h = Harness(service=T.SolverService(
        device="cpu", features=T.PROTO_FEATURES & ~T.PROTO_STREAM))
    try:
        ref = h.client(stream=False).pack(*args16, n_max=16)
        rs = h.client()
        assert_results_equal(rs.pack(*args16, n_max=16), ref)
        assert_results_equal(rs.pack(*args16, n_max=16), ref)
        assert rs._stream is None  # never even built
    finally:
        h.stop()


def test_old_client_new_server_unary_untouched(scan, args16):
    h = Harness()
    try:
        assert h.client(stream=False).pack(*args16, n_max=16) is not None
        assert h.server.stream_server_box[0] is None
    finally:
        h.stop()


def test_shm_solves_and_frees(scan, args16, tmp_path):
    h = Harness(shm_dir=str(tmp_path))
    try:
        ref = h.client(stream=False).pack(*args16, n_max=16)
        rs = h.client(shm_dir=str(tmp_path))
        rs.pack(*args16, n_max=16)
        assert wait_until(lambda: rs._stream is not None and rs._stream.shm_active)
        prof = {}
        assert_results_equal(rs.pack_begin(*args16, n_max=16, prof=prof)(), ref)
        assert prof["solver_transport"] == "stream_shm"
        assert rs._stream._arena.live_blocks() == 0
        assert h.server.stream_server_box[0].snapshot()["shm_solves"] >= 1
    finally:
        h.stop()


def test_server_without_shm_declines_arena(scan, args16, tmp_path):
    h = Harness()
    try:
        rs = h.client(shm_dir=str(tmp_path))
        rs.pack(*args16, n_max=16)
        assert stream_up(rs)
        prof = {}
        rs.pack_begin(*args16, n_max=16, prof=prof)()
        assert prof["solver_transport"] == "stream"
        assert not rs._stream.shm_active
    finally:
        h.stop()


# -- across the packages -------------------------------------------------------


PAIRS = [("port->jax", T, J), ("jax->port", J, T)]


@pytest.mark.parametrize("shm", [False, True], ids=["inline", "shm"])
@pytest.mark.parametrize("name,cli,srv", PAIRS, ids=[p[0] for p in PAIRS])
def test_cross_package_stream_equals_unary(scan, tmp_path, name, cli, srv, shm):
    """Either package's streaming client against the other's ``serve()``:
    the stream opens (and the arena, when both share the directory) and
    every streamed result equals the unary one."""
    shm_dir = str(tmp_path) if shm else ""
    h = Harness(side=srv, shm_dir=shm_dir)
    try:
        for args in (encoded_args(), encoded_args("teams", 200, 50)):
            n_max = max(16, len(args[0]) // 4)
            ref = h.client(side=cli, stream=False).pack(*args, n_max=n_max)
            rs = h.client(side=cli, shm_dir=shm_dir)
            rs.pack(*args, n_max=n_max)
            assert stream_up(rs)
            if shm:
                assert wait_until(lambda: rs._stream.shm_active)
            transports = []
            for _ in range(2):
                prof = {}
                assert_results_equal(rs.pack_begin(*args, n_max=n_max, prof=prof)(), ref)
                transports.append(prof["solver_transport"])
            assert transports == ["stream_shm" if shm else "stream"] * 2
        snap = h.server.stream_server_box[0].snapshot()
        assert snap["stream_solves"] >= 6 and snap["envelope_rejects"] == 0
        assert (snap["shm_solves"] >= 4) == shm
    finally:
        h.stop()


# -- coalescing ----------------------------------------------------------------


def _distinct_pods(args, n: int, seed: int = 11):
    """``n`` pod-side variants of ``args``: each clears ``pod_valid`` for a
    different seeded 5% of its rows, so a demultiplexing error shows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pods = [a.copy() for a in args[:N]]
        rows = rng.choice(len(pods[0]), max(1, len(pods[0]) // 20), replace=False)
        pods[0][rows] = False
        out.append(pods)
    return out


def _frame(side, key, pods, n_max, mode):
    flags = side.PACK_FLAG_ECHO_SESSION if mode in ("echo", "checksum") else 0
    vals = [n_max, 1] + ([flags] if flags else [])
    trailers = []
    if mode == "traced":
        trailers = [side._trace_ctx_array(side.TraceContext("12" * 16, "34" * 8))]
    frame = side.pack_arrays([side._key_array(key), np.asarray(vals, np.int32)]
                             + pods + trailers)
    return side.append_checksum(frame) if mode == "checksum" else frame


def _open_pair(args):
    """A JAX and a port cpu service holding ``args``' session."""
    key = T.catalog_session_key(*args[N:])
    services = (J.SolverService(), T.SolverService(device="cpu"))
    for svc in services:
        assert status_of(svc.open_session_bytes(
            T.pack_arrays([T._key_array(key)] + list(args[N:])))) == T.STATUS_OK
    return services, key


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("mode", ["plain", "checksum", "traced"])
def test_coalesced_group_bytes_equal_jax_and_unary(scan, n, mode):
    args = encoded_args(n_pods=200, n_types=50, seed=42)
    n_max = 64
    services, key = _open_pair(args)
    frames = [_frame(T, key, pods, n_max, mode) for pods in _distinct_pods(args, n)]
    answers = []
    for svc in services:
        responses = {}
        entries = [svc.stream_parse_solve(f, respond=lambda b, i=i: responses.__setitem__(i, b))
                   for i, f in enumerate(frames)]
        before = dict(svc.stream_stats)
        svc.solve_stream_group(entries)
        assert svc.stream_stats["coalesced_dispatches"] == before["coalesced_dispatches"] + 1
        assert svc.stream_stats["coalesced_solves"] == before["coalesced_solves"] + n
        answers.append([responses[i] for i in range(n)])
        unary = [svc.solve_bytes(f) for f in frames]
        for got, want in zip(answers[-1], unary):
            if mode == "traced":  # the stage seconds differ; the rest may not
                got, want = got[:-12], want[:-12]
            assert got == want
    if mode == "traced":
        answers = [[r[:-12] for r in side] for side in answers]
    assert answers[0] == answers[1]
    # the entries differ, so equal answers mean the demultiplexing held
    assert len({r for r in answers[1]}) > 1
    # one plain-version pass per group on the port, counted once
    assert services[1].served == {"pack_reference": 1 + n}


def test_group_refusals_identical(scan):
    """Inside a group, an expired entry sheds DEADLINE_EXCEEDED and an
    unknown session answers NEEDS_CATALOG, the same bytes from both."""
    args = encoded_args(n_pods=40, n_types=8)
    services, key = _open_pair(args)
    expired = T.pack_arrays([T._key_array(key), np.asarray([16, 1], np.int32)]
                            + list(args[:N]) + [np.asarray([0.0], np.float32)])
    unknown = T.pack_arrays([T._key_array(bytes(16)), np.asarray([16, 1], np.int32)]
                            + list(args[:N]))
    out = []
    for svc in services:
        got = []
        entry = svc.stream_parse_solve(expired, respond=got.append)
        shed = svc.shed_if_expired(entry)
        assert shed is not None
        svc.solve_stream_group([entry])  # the group re-check sheds it too
        entries = [svc.stream_parse_solve(unknown, respond=got.append) for _ in range(2)]
        svc.solve_stream_group(entries)
        out.append([shed] + got)
        assert svc.dispatches == 0 and svc.shed["deadline"] == 2
    assert out[0] == out[1]
    assert [status_of(r) for r in out[1]] == [
        T.STATUS_DEADLINE_EXCEEDED, T.STATUS_DEADLINE_EXCEEDED,
        T.STATUS_NEEDS_CATALOG, T.STATUS_NEEDS_CATALOG]


@pytest.mark.parametrize("payload", ["short", "corrupt", "shm-bad"])
def test_parse_refusals_identical(tmp_path, payload):
    args = encoded_args()
    key = T.catalog_session_key(*args[N:])
    head = [T._key_array(key), np.asarray([16, 1], np.int32)]
    arena = TS.ShmArena(str(tmp_path), size=1 << 16, name="p.shm")
    readers = (JS.ShmArenaReader(arena.path), TS.ShmArenaReader(arena.path))
    try:
        if payload == "short":
            frame, arena_of = T.pack_arrays(head), (None, None)
        elif payload == "corrupt":
            frame = bytearray(T.append_checksum(T.pack_arrays(head + list(args[:N]))))
            frame[len(frame) // 2] ^= 0x02
            frame, arena_of = bytes(frame), (None, None)
        else:
            frame = T.pack_arrays(head + [np.asarray([9, 0, 0, 7], np.int32)])
            arena_of = readers
        out = [svc.stream_parse_solve(frame, respond=None, arena=a)
               for svc, a in zip((J.SolverService(), T.SolverService(device="cpu")), arena_of)]
        assert isinstance(out[0], bytes) and out[0] == out[1]
        assert status_of(out[1]) == T.STATUS_INTEGRITY
    finally:
        for r in readers:
            r.close()
        arena.close()


def test_concurrent_same_shape_solves_coalesce(scan, args16):
    h = Harness(coalesce_window_s=0.25)
    try:
        ref = h.client(stream=False).pack(*args16, n_max=16)
        clients = [h.client() for _ in range(2)]
        for c in clients:
            c.pack(*args16, n_max=16)
            assert stream_up(c)
        svc = h.server.solver_service
        before = dict(svc.stream_stats)
        for _ in range(10):
            waits, errs = [], []

            def fire(c):
                try:
                    waits.append(c.pack_begin(*args16, n_max=16))
                except Exception as e:  # pragma: no cover - diagnostic
                    errs.append(e)

            threads = [threading.Thread(target=fire, args=(clients[i % 2],)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=20.0)
            assert not errs and len(waits) == 4
            for w in waits:
                assert_results_equal(w(), ref)
            if svc.stream_stats["coalesced_dispatches"] > before["coalesced_dispatches"]:
                break
        after = svc.stream_stats
        assert after["coalesced_dispatches"] > before["coalesced_dispatches"]
        assert after["coalesced_solves"] - before["coalesced_solves"] >= 2
    finally:
        h.stop()


def test_native_rig_groups_without_coalescing(args16):
    """Off the card under ``native`` there is nothing to amortize: the group
    keeps one admission slot and packs entry by entry."""
    from karpenter_tpu_torch.solver import native

    assert native.native_available(wait=180)
    services, key = _open_pair(args16)
    svc = services[1]
    frame = T.pack_arrays([T._key_array(key), np.asarray([16, 1], np.int32)] + list(args16[:N]))
    got = []
    with packer("native"):
        svc.solve_stream_group([svc.stream_parse_solve(frame, respond=got.append)
                                for _ in range(3)])
        unary = svc.solve_bytes(frame)
    assert got == [unary] * 3
    assert svc.stream_stats["coalesced_dispatches"] == 0
    assert svc.stream_stats["stream_solves"] == 3 and svc.dispatches == 2
    assert svc.served == {"native": 4}


def test_ttl_sweep_rides_streamed_solves():
    clock = [0.0]
    service = T.SolverService(device="cpu", session_ttl=5.0, clock=lambda: clock[0])
    args_a = encoded_args(n_types=8, seed=3)
    args_b = encoded_args(n_types=6, seed=9)
    keys = [T.catalog_session_key(*a[N:]) for a in (args_a, args_b)]
    assert keys[0] != keys[1]
    for args, key in zip((args_a, args_b), keys):
        assert status_of(service.open_session_bytes(
            T.pack_arrays([T._key_array(key)] + list(args[N:])))) == T.STATUS_OK
    clock[0] = 10.0  # both past the TTL
    responses = []
    entry = service.stream_parse_solve(
        T.pack_arrays([T._key_array(keys[1]), np.asarray([16, 1], np.int32)]
                      + list(args_b[:N])),
        respond=responses.append,
    )
    service.solve_stream_group([entry])
    assert status_of(responses[0]) == T.STATUS_OK
    assert service.session_count() == 1  # B touched by its solve, A swept


def test_hbm_gate_refuses_streamed_open(args16, monkeypatch):
    monkeypatch.setattr(T, "publish_device_headroom", lambda device=None: 1024)
    h = Harness(service=T.SolverService(device="cpu", hbm_floor_bytes=1 << 30))
    try:
        rs = h.client(checksum=False)
        assert rs._stream_for(T.PROTO_FEATURES) is not None
        key = T.catalog_session_key(*args16[N:])
        frame = T.pack_arrays([T._key_array(key)] + list(args16[N:]))
        response = rs._stream.open(frame).result(timeout=10.0)
        assert status_of(response) == T.STATUS_OVERLOADED
    finally:
        h.stop()


def test_stream_client_close_and_break(scan, args16):
    """``break_stream`` fails nothing in flight silently: the client goes
    down, re-establishes in the background, and ``close`` ends it."""
    h = Harness()
    try:
        rs = h.client()
        rs.pack(*args16, n_max=16)
        assert stream_up(rs)
        stream = rs._stream
        stream.break_stream("test")
        assert stream.breaks == 1
        assert wait_until(lambda: stream.up and stream.established_count == 2, timeout=20.0)
        prof = {}
        rs.pack_begin(*args16, n_max=16, prof=prof)()
        assert prof["solver_transport"] == "stream"
        stream.close()
        assert not stream.up
        with pytest.raises(TS.StreamUnavailable):
            stream.solve(b"")
    finally:
        h.stop()


def test_coalesced_entries_yield_identical_decision_records(scan):
    """A coalesced group of three equal entries: each entry's assignment,
    decision record and per-pod attribution equal the solo solve's, and
    the port's equal the reference's (pods named alike in both)."""
    def run(pkg, side):
        M = mods(pkg)
        prov, catalog, pods = scenario(pkg, "diverse", 5, 3, 8)
        pods.append(M.factories.make_pod(name="stuck-x", requests={"cpu": "100000"}))
        for i, p in enumerate(pods):
            p.metadata.name = f"p{i}"
        batch = encode_scenario(pkg, prov, catalog, pods)
        args = [np.asarray(a) for a in batch.pack_args()]
        p, r = len(batch.pod_valid), batch.pod_req.shape[1]
        kernel = importlib.import_module(f"{pkg}.solver.kernel")
        dec = importlib.import_module(f"{pkg}.obs.decisions")
        expl = importlib.import_module(f"{pkg}.solver.explain")
        svc = side.SolverService(**({"device": "cpu"} if side is T else {}))
        key = side.catalog_session_key(*args[N:])
        assert status_of(svc.open_session_bytes(
            side.pack_arrays([side._key_array(key)] + list(args[N:])))) == side.STATUS_OK
        frame = side.pack_arrays([side._key_array(key), np.asarray([16, 1], np.int32)]
                                 + list(args[:N]))

        def assignment(response):
            arrays = side.unpack_arrays(response)
            assert int(arrays[0].reshape(-1)[0]) == side.STATUS_OK
            out = kernel.split_result(np.asarray(arrays[1]), p, 16, r)
            return np.asarray(out.assignment)[: batch.n_pods].copy()

        def record_of(assigned):
            # a fixed clock and no nodes: what is left is a function of
            # (batch, assignment)
            rec = dec.DecisionLog(clock=lambda: 0.0).record_round(
                "parity", batch.pods[: batch.n_pods], [], trace_id="t",
                context={"batch": batch, "assignment": assigned, "n_max": 16,
                         "route": "device"})
            return {k: rec[k] for k in ("pods_considered", "unschedulable_count",
                                         "unschedulable", "route")}

        solo = assignment(svc.solve_bytes(frame))
        assert (solo < 0).any(), "the scenario needs a stuck pod"
        responses = []
        before = svc.stream_stats["coalesced_dispatches"]
        svc.solve_stream_group([svc.stream_parse_solve(frame, respond=responses.append)
                                for _ in range(3)])
        assert svc.stream_stats["coalesced_dispatches"] == before + 1 and len(responses) == 3
        want = (solo.tolist(), record_of(solo), expl.explain_batch(batch, solo))
        assert want[2], "attribution must cover the stuck pod"
        for response in responses:
            got = assignment(response)
            assert (got.tolist(), record_of(got), expl.explain_batch(batch, got)) == want
        return want

    dec_mods = [importlib.import_module(f"{pkg}.obs.decisions")
                for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]
    for d in dec_mods:
        d.set_enabled(True)
    try:
        assert run("karpenter_tpu_torch", T) == run("karpenter_tpu", J)
    finally:
        for d in dec_mods:
            d.set_enabled(None)
