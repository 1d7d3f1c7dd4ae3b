"""The solve service: the gRPC sidecar that owns the card, and its client.

A controller ships its encoded solve to a sidecar process that owns the
accelerator, selected by ``Scheduler(..., solver_service_address=...)``;
the in-process pack stays the fallback. The wire is the reference
package's v3 protocol, byte for byte, so a controller of either package is
served by a sidecar of either package.

Wire format: **flat little-endian buffers, not protobuf message trees**. A
message is::

    magic "KTPU" | u16 version | u16 array count
    per array: u8 dtype code | u8 ndim | u32 dims... | raw C-order bytes

The methods are served through gRPC's generic handler with identity
(bytes) serializers, so no generated stubs are needed.

**Sessions.** The catalog-side tensors (join table, frontiers, daemon
vector) do not change between solves of one catalog generation:

- ``OpenSession`` uploads them once, keyed by a content fingerprint
  (:func:`catalog_session_key`); the sidecar pins them on its device in a
  bounded LRU with TTL eviction;
- each ``Pack`` carries the 16-byte session key plus only the 7 pod-side
  arrays;
- a key the sidecar does not hold (eviction, or a restarted sidecar)
  answers ``NEEDS_CATALOG``, and the client re-opens and retries once;
- version skew fails loudly: a frame of another version raises
  ``unsupported version`` at the codec, never a silent mis-parse.

Every response leads with an i32 status array, so transport errors stay
apart from in-band protocol state.

**Optional trailers.** A Pack may end with a trace context (i32[6]) and the
round budget's remaining seconds (f32[1]), each sent only after the sidecar
advertised the capability bit in its OpenSession response. The client sends
the context of the span active at dispatch (``obs.tracer().current()``),
and an OpenSession carries it too. A traced Pack's response carries an f32
``[solve_s, fetch_s, serialize_s]`` stage trailer, which the client grafts
under its ``solver.wire`` span; the sidecar records its own
``sidecar.pack`` tree (``sidecar.solve``, ``sidecar.fetch``,
``sidecar.serialize``) parented on the client's ids, served at
``GET /debug/traces`` on its health port beside ``/metrics``. An untraced
frame is byte-identical to one from before the trailer existed.

**Overload control.** A bounded :class:`AdmissionGate` fronts the solves:
``max_inflight`` at once, ``queue_depth`` queued, the rest refused with
``STATUS_OVERLOADED`` and an f32 retry-after hint. A propagated deadline is
re-checked after queueing, so work whose round already expired is shed
with ``STATUS_DEADLINE_EXCEEDED`` before it reaches the device. New
session uploads are refused under a device-memory headroom floor while
solves against resident sessions keep flowing.

**Integrity.** With checksums negotiated (``PROTO_CHECKSUM``), every Pack
exchange carries a blake2b-64 frame checksum both ways, and the response
echoes the catalog session key it was solved against. A digest mismatch on
either side is a typed
:class:`~karpenter_tpu_torch.resilience.integrity.IntegrityError`; a
wrong-session echo is recovered by one forced re-open, then raises.

**Delta frames** (``PROTO_DELTA``): a Pack may frame its pod side as an
establish, elide or patch against a pod base the sidecar keeps resident,
addressed by content digests; a miss answers ``NEEDS_DELTA_BASE`` and the
client re-sends the full pod set.

**On the card.** ``SolverService`` pins each session's catalog tensors on
its device, uploads the 7 pod-side arrays per Pack, packs through
``backend.pack_unfused`` (on CUDA tensors the card's kernel ladder,
``pack_kernel.pack_best``), and makes one device→host copy of the fused
result. ``served`` counts what served each dispatch.

**The persistent stream** (``PROTO_STREAM``, ``stream.py``): a client
built with ``stream=True`` multiplexes its solves and session opens over
one ``SolveStream`` call per sidecar, with credits and an optional shared
memory arena (``shm_dir``) for the pod arrays; a broken or absent stream
falls back to unary calls. The sidecar parses each streamed solve with
``stream_parse_solve`` (the unary verification ladder) and serves groups
of concurrent solves that share a session, pod shapes and ``n_max`` with
``solve_stream_group``: on the card one launch of ``pack_first_fit`` or
``pack_first_fit_v2`` over a leading batch axis, one device→host copy.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import math
import os
import struct
import threading
import time
from collections import OrderedDict
from concurrent import futures
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import metrics, obs
from karpenter_tpu_torch.resilience.integrity import IntegrityError
from karpenter_tpu_torch.resilience.overload import (
    DeadlineExceededError,
    OverloadedError,
)
from karpenter_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("karpenter.solver.service")

MAGIC = b"KTPU"
# v3: stateful sessions; Pack carries a session key and the pod-side
# arrays, responses lead with a status word. Skew fails loudly.
VERSION = 3
METHOD = "/karpenter.solver.v1.Solver/Pack"
OPEN_SESSION_METHOD = "/karpenter.solver.v1.Solver/OpenSession"
STREAM_METHOD = "/karpenter.solver.v1.Solver/SolveStream"
HEALTH_METHOD = "/karpenter.solver.v1.Solver/Health"
SERVING = b"SERVING"
NOT_SERVING = b"NOT_SERVING"

# in-band response status (the first i32 array of every v3 response).
# DEADLINE_EXCEEDED: the propagated round budget expired before device
# dispatch, not retryable. OVERLOADED: the admission queue (or the device
# headroom floor) refused the work; an f32 retry-after hint follows.
# INTEGRITY: the request frame failed its checksum, or a claimed digest
# disagreed with the content. NEEDS_DELTA_BASE: a delta frame named a pod
# base the sidecar does not hold (or could not reproduce); the client
# re-sends the full pod set. A word neither side knows fails loudly.
STATUS_OK = 0
STATUS_NEEDS_CATALOG = 1
STATUS_DEADLINE_EXCEEDED = 2
STATUS_OVERLOADED = 3
STATUS_INTEGRITY = 4
STATUS_NEEDS_DELTA_BASE = 5

# capability bits a sidecar advertises in its OpenSession response; a
# client uses a feature only after seeing its bit
PROTO_TRACE_TRAILER = 1
PROTO_DEADLINE = 2
PROTO_CHECKSUM = 4
PROTO_STREAM = 8
PROTO_DELTA = 16
PROTO_FEATURES = (
    PROTO_TRACE_TRAILER | PROTO_DEADLINE | PROTO_CHECKSUM | PROTO_STREAM
    | PROTO_DELTA
)
# what this package's sidecar advertises by default: every bit
SIDECAR_FEATURES = PROTO_FEATURES

# Pack-request flags (the optional third word of the n_max array): bit 0
# asks the sidecar to echo the session key it solved against; bit 1 marks
# a delta frame (the array after the vals word is the i32[10] header)
PACK_FLAG_ECHO_SESSION = 1
PACK_FLAG_DELTA = 2

# admission defaults: max_inflight concurrent solves, queue_depth queued,
# the rest refused with STATUS_OVERLOADED and the retry-after hint
MAX_INFLIGHT = 4
QUEUE_DEPTH = 16
OVERLOAD_RETRY_AFTER_S = 1.0

# session store bounds: one entry per live catalog generation; the TTL
# reclaims device memory for catalogs no client touched in a while
SESSION_MAX = 8
SESSION_TTL_S = 900.0

# ``pack_args()`` holds 7 pod-side arrays, then the 3 catalog-side ones
# (join_table, frontiers, daemon): the split the sessions are built on
N_POD_ARRAYS = 7


def _resident_nbytes(resident) -> int:
    """Bytes pinned on the device by one session's catalog tensors."""
    return int(sum(int(getattr(a, "nbytes", 0) or 0) for a in resident))


def _session_label(key: bytes) -> str:
    return key.hex()[:12]


def _publish_session_hbm(key: bytes, nbytes: int) -> None:
    from karpenter_tpu_torch import metrics

    metrics.SOLVER_SESSION_HBM.labels(session=_session_label(key)).set(nbytes)


def _drop_session_hbm(key: bytes) -> None:
    from karpenter_tpu_torch import metrics

    try:
        metrics.SOLVER_SESSION_HBM.remove(_session_label(key))
    except KeyError:
        pass  # a label never published


def publish_device_headroom(device=None) -> Optional[int]:
    """Free bytes on ``device`` (``torch.cuda.mem_get_info``), published
    on ``karpenter_solver_hbm_headroom_bytes{device=<CUDA index>}``, or
    None off the card, where the gauge stays unset rather than lying with
    a zero and the headroom floor does not apply. What the
    ``--hbm-floor-bytes`` gate reads."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    from karpenter_tpu_torch import metrics

    try:
        free = int(torch.cuda.mem_get_info(dev)[0])
    except RuntimeError:
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    metrics.SOLVER_HBM_HEADROOM.labels(device=str(index)).set(free)
    return free


# ---------------------------------------------------------------------------
# delta framing
# ---------------------------------------------------------------------------
#
# With PACK_FLAG_DELTA set, the array right after the vals word is an
# i32[10] header, [kind, n_idx, base_epoch (16 bytes), new_epoch (16
# bytes)], shape-distinct from every trailer (the trace context is i32[6],
# the session echo i32[4]). The epoch is a blake2b-16 content digest of the
# 7 pod-side arrays; what follows the header depends on kind:
#
# - ESTABLISH: the 7 full pod arrays; the sidecar verifies that their
#   digest IS new_epoch (else INTEGRITY) and keeps them resident;
# - ELIDE: nothing; the pod side is the resident base named by new_epoch
#   (a miss answers NEEDS_DELTA_BASE);
# - PATCH: one i32[n_idx] row-index array, then the 7 arrays sliced to the
#   changed rows; the sidecar applies them to a copy of the base and
#   recomputes the digest, and a disagreement answers NEEDS_DELTA_BASE.
DELTA_HEADER_WORDS = 10
DELTA_ESTABLISH = 0
DELTA_ELIDE = 1
DELTA_PATCH = 2
# arrays after the header, per kind (patch = idx + 7 row slices)
_DELTA_BODY_ARRAYS = {
    DELTA_ESTABLISH: N_POD_ARRAYS,
    DELTA_ELIDE: 0,
    DELTA_PATCH: N_POD_ARRAYS + 1,
}
# resident pod bases the sidecar keeps (LRU): one per client in the steady
# state, advanced in place by each patch
POD_STORE_MAX = 8

_DTYPES = {0: np.dtype(np.bool_), 1: np.dtype(np.int32), 2: np.dtype(np.float32)}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def pod_epoch_key(pod_arrays) -> bytes:
    """16-byte content digest of the 7 pod-side arrays (dtype and shape
    folded in): the delta protocol's epoch."""
    h = hashlib.blake2b(digest_size=16)
    for a in pod_arrays:
        a = np.asarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def delta_header(kind: int, n_idx: int, base: bytes, new: bytes) -> np.ndarray:
    """Build the i32[10] delta header array."""
    return np.frombuffer(
        struct.pack("<2i", kind, n_idx) + base + new, np.int32
    )


def _delta_span(arrays: Sequence[np.ndarray]) -> Optional[int]:
    """Arrays consumed by a delta frame starting at index 2 (header and
    kind-dependent body), or None when the header is malformed: the caller
    refuses with INTEGRITY instead of mis-slicing trailers."""
    if len(arrays) < 3:
        return None
    h = np.asarray(arrays[2]).reshape(-1)
    if h.dtype != np.int32 or h.size != DELTA_HEADER_WORDS:
        return None
    n_body = _DELTA_BODY_ARRAYS.get(int(h[0]))
    if n_body is None or len(arrays) < 3 + n_body:
        return None
    return 1 + n_body


# ---------------------------------------------------------------------------
# flat buffer codec
# ---------------------------------------------------------------------------


def pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    parts: List[bytes] = [MAGIC, struct.pack("<HH", VERSION, len(arrays))]
    for a in arrays:
        # NOT ascontiguousarray: it promotes 0-d scalars to 1-d
        a = np.asarray(a, order="C")
        code = _DTYPE_CODES.get(a.dtype)
        if code is None:
            # normalize off-spec dtypes (int64 scalars, float64)
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32)
            elif np.issubdtype(a.dtype, np.bool_):
                a = a.astype(np.bool_)
            else:
                a = a.astype(np.int32)
            code = _DTYPE_CODES[a.dtype]
        parts.append(struct.pack("<BB", code, a.ndim))
        parts.append(struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(a.tobytes())
    return b"".join(parts)


def unpack_arrays(data: bytes) -> List[np.ndarray]:
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    version, count = struct.unpack_from("<HH", data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    offset = 8
    out: List[np.ndarray] = []
    for _ in range(count):
        code, ndim = struct.unpack_from("<BB", data, offset)
        offset += 2
        shape = struct.unpack_from(f"<{ndim}I", data, offset)
        offset += 4 * ndim
        dtype = _DTYPES[code]
        n_items = math.prod(shape)  # prod(()) == 1: a scalar
        n_bytes = n_items * dtype.itemsize
        arr = np.frombuffer(data, dtype=dtype, count=n_items, offset=offset).reshape(shape)
        offset += n_bytes
        out.append(arr)
    return out


# ---------------------------------------------------------------------------
# frame checksums
# ---------------------------------------------------------------------------
#
# The integrity trailer is one more array in the ordinary framing: an
# i32[3] whose first word is a magic marker and whose other 8 bytes are a
# blake2b-64 digest of everything between the fixed header and the
# trailer's own header (frame[8:trailer]). Appending it rewrites only the
# count word at offset 6, which the digest excludes: a flip there either
# breaks the parse or drops the trailer, and a frame that negotiated
# checksums but arrives without one is rejected as "missing".

CHECKSUM_MAGIC = 0x4B53554D  # spells KSUM on the wire
CHECKSUM_WORDS = 3  # [magic, digest_lo, digest_hi]
_I32_CODE = _DTYPE_CODES[np.dtype(np.int32)]


def append_checksum(frame: bytes) -> bytes:
    """``frame`` with the integrity trailer appended (count word bumped;
    every other byte of the original frame unchanged)."""
    digest = hashlib.blake2b(frame[8:], digest_size=8).digest()
    count = struct.unpack_from("<H", frame, 6)[0]
    trailer = (
        struct.pack("<BBI", _I32_CODE, 1, CHECKSUM_WORDS)
        + struct.pack("<i", CHECKSUM_MAGIC)
        + digest
    )
    return frame[:6] + struct.pack("<H", count + 1) + frame[8:] + trailer


def _checksum_span(frame: bytes) -> Tuple[Optional[int], Optional[bytes]]:
    """Walk the framing headers: ``(trailer_header_offset, digest)`` when
    the LAST declared array is an integrity trailer, else ``(None,
    None)``. Raises like :func:`unpack_arrays` on malformed framing."""
    if frame[:4] != MAGIC:
        raise ValueError("bad magic")
    version, count = struct.unpack_from("<HH", frame, 4)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    offset = 8
    last = None
    for _ in range(count):
        header = offset
        code, ndim = struct.unpack_from("<BB", frame, offset)
        offset += 2
        shape = struct.unpack_from(f"<{ndim}I", frame, offset)
        offset += 4 * ndim
        dtype = _DTYPES[code]
        n_bytes = math.prod(shape) * dtype.itemsize
        payload = offset
        offset += n_bytes
        if offset > len(frame):
            raise ValueError("truncated frame")
        last = (header, code, shape, payload)
    if last is None:
        return None, None
    header, code, shape, payload = last
    if code == _I32_CODE and shape == (CHECKSUM_WORDS,):
        if struct.unpack_from("<i", frame, payload)[0] == CHECKSUM_MAGIC:
            return header, frame[payload + 4:payload + 12]
    return None, None


def verify_checksum(frame: bytes) -> str:
    """``"ok"`` / ``"missing"`` / ``"mismatch"``. Malformed framing raises;
    whether ``"missing"`` is acceptable is the caller's negotiation state."""
    header, digest = _checksum_span(frame)
    if header is None:
        return "missing"
    computed = hashlib.blake2b(frame[8:header], digest_size=8).digest()
    return "ok" if computed == digest else "mismatch"


# the integrity trailer's size on the wire: the BB header, one u32 dim and
# 12 payload bytes
CHECKSUM_TRAILER_BYTES = 18


def verify_and_unpack(frame: bytes) -> Tuple[str, List[np.ndarray]]:
    """Verify and parse in one walk: ``(verdict, arrays)`` with the
    trailer stripped; the same verdicts as :func:`verify_checksum`, and
    raises like :func:`unpack_arrays` on malformed framing."""
    arrays = unpack_arrays(frame)
    if not arrays or not is_checksum_array(arrays[-1]):
        return "missing", arrays
    digest = np.asarray(arrays[-1])[1:].tobytes()
    computed = hashlib.blake2b(
        frame[8:len(frame) - CHECKSUM_TRAILER_BYTES], digest_size=8
    ).digest()
    return ("ok" if computed == digest else "mismatch"), arrays[:-1]


def is_checksum_array(a: np.ndarray) -> bool:
    """True for the integrity trailer once it has been through the codec:
    how parsers strip it before reading the payload by position."""
    a = np.asarray(a)
    return (
        a.dtype == np.int32
        and a.shape == (CHECKSUM_WORDS,)
        and int(a[0]) == CHECKSUM_MAGIC
    )


# ---------------------------------------------------------------------------
# session keys
# ---------------------------------------------------------------------------


def catalog_session_key(
    join_table: np.ndarray, frontiers: np.ndarray, daemon: np.ndarray
) -> bytes:
    """16-byte content fingerprint of the catalog-side tensors: two clients
    of one sidecar converge on one resident copy, and a new catalog
    generation mints a new key."""
    h = hashlib.blake2b(digest_size=16)
    for a in (join_table, frontiers, daemon):
        a = np.asarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def _key_array(key: bytes) -> np.ndarray:
    return np.frombuffer(key, np.int32)


class CatalogKeyMemo:
    """:func:`catalog_session_key` memoized by the arrays' identity: the
    encode cache reuses the catalog-side arrays across solves, so the
    steady state never re-hashes the join table. Each entry holds the
    arrays, so their ids stay valid for its lifetime."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._memo: "OrderedDict[tuple, tuple]" = OrderedDict()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def key(self, catalog_side: Tuple) -> bytes:
        id_key = tuple(map(id, catalog_side))
        with self._lock:
            hit = self._memo.get(id_key)
            if hit is not None:
                self._memo.move_to_end(id_key)
                return hit[1]
        key = catalog_session_key(*[np.asarray(a) for a in catalog_side])
        with self._lock:
            self._memo[id_key] = (tuple(catalog_side), key)
            while len(self._memo) > self.max_entries:
                self._memo.popitem(last=False)
        return key


def _status_response(status: int, payload: Sequence[np.ndarray] = ()) -> bytes:
    return pack_arrays([np.array([status], np.int32), *payload])


# ---------------------------------------------------------------------------
# trace-context trailer (optional on Pack requests)
# ---------------------------------------------------------------------------

# 16-byte trace id + 8-byte span id as six little-endian i32 words
TRACE_CTX_WORDS = 6


# a trace context as the trailer carries it (hex ids): the tracer's own
# portable span identity, so a sidecar span parents on it directly
TraceContext = obs.SpanContext


def _trace_ctx_array(ctx) -> np.ndarray:
    """A context (``trace_id``, ``span_id`` hex) → the 6-word i32 array."""
    raw = bytes.fromhex(ctx.trace_id) + bytes.fromhex(ctx.span_id)
    return np.frombuffer(raw, np.int32)


def _ctx_from_array(arr: np.ndarray) -> Optional[TraceContext]:
    """Trailer array → TraceContext, or None on anything off-shape: a
    malformed trailer degrades to an untraced solve, never an error."""
    a = np.asarray(arr).reshape(-1)
    if a.dtype != np.int32 or a.size != TRACE_CTX_WORDS:
        return None
    raw = a.tobytes()
    return TraceContext(raw[:16].hex(), raw[16:24].hex())


def _parse_trailers(trailer: Sequence[np.ndarray]):
    """Optional Pack trailers → ``(TraceContext|None, deadline_s|None)``,
    told apart by shape and dtype, not position: the trace context is
    i32[6], the deadline an f32[1] of REMAINING seconds (relative, because
    the two clocks never agree). Anything else is ignored."""
    ctx = None
    deadline_s = None
    for arr in trailer:
        a = np.asarray(arr).reshape(-1)
        if a.dtype == np.int32 and a.size == TRACE_CTX_WORDS:
            ctx = _ctx_from_array(arr)
        elif a.dtype == np.float32 and a.size == 1:
            deadline_s = float(a[0])
    return ctx, deadline_s


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class AdmissionGate:
    """Bounded admission in front of the solves: at most ``max_inflight``
    at once, at most ``queue_depth`` callers parked behind them, everyone
    else refused at once."""

    # a queued caller never parks longer than this even without a
    # propagated deadline; it stays well below the client's warm RPC
    # timeout, so the client sees STATUS_OVERLOADED, not a transport error
    MAX_WAIT_S = 5.0

    def __init__(
        self,
        max_inflight: int = MAX_INFLIGHT,
        queue_depth: int = QUEUE_DEPTH,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_inflight = max(int(max_inflight), 1)
        self.queue_depth = max(int(queue_depth), 0)
        self._clock = clock
        self._cv = threading.Condition()
        self._inflight = 0  # guarded-by: self._cv
        self._waiting = 0  # guarded-by: self._cv
        self.max_depth_seen = 0  # guarded-by: self._cv

    def _publish_locked(self) -> None:
        from karpenter_tpu_torch import metrics

        depth = self._inflight + self._waiting
        self.max_depth_seen = max(self.max_depth_seen, depth)
        metrics.SOLVER_ADMISSION_DEPTH.set(depth)

    def enter(self, deadline: Optional[float] = None) -> str:
        """Claim a solve slot: ``"admitted"`` (the caller MUST pair it with
        :meth:`leave`), ``"overloaded"`` (queue full, or the bounded wait
        ran out) or ``"deadline"`` (the caller's deadline expired while
        queued)."""
        with self._cv:
            if self._inflight < self.max_inflight and self._waiting == 0:
                self._inflight += 1
                self._publish_locked()
                return "admitted"
            if self._waiting >= self.queue_depth:
                return "overloaded"
            self._waiting += 1
            self._publish_locked()
            try:
                end = self._clock() + self.MAX_WAIT_S
                if deadline is not None:
                    end = min(end, deadline)
                while self._inflight >= self.max_inflight:
                    remaining = end - self._clock()
                    if remaining <= 0:
                        if deadline is not None and self._clock() >= deadline:
                            return "deadline"
                        return "overloaded"
                    self._cv.wait(remaining)
                self._inflight += 1
                return "admitted"
            finally:
                self._waiting -= 1
                self._publish_locked()

    def leave(self) -> None:
        with self._cv:
            self._inflight = max(self._inflight - 1, 0)
            self._cv.notify()
            self._publish_locked()

    def depth(self) -> int:
        """Solves admitted or queued right now."""
        with self._cv:
            return self._inflight + self._waiting


# ---------------------------------------------------------------------------
# server (the sidecar)
# ---------------------------------------------------------------------------


def warmed_up(served: str, device: torch.device) -> bool:
    """Whether a warm-up solve ``served`` by that name makes a sidecar on
    ``device`` ready: on the card only a kernel's solve does (a plain
    version or native says the kernels are not working); off the card any
    solve does."""
    from karpenter_tpu_torch.solver.backend import KERNELS

    if device.type != "cuda":
        return True
    return served in {card for card, _ in KERNELS.values()}


class SolverService:
    """The sidecar: one Pack call is one solve on its device.

    Stateful per catalog fingerprint: ``open_session_bytes`` pins a catalog
    generation's tensors on the device, ``solve_bytes`` serves solves
    against them. The session store is an in-memory LRU: a restart empties
    it and clients recover through NEEDS_CATALOG.

    ``device`` is ``cuda`` by default and raises without a card. Readiness
    follows a warm-up solve (on the card, one a kernel served); liveness is
    the process answering at all."""

    def __init__(
        self,
        session_max: int = SESSION_MAX,
        session_ttl: float = SESSION_TTL_S,
        clock: Callable[[], float] = time.monotonic,
        max_inflight: int = MAX_INFLIGHT,
        queue_depth: int = QUEUE_DEPTH,
        overload_retry_after: float = OVERLOAD_RETRY_AFTER_S,
        hbm_floor_bytes: int = 0,
        device="cuda",
        features: int = SIDECAR_FEATURES,
    ):
        self.device = resolve_device(device)
        self.ready = threading.Event()
        self.session_max = session_max
        self.session_ttl = session_ttl
        self._clock = clock
        # the capability word advertised in OpenSession responses (a test
        # lowers it to stand for an older build)
        self.features = int(features)
        self.admission = AdmissionGate(max_inflight, queue_depth, clock=clock)
        self.overload_retry_after = float(overload_retry_after)
        self.hbm_floor_bytes = int(hbm_floor_bytes)
        # solves that reached the device, and what served each of them
        # (pack_unfused's name), and the sheds by reason
        self.dispatches = 0  # guarded-by: self._stats_lock
        self.served: Dict[str, int] = {}  # guarded-by: self._stats_lock
        self.shed: dict = {
            "queue_full": 0, "deadline": 0, "hbm_pressure": 0,
        }  # guarded-by: self._stats_lock
        # request frames rejected for a checksum mismatch, by method
        self.checksum_failures: dict = {}  # guarded-by: self._stats_lock
        # streamed dispatches: groups, the solves they carried, and those
        # of them served by one batched launch
        self.stream_stats: dict = {
            "coalesced_dispatches": 0, "coalesced_solves": 0,
            "stream_dispatches": 0, "stream_solves": 0,
        }  # guarded-by: self._stats_lock
        self._stats_lock = threading.Lock()
        # what served the calling thread's last solve (the warm-up reads it)
        self._served_tl = threading.local()
        # key -> [device tensors (join, frontiers, daemon), last_used, fresh];
        # ``fresh`` marks a just-uploaded session: the upload is the recorded
        # miss, so the first solve against it is not also counted a hit
        self._sessions: "OrderedDict[bytes, list]" = OrderedDict()  # guarded-by: self._sessions_lock
        self._sessions_lock = threading.Lock()
        # resident pod bases: epoch digest -> the 7 pod-side host arrays a
        # delta frame may elide or patch against (uploaded per solve)
        self._pod_store: "OrderedDict[bytes, list]" = OrderedDict()  # guarded-by: self._pod_lock
        self._pod_lock = threading.Lock()
        self.delta_stats: dict = {
            "established": 0, "elided": 0, "patched": 0,
            "base_misses": 0, "epoch_mismatches": 0,
        }  # guarded-by: self._stats_lock

    # -- overload accounting ------------------------------------------------

    def _count_shed(self, reason: str) -> None:
        from karpenter_tpu_torch import metrics

        with self._stats_lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1
        metrics.SOLVER_ADMISSION_SHED.labels(reason=reason).inc()

    def _overloaded_response(self) -> bytes:
        return _status_response(
            STATUS_OVERLOADED,
            [np.asarray([self.overload_retry_after], np.float32)],
        )

    # -- integrity ----------------------------------------------------------

    def _reject_corrupt(self, method: str) -> bytes:
        """The request's bytes are not the bytes the client sent: refuse
        with the typed status. The response is checksummed, since the
        client negotiated integrity."""
        with self._stats_lock:
            self.checksum_failures[method] = (
                self.checksum_failures.get(method, 0) + 1
            )
        logger.error(
            "%s request failed frame checksum; rejecting (STATUS_INTEGRITY)",
            method,
        )
        return append_checksum(_status_response(STATUS_INTEGRITY))

    @staticmethod
    def _seal(response: bytes, checksummed: bool) -> bytes:
        """Checksum the response iff the request carried a valid checksum:
        an unchecksummed exchange stays byte-identical."""
        return append_checksum(response) if checksummed else response

    # -- sessions -----------------------------------------------------------

    def _evict_sessions_locked(self) -> None:
        """LRU + TTL eviction; the caller holds ``_sessions_lock``. Every
        evicted session also releases its HBM gauge label, so a dashboard
        summing ``karpenter_solver_session_hbm_bytes`` tracks what is
        pinned, not what ever was."""
        from karpenter_tpu_torch.solver import session_stats

        now = self._clock()
        evicted = []
        stale = [
            k for k, v in self._sessions.items()
            if now - v[1] > self.session_ttl
        ]
        for k in stale:
            del self._sessions[k]
            evicted.append(k)
        while len(self._sessions) > self.session_max:
            k, _ = self._sessions.popitem(last=False)
            evicted.append(k)
        if evicted:
            session_stats.record_eviction(len(evicted))
            for k in evicted:
                _drop_session_hbm(k)

    def _upload(self, arrays, dtypes) -> tuple:
        """Host arrays → tensors on the sidecar's device, in the kernels'
        dtypes (``carry.PACK_ARG_DTYPES``); each solve gets its own."""
        return tuple(
            torch.tensor(np.asarray(a), dtype=dt, device=self.device)
            for a, (_, dt) in zip(arrays, dtypes)
        )

    def open_session_bytes(self, request: bytes) -> bytes:
        """Pin one catalog generation's tensors on the device under its
        key. Idempotent for a resident key (the store is touched, nothing
        re-uploaded). The optional trailing flags array (``[record]``)
        keeps probe traffic out of the hit-rate stats."""
        from karpenter_tpu_torch.solver import session_stats
        from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

        # a corrupted upload must never pin catalog tensors every later
        # solve under this key would trust: reject before touching the store
        try:
            verdict = verify_checksum(request)
        except ValueError as e:
            if "version" in str(e) or "magic" in str(e):
                raise  # version skew stays a loud protocol error
            return self._reject_corrupt("open_session")
        except Exception:
            # otherwise unparseable framing is corruption: the typed status
            return self._reject_corrupt("open_session")
        if verdict == "mismatch":
            return self._reject_corrupt("open_session")
        checksummed = verdict == "ok"
        key_arr, join_table, frontiers, daemon, *rest = unpack_arrays(request)
        rest = [a for a in rest if not is_checksum_array(a)]
        key = key_arr.tobytes()
        # the claimed key must BE the hash of the uploaded tensors, or every
        # solve under it would run against tensors the key does not describe
        computed = catalog_session_key(join_table, frontiers, daemon)
        if computed != key:
            with self._stats_lock:
                self.checksum_failures["open_session_key"] = (
                    self.checksum_failures.get("open_session_key", 0) + 1
                )
            logger.error(
                "session open claims key %s but tensors hash to %s; "
                "rejecting (STATUS_INTEGRITY)",
                key.hex()[:12], computed.hex()[:12],
            )
            return self._seal(_status_response(STATUS_INTEGRITY), checksummed)
        record = bool(rest[0].reshape(-1)[0]) if rest else True
        ctx = _ctx_from_array(rest[1]) if len(rest) > 1 else None
        with self._sessions_lock:
            hit = self._sessions.get(key)
            if hit is not None:
                hit[1] = self._clock()
                self._sessions.move_to_end(key)
                self._evict_sessions_locked()
        if hit is not None:
            return self._seal(
                _status_response(
                    STATUS_OK, [np.array([self.features], np.int32)]
                ),
                checksummed,
            )
        # the one request that grows device residency: below the headroom
        # floor it is refused with a retry hint, while solves against
        # resident sessions keep flowing
        if self.hbm_floor_bytes:
            headroom = publish_device_headroom(self.device)
            if headroom is not None and headroom < self.hbm_floor_bytes:
                self._count_shed("hbm_pressure")
                logger.warning(
                    "refusing session open %s: device headroom %d under "
                    "floor %d", key.hex()[:12], headroom, self.hbm_floor_bytes,
                )
                return self._seal(self._overloaded_response(), checksummed)
        # the catalog upload is the session protocol's one heavy moment: a
        # traced open records it as the sidecar's own span, linked to the
        # client's trace by the trailer ids
        with obs.tracer().span(
            "sidecar.device_put", parent=ctx,
            attrs={"session": _session_label(key)},
        ) if ctx is not None else contextlib.nullcontext():
            resident = self._upload(
                (join_table, frontiers, daemon), PACK_ARG_DTYPES[N_POD_ARRAYS:]
            )
        # re-check under the lock: two clients racing to open one new key
        # both upload; the first insert wins and the loser's tensors drop
        with self._sessions_lock:
            won = key not in self._sessions
            if won:
                self._sessions[key] = [resident, self._clock(), True]
                # the gauge write stays under the lock: after release, a
                # concurrent open's eviction of this key could drop the
                # label BEFORE this publish and resurrect it for good
                _publish_session_hbm(key, _resident_nbytes(resident))
            else:
                self._sessions[key][1] = self._clock()
            self._sessions.move_to_end(key)
            self._evict_sessions_locked()
        if won:
            session_stats.record_upload()
            if record:
                # the upload IS the residency miss of the solve that asked
                session_stats.record(False)
            publish_device_headroom(self.device)
            logger.info("solver session opened (catalog key %s)", key.hex()[:12])
        # the capability word rides every OpenSession response
        return self._seal(
            _status_response(
                STATUS_OK, [np.array([self.features], np.int32)]
            ),
            checksummed,
        )

    def session_count(self) -> int:
        with self._sessions_lock:
            return len(self._sessions)

    def session_tensors(self, key: bytes) -> Optional[tuple]:
        """The device tensors pinned under ``key``, or None."""
        with self._sessions_lock:
            hit = self._sessions.get(key)
            return None if hit is None else hit[0]

    def resident_bytes(self) -> int:
        """Bytes the session store pins on the device."""
        with self._sessions_lock:
            return sum(_resident_nbytes(v[0]) for v in self._sessions.values())

    # -- resident pod bases ---------------------------------------------------

    def _count_delta(self, what: str) -> None:
        with self._stats_lock:
            self.delta_stats[what] = self.delta_stats.get(what, 0) + 1

    def _count_epoch_mismatch(self) -> None:
        self._count_delta("epoch_mismatches")
        metrics.SOLVER_DELTA_EPOCH_MISMATCHES.labels(side="sidecar").inc()

    def _store_pods(self, epoch: bytes, pods: List[np.ndarray]) -> None:
        with self._pod_lock:
            self._pod_store[epoch] = [pods, self._clock()]
            self._pod_store.move_to_end(epoch)
            while len(self._pod_store) > POD_STORE_MAX:
                self._pod_store.popitem(last=False)
            resident = [entry[0] for entry in self._pod_store.values()]
        # host bytes: summed off the store lock, which guards the dict only
        metrics.SOLVER_DELTA_RESIDENT_BYTES.labels(side="sidecar").set(
            sum(int(np.asarray(a).nbytes) for pods_ in resident for a in pods_)
        )

    def _pods_for(self, epoch: bytes) -> Optional[List[np.ndarray]]:
        with self._pod_lock:
            hit = self._pod_store.get(epoch)
            if hit is None:
                return None
            hit[1] = self._clock()
            self._pod_store.move_to_end(epoch)
            return hit[0]

    def pod_store_count(self) -> int:
        with self._pod_lock:
            return len(self._pod_store)

    def _resolve_delta(
        self, arrays: Sequence[np.ndarray]
    ) -> Tuple[Optional[List[np.ndarray]], Optional[int]]:
        """One delta frame → ``(pod_arrays, None)`` or ``(None,
        refusal_status)``: malformed framing is INTEGRITY; a missing base,
        or a patch whose recomputed digest disagrees with the epoch it
        claims, is NEEDS_DELTA_BASE. The sidecar never trusts the client's
        account of the patched state: it recomputes the digest."""
        span = _delta_span(arrays)
        if span is None:
            return None, STATUS_INTEGRITY
        h = np.asarray(arrays[2]).reshape(-1)
        kind, n_idx = int(h[0]), int(h[1])
        base_epoch = h[2:6].tobytes()
        new_epoch = h[6:10].tobytes()
        body = [np.asarray(a) for a in arrays[3:2 + span]]
        if kind == DELTA_ESTABLISH:
            if pod_epoch_key(body) != new_epoch:
                # the claimed epoch is not the content's digest: never pin
                # a mislabelled base
                self._count_epoch_mismatch()
                return None, STATUS_INTEGRITY
            self._store_pods(new_epoch, body)
            self._count_delta("established")
            return body, None
        if kind == DELTA_ELIDE:
            pods = self._pods_for(new_epoch)
            if pods is None:
                self._count_delta("base_misses")
                return None, STATUS_NEEDS_DELTA_BASE
            self._count_delta("elided")
            return pods, None
        # DELTA_PATCH
        base = self._pods_for(base_epoch)
        if base is None:
            self._count_delta("base_misses")
            return None, STATUS_NEEDS_DELTA_BASE
        idx = body[0].reshape(-1)
        slices = body[1:]
        if idx.dtype != np.int32 or idx.size != n_idx:
            return None, STATUS_INTEGRITY
        n_pods = int(np.asarray(base[0]).shape[0])
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_pods):
            return None, STATUS_INTEGRITY
        pods = []
        for cur, rows in zip(base, slices):
            cur = np.asarray(cur)
            rows = np.asarray(rows)
            if rows.shape != (idx.size,) + cur.shape[1:] or rows.dtype != cur.dtype:
                return None, STATUS_INTEGRITY
            patched = cur.copy()
            patched[idx] = rows
            pods.append(patched)
        if pod_epoch_key(pods) != new_epoch:
            # the patch applied but does not produce the state the client
            # believes in: the base stays resident (it is still what its
            # own epoch says) and the client re-establishes
            self._count_epoch_mismatch()
            return None, STATUS_NEEDS_DELTA_BASE
        self._store_pods(new_epoch, pods)
        self._count_delta("patched")
        return pods, None

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> None:
        """Run a minimal 4-pod solve so readiness means a working device
        path, not just a bound port. On the card this builds both kernels
        at first use, and only a solve a kernel served sets ready."""
        try:
            from karpenter_tpu_torch.cloudprovider.fake import instance_types
            from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
            from karpenter_tpu_torch.kube.client import Cluster
            from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd
            from karpenter_tpu_torch.scheduling.topology import Topology
            from karpenter_tpu_torch.solver import encode as enc
            from karpenter_tpu_torch.testing.factories import make_pod, make_provisioner

            catalog = instance_types(4)
            constraints = make_provisioner(solver="tpu").spec.constraints
            constraints.requirements = constraints.requirements.merge(
                catalog_requirements(catalog)
            )
            pods = sort_pods_ffd([make_pod(requests={"cpu": "0.1"}) for _ in range(4)])
            cluster = Cluster()
            Topology(cluster).inject(constraints, pods)
            batch = enc.encode(
                constraints, catalog, pods, daemon_overhead(cluster, constraints)
            )
            args = [np.asarray(a) for a in batch.pack_args()]
            key = catalog_session_key(*args[N_POD_ARRAYS:])
            self.open_session_bytes(
                pack_arrays([_key_array(key)] + args[N_POD_ARRAYS:])
            )
            self._served_tl.name = None
            response = self.solve_bytes(
                pack_arrays(
                    [_key_array(key), np.asarray([len(batch.pod_valid)], np.int32)]
                    + args[:N_POD_ARRAYS]
                )
            )
            status = int(unpack_arrays(response)[0].reshape(-1)[0])
            if status != STATUS_OK:
                raise RuntimeError(f"warmup solve answered status {status}")
            served = self._served_tl.name
            if not warmed_up(served, self.device):
                raise RuntimeError(f"warmup solve served by {served}, not a kernel")
            logger.info("solver warmup complete (%s)", served)
        except Exception:
            logger.exception("solver warmup failed; staying unready")
            return
        self.ready.set()

    def warmup_loop(self, max_backoff: float = 60.0) -> None:
        """Retry warmup with capped decorrelated-jitter backoff until it
        succeeds, so a transient failure does not leave the sidecar
        unready forever and a fleet does not re-warm in lockstep."""
        from karpenter_tpu_torch.resilience.policy import decorrelated_jitter

        backoffs = decorrelated_jitter(1.0, cap=max_backoff)
        while not self.ready.is_set():
            self.warmup()
            if self.ready.is_set():
                return
            time.sleep(next(backoffs))

    def health_bytes(self, request: bytes) -> bytes:
        return SERVING if self.ready.is_set() else NOT_SERVING

    def solve_bytes(self, request: bytes) -> bytes:
        """One solve: session key + n_max + the 7 pod-side arrays (or a
        delta frame), then the optional trailers. An unknown key answers
        ``NEEDS_CATALOG``. Admission wraps the solve, a propagated deadline
        is re-checked after queueing, and the checksum brackets it all:
        a request whose digest disagrees is refused before any byte of it
        is trusted, and a checksummed request gets a checksummed reply."""
        try:
            verdict = verify_checksum(request)
        except ValueError as e:
            if "version" in str(e) or "magic" in str(e):
                raise  # version skew stays a loud protocol error
            return self._reject_corrupt("pack")
        except Exception:
            # otherwise unparseable framing is corruption: the typed refusal
            return self._reject_corrupt("pack")
        if verdict == "mismatch":
            return self._reject_corrupt("pack")
        checksummed = verdict == "ok"
        arrays = [a for a in unpack_arrays(request) if not is_checksum_array(a)]
        # the trailer offset depends on the framing: a delta body is the
        # header plus a kind-dependent count of arrays, and a patch's idx
        # array could pass for an i32[6] trace context, so the span is
        # computed, never assumed
        vals0 = np.asarray(arrays[1]).reshape(-1) if len(arrays) > 1 else np.zeros(0, np.int32)
        flags0 = int(vals0[2]) if vals0.size > 2 else 0
        if flags0 & PACK_FLAG_DELTA:
            span = _delta_span(arrays)
            if span is None:
                return self._seal(
                    _status_response(STATUS_INTEGRITY), checksummed
                )
            trailer = arrays[2 + span:]
        else:
            trailer = arrays[2 + N_POD_ARRAYS:]
        ctx, deadline_s = _parse_trailers(trailer)
        deadline = (
            None if deadline_s is None
            else self._clock() + max(deadline_s, 0.0)
        )
        adm_t0 = time.perf_counter()
        outcome = self.admission.enter(deadline)
        # queue time precedes the pack span (a backdated child would corrupt
        # self-time attribution), so it rides the span as an attribute
        admission_wait_s = time.perf_counter() - adm_t0
        if outcome == "deadline":
            self._count_shed("deadline")
            return self._seal(_status_response(STATUS_DEADLINE_EXCEEDED), checksummed)
        if outcome == "overloaded":
            self._count_shed("queue_full")
            return self._seal(self._overloaded_response(), checksummed)
        try:
            if deadline is not None and self._clock() >= deadline:
                # the budget died while this request sat in the queue:
                # shed before device dispatch
                self._count_shed("deadline")
                return self._seal(
                    _status_response(STATUS_DEADLINE_EXCEEDED), checksummed
                )
            return self._seal(
                self._solve_admitted(arrays, ctx, admission_wait_s), checksummed
            )
        finally:
            self.admission.leave()

    def _solve_admitted(
        self, arrays: List[np.ndarray], ctx, admission_wait_s: float = 0.0
    ) -> bytes:
        from karpenter_tpu_torch.solver import backend, session_stats
        from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

        key_arr, n_max_arr = arrays[0], arrays[1]
        key = key_arr.tobytes()
        vals = n_max_arr.reshape(-1)
        n_max = int(vals[0])
        # optional second word: 0 keeps this Pack out of the hit-rate stats
        record = bool(vals[1]) if vals.size > 1 else True
        # optional third word: flags (session echo, delta framing)
        flags = int(vals[2]) if vals.size > 2 else 0
        if flags & PACK_FLAG_DELTA:
            pod_arrays, refusal = self._resolve_delta(arrays)
            if refusal is not None:
                return _status_response(refusal)
        else:
            pod_arrays = arrays[2:2 + N_POD_ARRAYS]
        echo = (
            [_key_array(key)] if flags & PACK_FLAG_ECHO_SESSION else []
        )
        record_hit = False
        with self._sessions_lock:
            hit = self._sessions.get(key)
            if hit is not None:
                hit[1] = self._clock()
                self._sessions.move_to_end(key)
                resident = hit[0]
                if record:
                    record_hit = not hit[2]  # a fresh upload was the miss
                    hit[2] = False
            # TTL expiry rides the hot path too (this solve's own session
            # was just touched, so it is never the victim)
            self._evict_sessions_locked()
        if hit is None:
            # the client's re-open records the miss of this logical solve
            return _status_response(STATUS_NEEDS_CATALOG)
        if record_hit:
            session_stats.record(True)
        with self._stats_lock:
            self.dispatches += 1
        # KARPENTER_PACKER is read once per request, as the in-process
        # backend reads it once per solve
        packer = os.environ.get("KARPENTER_PACKER", "auto").lower()
        # a traced solve (the client sent its trace context) records the
        # sidecar's half of the round trip in THIS process's ring (GET
        # /debug/traces on the health port), parented on the client's ids:
        # sidecar.pack over sidecar.solve (the upload and the kernel's
        # launch), sidecar.fetch (the one device-to-host copy) and a
        # sidecar.serialize record; the response grows an f32 [solve_s,
        # fetch_s, serialize_s] trailer the client grafts into its tree
        tr = obs.tracer()
        traced = ctx is not None

        def stage(name: str):
            return tr.span(name) if traced else contextlib.nullcontext()

        with tr.span(
            "sidecar.pack", parent=ctx,
            attrs={
                "session": _session_label(key),
                "admission_wait_s": round(admission_wait_s, 6),
                "pods": int(len(pod_arrays[0])),
            },
        ) if traced else contextlib.nullcontext() as sp:
            t0 = time.perf_counter()
            with stage("sidecar.solve"):
                pod = self._upload(pod_arrays, PACK_ARG_DTYPES[:N_POD_ARRAYS])
                served, result = backend.pack_unfused(
                    *pod, *resident, n_max=n_max, packer=packer
                )
            solve_s = time.perf_counter() - t0
            with self._stats_lock:
                self.served[served] = self.served.get(served, 0) + 1
            self._served_tl.name = served
            t0 = time.perf_counter()
            with stage("sidecar.fetch"):
                buf = self._fetch(result)
            fetch_s = time.perf_counter() - t0
            if not traced:
                return _status_response(STATUS_OK, [buf, *echo])
            # the trailer is written in place after the serialize it
            # measures. Its 12 payload bytes sit right before the
            # (22-byte) session echo when one was asked for, else they end
            # the message
            t0 = time.perf_counter()
            response = _status_response(
                STATUS_OK, [buf, np.zeros(3, np.float32), *echo]
            )
            serialize_s = time.perf_counter() - t0
            sp.add_child_record("sidecar.serialize", serialize_s)
            tail = len(response) - (22 if echo else 0)
            return (
                response[:tail - 12]
                + struct.pack("<3f", solve_s, fetch_s, serialize_s)
                + response[tail:]
            )

    @staticmethod
    def _fetch(result) -> np.ndarray:
        """One device→host copy of ``result`` fused into one i32 buffer, on
        the current stream (native serves host arrays: no copy)."""
        from karpenter_tpu_torch.solver import kernel

        if not isinstance(result.assignment, torch.Tensor):
            result = kernel.PackResult(*(torch.as_tensor(np.asarray(a)) for a in result))
        return kernel.fuse_result(result).cpu().numpy()

    # -- the streamed transport (stream.py) -----------------------------------

    def stream_parse_solve(self, payload: bytes, respond, arena=None):
        """Verify and parse one streamed solve into a
        :class:`~karpenter_tpu_torch.solver.stream.StreamSolve` awaiting
        dispatch, or return the immediate refusal frame. The verification
        ladder is ``solve_bytes``'s (the payload is a unary frame); only
        admission and dispatch move to the coalescer.

        ``arena`` (a ``ShmArenaReader``) marks the shared-memory variant:
        the frame carries one i32 descriptor in place of the 7 pod arrays,
        which are read as views onto the mapped arena."""
        from karpenter_tpu_torch.solver.stream import StreamSolve

        try:
            verdict, arrays = verify_and_unpack(payload)
        except ValueError as e:
            if "version" in str(e) or "magic" in str(e):
                raise  # version skew stays loud: it breaks the stream
            return self._reject_corrupt("stream_pack")
        except Exception:
            return self._reject_corrupt("stream_pack")
        if verdict == "mismatch":
            return self._reject_corrupt("stream_pack")
        checksummed = verdict == "ok"
        # structural guards before any positional indexing: a malformed
        # payload fails this message with the typed refusal, never the
        # reader thread (which would tear down every solve on the stream)
        if len(arrays) < 3 or np.asarray(arrays[1]).reshape(-1).size < 1:
            return self._seal(_status_response(STATUS_INTEGRITY), checksummed)
        key_arr, n_max_arr = arrays[0], arrays[1]
        vals = n_max_arr.reshape(-1)
        flags = int(vals[2]) if vals.size > 2 else 0
        if arena is not None:
            trailer = arrays[3:]
            try:
                pod_arrays = arena.read(arrays[2])
            except ValueError as e:
                logger.error("shm descriptor rejected: %s", e)
                return self._seal(_status_response(STATUS_INTEGRITY), checksummed)
            if len(pod_arrays) != N_POD_ARRAYS:
                return self._seal(_status_response(STATUS_INTEGRITY), checksummed)
        elif flags & PACK_FLAG_DELTA:
            # a delta frame resolves to concrete pod arrays here, at parse
            # time, so the coalescer's group keys and the batched launch
            # never see one; a refusal answers from the reader thread
            pod_arrays, refusal = self._resolve_delta(arrays)
            if refusal is not None:
                return self._seal(_status_response(refusal), checksummed)
            trailer = arrays[2 + _delta_span(arrays):]
        else:
            pod_arrays = arrays[2:2 + N_POD_ARRAYS]
            trailer = arrays[2 + N_POD_ARRAYS:]
            if len(pod_arrays) != N_POD_ARRAYS:
                return self._seal(_status_response(STATUS_INTEGRITY), checksummed)
        ctx, deadline_s = _parse_trailers(trailer)
        return StreamSolve(
            key=key_arr.tobytes(),
            n_max=int(vals[0]),
            record=bool(vals[1]) if vals.size > 1 else True,
            flags=flags,
            pod_arrays=[np.asarray(a) for a in pod_arrays],
            ctx=ctx,
            deadline=None if deadline_s is None else self._clock() + max(deadline_s, 0.0),
            checksummed=checksummed,
            respond=respond,
            shm=arena is not None,
        )

    # the deadline shed is a constant frame (sealed or not), built once
    _SHED_RESPONSES: dict = {}

    def shed_if_expired(self, entry) -> Optional[bytes]:
        """The stream reader's early deadline shed: an expired solve is
        answered ``STATUS_DEADLINE_EXCEEDED`` from the reader thread, with
        no dispatcher hop and no admission slot (``solve_stream_group``
        re-checks for budgets that expire while queued)."""
        if entry.deadline is None or self._clock() < entry.deadline:
            return None
        self._count_shed("deadline")
        cached = self._SHED_RESPONSES.get(entry.checksummed)
        if cached is None:
            cached = self._SHED_RESPONSES[entry.checksummed] = self._seal(
                _status_response(STATUS_DEADLINE_EXCEEDED), entry.checksummed
            )
        return cached

    # a coalesced group is padded to the next bucket by repeating its last
    # entry, so the batched launch sees few distinct batch sizes
    _COALESCE_BUCKETS = (1, 2, 4, 8)

    def solve_stream_group(self, entries) -> None:
        """Serve one group of streamed solves (same session key, pod shapes
        and ``n_max``: the coalescer's group key) under ONE admission slot,
        answering each entry with its own response frame.

        Per entry, as the unary solve does: the deadline is re-checked
        after queueing, an unknown session answers ``NEEDS_CATALOG``
        (unsealed), and hits are counted as solves happen; the TTL sweep
        runs here too, since a steady stream sends no unary traffic.

        More than one live entry on a device route (``KARPENTER_PACKER``
        forcing ``scan`` or ``pallas``, or not ``native`` with the session
        on the card) is one launch over the group padded to its bucket
        (``_launch_group``) and one device→host copy; otherwise each entry
        packs through ``backend.pack_unfused`` as in ``solve_bytes``. A
        traced entry's stage trailer is ``[dispatch_s, fetch_s, 0.0]``,
        shared across the group."""
        from karpenter_tpu_torch.solver import backend, session_stats
        from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

        if self.admission.enter() != "admitted":
            for e in entries:
                self._count_shed("queue_full")
                e.reply(self._seal(self._overloaded_response(), e.checksummed))
            return
        try:
            now = self._clock()
            live = []
            for e in entries:
                if e.deadline is not None and now >= e.deadline:
                    self._count_shed("deadline")
                    e.reply(self._seal(
                        _status_response(STATUS_DEADLINE_EXCEEDED), e.checksummed))
                else:
                    live.append(e)
            if not live:
                return
            key = live[0].key
            hits = 0
            with self._sessions_lock:
                hit = self._sessions.get(key)
                if hit is not None:
                    hit[1] = self._clock()
                    self._sessions.move_to_end(key)
                    resident = hit[0]
                    for e in live:
                        if e.record:
                            if hit[2]:
                                hit[2] = False  # the fresh upload was the miss
                            else:
                                hits += 1
                self._evict_sessions_locked()
            if hit is None:
                for e in live:
                    # unsealed, as on the unary path: NEEDS_CATALOG is the
                    # capability renegotiation channel
                    e.reply(_status_response(STATUS_NEEDS_CATALOG))
                return
            for _ in range(hits):
                session_stats.record(True)
            packer = os.environ.get("KARPENTER_PACKER", "auto").lower()
            device_route = packer in ("scan", "pallas") or (
                packer != "native" and resident[0].device.type == "cuda"
            )
            coalesced = len(live) > 1 and device_route
            with self._stats_lock:
                self.dispatches += 1
                self.stream_stats["stream_dispatches"] += 1
                self.stream_stats["stream_solves"] += len(live)
                if coalesced:
                    self.stream_stats["coalesced_dispatches"] += 1
                    self.stream_stats["coalesced_solves"] += len(live)
            if coalesced:
                # a group is one launch: counted once, with its solves; no
                # per-solve span (each traced entry gets the shared
                # dispatch/fetch trailer, as the reference's group does)
                metrics.SOLVER_STREAM_COALESCED_DISPATCHES.inc()
                metrics.SOLVER_STREAM_COALESCED_SOLVES.inc(len(live))
            n_max = live[0].n_max
            t0 = time.perf_counter()
            if coalesced:
                served, fused = self._launch_group(live, resident, n_max, packer)
                with self._stats_lock:
                    self.served[served] = self.served.get(served, 0) + 1
                dispatch_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                # one device→host copy of the stacked buffers
                host = fused.cpu().numpy()
                fetch_s = time.perf_counter() - t0
                bufs = [host[i] for i in range(len(live))]
            else:
                results = []
                for e in live:
                    pod = self._upload(e.pod_arrays, PACK_ARG_DTYPES[:N_POD_ARRAYS])
                    served, result = backend.pack_unfused(
                        *pod, *resident, n_max=n_max, packer=packer)
                    with self._stats_lock:
                        self.served[served] = self.served.get(served, 0) + 1
                    results.append(result)
                dispatch_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                bufs = [self._fetch(r) for r in results]
                fetch_s = time.perf_counter() - t0
            self._served_tl.name = served
            for e, buf in zip(live, bufs):
                payload = [buf]
                if e.ctx is not None:
                    payload.append(np.asarray([dispatch_s, fetch_s, 0.0], np.float32))
                if e.flags & PACK_FLAG_ECHO_SESSION:
                    payload.append(_key_array(key))
                e.reply(self._seal(_status_response(STATUS_OK, payload), e.checksummed))
        finally:
            self.admission.leave()

    def _launch_group(self, live, resident, n_max: int, packer: str):
        """One launch for a coalesced group → ``(what served, fused
        buffers [B, L] on the session's device)``, B the group padded to
        its bucket by repeating the last entry. The 7 pod arrays are
        stacked and uploaded once; the session's catalog tensors get the
        same leading axis as contiguous copies (the kernels take
        contiguous inputs); ``backend.pack_unfused`` then serves the stack
        as it serves one problem: the card's kernel ladder in one launch
        (v2 over the session's tables, built once), ``pallas`` forcing
        ``pack_first_fit``, ``scan`` the plain version per problem."""
        from karpenter_tpu_torch.solver import backend, kernel
        from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

        B = next(b for b in self._COALESCE_BUCKETS if b >= len(live))
        padded = live + [live[-1]] * (B - len(live))
        pod = self._upload(
            [np.stack([e.pod_arrays[i] for e in padded]) for i in range(N_POD_ARRAYS)],
            PACK_ARG_DTYPES[:N_POD_ARRAYS],
        )
        catalog = tuple(t.expand(B, *t.shape).contiguous() for t in resident)
        served, result = backend.pack_unfused(*pod, *catalog, n_max=n_max, packer=packer)
        fused = torch.stack([
            kernel.fuse_result(kernel.PackResult(*(f[b] for f in result)))
            for b in range(B)
        ])
        return served, fused


def serve(
    address: str = "127.0.0.1:50051",
    max_workers: int = 4,
    health_port: int = 0,
    warmup: bool = False,
    service=None,
    shm_dir: str = "",
    coalesce_window_s: Optional[float] = None,
):
    """Start the sidecar server; returns the grpc server object.

    ``health_port`` > 0 also serves HTTP ``/healthz`` (liveness) and
    ``/readyz`` (503 until the warm-up solve completes). ``warmup`` runs the
    warm-up solve in the background; without it readiness is immediate.
    ``service`` hands in a pre-built (or chaos-wrapped) ``SolverService``
    (the default builds one on the card).

    ``shm_dir`` lets clients that share the directory send their pod arrays
    through a shared-memory arena; ``coalesce_window_s`` is the streamed
    solves' collection window (``stream.DEFAULT_COALESCE_WINDOW_S`` when
    None). The stream's threads and executor are built on the first
    ``SolveStream`` call (``server.stream_server()``; the built one, or
    None, in ``server.stream_server_box[0]``) and stopped with the
    server."""
    import grpc

    service = service if service is not None else SolverService()
    stream_box: list = [None]  # guarded-by: stream_lock
    stream_lock = threading.Lock()

    def stream_server():
        with stream_lock:
            if stream_box[0] is None:
                from karpenter_tpu_torch.solver.stream import (
                    DEFAULT_COALESCE_WINDOW_S,
                    StreamServer,
                )

                stream_box[0] = StreamServer(
                    service,
                    max_workers=max_workers,
                    coalesce_window_s=(
                        DEFAULT_COALESCE_WINDOW_S
                        if coalesce_window_s is None else coalesce_window_s
                    ),
                    shm_dir=shm_dir,
                )
            return stream_box[0]

    def unary(fn):
        return grpc.unary_unary_rpc_method_handler(
            lambda request, ctx: fn(request),
            request_deserializer=None,  # raw bytes in
            response_serializer=None,  # raw bytes out
        )

    handlers = {
        METHOD: service.solve_bytes,
        OPEN_SESSION_METHOD: service.open_session_bytes,
        HEALTH_METHOD: service.health_bytes,
    }

    class Handler(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            if handler_call_details.method == STREAM_METHOD:
                return grpc.stream_stream_rpc_method_handler(
                    lambda request_iterator, ctx: stream_server().handle(
                        request_iterator, ctx),
                    request_deserializer=None,
                    response_serializer=None,
                )
            fn = handlers.get(handler_call_details.method)
            return None if fn is None else unary(fn)

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_receive_message_length", 256 * 1024 * 1024),
            ("grpc.max_send_message_length", 256 * 1024 * 1024),
        ],
    )
    server.add_generic_rpc_handlers((Handler(),))
    server.add_insecure_port(address)
    server.start()
    if warmup:
        threading.Thread(target=service.warmup_loop, daemon=True).start()
    else:
        service.ready.set()
    if health_port:
        server.health_server = _serve_health(service, health_port)
    server.solver_service = service
    server.stream_server = stream_server
    server.stream_server_box = stream_box
    # the coalescer thread and the solve executor die with the server
    grpc_stop = server.stop

    def stop(grace=None):
        box = stream_box[0]
        if box is not None:
            box.stop()
        return grpc_stop(grace)

    server.stop = stop
    logger.info("solver service listening on %s", address)
    return server


def _serve_health(service: SolverService, port: int):
    """Plain-HTTP probe endpoints for kubelet — ``/healthz`` (200 once the
    process is up) and ``/readyz`` (503 until the warm-up solve) — plus
    ``/metrics`` (the port's registry) and ``/debug/{traces,slo,flight,
    decisions,explain,forecast}``: the session store and the sidecar's span ring
    live in THIS process, so its residency gauges and its half of every
    traced solve are observable only on its own port."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import urlsplit

    debug = {
        "/debug/traces": obs.debug_traces_payload,
        "/debug/slo": obs.debug_slo_payload,
        "/debug/flight": obs.debug_flight_payload,
        "/debug/decisions": obs.debug_decisions_payload,
        "/debug/explain": obs.debug_explain_payload,
        "/debug/forecast": obs.debug_forecast_payload,
    }

    class Probe(BaseHTTPRequestHandler):
        def do_GET(self):
            ctype = "text/plain"
            url = urlsplit(self.path)
            if self.path == "/healthz":
                code, body = 200, b"ok"
            elif self.path == "/readyz":
                if service.ready.is_set():
                    code, body = 200, b"ok"
                else:
                    code, body = 503, b"warming"
            elif self.path == "/metrics":
                from prometheus_client import generate_latest

                code, body = 200, generate_latest(metrics.REGISTRY)
            elif url.path in debug:
                code, ctype = 200, "application/json"
                body = _json.dumps(debug[url.path](url.query)).encode()
            else:
                code, body = 404, b"not found"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def log_message(self, *a):  # quiet
            pass

    httpd = ThreadingHTTPServer(("0.0.0.0", port), Probe)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


# ---------------------------------------------------------------------------
# client (lives in the controller process)
# ---------------------------------------------------------------------------


class RemoteSolver:
    """Drop-in for the in-process pack: ships the arrays to the sidecar
    and returns the PackResult as host numpy arrays.

    The catalog-side arrays are uploaded once per fingerprint
    (``OpenSession``); every ``pack`` ships the session key plus only the
    pod-side arrays. ``pack_begin`` dispatches without blocking (a gRPC or
    stream future) and returns ``wait()``: the scheduler releases its
    solve lock between the two.

    ``stream=True`` multiplexes solves and opens over one persistent
    stream once the sidecar advertised ``PROTO_STREAM``; ``shm_dir`` also
    sends the pod arrays through a shared-memory arena once the sidecar
    accepted it. The transport ladder per solve is stream + arena, stream
    inline, unary."""

    # catalog-key memos retained (bounded; they hold the array refs)
    KEY_MEMO_MAX = 8
    # opened-session keys retained: forgetting a live key costs one
    # redundant re-open on its next use
    OPENED_MAX = 64

    def __init__(
        self,
        address: str,
        timeout: float = 30.0,
        cold_timeout: float = 180.0,
        checksum: bool = False,
        stream: bool = False,
        shm_dir: str = "",
        delta: bool = False,
    ):
        import grpc

        self.address = address
        self.timeout = timeout
        # the persistent stream (stream.py), used once the sidecar
        # advertised PROTO_STREAM; shm_dir adds the arena once it is acked
        self._stream_enabled = bool(stream)
        self._shm_dir = shm_dir
        self._stream = None  # guarded-by: self._lock
        # pod-side deltas: when on AND the sidecar advertised PROTO_DELTA,
        # Pack frames establish / elide / patch against a resident base
        self.delta = bool(delta)
        # (epoch, pod array refs) last shipped: the patch planner's base
        self._delta_base: Optional[Tuple[bytes, List[np.ndarray]]] = None  # guarded-by: self._lock
        # pod epochs memoized by the arrays' identity (a no-churn round
        # presents the same arrays)
        self._pod_epoch_memo: "OrderedDict[tuple, tuple]" = OrderedDict()  # guarded-by: self._lock
        # frame checksums both ways and the session echo, when on AND the
        # sidecar advertised PROTO_CHECKSUM; OpenSession requests carry
        # the trailer whenever it is on (an older server ignores it)
        self.checksum = bool(checksum)
        # the first call per (P, n_max) shape may include the sidecar's
        # kernel build; later calls get the short deadline
        self.cold_timeout = cold_timeout
        self._warm_shapes = set()  # guarded-by: self._lock
        # capability bits from the last OpenSession response (0 before)
        self._server_features = 0  # guarded-by: self._lock
        # catalog keys this client has uploaded (bounded LRU); a sidecar
        # restart orphans them and NEEDS_CATALOG re-opens
        self._opened: "OrderedDict[bytes, bool]" = OrderedDict()  # guarded-by: self._lock
        self._key_memo = CatalogKeyMemo(self.KEY_MEMO_MAX)
        self.session_uploads = 0  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ("grpc.max_send_message_length", 256 * 1024 * 1024),
            ],
        )
        self._call = self._channel.unary_unary(METHOD)
        self._open_call = self._channel.unary_unary(OPEN_SESSION_METHOD)
        self._health_call = self._channel.unary_unary(HEALTH_METHOD)

    def health(self, timeout: float = 2.0) -> bool:
        """True when the sidecar reports SERVING (warm-up done)."""
        try:
            return self._health_call(b"", timeout=timeout) == SERVING
        except Exception:
            return False

    # -- sessions -----------------------------------------------------------

    def _catalog_key(self, catalog_side: Tuple) -> bytes:
        return self._key_memo.key(catalog_side)

    def _open_session(
        self,
        key: bytes,
        catalog_side: Tuple,
        timeout: float,
        force: bool = False,
        record: bool = True,
    ) -> None:
        with self._lock:
            if not force and key in self._opened:
                self._opened.move_to_end(key)
                return
        arrays = (
            [_key_array(key)]
            + [np.asarray(a) for a in catalog_side]
            + [np.asarray([1 if record else 0], np.int32)]
        )
        span = obs.tracer().current()
        if span is not None:
            # safe on any sidecar: the open request's tail is variadic
            arrays.append(_trace_ctx_array(span.context))
        request = pack_arrays(arrays)
        if self.checksum:
            request = append_checksum(request)
        with self._lock:
            require = bool(
                self.checksum and (self._server_features & PROTO_CHECKSUM)
            )
        with obs.tracer().span("solver.wire_open", attrs={"address": self.address}):
            response = self._dispatch_open(request, timeout)
        status, payload = self._receive_open(response, require)
        if status == STATUS_OVERLOADED:
            # backpressure, not failure: typed so no breaker trips on it
            raise OverloadedError(
                f"solver {self.address} refused session open (overloaded)",
                retry_after=self._retry_after(payload),
            )
        if status != STATUS_OK:
            self._check_status(status, payload)
        features = int(payload[0].reshape(-1)[0]) if payload else 0
        with self._lock:
            self._server_features = features
            self._opened[key] = True
            self._opened.move_to_end(key)
            while len(self._opened) > self.OPENED_MAX:
                self._opened.popitem(last=False)
            self.session_uploads += 1

    # -- the stream ------------------------------------------------------------

    def _stream_for(self, features: int):
        """The established stream client, or None (off, a sidecar without
        ``PROTO_STREAM``, or down and re-establishing): the unary path is
        the wait-free fallback in every case."""
        if not self._stream_enabled or not (features & PROTO_STREAM):
            return None
        with self._lock:
            client = self._stream
            if client is None:
                from karpenter_tpu_torch.solver.stream import StreamClient

                client = self._stream = StreamClient(
                    self._channel, self.address, shm_dir=self._shm_dir
                )
        return client if client.ensure() else None

    def _dispatch_open(self, request: bytes, timeout: float) -> bytes:
        """OpenSession over the stream when one is up (the NEEDS_CATALOG
        re-open after a sidecar restart rides the re-established stream),
        else unary."""
        from karpenter_tpu_torch.solver.stream import StreamBrokenError, StreamUnavailable

        with self._lock:
            client = self._stream
        if client is not None and client.up:
            try:
                return client.open(request).result(timeout=timeout + 5.0)
            except (StreamBrokenError, StreamUnavailable):
                self._count_stream_fallback("open")
            except futures.TimeoutError:
                self._count_stream_fallback("open_timeout")
                client.break_stream("open future timed out")
        return self._open_call(request, timeout=timeout)

    def _count_stream_fallback(self, reason: str) -> None:
        metrics.SOLVER_STREAM_FALLBACKS.labels(
            address=self.address, reason=reason
        ).inc()

    @staticmethod
    def _split_status(response: bytes) -> Tuple[int, List[np.ndarray]]:
        status_arr, *payload = unpack_arrays(response)
        # the integrity trailer is framing, not payload
        payload = [a for a in payload if not is_checksum_array(a)]
        return int(status_arr.reshape(-1)[0]), payload

    def _receive(self, response: bytes, require_checksum: bool) -> Tuple[int, List[np.ndarray]]:
        """Verify, then parse one Pack response. With checksums negotiated
        a missing or disagreeing digest, or a frame too mangled to parse,
        is an :class:`IntegrityError`; without them a present-but-wrong
        digest still fails, and parse errors propagate. One tolerance: an
        unsealed ``NEEDS_CATALOG`` (a sidecar restarted on an older build)
        only forces the re-open, which renegotiates the capabilities."""
        try:
            verdict = verify_checksum(response)
            status, payload = self._split_status(response)
        except Exception as e:
            if require_checksum:
                self._record_checksum_failure()
                raise IntegrityError(
                    f"solver {self.address} sent an unparseable frame ({e})",
                    address=self.address, kind="frame",
                ) from e
            raise
        if verdict == "mismatch" or (
            verdict == "missing"
            and require_checksum
            and status != STATUS_NEEDS_CATALOG
        ):
            self._record_checksum_failure()
            raise IntegrityError(
                f"solver {self.address} response failed frame checksum "
                f"({verdict})",
                address=self.address, kind="checksum",
            )
        return status, payload

    def _receive_open(self, response: bytes, require_checksum: bool) -> Tuple[int, List[np.ndarray]]:
        """:meth:`_receive` for an OpenSession response, with one more
        tolerance: an unchecksummed response whose features word no longer
        advertises ``PROTO_CHECKSUM`` is a rollback to an older build, not
        corruption. One that still claims the bit without its trailer, or
        any digest mismatch, raises."""
        try:
            verdict = verify_checksum(response)
            status, payload = self._split_status(response)
        except Exception as e:
            if require_checksum:
                self._record_checksum_failure()
                raise IntegrityError(
                    f"solver {self.address} sent an unparseable open "
                    f"response ({e})",
                    address=self.address, kind="frame",
                ) from e
            raise
        if verdict == "mismatch":
            self._record_checksum_failure()
            raise IntegrityError(
                f"solver {self.address} open response failed frame checksum",
                address=self.address, kind="checksum",
            )
        if verdict == "missing" and require_checksum:
            features = (
                int(payload[0].reshape(-1)[0])
                if status == STATUS_OK and payload else 0
            )
            if features & PROTO_CHECKSUM:
                self._record_checksum_failure()
                raise IntegrityError(
                    f"solver {self.address} advertises PROTO_CHECKSUM but "
                    "sent no frame checksum",
                    address=self.address, kind="checksum",
                )
            logger.warning(
                "solver %s no longer advertises PROTO_CHECKSUM; disabling "
                "frame checksums toward this member", self.address,
            )
        return status, payload

    def _record_checksum_failure(self) -> None:
        from karpenter_tpu_torch.solver import integrity

        integrity.record_checksum_failure(self.address)

    @staticmethod
    def _retry_after(payload: List[np.ndarray]) -> float:
        """The f32 retry-after hint an OVERLOADED response leads with."""
        try:
            return float(np.asarray(payload[0]).reshape(-1)[0])
        except Exception:
            return 1.0

    def _check_status(self, status: int, payload: List[np.ndarray]) -> None:
        """Raise the typed verdict for a terminal non-OK status; an unknown
        word fails loudly."""
        if status == STATUS_OK:
            return
        if status == STATUS_DEADLINE_EXCEEDED:
            raise DeadlineExceededError(
                f"solver {self.address} shed the solve: propagated round "
                "budget expired before device dispatch"
            )
        if status == STATUS_OVERLOADED:
            raise OverloadedError(
                f"solver {self.address} refused the solve (overloaded)",
                retry_after=self._retry_after(payload),
            )
        if status == STATUS_INTEGRITY:
            # the REQUEST arrived corrupt: the path is broken, never retry it
            self._record_checksum_failure()
            raise IntegrityError(
                f"solver {self.address} rejected a corrupt request frame "
                "(checksum mismatch server-side)",
                address=self.address, kind="checksum",
            )
        raise RuntimeError(
            f"unknown solver status word {status} from {self.address}"
        )

    # -- pod-side deltas ------------------------------------------------------

    POD_EPOCH_MEMO_MAX = 4
    # past a quarter of the rows the establish frame is simpler and barely
    # bigger than a patch
    PATCH_MAX_ROW_FRACTION = 4

    def _pod_epoch(self, pod_np: List[np.ndarray]) -> bytes:
        """:func:`pod_epoch_key` memoized by the arrays' identity."""
        id_key = tuple(map(id, pod_np))
        with self._lock:
            hit = self._pod_epoch_memo.get(id_key)
            if hit is not None:
                self._pod_epoch_memo.move_to_end(id_key)
                return hit[1]
        epoch = pod_epoch_key(pod_np)
        with self._lock:
            self._pod_epoch_memo[id_key] = (tuple(pod_np), epoch)
            while len(self._pod_epoch_memo) > self.POD_EPOCH_MEMO_MAX:
                self._pod_epoch_memo.popitem(last=False)
        return epoch

    def _plan_delta(
        self, epoch: bytes, pod_np: List[np.ndarray], p: int
    ) -> Tuple[int, List[np.ndarray], bytes]:
        """The delta frame kind against the last-shipped base: ``(kind,
        body arrays, base_epoch)``. The same epoch elides; the same shapes
        with few changed rows patch; anything else establishes. Every kind
        names ``epoch`` as its new epoch, and the sidecar proves it."""
        with self._lock:
            base = self._delta_base
        if base is not None and base[0] == epoch:
            return DELTA_ELIDE, [], epoch
        if base is not None and all(
            b.shape == a.shape and b.dtype == a.dtype
            for b, a in zip(base[1], pod_np)
        ):
            changed = np.zeros(p, dtype=bool)
            for b, a in zip(base[1], pod_np):
                diff = b != a
                changed |= diff.any(axis=tuple(range(1, diff.ndim))) if diff.ndim > 1 else diff
            idx = np.flatnonzero(changed).astype(np.int32)
            if idx.size and idx.size <= max(1, p // self.PATCH_MAX_ROW_FRACTION):
                return DELTA_PATCH, [idx] + [a[idx] for a in pod_np], base[0]
        return DELTA_ESTABLISH, list(pod_np), b"\x00" * 16

    def _remember_delta_base(self, epoch: bytes, pod_np: List[np.ndarray]) -> None:
        with self._lock:
            self._delta_base = (epoch, list(pod_np))

    # -- solves -------------------------------------------------------------

    def pack_begin(
        self, *inputs, n_max: int, prof: Optional[dict] = None, record: bool = True
    ):
        """Serialize the pod side (or its delta), make sure the session is
        open, and dispatch the Pack WITHOUT blocking. Returns ``wait()`` →
        PackResult (host arrays). ``prof`` receives ``wire_ser_s`` and
        ``wire_deser_s``; ``record=False`` keeps this Pack out of the
        sidecar's hit-rate stats."""
        from karpenter_tpu_torch.resilience.policy import current_budget
        from karpenter_tpu_torch.solver.kernel import split_result

        # a round whose budget already expired does not even serialize
        budget = current_budget.get()
        if budget is not None and budget.expired:
            raise DeadlineExceededError(
                "round budget expired before solver dispatch"
            )
        pod_side, catalog_side = inputs[:N_POD_ARRAYS], inputs[N_POD_ARRAYS:]
        key = self._catalog_key(catalog_side)
        p = len(inputs[0])
        r = inputs[6].shape[1]  # pod_req
        shape = (p, n_max)
        with self._lock:
            warm = shape in self._warm_shapes
        timeout = self.timeout if warm else self.cold_timeout
        # proactive open: the steady state returns at once from the set
        self._open_session(key, catalog_side, timeout, record=record)

        t0 = time.perf_counter()
        with self._lock:
            features = self._server_features
        integrity_on = bool(self.checksum and (features & PROTO_CHECKSUM))
        delta_on = bool(self.delta and (features & PROTO_DELTA))
        flags = 0
        if integrity_on:
            flags |= PACK_FLAG_ECHO_SESSION
        if delta_on:
            flags |= PACK_FLAG_DELTA
        vals = [n_max, 1 if record else 0]
        if flags:
            vals.append(flags)
        head = [_key_array(key), np.asarray(vals, np.int32)]
        pod_np = [np.asarray(a) for a in pod_side]
        epoch = None
        delta_body: List[np.ndarray] = []
        if delta_on:
            epoch = self._pod_epoch(pod_np)
            kind, body, base_epoch = self._plan_delta(epoch, pod_np, p)
            n_idx = int(body[0].size) if kind == DELTA_PATCH else 0
            delta_body = [delta_header(kind, n_idx, base_epoch, epoch)] + body
            # optimistic: if this dispatch sheds before the sidecar keeps
            # the epoch, the next round misses and re-establishes
            self._remember_delta_base(epoch, pod_np)
            if kind != DELTA_ESTABLISH:
                metrics.SOLVER_DELTA_APPLIED.labels(path="wire").inc()
            if prof is not None:
                prof["delta_kind"] = (
                    "elide" if kind == DELTA_ELIDE
                    else "patch" if kind == DELTA_PATCH else "establish"
                )
        # optional trailers, each gated on the bit the sidecar advertised,
        # so an untraced (or older-peer) frame is byte-identical to before:
        # the trace context of the span active at dispatch parents the
        # sidecar's spans (PROTO_TRACE_TRAILER); the deadline is the
        # budget's REMAINING seconds (PROTO_DEADLINE)
        trailers: List[np.ndarray] = []
        span = obs.tracer().current()
        if span is not None and (features & PROTO_TRACE_TRAILER):
            trailers.append(_trace_ctx_array(span.context))
        if budget is not None and (features & PROTO_DEADLINE):
            trailers.append(np.asarray([budget.remaining()], np.float32))

        def build_inline() -> bytes:
            req = pack_arrays(
                head + (delta_body if delta_on else pod_np) + trailers
            )
            # checksum LAST, over the final bytes
            return append_checksum(req) if integrity_on else req

        def build_establish() -> bytes:
            """The NEEDS_DELTA_BASE (or post-re-open) frame: the full pod
            set under an ESTABLISH header, which any delta-capable sidecar
            state satisfies, a cold restart included."""
            hdr = delta_header(DELTA_ESTABLISH, 0, b"\x00" * 16, epoch)
            self._remember_delta_base(epoch, pod_np)
            req = pack_arrays(head + [hdr] + pod_np + trailers)
            return append_checksum(req) if integrity_on else req

        # the transport ladder: stream + arena, stream inline, unary. An
        # empty credit window raises OverloadedError(kind="credits") here,
        # at the sender; a stream that is not up is never an error
        from karpenter_tpu_torch.solver.stream import StreamBrokenError, StreamUnavailable

        request: Optional[bytes] = None
        stream_fut = None
        arena_token = None
        transport = "unary"
        stream = self._stream_for(features)
        if stream is not None:
            # delta frames ride inline: a resident base must outlive the
            # arena slot it would arrive in, and the elide and patch frames
            # are small anyway
            wrote = None if delta_on else stream.write_arena(pod_np)
            if wrote is not None:
                arena_token, desc = wrote
                shm_req = pack_arrays(head + [desc] + trailers)
                if integrity_on:
                    shm_req = append_checksum(shm_req)
                try:
                    stream_fut = stream.solve_shm(shm_req)
                    transport = "stream_shm"
                except OverloadedError:
                    stream.free_arena(arena_token)
                    raise
                except StreamUnavailable:
                    stream.free_arena(arena_token)
                    arena_token = None
            if stream_fut is None:
                request = build_inline()
                try:
                    stream_fut = stream.solve(request)
                    transport = "stream"
                except StreamUnavailable:
                    pass  # it went down between ensure() and dispatch
        grpc_future = None
        if stream_fut is None:
            if request is None:
                request = build_inline()
            grpc_future = self._call.future(request, timeout=timeout)
        metrics.SOLVER_STREAM_SOLVES.labels(
            address=self.address, transport=transport
        ).inc()
        if prof is not None:
            prof["wire_ser_s"] = (
                prof.get("wire_ser_s", 0.0) + time.perf_counter() - t0
            )
            prof["solver_transport"] = transport
            prof["session_key"] = key.hex()

        def redispatch(req: bytes) -> bytes:
            """The synchronous recovery redispatch: over the stream when it
            is up (the re-open just rode it), else unary."""
            if stream is not None and stream.up:
                try:
                    return stream.solve(req).result(timeout=timeout + 5.0)
                except (StreamBrokenError, StreamUnavailable):
                    self._count_stream_fallback("retry")
                except futures.TimeoutError:
                    self._count_stream_fallback("retry_timeout")
                    stream.break_stream("retry future timed out")
            return self._call(req, timeout=timeout)

        def wait():
            nonlocal request, arena_token
            with obs.tracer().span(
                "solver.wire",
                attrs={"address": self.address, "transport": transport},
            ) as wsp:
                # the slack only bounds a misbehaving transport: the future
                # resolves by ``timeout`` in every healthy case
                if stream_fut is not None:
                    try:
                        response = stream_fut.result(timeout=timeout + 5.0)
                    except StreamBrokenError:
                        # the stream died with this solve in flight: retry it
                        # over unary while the stream re-establishes
                        self._count_stream_fallback("broken")
                        wsp.set_attribute("stream_fallback", True)
                        if request is None:
                            request = build_inline()
                        response = self._call(request, timeout=timeout)
                    except futures.TimeoutError:
                        self._count_stream_fallback("timeout")
                        wsp.set_attribute("stream_fallback", True)
                        stream.break_stream("solve future timed out")
                        if request is None:
                            request = build_inline()
                        response = self._call(request, timeout=timeout)
                    finally:
                        if arena_token is not None:
                            stream.free_arena(arena_token)
                            arena_token = None
                else:
                    response = grpc_future.result(timeout=timeout + 5.0)
                buf = stage = None
                # integrity expectation for THIS exchange; the forced re-open
                # below may lower it (a sidecar rolled back to an older build)
                require = integrity_on
                # each distinct refusal reason earns ONE synchronous recovery
                # and redispatch; the same reason twice fails loudly. Three
                # reasons, so at most 4 receives
                recovered: set = set()
                for _ in range(4):
                    status, payload = self._receive(response, require)
                    if status == STATUS_NEEDS_CATALOG:
                        reason = "not resident"
                    elif status == STATUS_NEEDS_DELTA_BASE:
                        reason = "delta base missing"
                    else:
                        if status != STATUS_OK:
                            wsp.set_attribute("status", status)
                            self._check_status(status, payload)
                        buf, stage, echoed = self._parse_pack_payload(payload)
                        if not require or echoed in (None, key):
                            break
                        # the sidecar solved against ANOTHER catalog generation:
                        # never decode it; record, then recover by a re-open
                        reason = "wrong-session echo"
                        from karpenter_tpu_torch.solver import integrity

                        integrity.record_session_mismatch(self.address)
                        logger.warning(
                            "solver %s echoed session %s for a solve against "
                            "%s; re-opening", self.address,
                            echoed.hex()[:12], key.hex()[:12],
                        )
                    if reason in recovered:
                        if reason == "wrong-session echo":
                            raise IntegrityError(
                                f"solver {self.address} kept answering with "
                                f"the wrong catalog session (want "
                                f"{key.hex()[:12]})",
                                address=self.address, kind="session",
                            )
                        if reason == "delta base missing":
                            raise RuntimeError(
                                "solver delta establish did not take "
                                f"(catalog key {key.hex()[:12]})"
                            )
                        raise RuntimeError(
                            "solver session re-open did not take "
                            f"(catalog key {key.hex()[:12]})"
                        )
                    recovered.add(reason)
                    logger.info(
                        "solver session %s %s; recovering",
                        key.hex()[:12], reason,
                    )
                    if reason == "delta base missing":
                        wsp.set_attribute("delta_establish_retry", True)
                        metrics.SOLVER_DELTA_EPOCH_MISMATCHES.labels(side="client").inc()
                        metrics.SOLVER_DELTA_FULL_REENCODES.labels(reason="wire").inc()
                    else:
                        # restarted, evicted, or the wrong generation: re-open
                        wsp.set_attribute("needs_catalog_retry", True)
                        self._open_session(
                            key, catalog_side, timeout, force=True, record=record,
                        )
                        with self._lock:
                            # downward only: the sidecar seals iff the REQUEST
                            # carried a checksum, and the retry resends it
                            require = require and bool(
                                self._server_features & PROTO_CHECKSUM
                            )
                    if delta_on:
                        # every recovery redispatch ships the full pod set
                        request = build_establish()
                    elif request is None:
                        request = build_inline()
                    response = redispatch(request)
                else:
                    raise RuntimeError(
                        f"solver {self.address} retry loop exhausted"
                    )  # unreachable: at most 3 distinct reasons
                with self._lock:
                    self._warm_shapes.add(shape)
                t1 = time.perf_counter()
                if stage is not None:
                    # the sidecar's stage trailer: its half of the round
                    # trip grafted into this tree as completed records; the
                    # rest of the wire span is transport
                    for name, seconds in zip(
                        ("sidecar.solve", "sidecar.fetch", "sidecar.serialize"),
                        stage[:3],
                    ):
                        wsp.add_child_record(name, float(seconds))
                out = split_result(buf, p, n_max, r)
                if prof is not None:
                    prof["wire_deser_s"] = (
                        prof.get("wire_deser_s", 0.0) + time.perf_counter() - t1
                    )
                    prof["solver_address"] = self.address  # pack provenance
                return out

        return wait

    @staticmethod
    def _parse_pack_payload(payload: List[np.ndarray]):
        """An OK Pack payload → ``(fused buf, stage trailer | None, echoed
        session key | None)``; the trailers are told apart by shape and
        dtype (f32[3] = the sidecar's stages, i32[4] = the session echo)."""
        buf = payload[0]
        stage = echoed = None
        for extra in payload[1:]:
            a = np.asarray(extra).reshape(-1)
            if a.dtype == np.float32 and a.size == 3:
                stage = a
            elif a.dtype == np.int32 and a.size == 4:
                echoed = a.tobytes()
        return buf, stage, echoed

    def pack(self, *inputs, n_max: int):
        """Synchronous convenience wrapper over ``pack_begin``."""
        return self.pack_begin(*inputs, n_max=n_max)()

    def close(self) -> None:
        with self._lock:
            stream = self._stream
            self._stream = None
        if stream is not None:
            stream.close()
        self._channel.close()


def main(argv: Optional[List[str]] = None) -> None:
    """Sidecar entry point: ``python -m karpenter_tpu_torch.solver.service``.
    It serves on the card; any flag not listed here is an argparse error."""
    import argparse

    ap = argparse.ArgumentParser(prog="karpenter-solver-service")
    ap.add_argument("--address", default="127.0.0.1:50051")
    ap.add_argument("--max-workers", type=int, default=4)
    ap.add_argument("--health-port", type=int, default=8081)
    ap.add_argument("--session-max", type=int, default=SESSION_MAX)
    ap.add_argument("--session-ttl", type=float, default=SESSION_TTL_S)
    ap.add_argument("--solver-max-inflight", type=int, default=MAX_INFLIGHT,
                    help="concurrent solves admitted to the device; "
                         "everything past this queues")
    ap.add_argument("--solver-queue-depth", type=int, default=QUEUE_DEPTH,
                    help="solve requests allowed to queue behind the "
                         "inflight cap; beyond it requests are refused "
                         "STATUS_OVERLOADED with a retry-after hint")
    ap.add_argument("--overload-retry-after", type=float,
                    default=OVERLOAD_RETRY_AFTER_S,
                    help="retry-after hint (seconds) carried by "
                         "STATUS_OVERLOADED responses")
    ap.add_argument("--hbm-floor-bytes", type=int, default=0,
                    help="device-memory headroom floor: below it NEW "
                         "session uploads are refused STATUS_OVERLOADED "
                         "while resident-session solves keep flowing "
                         "(0 disables)")
    ap.add_argument("--solver-shm-dir", default="",
                    help="shared-memory directory: clients on the same host "
                         "pass pod arrays through an mmap'd arena and the "
                         "stream carries only a descriptor ('' disables)")
    ap.add_argument("--solver-coalesce-window", type=float, default=None,
                    metavar="SECONDS",
                    help="collection window of the streamed solves: those "
                         "with the same session, shapes and n_max inside it "
                         "share one launch (default 0.002; 0 still groups "
                         "what is already queued)")
    ap.add_argument("--flight-dir", default="",
                    help="capped on-disk ring for slow-solve flight records "
                         "('' disables; served at GET /debug/flight)")
    ap.add_argument("--flight-budget-ms", type=float, default=100.0,
                    help="sidecar.pack spans over this budget are recorded")
    ap.add_argument("--slo-window", type=float, default=300.0,
                    help="online SLO fast evaluation window in seconds "
                         "(slow burn-rate window is 12x; GET /debug/slo)")
    ap.add_argument("--slo-config", default="",
                    help="objectives file ('' = the sidecar defaults: "
                         "sidecar.pack.p99 + session.catalog_hit_rate)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.flight_dir:
        # the sidecar's end-to-end unit is its own pack span
        obs.configure_flight(
            args.flight_dir, budget_s=args.flight_budget_ms / 1e3,
            watch=("sidecar.pack",),
        )
    # the sidecar judges its own half of the objectives: its pack span and
    # the session store it owns
    obs.configure_slo(
        objectives=(
            obs.load_objectives(args.slo_config)
            if args.slo_config
            else obs.SIDECAR_OBJECTIVES
        ),
        window_s=args.slo_window,
    )
    server = serve(
        args.address, args.max_workers, health_port=args.health_port, warmup=True,
        service=SolverService(
            session_max=args.session_max, session_ttl=args.session_ttl,
            max_inflight=args.solver_max_inflight,
            queue_depth=args.solver_queue_depth,
            overload_retry_after=args.overload_retry_after,
            hbm_floor_bytes=args.hbm_floor_bytes,
        ),
        shm_dir=args.solver_shm_dir,
        coalesce_window_s=args.solver_coalesce_window,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop(grace=2)


if __name__ == "__main__":
    main()
