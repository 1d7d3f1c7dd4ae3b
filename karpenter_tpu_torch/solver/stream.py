"""The sidecar's persistent solve stream: one bidirectional gRPC stream per
sidecar (per ``SolverPool`` member) that multiplexes solves by a
per-message correlation id. Responses complete out of order into the
``pack_begin`` / ``wait()`` futures; a broken stream falls back to the
unary path while a background thread re-establishes it. The bytes are the
reference package's, so a client of either package streams to a sidecar of
either package.

Three layers:

- **Envelope codec.** Each stream message wraps an unchanged unary v3
  frame (``service.pack_arrays`` bytes) in a 20-byte envelope::

      magic "KSTM" | u16 version=1 | u16 msg type | u64 correlation id
                   | u32 crc32(version, msg_type, corr_id) | payload

  The payload is the unary frame, so the trace, deadline and checksum
  capabilities ride the stream unchanged. The envelope CRC covers the
  words the frame checksum cannot: a flipped correlation id would complete
  another solve's future with a checksum-valid result, so a header that
  fails its CRC is dropped and counted, never routed.

- **Flow-control credits.** The server's first message grants a credit
  window (the sidecar's ``max_inflight + queue_depth``, the bound its
  ``AdmissionGate`` enforces by refusal on the unary path) and a
  retry-after hint. Each solve spends a credit and each result returns
  one. An empty window raises
  :class:`~karpenter_tpu_torch.resilience.overload.OverloadedError` with
  ``kind="credits"`` at the sender, before any bytes move; ``SolverPool``
  takes it as it takes a ``STATUS_OVERLOADED`` refusal.

- **Shared-memory arena.** When controller and sidecar share a host
  (``--solver-shm-dir`` on both), the client writes the 7 pod-side arrays
  into an mmap'd arena file (a per-block header with a CRC over the header
  only) and the stream message carries an i32 descriptor in their place.
  The arena is negotiated in the stream (``MSG_ARENA`` →
  ``MSG_ARENA_ACK``): a sidecar without the directory declines and the
  client stays on inline frames. The arena's layout is the reference's,
  so either package reads the other's files.

**Coalescing** (server side): concurrent streamed solves whose session
key, pod-array shapes and ``n_max`` agree are grouped by a short
collection window and handed to ``SolverService.solve_stream_group`` as
one group, which the card serves with one launch of ``pack_first_fit`` or
``pack_first_fit_v2`` over a leading batch axis.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from concurrent import futures
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.resilience.overload import OverloadedError

logger = logging.getLogger("karpenter.solver.stream")

# ---------------------------------------------------------------------------
# envelope codec
# ---------------------------------------------------------------------------

STREAM_MAGIC = b"KSTM"
STREAM_VERSION = 1
ENVELOPE_BYTES = 20  # magic + <HH + <Q + <I

MSG_SOLVE = 1  # payload: a unary v3 Pack request frame
MSG_OPEN = 2  # payload: a unary v3 OpenSession request frame
MSG_RESULT = 3  # payload: the matching unary v3 response frame
MSG_CREDITS = 4  # payload: <if credits delta (the initial grant), retry hint
MSG_ARENA = 5  # payload: UTF-8 arena file basename (client → server)
MSG_ARENA_ACK = 6  # payload: <i ok word (+ UTF-8 detail on refusal)
MSG_SOLVE_SHM = 7  # payload: a Pack frame whose pod arrays are replaced by
#                    one shm descriptor array (see ShmArena)


class EnvelopeCorrupt(ValueError):
    """The envelope header failed its CRC: the correlation id cannot be
    trusted, so the message is dropped (counted), never routed; the
    sender's future times out and falls back to the unary path."""


def _envelope_crc(msg_type: int, corr_id: int) -> int:
    return zlib.crc32(struct.pack("<HHQ", STREAM_VERSION, msg_type, corr_id))


def pack_stream_msg(msg_type: int, corr_id: int, payload: bytes = b"") -> bytes:
    """One stream message: envelope header + payload bytes."""
    return (
        STREAM_MAGIC
        + struct.pack(
            "<HHQI", STREAM_VERSION, msg_type, corr_id,
            _envelope_crc(msg_type, corr_id),
        )
        + payload
    )


def unpack_stream_msg(data: bytes) -> Tuple[int, int, bytes]:
    """``(msg_type, corr_id, payload)``. Bad magic, version skew and
    truncation raise ``ValueError``; a CRC mismatch raises
    :class:`EnvelopeCorrupt` (a detected drop)."""
    if data[:4] != STREAM_MAGIC:
        raise ValueError("bad stream magic")
    if len(data) < ENVELOPE_BYTES:
        raise ValueError("truncated stream envelope")
    version, msg_type, corr_id, crc = struct.unpack_from("<HHQI", data, 4)
    if version != STREAM_VERSION:
        raise ValueError(f"unsupported stream version {version}")
    if crc != _envelope_crc(msg_type, corr_id):
        raise EnvelopeCorrupt("stream envelope failed CRC")
    return msg_type, corr_id, data[ENVELOPE_BYTES:]


# ---------------------------------------------------------------------------
# shared-memory arena
# ---------------------------------------------------------------------------

ARENA_MAGIC = 0x4B41524E  # "KARN"
DEFAULT_ARENA_BYTES = 64 << 20
_BLOCK_HEADER = struct.Struct("<IIQI")  # magic, token, payload nbytes, crc
_ALIGN = 8

# the v3 framing's dtype codes (service._DTYPES), declared here too so this
# module imports without the service
_SHM_DTYPES = {0: np.dtype(np.bool_), 1: np.dtype(np.int32), 2: np.dtype(np.float32)}
_SHM_DTYPE_CODES = {v: k for k, v in _SHM_DTYPES.items()}


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _header_crc(token: int, nbytes: int) -> int:
    return zlib.crc32(struct.pack("<IIQ", ARENA_MAGIC, token, nbytes))


class ShmArena:
    """The client's writer over one mmap'd arena file.

    Allocation is a bump pointer that wraps to the front once; blocks are
    freed when their solve completes, and the credit window keeps the live
    set small. A write that does not fit returns ``None`` and the caller
    sends an inline frame.

    Block layout at ``offset``::

        <IIQI  magic | token | payload nbytes | crc32(header)   (24 B, padded)
        raw C-order array bytes, each 8-byte aligned

    The CRC covers the header only: the arena exists to skip touching the
    payload, and the two processes share a host. The descriptor that
    crosses the stream (covered by the frame checksum when it is
    negotiated) carries the offset, the token and each array's dtype and
    shape, so the reader verifies the header before it trusts a byte.
    """

    def __init__(
        self,
        directory: str,
        size: int = DEFAULT_ARENA_BYTES,
        name: Optional[str] = None,
    ):
        import mmap

        os.makedirs(directory, exist_ok=True)
        self.name = name or f"arena-{os.getpid()}-{os.urandom(4).hex()}.shm"
        self.path = os.path.join(directory, self.name)
        self.size = int(size)
        with open(self.path, "wb") as f:
            f.truncate(self.size)
        self._f = open(self.path, "r+b")
        self._map = mmap.mmap(self._f.fileno(), self.size)
        self._mu = threading.Lock()
        self._next = 0  # guarded-by: self._mu
        self._live: "OrderedDict[int, Tuple[int, int]]" = OrderedDict()  # guarded-by: self._mu
        self._token = 0  # guarded-by: self._mu

    def _reserve_locked(self, nbytes: int) -> Optional[int]:
        """The block's offset, or None when no free span fits right now.
        The credit window bounds the live set, so the overlap scan is a
        handful of comparisons."""
        total = _aligned(_BLOCK_HEADER.size) + nbytes
        if total > self.size:
            return None
        for base in (self._next, 0):
            end = base + total
            if end > self.size:
                continue
            if any(not (end <= s or base >= e) for s, e in self._live.values()):
                continue
            return base
        return None

    def write(self, arrays: Sequence[np.ndarray]) -> Optional[Tuple[int, np.ndarray]]:
        """Copy ``arrays`` into the arena: ``(token, descriptor)``, or None
        when the arena cannot hold them right now. The descriptor is the
        i32 array that replaces the pod arrays on the wire: ``[token,
        offset_lo, offset_hi, n_arrays, (dtype, ndim, *shape) per
        array]``."""
        # not ascontiguousarray: it promotes 0-d scalars to 1-d
        arrs = [np.asarray(a, order="C") for a in arrays]
        if any(a.dtype not in _SHM_DTYPE_CODES for a in arrs):
            return None
        payload = sum(_aligned(a.nbytes) for a in arrs)
        with self._mu:
            base = self._reserve_locked(payload)
            if base is None:
                return None
            self._token += 1
            token = self._token & 0xFFFFFFFF
            total = _aligned(_BLOCK_HEADER.size) + payload
            self._live[token] = (base, base + total)
            self._next = base + total
            _BLOCK_HEADER.pack_into(
                self._map, base, ARENA_MAGIC, token, payload, _header_crc(token, payload),
            )
        # the region is reserved: concurrent writers copy into disjoint
        # regions off the lock
        cursor = base + _aligned(_BLOCK_HEADER.size)
        desc: List[int] = [token, base & 0x7FFFFFFF, base >> 31, len(arrs)]
        for a in arrs:
            self._map[cursor:cursor + a.nbytes] = a.tobytes()
            desc += [_SHM_DTYPE_CODES[a.dtype], a.ndim, *a.shape]
            cursor += _aligned(a.nbytes)
        return token, np.asarray(desc, np.int32)

    def free(self, token: int) -> None:
        with self._mu:
            self._live.pop(token, None)

    def live_blocks(self) -> int:
        with self._mu:
            return len(self._live)

    def close(self) -> None:
        try:
            self._map.close()
            self._f.close()
        except Exception:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ShmArenaReader:
    """The sidecar's read-only view of a client's arena file. ``read``
    checks the block header (magic, token, length, CRC) before it trusts
    an offset, then returns numpy views onto the mmap: the device upload is
    the first copy."""

    def __init__(self, path: str):
        import mmap

        self._f = open(path, "rb")
        self.size = os.fstat(self._f.fileno()).st_size
        self._map = mmap.mmap(self._f.fileno(), self.size, prot=mmap.PROT_READ)

    def read(self, desc: np.ndarray) -> List[np.ndarray]:
        d = np.asarray(desc).reshape(-1)
        if d.dtype != np.int32 or d.size < 4:
            raise ValueError("malformed shm descriptor")
        token = int(d[0]) & 0xFFFFFFFF
        base = int(d[1]) | (int(d[2]) << 31)
        n_arrays = int(d[3])
        if not 0 <= base <= self.size - _BLOCK_HEADER.size:
            raise ValueError("shm descriptor offset out of bounds")
        magic, htoken, nbytes, crc = _BLOCK_HEADER.unpack_from(self._map, base)
        if magic != ARENA_MAGIC or htoken != token:
            raise ValueError("shm block header does not match descriptor")
        if crc != _header_crc(htoken, nbytes):
            raise ValueError("shm block header failed CRC")
        cursor = base + _aligned(_BLOCK_HEADER.size)
        if cursor + nbytes > self.size:
            raise ValueError("shm block payload out of bounds")
        out: List[np.ndarray] = []
        i = 4
        for _ in range(n_arrays):
            if i + 2 > d.size:
                raise ValueError("truncated shm descriptor")
            dtype = _SHM_DTYPES.get(int(d[i]))
            ndim = int(d[i + 1])
            if dtype is None or i + 2 + ndim > d.size:
                raise ValueError("malformed shm descriptor entry")
            shape = tuple(int(x) for x in d[i + 2:i + 2 + ndim])
            i += 2 + ndim
            n_items = int(np.prod(shape, dtype=np.int64))
            arr_bytes = n_items * dtype.itemsize
            if cursor + arr_bytes > base + _aligned(_BLOCK_HEADER.size) + nbytes:
                raise ValueError("shm array exceeds block payload")
            out.append(
                np.frombuffer(self._map, dtype=dtype, count=n_items, offset=cursor)
                .reshape(shape)
            )
            cursor += _aligned(arr_bytes)
        return out

    def close(self) -> None:
        try:
            self._map.close()
            self._f.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# server half
# ---------------------------------------------------------------------------

DEFAULT_COALESCE_WINDOW_S = 0.002
COALESCE_MAX = 8


@dataclass
class StreamSolve:
    """One parsed streamed solve awaiting dispatch (server side)."""

    key: bytes
    n_max: int
    record: bool
    flags: int
    pod_arrays: List[np.ndarray]
    ctx: object  # TraceContext | None
    deadline: Optional[float]  # absolute, on the service clock
    checksummed: bool
    respond: Callable[[bytes], None]
    shm: bool = False
    answered: bool = False

    def reply(self, response: bytes) -> bool:
        """Answer this solve exactly once: every answer decrements the
        stream's inflight count and returns the sender a credit, so a
        double reply would corrupt both. False = already answered. Only
        dispatch threads touch an entry, so no lock."""
        if self.answered:
            return False
        self.answered = True
        self.respond(response)
        return True

    @property
    def group_key(self) -> tuple:
        return (
            self.key,
            self.n_max,
            tuple((a.shape, str(a.dtype)) for a in self.pod_arrays),
        )


class _CoalescingDispatcher:
    """One queue fed by every stream's reader; a dispatcher thread drains it
    in short collection windows, groups entries whose (session key, pod
    shapes, n_max) agree, and submits each group to the solve executor as
    one dispatch."""

    def __init__(
        self,
        service,
        executor: futures.ThreadPoolExecutor,
        window_s: float = DEFAULT_COALESCE_WINDOW_S,
        max_batch: int = COALESCE_MAX,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.window_s = max(float(window_s), 0.0)
        self.max_batch = max(int(max_batch), 1)
        self._executor = executor
        self._clock = clock
        self._q: "Queue[StreamSolve]" = Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="solver-stream-coalescer", daemon=True
        )
        self._thread.start()

    def submit(self, entry: StreamSolve) -> None:
        self._q.put(entry)

    def stop(self) -> None:
        self._stop.set()

    def _busy(self) -> bool:
        """Solves already admitted or queued: waiting the window then costs
        nothing, since this entry would queue at the gate anyway."""
        try:
            return self.service.admission.depth() > 0
        except Exception:
            return False

    def _collect(self) -> List[StreamSolve]:
        try:
            first = self._q.get(timeout=0.25)
        except Empty:
            return []
        batch = [first]
        # everything already queued groups at no added latency
        while True:
            try:
                batch.append(self._q.get_nowait())
            except Empty:
                break
        # linger for stragglers only when there is concurrency to harvest:
        # companions already arrived, or the admission gate is busy. A
        # lone solve against an idle sidecar dispatches at once
        if self.window_s > 0 and (len(batch) > 1 or self._busy()):
            deadline = self._clock() + self.window_s
            while True:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except Empty:
                    break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            groups: "OrderedDict[tuple, List[StreamSolve]]" = OrderedDict()
            for entry in batch:
                groups.setdefault(entry.group_key, []).append(entry)
            for entries in groups.values():
                for i in range(0, len(entries), self.max_batch):
                    self._executor.submit(self._run_group, entries[i:i + self.max_batch])

    def _run_group(self, entries: List[StreamSolve]) -> None:
        try:
            self.service.solve_stream_group(entries)
        except Exception as e:  # a crash fails its own solves only
            logger.exception("coalesced stream dispatch failed")
            from karpenter_tpu_torch.solver import service as svc

            for entry in entries:
                try:
                    # only entries not yet answered (reply() is once-only),
                    # sealed per the entry's own negotiation (an unsealed
                    # refusal to an integrity-negotiated client would read
                    # as corruption), and OVERLOADED with a short hint, so
                    # a pool backs off instead of tripping a breaker
                    entry.reply(
                        svc.SolverService._seal(
                            svc._status_response(
                                svc.STATUS_OVERLOADED, [np.asarray([0.2], np.float32)],
                            ),
                            entry.checksummed,
                        )
                    )
                except Exception:
                    logger.debug("stream error response failed for %s", e, exc_info=True)


class StreamServer:
    """The sidecar's half of the stream: one per ``service.serve`` call,
    handling every ``SolveStream`` RPC against one (possibly chaos-wrapped)
    ``SolverService``."""

    def __init__(
        self,
        service,
        max_workers: int = 4,
        coalesce_window_s: float = DEFAULT_COALESCE_WINDOW_S,
        coalesce_max: int = COALESCE_MAX,
        shm_dir: str = "",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.shm_dir = shm_dir
        self._clock = clock
        self._executor = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="solver-stream-solve",
        )
        self.dispatcher = _CoalescingDispatcher(
            service, self._executor,
            window_s=coalesce_window_s, max_batch=coalesce_max, clock=clock,
        )
        self.stats: Dict[str, int] = {
            "streams_opened": 0, "stream_solves": 0, "shm_solves": 0,
            "stream_opens": 0, "envelope_rejects": 0,
        }  # guarded-by: self._stats_mu
        self._stats_mu = threading.Lock()

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_mu:
            self.stats[key] = self.stats.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._stats_mu:
            out = dict(self.stats)
        # the coalescing counters are the service's (dispatch facts)
        for k in ("coalesced_dispatches", "coalesced_solves"):
            out[k] = int(getattr(self.service, "stream_stats", {}).get(k, 0))
        return out

    def stop(self) -> None:
        self.dispatcher.stop()
        self._executor.shutdown(wait=False)

    def _credit_window(self) -> Tuple[int, float]:
        adm = self.service.admission
        return adm.max_inflight + adm.queue_depth, float(self.service.overload_retry_after)

    def _attach_arena(self, payload: bytes) -> Tuple[Optional[ShmArenaReader], bytes]:
        """MSG_ARENA: map the client's arena iff a shm directory is
        configured and the file resolves inside it (basename-only joins, so
        a hostile path cannot escape it)."""
        if not self.shm_dir:
            return None, b"sidecar has no --solver-shm-dir"
        name = os.path.basename(payload.decode("utf-8", "replace"))
        path = os.path.realpath(os.path.join(self.shm_dir, name))
        if not path.startswith(os.path.realpath(self.shm_dir) + os.sep):
            return None, b"arena path escapes shm dir"
        try:
            return ShmArenaReader(path), b""
        except OSError as e:
            return None, str(e).encode()

    def handle(self, request_iterator, grpc_context):
        """The gRPC stream-stream handler: a generator yielding response
        messages as solves complete, in whatever order they finish."""
        self._count("streams_opened")
        out_q: "Queue[bytes]" = Queue()
        state = {"inflight": 0, "closed": False, "abort": None}  # guarded-by: mu
        mu = threading.Lock()
        arena_box: List[Optional[ShmArenaReader]] = [None]
        credits, hint = self._credit_window()
        out_q.put(pack_stream_msg(MSG_CREDITS, 0, struct.pack("<if", credits, hint)))

        def done(corr_id: int, response: bytes) -> None:
            out_q.put(pack_stream_msg(MSG_RESULT, corr_id, response))
            with mu:
                state["inflight"] -= 1

        def reader() -> None:
            try:
                for raw in request_iterator:
                    try:
                        msg_type, corr_id, payload = unpack_stream_msg(raw)
                    except EnvelopeCorrupt:
                        # the corr id cannot be trusted: a response could
                        # complete the wrong future. Drop and count; the
                        # sender's timeout takes the unary fallback
                        self._count("envelope_rejects")
                        logger.error("stream envelope failed CRC; dropping message")
                        continue
                    if msg_type == MSG_ARENA:
                        arena, err = self._attach_arena(payload)
                        arena_box[0] = arena
                        ok = 1 if arena is not None else 0
                        out_q.put(pack_stream_msg(
                            MSG_ARENA_ACK, corr_id, struct.pack("<i", ok) + err))
                        continue
                    if msg_type == MSG_OPEN:
                        self._count("stream_opens")
                        with mu:
                            state["inflight"] += 1
                        self._executor.submit(self._run_open, payload, corr_id, done)
                        continue
                    if msg_type in (MSG_SOLVE, MSG_SOLVE_SHM):
                        self._count("stream_solves")
                        if msg_type == MSG_SOLVE_SHM:
                            self._count("shm_solves")
                        try:
                            entry_or_resp = self.service.stream_parse_solve(
                                payload,
                                respond=lambda b, c=corr_id: done(c, b),
                                arena=arena_box[0] if msg_type == MSG_SOLVE_SHM else None,
                            )
                        except Exception as e:
                            # version skew (and whatever the typed refusals
                            # do not cover) breaks the stream loudly: the
                            # client's unary fallback then raises the skew
                            # at the codec
                            logger.error(
                                "stream reader aborting: unparseable solve message (%s)", e)
                            with mu:
                                state["abort"] = e
                            return
                        # inflight counts only messages that will be answered
                        with mu:
                            state["inflight"] += 1
                        if isinstance(entry_or_resp, bytes):
                            done(corr_id, entry_or_resp)
                            continue
                        # a solve whose deadline already passed never pays
                        # the dispatcher hop or an executor slot
                        shed = self.service.shed_if_expired(entry_or_resp)
                        if shed is not None:
                            entry_or_resp.reply(shed)
                        else:
                            self.dispatcher.submit(entry_or_resp)
                        continue
                    logger.warning("unknown stream message type %d; ignoring", msg_type)
            except Exception:
                logger.debug("stream reader ended", exc_info=True)
            finally:
                with mu:
                    state["closed"] = True

        threading.Thread(target=reader, name="solver-stream-reader", daemon=True).start()
        try:
            while True:
                try:
                    yield out_q.get(timeout=0.25)
                    continue
                except Empty:
                    pass
                with mu:
                    abort = state["abort"]
                    drained = state["closed"] and state["inflight"] <= 0
                if abort is not None:
                    # fail the RPC itself: the client sees the break now
                    # instead of each in-flight solve waiting out its timeout
                    raise RuntimeError(f"solve stream aborted: {abort}")
                if drained and out_q.empty():
                    return
                if grpc_context is not None and not grpc_context.is_active():
                    return
        finally:
            arena = arena_box[0]
            if arena is not None:
                arena.close()

    def _run_open(self, payload: bytes, corr_id: int, done) -> None:
        try:
            response = self.service.open_session_bytes(payload)
        except Exception as e:
            # version skew and other loud protocol errors: the unary handler
            # would fail the RPC; over the stream this message fails with
            # the typed refusal
            logger.error("streamed open failed: %s", e)
            from karpenter_tpu_torch.solver import service as svc

            response = svc._status_response(svc.STATUS_INTEGRITY)
        done(corr_id, response)


# ---------------------------------------------------------------------------
# client half
# ---------------------------------------------------------------------------


class StreamUnavailable(RuntimeError):
    """No established stream right now: the caller takes the unary path."""


class StreamBrokenError(RuntimeError):
    """The stream died with this solve in flight: the caller retries it over
    the unary path (a solve is idempotent)."""


class StreamClient:
    """The controller's half of the stream toward one sidecar.

    ``ensure()`` establishes lazily (the server's MSG_CREDITS grant is the
    "stream is up" signal). A receive-loop error fails every in-flight
    future with :class:`StreamBrokenError`, marks the stream down and
    starts one background reconnect thread with decorrelated-jitter
    backoff: the hot path never blocks on a dead stream, it sees
    :class:`StreamUnavailable` and stays on unary."""

    ESTABLISH_TIMEOUT_S = 5.0
    RECONNECT_CAP_S = 15.0

    def __init__(
        self,
        channel,
        address: str,
        shm_dir: str = "",
        arena_bytes: int = DEFAULT_ARENA_BYTES,
        clock: Callable[[], float] = time.monotonic,
    ):
        from karpenter_tpu_torch.solver import service as svc

        self.address = address
        self._call_factory = channel.stream_stream(svc.STREAM_METHOD)
        self._clock = clock
        self._shm_dir = shm_dir
        self._arena_bytes = arena_bytes
        self._mu = threading.Lock()
        # one establish attempt at a time (each blocks up to
        # ESTABLISH_TIMEOUT_S); a flag, not a lock, so a loser returns False
        # and takes the unary path instead of waiting out the handshake
        self._establishing = False  # guarded-by: self._mu
        self._state = "down"  # guarded-by: self._mu — down|up|closed
        self._credits = 0  # guarded-by: self._mu
        self._hint = 0.05  # guarded-by: self._mu
        # corr id -> (future, spent_credit)
        self._pending: Dict[int, tuple] = {}  # guarded-by: self._mu
        self._corr = 0  # guarded-by: self._mu
        self._out: Optional[Queue] = None  # guarded-by: self._mu
        self._epoch = 0  # guarded-by: self._mu
        self._reconnecting = False  # guarded-by: self._mu
        self._arena: Optional[ShmArena] = None  # guarded-by: self._mu
        self._shm_ready = threading.Event()
        # after a failed establish the hot path does not re-pay the
        # establish timeout per solve
        self._cooldown_until = 0.0  # guarded-by: self._mu
        self.credit_stalls = 0  # guarded-by: self._mu
        self.breaks = 0  # guarded-by: self._mu
        self.established_count = 0  # guarded-by: self._mu

    @property
    def up(self) -> bool:
        with self._mu:
            return self._state == "up"

    @property
    def shm_active(self) -> bool:
        with self._mu:
            return (
                self._state == "up"
                and self._arena is not None
                and self._shm_ready.is_set()
            )

    def ensure(self) -> bool:
        """Establish if down (bounded); True when the stream is usable.
        While a background reconnect runs this returns False at once."""
        with self._mu:
            if self._state == "up":
                return True
            if self._state == "closed" or self._reconnecting:
                return False
            if self._clock() < self._cooldown_until:
                return False
        return self._establish()

    def _establish(self) -> bool:
        import grpc  # noqa: F401 — establishing needs a live channel

        with self._mu:
            if self._establishing:
                return False  # another attempt owns the handshake
            self._establishing = True
        try:
            return self._establish_once()
        finally:
            with self._mu:
                self._establishing = False

    def _establish_once(self) -> bool:
        out: "Queue[object]" = Queue()
        credits_evt = threading.Event()
        with self._mu:
            if self._state in ("up", "closed"):
                return self._state == "up"
            self._epoch += 1
            epoch = self._epoch
            self._out = out
            self._shm_ready.clear()

        def gen():
            while True:
                try:
                    item = out.get(timeout=1.0)
                except Empty:
                    with self._mu:
                        dead = self._epoch != epoch or self._state == "closed"
                    if dead:
                        return
                    continue
                yield item

        try:
            call = self._call_factory(gen())
        except Exception as e:
            logger.info("stream establish to %s failed: %s", self.address, e)
            with self._mu:
                self._cooldown_until = self._clock() + 2.0
            return False

        def receiver():
            try:
                for raw in call:
                    try:
                        msg_type, corr_id, payload = unpack_stream_msg(raw)
                    except EnvelopeCorrupt:
                        logger.error("response stream envelope failed CRC; dropping")
                        metrics.SOLVER_STREAM_FALLBACKS.labels(
                            address=self.address, reason="envelope"
                        ).inc()
                        continue
                    if msg_type == MSG_CREDITS:
                        delta, hint = struct.unpack("<if", payload[:8])
                        with self._mu:
                            if self._epoch != epoch:
                                return
                            self._credits += delta
                            self._hint = max(float(hint), 0.0)
                            if not credits_evt.is_set():
                                self._state = "up"
                                self.established_count += 1
                        credits_evt.set()
                        continue
                    if msg_type == MSG_ARENA_ACK:
                        with self._mu:
                            if self._epoch != epoch:
                                # a stale receiver's late ack must not arm
                                # shm on a fresh stream
                                return
                        ok = struct.unpack("<i", payload[:4])[0]
                        if ok:
                            self._shm_ready.set()
                        else:
                            logger.info(
                                "sidecar %s declined shm arena: %s",
                                self.address, payload[4:].decode("utf-8", "replace"),
                            )
                        continue
                    if msg_type == MSG_RESULT:
                        with self._mu:
                            if self._epoch != epoch:
                                return
                            hit = self._pending.pop(corr_id, None)
                            # a credit returns only if this request spent
                            # one: opens never do, and an unknown corr id
                            # must not mint credits past the sidecar's bound
                            if hit is not None and hit[1]:
                                self._credits += 1
                        if hit is None:
                            logger.warning(
                                "stream result for unknown correlation id %d", corr_id)
                        else:
                            hit[0].set_result(payload)
                        continue
                    logger.warning("unknown stream response type %d; ignoring", msg_type)
            except Exception as e:
                self._on_break(epoch, e)
            else:
                self._on_break(epoch, StreamBrokenError("stream closed by peer"))

        threading.Thread(
            target=receiver, name=f"solver-stream-recv-{self.address}", daemon=True,
        ).start()
        if not credits_evt.wait(self.ESTABLISH_TIMEOUT_S):
            try:
                call.cancel()
            except Exception:
                pass
            with self._mu:
                self._cooldown_until = self._clock() + 2.0
            logger.info(
                "stream to %s not established within %.1fs; staying unary",
                self.address, self.ESTABLISH_TIMEOUT_S,
            )
            return False
        # the arena is negotiated after the stream is up: it is optional,
        # and its failure must not cost the stream
        if self._shm_dir:
            with self._mu:
                if self._arena is None:
                    try:
                        self._arena = ShmArena(self._shm_dir, size=self._arena_bytes)
                    except OSError as e:
                        logger.info("shm arena unavailable: %s", e)
                arena = self._arena
            if arena is not None:
                out.put(pack_stream_msg(MSG_ARENA, 0, arena.name.encode("utf-8")))
        metrics.SOLVER_STREAM_STATE.labels(address=self.address).set(1)
        logger.info("solver stream established to %s", self.address)
        return True

    def _on_break(self, epoch: int, exc: Exception) -> None:
        with self._mu:
            if self._epoch != epoch or self._state == "closed":
                return
            if self._state != "up":
                # this epoch never established: establish's own timeout and
                # cooldown pace the retry, no reconnect thread
                return
            self._state = "down"
            self._credits = 0
            self.breaks += 1
            pending = [fut for fut, _ in self._pending.values()]
            self._pending.clear()
            already = self._reconnecting
            self._reconnecting = True
            self._shm_ready.clear()
        metrics.SOLVER_STREAM_STATE.labels(address=self.address).set(0)
        metrics.SOLVER_STREAM_BREAKS.labels(address=self.address).inc()
        logger.warning(
            "solver stream to %s broke (%s); %d in-flight solves fall back to "
            "unary; re-establishing in the background",
            self.address, exc, len(pending),
        )
        for fut in pending:
            if not fut.done():
                fut.set_exception(StreamBrokenError(f"stream to {self.address} broke: {exc}"))
        if not already:
            threading.Thread(
                target=self._reconnect_loop,
                name=f"solver-stream-reconnect-{self.address}", daemon=True,
            ).start()

    def _reconnect_loop(self) -> None:
        from karpenter_tpu_torch.resilience.policy import decorrelated_jitter

        backoffs = decorrelated_jitter(0.2, cap=self.RECONNECT_CAP_S)
        try:
            while True:
                with self._mu:
                    if self._state in ("up", "closed"):
                        return
                if self._establish():
                    return
                time.sleep(next(backoffs))
        finally:
            with self._mu:
                self._reconnecting = False

    def break_stream(self, reason: str = "client-side") -> None:
        """Force a teardown (a wedged stream whose future timed out must not
        keep taking solves); the background loop re-establishes."""
        with self._mu:
            epoch = self._epoch
        self._on_break(epoch, StreamBrokenError(reason))

    def _send(self, msg_type: int, payload: bytes, spend_credit: bool):
        with self._mu:
            if self._state != "up" or self._out is None:
                raise StreamUnavailable(f"no stream to {self.address}")
            if spend_credit:
                if self._credits <= 0:
                    self.credit_stalls += 1
                    metrics.SOLVER_STREAM_CREDIT_STALLS.labels(
                        address=self.address
                    ).inc()
                    raise OverloadedError(
                        f"solver stream to {self.address} out of credits",
                        retry_after=self._hint, kind="credits",
                    )
                self._credits -= 1
            self._corr += 1
            corr = self._corr
            fut: futures.Future = futures.Future()
            self._pending[corr] = (fut, spend_credit)
            out = self._out
        try:
            out.put(pack_stream_msg(msg_type, corr, payload))
        except Exception:
            with self._mu:
                self._pending.pop(corr, None)
                if spend_credit:
                    self._credits += 1
            raise
        return fut

    def solve(self, frame: bytes) -> futures.Future:
        """Dispatch one solve frame; the future resolves to the response
        frame (out of order with other solves). Raises
        :class:`StreamUnavailable` (go unary) or ``OverloadedError``
        (``kind="credits"``)."""
        return self._send(MSG_SOLVE, frame, spend_credit=True)

    def solve_shm(self, frame: bytes) -> futures.Future:
        return self._send(MSG_SOLVE_SHM, frame, spend_credit=True)

    def open(self, frame: bytes) -> futures.Future:
        """A session open over the stream (the NEEDS_CATALOG re-open rides
        the same transport as the solves); it spends no credit."""
        return self._send(MSG_OPEN, frame, spend_credit=False)

    def write_arena(self, arrays: Sequence[np.ndarray]):
        """``(token, descriptor)`` when the arena can carry these arrays
        right now, else None (the caller sends an inline frame)."""
        if not self.shm_active:
            return None
        with self._mu:
            arena = self._arena
        if arena is None:
            return None
        return arena.write(arrays)

    def free_arena(self, token: int) -> None:
        with self._mu:
            arena = self._arena
        if arena is not None:
            arena.free(token)

    def credits_available(self) -> int:
        with self._mu:
            return self._credits

    def close(self) -> None:
        with self._mu:
            self._state = "closed"
            pending = [fut for fut, _ in self._pending.values()]
            self._pending.clear()
            arena = self._arena
            self._arena = None
        for fut in pending:
            if not fut.done():
                fut.set_exception(StreamBrokenError("stream client closed"))
        # the outgoing generator sees "closed" on its next bounded get
        if arena is not None:
            arena.close()
