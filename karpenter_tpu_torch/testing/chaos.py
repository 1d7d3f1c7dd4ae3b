"""Chaos injection for the solver sidecar.

``ChaosPolicy`` + ``chaos_wrap`` turn a ``SolverService`` (or any object
with the methods in ``CHAOS_METHODS``) into a misbehaving dependency:

- a per-call **error probability**, some of the injected errors throttles;
- an **injected latency**: an exponential draw calibrated by its p95 and
  capped, plus a deterministic ``latency_floor`` (the pipeline tests need
  a known in-flight time to hide host work under);
- **blackouts**: windows in which every wrapped call fails;
- **silent data corruption** of the wire frames (``CORRUPT_METHODS``):
  a bit flip, a truncation, a stale session echo, a garbled delta epoch or
  a NaN in the result, the last three with the checksum recomputed;
- a **seeded RNG**, drawn in the reference package's order, so a seeded
  policy makes the same decisions and corrupts the same bytes as the
  reference's; and per-method counters, so a test can assert that chaos
  fired.

Anything else passes through unwrapped. ``SidecarChaos`` runs a few
in-process sidecars with kill and restart controls.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

# the calls chaos applies to: the solver sidecar's three, and the cloud
# control plane's, kept by name so a policy reads as the reference's
# (nothing of this package serves them). solve_stream_group is the
# streamed dispatch: without it a latency floor would slow unary solves
# while streamed ones sailed through
CHAOS_METHODS = frozenset({
    "describe_instance_types", "describe_subnets", "describe_security_groups",
    "ensure_launch_template", "delete_launch_template", "create_fleet",
    "describe_instances", "terminate_instances", "poll_disruptions",
    "create_node_pool", "delete_node_pool", "delete_instance",
    "solve_bytes", "open_session_bytes", "solve_stream_group",
})

# the byte-level corruption surface: the solver wire only
CORRUPT_METHODS = frozenset({"solve_bytes", "open_session_bytes"})

# the corruption modes:
# - bit_flip: one random bit of the request or response frame;
# - truncate: the frame cut short mid-array;
# - stale_session: the response's echoed session key swapped, checksum
#   recomputed: only the client's session guard can reject it;
# - nan_inject: NaN over the first result word, checksum recomputed: only
#   the host screen or the canary can catch it;
# - stale_delta: a delta request's epoch words garbled, checksum
#   recomputed: only the sidecar's epoch recompute can refuse it.
CORRUPTION_MODES = ("bit_flip", "truncate", "stale_session", "nan_inject", "stale_delta")

# exponential p95 = mean * ln(20); invert to calibrate the mean from a p95
_LN20 = 2.9957322735539909


class ChaosError(RuntimeError):
    """A failure the chaos policy injected into a wrapped call."""


class ChaosThrottle(ChaosError):
    """An injected throttle (a 429's shape), with its retry-after hint."""

    def __init__(self, retry_after: float = 0.01):
        super().__init__(f"chaos: throttled (retry after {retry_after}s)")
        self.retry_after = retry_after


class ChaosCapacityError(ChaosError):
    """An injected insufficient-capacity answer of ``create_fleet``,
    carrying the overrides it refused."""

    def __init__(self, message: str, overrides=()):
        super().__init__(message)
        self.overrides = list(overrides)


@dataclass(frozen=True)
class ChaosWindow:
    """Half-open [start, end) window in seconds since the policy armed."""

    start: float
    end: float

    def contains(self, t: float) -> bool:
        return self.start <= t < self.end


@dataclass
class ChaosPolicy:
    """What misbehavior to inject, and how much."""

    error_rate: float = 0.0          # per-call failure probability
    latency_p95: float = 0.0         # seconds; 0 = no injected latency
    # deterministic per-call latency (seconds), added before any draw
    latency_floor: float = 0.0
    throttle_fraction: float = 0.25  # this share of injected errors throttle
    ice_storms: Sequence[ChaosWindow] = ()
    blackouts: Sequence[ChaosWindow] = ()
    seed: int = 0
    # restrict chaos to these methods (None = every CHAOS_METHODS member)
    methods: Optional[frozenset] = None
    # cap one latency sample at this many p95s
    latency_cap_factor: float = 4.0
    # corruption (CORRUPT_METHODS only): per-call probability, and the
    # modes drawn from
    corrupt_rate: float = 0.0
    corruption_modes: Sequence[str] = CORRUPTION_MODES

    def applies_to(self, method: str) -> bool:
        if method not in CHAOS_METHODS:
            return False
        return self.methods is None or method in self.methods

    def corrupt_applies_to(self, method: str) -> bool:
        if method not in CORRUPT_METHODS:
            return False
        return self.methods is None or method in self.methods


class ChaosProxy:
    """Wraps a delegate with a :class:`ChaosPolicy`: calls to its methods
    in ``CHAOS_METHODS`` (and ``CORRUPT_METHODS``) are intercepted, the
    rest proxies through, so a wrapped ``SolverService`` still serves
    ``service.serve``."""

    def __init__(self, delegate, policy: ChaosPolicy, clock=time.monotonic):
        self._delegate = delegate
        self.policy = policy
        self._clock = clock
        self._t0 = clock()
        # one lock around the RNG: chaos fires from several threads, and a
        # seeded run must keep its draw sequence
        self._rng = random.Random(policy.seed)
        self._rng_mu = threading.Lock()
        self.injected: Dict[str, int] = {}   # method -> injected failures
        self.delayed: Dict[str, int] = {}    # method -> latency injections
        self.corrupted: Dict[str, int] = {}  # corruption mode -> injections
        self.calls: Dict[str, int] = {}      # method -> corruptible calls
        self._count_mu = threading.Lock()

    def _note(self, table: Dict[str, int], method: str) -> None:
        with self._count_mu:
            table[method] = table.get(method, 0) + 1

    def injected_total(self) -> int:
        with self._count_mu:
            return sum(self.injected.values())

    def corrupted_total(self) -> int:
        with self._count_mu:
            return sum(self.corrupted.values())

    def calls_total(self, method: str = "solve_bytes") -> int:
        with self._count_mu:
            return self.calls.get(method, 0)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def __getattr__(self, name: str):
        attr = getattr(self._delegate, name)
        corruptible = callable(attr) and name in CORRUPT_METHODS
        if not callable(attr) or (not self.policy.applies_to(name) and not corruptible):
            return attr

        def chaotic(*args, **kwargs):
            if name in CORRUPT_METHODS:
                self._note(self.calls, name)
            if self.policy.applies_to(name):
                self._maybe_disturb(name, args)
            mode = seed = None
            request_side = False
            if self.policy.corrupt_rate > 0 and self.policy.corrupt_applies_to(name):
                with self._rng_mu:
                    if self._rng.random() < self.policy.corrupt_rate:
                        mode = self._rng.choice(list(self.policy.corruption_modes))
                        # a bit flip hits either direction; stale_delta is
                        # request-side (the delta header rides the request);
                        # the other modes corrupt the response
                        request_side = mode == "stale_delta" or (
                            mode == "bit_flip" and self._rng.random() < 0.5
                        )
                        seed = self._rng.randrange(2**31)
            if mode is not None and request_side:
                self._note(self.corrupted, mode)
                return attr(corrupt_frame(args[0], mode, seed), *args[1:], **kwargs)
            out = attr(*args, **kwargs)
            if mode is not None:
                self._note(self.corrupted, mode)
                out = corrupt_frame(out, mode, seed)
            return out

        return chaotic

    def _maybe_disturb(self, method: str, args: tuple) -> None:
        now = self.elapsed()
        policy = self.policy
        with self._rng_mu:
            roll = self._rng.random()
            throttle = self._rng.random() < policy.throttle_fraction
            delay = 0.0
            if policy.latency_p95 > 0.0:
                delay = min(
                    self._rng.expovariate(_LN20 / policy.latency_p95),
                    policy.latency_p95 * policy.latency_cap_factor,
                )
        delay += policy.latency_floor
        if delay > 0.0:
            self._note(self.delayed, method)
            time.sleep(delay)
        if any(w.contains(now) for w in policy.blackouts):
            self._note(self.injected, method)
            raise ChaosError(f"chaos blackout: {method} unavailable")
        if method == "create_fleet" and any(w.contains(now) for w in policy.ice_storms):
            self._note(self.injected, method)
            overrides = [
                (args[0], it, zone) for (_lt, it, zone) in (args[1] if len(args) > 1 else [])
            ]
            raise ChaosCapacityError("chaos ICE storm: all pools exhausted", overrides=overrides)
        if roll < policy.error_rate:
            self._note(self.injected, method)
            if throttle:
                raise ChaosThrottle(retry_after=0.01)
            raise ChaosError(f"chaos: injected {method} failure")


def chaos_wrap(delegate, policy: ChaosPolicy, clock=time.monotonic) -> ChaosProxy:
    """Wrap ``delegate`` (a ``SolverService``, or anything with the methods
    in ``CHAOS_METHODS``) in a chaos proxy; the result goes wherever the
    bare object went, ``service.serve(..., service=...)`` included."""
    return ChaosProxy(delegate, policy, clock=clock)


# ---------------------------------------------------------------------------
# corruption: each mode is a pure seeded function of one wire frame
# ---------------------------------------------------------------------------


def corrupt_frame(frame: bytes, mode: str, seed: int) -> bytes:
    """``frame`` corrupted by ``mode`` from ``seed`` (anything that is not
    a frame passes through)."""
    if not isinstance(frame, (bytes, bytearray)):
        return frame
    fn = {
        "truncate": _truncate, "stale_session": _stale_session,
        "nan_inject": _nan_inject, "stale_delta": _stale_delta,
    }.get(mode, _bit_flip)
    return fn(bytes(frame), seed)


def _bit_flip(frame: bytes, seed: int) -> bytes:
    """Flip one random bit past the magic and version words (those fail
    loudly on their own and prove nothing about the checksum layer)."""
    rng = random.Random(seed)
    if len(frame) <= 8:
        return frame
    out = bytearray(frame)
    out[rng.randrange(8, len(out))] ^= 1 << rng.randrange(8)
    return bytes(out)


def _truncate(frame: bytes, seed: int) -> bytes:
    rng = random.Random(seed)
    if len(frame) <= 5:
        return frame[:1]
    return frame[:rng.randrange(4, len(frame))]


def _reframe(frame: bytes, seed: int, patch) -> bytes:
    """Parse ``frame``, let ``patch(rng, arrays)`` rewrite one array in
    place (True when it found its target), and re-frame it with the
    checksum recomputed when it had one. A frame that does not parse, or
    has no target, gets a bit flip."""
    import numpy as np

    from karpenter_tpu_torch.solver import service

    rng = random.Random(seed)
    try:
        arrays = service.unpack_arrays(frame)
    except Exception:
        return _bit_flip(frame, seed)
    had_checksum = bool(arrays) and service.is_checksum_array(arrays[-1])
    arrays = [np.array(a) for a in arrays if not service.is_checksum_array(a)]
    if not patch(rng, arrays):
        return _bit_flip(frame, seed)
    out = service.pack_arrays(arrays)
    return service.append_checksum(out) if had_checksum else out


def _stale_session(frame: bytes, seed: int) -> bytes:
    """Swap the echoed session key (the i32[4] after the status) for a
    random one: a wrong-catalog response that passes every byte check."""
    import numpy as np

    def patch(rng, arrays):
        for i, a in enumerate(arrays):
            if i > 0 and a.dtype == np.int32 and a.ndim == 1 and a.size == 4:
                arrays[i] = np.frombuffer(bytes(rng.randrange(256) for _ in range(16)), np.int32)
                return True
        return False

    return _reframe(frame, seed, patch)


def _stale_delta(frame: bytes, seed: int) -> bytes:
    """Garble the epoch words of a delta request's i32[10] header (kind and
    row count kept, so it still parses as a delta): a missed or
    misordered delta's shape on the wire."""
    import numpy as np

    from karpenter_tpu_torch.solver import service

    def patch(rng, arrays):
        for i, a in enumerate(arrays):
            if i > 1 and a.dtype == np.int32 and a.ndim == 1 and a.size == service.DELTA_HEADER_WORDS:
                a[2:] = np.frombuffer(bytes(rng.randrange(256) for _ in range(32)), np.int32)
                return True
        return False

    return _reframe(frame, seed, patch)


def _nan_inject(frame: bytes, seed: int) -> bytes:
    """Write the f32 NaN bit pattern over the first word of the fused result
    buffer (the one large i32 array): a well-framed, checksum-valid pack
    computed wrong, as device corruption would be."""
    import numpy as np

    def patch(rng, arrays):
        for i, a in enumerate(arrays):
            if i > 0 and a.dtype == np.int32 and a.ndim == 1 and a.size > 16:
                a.reshape(-1)[0] = np.float32(np.nan).view(np.int32)
                return True
        return False

    return _reframe(frame, seed, patch)


# ---------------------------------------------------------------------------
# a pool of in-process sidecars
# ---------------------------------------------------------------------------


class SidecarChaos:
    """In-process solver sidecars with kill and restart controls.

    ``kill`` stops a member's gRPC server with no grace: in-flight calls
    fail as a killed pod's would. ``restart`` serves the same address again
    with a fresh ``SolverService`` (an empty session store), so clients hit
    ``NEEDS_CATALOG`` and recover. ``policies`` (member index →
    :class:`ChaosPolicy`), or ``restart``'s ``policy``, wraps that member
    in a chaos proxy, kept in ``proxies``. ``device`` is where the members
    solve: the card unless the caller asks for the CPU."""

    def __init__(
        self,
        n: int = 2,
        max_workers: int = 4,
        policies: Optional[Dict[int, ChaosPolicy]] = None,
        device="cuda",
    ):
        from karpenter_tpu_torch.solver.service import serve

        self._serve = serve
        self._max_workers = max_workers
        self._device = device
        self.servers: Dict[str, object] = {}
        self.proxies: Dict[str, ChaosProxy] = {}
        self.addresses: list = []
        for i in range(n):
            address = f"127.0.0.1:{self._free_port()}"
            self.addresses.append(address)
            self.servers[address] = self._serve_member(address, (policies or {}).get(i))

    def _serve_member(self, address: str, policy: Optional[ChaosPolicy]):
        from karpenter_tpu_torch.solver.service import SolverService

        service = SolverService(device=self._device)
        if policy is not None:
            service = chaos_wrap(service, policy)
            self.proxies[address] = service
        else:
            self.proxies.pop(address, None)
        return self._serve(address, max_workers=self._max_workers, service=service)

    @staticmethod
    def _free_port() -> int:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    @property
    def address_spec(self) -> str:
        """The comma-joined pool address a scheduler takes."""
        return ",".join(self.addresses)

    def busiest(self) -> str:
        """The member holding the most sessions: killing it (not a cold
        spare) is what exercises failover and re-upload."""
        return max(self.servers, key=lambda a: self.servers[a].solver_service.session_count())

    def kill(self, address: str) -> None:
        server = self.servers.pop(address, None)
        if server is not None:
            server.stop(grace=0)

    def restart(self, address: str, policy: Optional[ChaosPolicy] = None) -> None:
        """A fresh sidecar on the same address: an empty session store,
        ready at once; ``policy`` puts it behind a chaos proxy."""
        self.kill(address)
        self.servers[address] = self._serve_member(address, policy)

    def stop_all(self) -> None:
        for address in list(self.servers):
            self.kill(address)
