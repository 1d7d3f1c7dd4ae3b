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
in-process sidecars with kill and restart controls; ``ReplicaChaos``
crashes controller replicas of a sharded fleet without releasing their
shard leases. ``LaunchCrash`` and
``LaunchCrashCluster`` simulate a replica dying between the launch path's
writes (cloud create → Node object → bind). ``ArrivalPattern`` compiles a
seeded diurnal + flash-crowd pod-arrival schedule (the forecast storm's
demand), bit for bit the reference's for the same seed. ``ApiServerChaos``
wraps the in-repo Kubernetes API server (``kube/testserver.py``): seeded
503s, 429s with ``Retry-After``, latency and blackout windows that drop the
connection, drawn in the reference's order.
"""

from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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
# control-plane partition scenarios (docs/partition.md): the KUBE apiserver
# misbehaving — the one dependency every subsystem shares
# ---------------------------------------------------------------------------


class ApiServerChaos:
    """Chaos for the Kubernetes control plane: wraps ``TestApiServer``
    (``TestApiServer(chaos=...)`` or ``server.chaos = ...``) so every REST
    request — reads, writes, lease renewals, watch connects — can be
    seeded-randomly failed, throttled, slowed, or dropped:

    - **error_rate**: per-request probability of an injected 503 (a
      browning-out apiserver), optionally overridden per HTTP verb
      (``per_verb={"PATCH": 0.5}``);
    - **throttle_rate**: probability of a 429 WITH a ``Retry-After``
      header — the signal the transport's backoff must honor;
    - **latency_floor / latency_p95**: server-side delay (deterministic
      floor + exponential tail capped at 4x p95);
    - **blackout windows**: the connection is dropped without a response
      (the client sees ``RemoteDisconnected`` — a real partition's shape,
      not a polite error document). ``blackout(seconds)`` opens a window
      starting now; ``blackouts`` pre-seeds windows relative to arming.

    Counters (``injected``/``throttled``/``dropped``/``delayed`` by verb)
    let tests assert chaos actually fired; the RNG is seeded and drawn
    under a lock so a storm's draw SEQUENCE is reproducible."""

    def __init__(
        self,
        error_rate: float = 0.0,
        throttle_rate: float = 0.0,
        retry_after: float = 0.25,
        latency_p95: float = 0.0,
        latency_floor: float = 0.0,
        blackouts: Sequence[ChaosWindow] = (),
        per_verb: Optional[Dict[str, float]] = None,
        seed: int = 0,
        clock=time.monotonic,
    ):
        import random

        self.error_rate = error_rate
        self.throttle_rate = throttle_rate
        self.retry_after = retry_after
        self.latency_p95 = latency_p95
        self.latency_floor = latency_floor
        self.blackouts = list(blackouts)
        self.per_verb = dict(per_verb or {})
        self._clock = clock
        self._t0 = clock()
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.injected: Dict[str, int] = {}   # verb -> injected 503s
        self.throttled: Dict[str, int] = {}  # verb -> injected 429s
        self.dropped: Dict[str, int] = {}    # verb -> blackout drops
        self.delayed: Dict[str, int] = {}    # verb -> latency injections
        # verb -> remaining forced failures (fail_next): the deterministic
        # "exactly the next N requests fail" primitive retry tests need —
        # probabilistic rates make "retried then succeeded" flaky
        self._forced: Dict[str, int] = {}

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def blackout(self, seconds: float) -> ChaosWindow:
        """Open a blackout window starting NOW (storm legs phase these)."""
        now = self.elapsed()
        window = ChaosWindow(now, now + seconds)
        with self._mu:
            self.blackouts.append(window)
        return window

    def in_blackout(self) -> bool:
        now = self.elapsed()
        with self._mu:
            return any(w.contains(now) for w in self.blackouts)

    def _note(self, table: Dict[str, int], verb: str) -> None:
        with self._mu:
            table[verb] = table.get(verb, 0) + 1

    def counts(self, table: Dict[str, int]) -> int:
        with self._mu:
            return sum(table.values())

    def fail_next(self, verb: str, n: int = 1) -> None:
        """Force exactly the next ``n`` requests of ``verb`` to answer 503
        (counted in ``injected``) regardless of rates — the deterministic
        arm for proving a retry ladder recovers."""
        with self._mu:
            self._forced[verb] = self._forced.get(verb, 0) + n

    def intercept(self, handler, method: str, path: str) -> bool:
        """Chaos disposition for one request. Returns True when the chaos
        layer handled it (sent an error / dropped the connection) and the
        real handler must not run."""
        with self._mu:
            roll = self._rng.random()
            throttle_roll = self._rng.random()
            forced = self._forced.get(method, 0) > 0
            if forced:
                self._forced[method] -= 1
            delay = self.latency_floor
            if self.latency_p95 > 0.0:
                delay += min(
                    self._rng.expovariate(_LN20 / self.latency_p95),
                    self.latency_p95 * 4.0,
                )
        if delay > 0.0:
            self._note(self.delayed, method)
            time.sleep(delay)
        if self.in_blackout():
            # a partition, not a polite error: drop the connection without
            # a response — the client sees RemoteDisconnected/reset
            self._note(self.dropped, method)
            handler.close_connection = True
            try:
                import socket as _socket

                handler.connection.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            return True
        if forced or roll < self.per_verb.get(method, self.error_rate):
            self._note(self.injected, method)
            handler._send_json(503, {
                "apiVersion": "v1", "kind": "Status", "status": "Failure",
                "code": 503, "reason": "ServiceUnavailable",
                "message": "chaos: injected apiserver failure",
            })
            return True
        if throttle_roll < self.throttle_rate:
            self._note(self.throttled, method)
            handler._send_json(
                429,
                {
                    "apiVersion": "v1", "kind": "Status", "status": "Failure",
                    "code": 429, "reason": "TooManyRequests",
                    "message": "chaos: apiserver brownout",
                },
                headers={"Retry-After": f"{self.retry_after:g}"},
            )
            return True
        return False


# ---------------------------------------------------------------------------
# crash-consistency scenarios: kill a replica
# between the launch path's three writes (cloud create → Node object → bind)
# ---------------------------------------------------------------------------


class LaunchCrash(BaseException):
    """Simulated process death at an armed launch-path point.

    Deliberately a ``BaseException``: the provisioning worker's launch and
    run loops contain ``Exception`` (a failed launch requeues its pods and
    the loop continues), but a CRASH kills the thread outright — nothing
    runs after the armed point, exactly like a SIGKILL between two writes.
    The journal entry the launch recorded beforehand is the only survivor.
    """


class LaunchCrashCluster:
    """Cluster proxy that simulates a replica dying mid-launch.

    Wraps the (shared) cluster a runtime is built over and intercepts the
    Node write the launch path makes; everything else proxies through, so
    the OTHER replicas of a fleet scenario keep using the bare cluster.

    Armable one-shot points, named for the launch path's crash windows:

    - ``before_node_write`` — the cloud create committed (instance exists,
      token stamped, journal entry in ``intent``) but the Node object was
      never written: the orphan the GC sweep must ADOPT.
    - ``after_node_write`` — the Node object landed but no pod was bound
      (journal entry still unresolved): recovery must confirm the Node
      already tracks the instance and resolve, with the pods re-entering
      selection on their own.
    """

    POINTS = ("before_node_write", "after_node_write")

    def __init__(self, cluster):
        self._cluster = cluster
        self._mu = threading.Lock()
        self._armed: Optional[str] = None  # guarded-by: self._mu
        self.crashes: Dict[str, int] = {}  # point -> fired count; guarded-by: self._mu
        # point -> node/instance name the interrupted write was for — the
        # scenario's authoritative handle on WHICH instance was orphaned
        # (scanning the provider for "newest untracked instance" would race
        # the other replicas' healthy in-flight launches)
        self.crash_nodes: Dict[str, str] = {}  # guarded-by: self._mu
        # set when an armed crash fires — the scenario's cue to kill the
        # replica whose launch thread just died
        self.crashed = threading.Event()

    def arm(self, point: str) -> None:
        if point not in self.POINTS:
            raise ValueError(f"unknown crash point {point!r}")
        with self._mu:
            self._armed = point
        self.crashed.clear()

    def _maybe_crash(self, point: str, node_name: str) -> None:
        with self._mu:
            if self._armed != point:
                return
            self._armed = None
            self.crashes[point] = self.crashes.get(point, 0) + 1
            self.crash_nodes[point] = node_name
        self.crashed.set()
        raise LaunchCrash(f"simulated crash {point} (node {node_name})")

    def create(self, kind: str, obj):
        if kind == "nodes":
            self._maybe_crash("before_node_write", obj.metadata.name)
        out = self._cluster.create(kind, obj)
        if kind == "nodes":
            self._maybe_crash("after_node_write", obj.metadata.name)
        return out

    def __getattr__(self, name: str):
        return getattr(self._cluster, name)


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


class ReplicaChaos:
    """Controller-replica kill/restart over a shared cluster + lease set.

    Replicas are ``main.Runtime`` objects (each with a ``fleet.ShardManager``).
    ``kill`` is a CRASH: the shard manager dies without releasing its
    leases, so survivors must wait out the lease duration and take the dead
    replica's shards over — the rebalance-on-death path the acceptance
    criteria time-bound to 2x the lease duration."""

    def __init__(self):
        self.replicas: Dict[str, object] = {}
        self.killed: Dict[str, object] = {}

    def add(self, name: str, runtime) -> None:
        self.replicas[name] = runtime

    def kill(self, name: str) -> None:
        runtime = self.replicas.pop(name)
        self.killed[name] = runtime
        if runtime.ownership is not None:
            runtime.ownership.crash()  # no lease release: a real SIGKILL
        runtime.stop()

    def owner_named(self, shard: str):
        """(replica name, runtime) currently owning ``shard`` among the
        LIVE replicas, or (None, None)."""
        for name, runtime in self.replicas.items():
            if runtime.ownership is not None and runtime.ownership.owns(shard):
                return name, runtime
        return None, None

    def owned_shards(self) -> Dict[str, frozenset]:
        return {
            name: frozenset(rt.ownership.owned())
            for name, rt in self.replicas.items()
            if rt.ownership is not None
        }

    def stop_all(self) -> None:
        for name in list(self.replicas):
            self.replicas.pop(name).stop()


class ArrivalPattern:
    """Seeded diurnal + flash-crowd pod-arrival generator.

    The forecast-storm bench leg and the forecaster tests need a demand
    shape with both of the signals predictive provisioning exists for: a
    smooth periodic baseline the seasonal model can learn, and sudden
    flash crowds that punish purely-reactive provisioning with a full
    cold launch-to-ready tail. ``schedule(duration_s)`` compiles the
    whole run up front into ``[(t_offset_s, n_pods), ...]`` ticks —
    reproducible bit-for-bit from the seed, so a bench regression replays
    the exact same storm.

    The baseline is a sinusoid (one ``period_s`` = one compressed "day"),
    Poisson-ish jittered per tick; each flash crowd is a burst of
    ``flash_pods`` spread over ``flash_len_s`` starting at its offset."""

    def __init__(
        self,
        base_pods_per_tick: float = 4.0,
        amplitude: float = 0.75,
        period_s: float = 240.0,
        tick_s: float = 5.0,
        flash_at: Sequence[float] = (),
        flash_pods: int = 40,
        flash_len_s: float = 15.0,
        seed: int = 0,
    ):
        self.base = float(base_pods_per_tick)
        self.amplitude = min(max(float(amplitude), 0.0), 1.0)
        self.period_s = float(period_s)
        self.tick_s = float(tick_s)
        self.flash_at = tuple(float(t) for t in flash_at)
        self.flash_pods = int(flash_pods)
        self.flash_len_s = float(flash_len_s)
        self.seed = int(seed)

    def in_flash(self, t: float) -> bool:
        """True when offset ``t`` falls inside a flash-crowd window —
        how the bench separates the spike tail from the baseline."""
        return any(
            start <= t < start + self.flash_len_s for start in self.flash_at
        )

    def rate_at(self, t: float) -> float:
        """The noiseless diurnal baseline (pods per tick) at offset ``t``
        — what a perfect seasonal forecaster would predict."""
        phase = 2.0 * math.pi * (t / self.period_s)
        return self.base * (1.0 + self.amplitude * math.sin(phase))

    def schedule(self, duration_s: float) -> List[Tuple[float, int]]:
        """``[(t_offset_s, n_pods), ...]`` ticks covering ``duration_s``,
        flash bursts folded in. Zero-pod ticks are kept: silence is
        signal to the forecaster (rates must decay, not freeze)."""
        rng = random.Random(self.seed)
        ticks: List[Tuple[float, int]] = []
        t = 0.0
        while t < duration_s:
            lam = max(self.rate_at(t), 0.0)
            # cheap Poisson-ish draw: uniform jitter of +-50% keeps the
            # variance the EWMA band must cover without scipy
            n = int(round(lam * (0.5 + rng.random())))
            ticks.append((t, max(n, 0)))
            t += self.tick_s
        for start in self.flash_at:
            if start >= duration_s:
                continue
            burst_ticks = max(int(self.flash_len_s / self.tick_s), 1)
            per_tick = max(self.flash_pods // burst_ticks, 1)
            for i in range(burst_ticks):
                at = start + i * self.tick_s
                if at >= duration_s:
                    break
                ticks.append((at, per_tick))
        ticks.sort(key=lambda p: p[0])
        return ticks

    def total_pods(self, duration_s: float) -> int:
        return sum(n for _, n in self.schedule(duration_s))
