"""TorchScheduler: the GPU-backed solve path.

Same contract as ``FFDScheduler.solve``: sort, inject topology, encode to
dense arrays, run the packing kernel, decode virtual nodes, validate them.
Stage order and profile keys follow the reference package's ``solver: tpu``
backend:

    sort → inject → encode → pack (begin) → fetch → split → decode → validate

**Routing** (``_pack``). ``KARPENTER_PACKER`` is read once per solve. On
the card, ``auto`` (the default) and ``fused`` take the device path: the
port keeps a CUDA scheduler's pack on the card. On a ``device="cpu"``
scheduler, where both contenders run on the host, ``auto`` routes by
MEASURED cost between the device path (the plain versions) and the
in-process native C++ packer (``native.py``), through the process-shared
``router.default_router()``: every candidate is tried once per shape class
(``_route_key``), then each solve takes the lower EMA of end-to-end pack
time. A backend that raises records ``router.FAILURE_PENALTY_S``; a failed
native pack is served by the device path. Every ``probe_every``-th solve of
a class re-measures the losing backend on a daemon thread
(``_shadow_probe``). ``pallas``, ``scan`` and ``native`` force a rung of the
unfused ladder (``pack_unfused``) on either device.

**The device path** (``_pack_device``). The fused route is one dispatch
(one compact upload, one kernel, one flat buffer back): ``fused.fused_solve``
over ``pack_first_fit`` (route ``v1``) or, for constraint-diverse batches
whose per-core join tables fit the card's budget, ``fused.fused_solve_v2``
over ``pack_first_fit_v2`` (route ``v2``; ``pack_kernel_v2.fused_route``).
It starts at ``min(P, 512)`` slots. Batches the fused route cannot take —
ids past the compact int16 table, a shape whose fused solve failed (the
failed-fused memo), or ``KARPENTER_PACKER`` not ``auto``/``fused`` — take
the unfused ladder (``pack_unfused`` over the ``pack_args()`` tensors) at
``max(256, P // 4)`` slots. A saturated node table retries once
at ``P`` slots, the route re-derived. Begin launches the work, queues a
``non_blocking`` copy of the result buffer into pinned host memory and
records a CUDA event; finish waits on that event. The profile names what
served (``packer_backend``: ``pack_first_fit``, ``pack_first_fit_v2``, on
the CPU their plain versions ``pack_reference`` / ``pack_v2_reference``, or
``native``) and which caller ran it (``pack_route``: ``fused``,
``unfused``, or ``native`` for the router's native backend). On CUDA
tensors no path ends in a plain version or in native unless
``KARPENTER_PACKER`` asks for it.

**The degrade ladder** (``solve``), in the reference's order. Each trigger
is met when the accelerated path failed a batch or answered it wrongly:

- the signature closure overflows twice (the cache-clearing retry
  included): nothing is recorded;
- the shape class's pack breaker (``_pack_breakers``, one per
  ``_route_key``) is open: no pack is attempted;
- the pack raises at begin or at finish (on the card: both kernels
  failed): one failure on the breaker;
- the NaN/bounds screen (``integrity.screen_result``) fails over the raw
  host result, or the decoded plan fails ``_validate_pack``: the shape
  class is quarantined (``_quarantine_source``: its breaker tripped, the
  integrity counter bumped, an ``IntegrityQuarantine`` Warning event).

Each such round logs at ERROR (with the traceback where an exception
caused it; the reference logs the overflow at WARNING and the open breaker
not at all). Then a ``device="cpu"`` scheduler serves the batch from the
host FFD floor (``_ffd_degrade``), as the reference does: ``packer_backend``
is ``ffd-degraded``, or absent after an overflow. A card scheduler has no
floor: it raises (``SignatureOverflow``, ``BreakerOpen``, the pack's own
exception, ``InvalidPackError``), so a kernel that fails or answers wrongly
shows as a failed round, never as a slower plan made on the host. A valid
plan served by a kernel or its plain version is re-solved, at
``canary_rate``, by the native packer on a daemon thread
(``_maybe_canary``); a disagreement quarantines the shape class, so its
next round meets the open breaker.

**The sidecar** (``service_address``, the reference's
``--solver-service-address``). While a sidecar is configured and its
breaker admits calls, the sidecar owns the card: no fused route is taken
in process, and each unfused dispatch ships the batch's host arrays
(``pack_args()``) to the sidecar over the v3 wire
(``service.RemoteSolver``); ``packer_backend`` is ``sidecar`` and
``solver_address`` names it. A failed sidecar opens its breaker
(``_remote_breaker``) and the batch packs in process (the kernel ladder on
a card scheduler, the host rungs on a cpu one); an overloaded one packs in
process without touching the breaker; a corrupt exchange (an
``IntegrityError``) trips it. A shed for the round's deadline
(``DeadlineExceededError``) moves no breaker: a cpu scheduler serves the
batch from the floor, a card scheduler raises. A screen failure, an
invalid plan or a canary mismatch on a sidecar round quarantines the
sidecar (its breaker tripped). A comma-separated address is a pool
(``pool.SolverPool``): members chosen by the session key's hash ring,
each with its own breaker and quarantine (an ``IntegrityQuarantine``
event through ``_integrity_event``), failover along the ring; the outer
breaker moves only when the whole pool refused. ``solver_stream`` and
``solver_shm_dir`` (env ``KARPENTER_SOLVER_STREAM`` and
``KARPENTER_SOLVER_SHM_DIR``) put the sidecar's solves on the persistent
stream and its shared-memory arena.

**The solve lock** (``_solve_lock``) covers the host prepare stages
(inject, encode), the pack breaker's check and the pack's non-blocking
begin, and publishes ``last_profile``. The fetch, the screen, the decode,
the validation and the canary run outside it, so a second thread's encode
overlaps the first one's pack in flight, on the card or on the wire. Each
begin owns its output and its pinned staging buffer, and the kernels run
on one stream in launch order. What runs off the lock is per thread or
published as one object: the decode memo's hit flag (``_dec_tl``), the
memos (one tuple each), and ``completed_profile()``, this thread's last
finished profile (``last_completed_profile``: the latest of any thread).
A floor round after the begin takes the lock back.

**Shadow probes** (``device="cpu"`` schedulers only). A probe runs on its
own daemon thread while the next solve runs. It may touch only state that is safe to share: the batch (read
only), ``DeviceInvariants`` and the router (both locked), the two
failed-shape memos (locked) and the kernels' launch counters (unlocked: a
caller that reads them joins ``_probe_thread`` first). It never touches
``PodResidency`` (it uploads its own pod table), the decode and validation
memos, or ``last_profile`` (its profile is a throwaway dict).

**Observability** (the reference's spans, metrics and decision context).
Each stage runs inside its span — ``solve.sort``, ``solve.inject``,
``solve.encode``, ``solve.pack_begin`` (the router's choice and EMAs as
attributes), ``solve.pack_fetch``, ``solve.decode`` — under the facade's
``solver.solve``, with its prof clock inside the span. The begin only
enqueues the kernel and the fetch holds the one synchronize and copy, so
tracing adds no device work. Every degrade trigger but the overflow counts
``karpenter_solver_degraded_total{reason, address}``; the sidecar's breaker
publishes ``karpenter_solver_breaker_*``. A valid round publishes its
decision context (the batch, the assignment from the fetch's host copy,
``n_max``, route, transport, address, session key) for
``completed_decision()``; a floor round publishes ``{"route":
"ffd-degraded"}``. The constructor registers the flight recorder's
``router_ema``, ``pack_breakers_open``, ``remote_breaker``,
``session_cache`` and ``integrity`` panels.

The resident delta path (``solver_delta``, env ``KARPENTER_SOLVER_DELTA``)
keeps each stage's work across rounds, and a stage served from resident
state records its ``*_delta_s`` profile key in place of the full one:

- sort: ``ResidentEncoder.sort`` returns the cached order for the same pod
  objects (``sort_delta_s``);
- inject: a topology-free batch takes the empty plan, a topology batch
  reuses the cached injected plan while the pods, the pre-inject
  requirements and ``Cluster.version()`` stand still (``inject_delta_s``);
- encode: ``ResidentEncoder.encode``'s reuse and row-delta rungs
  (``encode_delta_s``);
- upload: ``fused.PodResidency`` reuses or column-patches the device pod
  table;
- decode: a bit-identical result for the same resident batch rebuilds the
  nodes from the previous decode's rows (``decode_delta_s``); the unfused
  and native routes bring no device typemask (``None``), and the memo
  holds the two cases apart;
- validate: skipped after such a decode when the memoized plan passed
  (``validate_delta_s``).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import metrics, obs
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.resilience import (
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
    DeadlineExceededError,
    IntegrityError,
    OverloadedError,
)
from karpenter_tpu_torch.scheduling.ffd import (
    FFDScheduler,
    VirtualNode,
    daemon_overhead,
    sort_pods_ffd_with_statics,
)
from karpenter_tpu_torch.scheduling.topology import (
    Topology,
    restore_selectors,
    snapshot_selectors,
)
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.solver import (
    fused, integrity, kernel, native, pack_kernel, pack_kernel_v2, session_stats,
)
from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
from karpenter_tpu_torch.solver.delta import ResidentEncoder
from karpenter_tpu_torch.solver.kernel import PackResult
from karpenter_tpu_torch.solver.router import default_router
from karpenter_tpu_torch.solver.signature import SignatureOverflow
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("karpenter.solver")

# first node-table size of the fused route; a saturated table retries at
# P slots (the unfused ladder, the sidecar and native start at
# max(256, P // 4))
N_MAX_FIRST = 512

# Sidecar RPC budget: a short deadline and an open circuit after a failure,
# so a dead sidecar costs one bounded stall, not one per batch.
REMOTE_SOLVE_TIMEOUT = 5.0
REMOTE_BREAKER_SECONDS = 30.0

# Per-shape-class pack breaker: two failures of a shape class open it and
# its solves meet the open breaker at once (no failure latency per batch)
# until a half-open probe finds the accelerated path healthy again.
PACK_BREAKER_WINDOW = 6
PACK_BREAKER_MIN_VOLUME = 2
PACK_BREAKER_OPEN_SECONDS = 30.0

# (P, S, F, n_max) whose fused dispatch or fetch failed — those shapes take
# the unfused ladder from then on (pack_kernel._failed_shapes is the
# ladder's own memo). Written from solve threads and a cpu scheduler's
# shadow-probe thread while other solves iterate it: snapshot and mutate
# under the lock.
_fused_failed_lock = threading.Lock()
_fused_failed_shapes: set = set()  # guarded-by: _fused_failed_lock

# kernel name per route: (on the card, plain version on the CPU)
KERNELS = {
    "v1": ("pack_first_fit", "pack_reference"),
    "v2": ("pack_first_fit_v2", "pack_v2_reference"),
}
# what the reference calls the "device" backend: a kernel or its plain
# version served the pack (never native). Such packs, and the sidecar's
# (packer_backend "sidecar"), are canaried.
DEVICE_BACKENDS = frozenset(name for pair in KERNELS.values() for name in pair)
SIDECAR = "sidecar"


def pack_unfused(*args, n_max: int, packer: str = "auto") -> Tuple[str, PackResult]:
    """The reference's ``pack_best`` rungs over ``pack_args()`` tensors →
    ``(what served, PackResult)``. ``packer`` (the solve's
    ``KARPENTER_PACKER``) forces a rung: ``native`` blocks for the native
    build and packs on the host (its result is host numpy arrays); ``scan``
    runs the plain version on the tensors' device (a force, never a
    fallback); ``pallas`` runs ``pack_first_fit`` and raises on CPU tensors,
    as the reference raises without a TPU. Otherwise CUDA tensors take the
    card's kernel ladder (``pack_kernel.pack_best``), which never ends off
    the card, and CPU tensors, as the reference without a TPU, the native
    packer when it is built (its failure falls to the plain version), else
    the plain version. ``scan``, ``pallas`` and the card's ladder also take
    the tensors with a shared leading batch axis (a coalesced group), the
    kernels in one launch."""
    if packer == "native":
        native.native_available(wait=180)  # forced: block for the g++ build
        return "native", native.pack_native(*args, n_max=n_max)
    if packer == "scan":
        batch = args[6].shape[0] if args[6].dim() == 3 else None
        return "pack_reference", pack_kernel.per_problem(
            kernel.pack_reference, args, batch, n_max=n_max)
    on_card = args[6].device.type == "cuda"
    if packer == "pallas":
        # forced means forced: no silent fallback when the card is absent
        if not on_card:
            raise RuntimeError("KARPENTER_PACKER=pallas but the tensors are not on a CUDA device")
        return "pack_first_fit", pack_kernel.pack_first_fit(*args, n_max=n_max)
    if not on_card and native.native_available():
        try:
            return "native", native.pack_native(*args, n_max=n_max)
        except Exception:
            logger.exception("native packer failed; plain version")
    return pack_kernel.pack_best(*args, n_max=n_max)


def _env_bool(key: str, default: bool = False) -> bool:
    """The boolean env contract: only the literal ``true`` (any case,
    surrounding space ignored) turns a knob on."""
    return os.environ.get(key, "true" if default else "false").strip().lower() == "true"


def _env_float(key: str, default: float = 0.0) -> float:
    """The float env contract: unset or blank is ``default``."""
    raw = os.environ.get(key, "").strip()
    return float(raw) if raw else default


def _shed_reason(e: Exception) -> str:
    """The ``karpenter_solver_degraded_total`` reason of a typed shed."""
    return "deadline" if isinstance(e, DeadlineExceededError) else "overload"


def kernel_name(route: str, device: torch.device) -> str:
    """The kernel a route runs on ``device``: the CUDA kernel on the card,
    its plain version on the CPU."""
    on_card, plain = KERNELS[route]
    return on_card if device.type == "cuda" else plain


class InvalidPackError(RuntimeError):
    """A pack result failed the integrity screen, or its decoded plan broke
    a host-checked invariant (raised on the card, which has no floor)."""


def _with_hostname(reqs, hostname: str, cache: dict):
    """``reqs.add(NodeSelectorRequirement(HOSTNAME, In, [hostname]))`` with
    the signature-invariant parts (requirements tuple, sorted sets minus the
    hostname entry, the hostname key's position and prior ValueSet) computed
    once per signature — decode runs this for every hostname-pinned node."""
    from karpenter_tpu_torch.api.requirements import Requirements
    from karpenter_tpu_torch.utils.sets import ValueSet

    hit = cache.get(id(reqs))
    if hit is None:
        items = list(reqs._sets)
        host_pos = None
        base_set = None
        for pos, (k, vs) in enumerate(items):
            if k == lbl.HOSTNAME:
                host_pos = pos
                base_set = vs
                break
        if host_pos is None:
            # insertion point that keeps the items key-sorted
            host_pos = sum(1 for k, _ in items if k < lbl.HOSTNAME)
        hit = cache[id(reqs)] = (reqs, reqs.requirements, items, host_pos, base_set)
    _, base_reqs, items, host_pos, base_set = hit
    vs = ValueSet.of(hostname)
    if base_set is not None:
        vs = vs.intersection(base_set)
        out_items = list(items)
        out_items[host_pos] = (lbl.HOSTNAME, vs)
    else:
        out_items = list(items)
        out_items.insert(host_pos, (lbl.HOSTNAME, vs))
    req = NodeSelectorRequirement(
        key=lbl.HOSTNAME, operator="In", values=[hostname]
    )
    return Requirements(base_reqs + (req,), tuple(out_items))


class TorchScheduler:
    def __init__(
        self,
        cluster: Cluster,
        rng: Optional[random.Random] = None,
        device="cuda",
        solver_delta: Optional[bool] = None,
        canary_rate: Optional[float] = None,
        service_address: Optional[str] = None,
        pack_checksum: Optional[bool] = None,
        solver_stream: Optional[bool] = None,
        solver_shm_dir: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.cluster = cluster
        # the solver sidecar (service.py), or a pool of them for a
        # comma-separated address (pool.py); None = the in-process pack
        self.service_address = service_address
        # the persistent stream toward the sidecar(s), and the shared-memory
        # arena when they share a host; None = the env twins
        self.solver_stream = (
            bool(solver_stream) if solver_stream is not None
            else _env_bool("KARPENTER_SOLVER_STREAM")
        )
        self.solver_shm_dir = (
            solver_shm_dir if solver_shm_dir is not None
            else os.environ.get("KARPENTER_SOLVER_SHM_DIR", "")
        )
        # per-frame wire checksums toward the sidecar (capability-gated);
        # None = the env twin
        self.pack_checksum = (
            bool(pack_checksum) if pack_checksum is not None
            else _env_bool("KARPENTER_PACK_CHECKSUM")
        )
        self._remote = None  # guarded-by: self._remote_init_lock
        self._remote_init_lock = threading.Lock()
        # window 1 / min_volume 1: a dead sidecar opens the breaker on ANY
        # failure and costs one bounded stall; half-open probes re-admit it
        self._remote_breaker = CircuitBreaker(
            dependency=f"solver-service:{service_address}" if service_address else "",
            window=1, min_volume=1, failure_rate=0.5,
            open_seconds=REMOTE_BREAKER_SECONDS,
        )
        # the canary cross-check rate: the fraction of kernel-served solves
        # re-solved on the native packer off the hot path and compared.
        # None = the env twin
        self.canary_rate = (
            float(canary_rate) if canary_rate is not None
            else _env_float("KARPENTER_CANARY_RATE")
        )
        # seeded so a run's canary sampling is reproducible; the rate, not
        # the sequence, is the contract
        self._canary_rng = random.Random(0xCA7A17)  # guarded-by: self._canary_lock
        self._canary_thread: Optional[threading.Thread] = None  # guarded-by: self._canary_lock
        self._canary_lock = threading.Lock()
        self.topology = Topology(cluster, rng=rng)
        # the degrade ladder's floor, sharing the topology's rng. Only a cpu
        # scheduler has one: on the card a failed or wrong pack raises
        self._floor_serves = self.device.type != "cuda"
        self._ffd_fallback = FFDScheduler(cluster, rng=rng) if self._floor_serves else None
        # per-shape-class breakers over the whole accelerated pack: a shape
        # whose pack keeps failing meets the open breaker at once instead
        # of re-paying the failure latency every solve
        self._pack_breakers = BreakerBoard(
            window=PACK_BREAKER_WINDOW,
            min_volume=PACK_BREAKER_MIN_VOLUME,
            failure_rate=0.5,
            open_seconds=PACK_BREAKER_OPEN_SECONDS,
        )
        # solve-invariant encode state (signature table, capacity matrix),
        # reused across this scheduler's batches
        self._encode_cache = enc.EncodeCache()
        self._invariants = fused.DeviceInvariants(self.device)
        # resident delta path (module docstring); None = the env twin
        self.solver_delta = (
            bool(solver_delta) if solver_delta is not None
            else _env_bool("KARPENTER_SOLVER_DELTA")
        )
        self._resident: Optional[ResidentEncoder] = None
        self._pod_residency: Optional[fused.PodResidency] = None
        if self.solver_delta:
            self._resident = ResidentEncoder(self._encode_cache)
            self._pod_residency = fused.PodResidency(self.device)
        # per-axis-vocabulary scale vectors for decode: axis_names is
        # identity-stable across steady-state solves (the trim memo), so
        # the AXIS_SCALES gather runs once per vocabulary, not per decode
        self._scales_memo: Dict[int, tuple] = {}
        # decode residency: when the SAME resident batch solves to a
        # bit-identical result under compatible constraints, the
        # VirtualNodes are rebuilt from the previous decode's derived
        # per-node rows. Decode runs off the solve lock: the memo is one
        # tuple snapshot (a losing racer pays a full decode) and the hit
        # flag is per thread
        self._dec_memo: Optional[tuple] = None
        self._dec_tl = threading.local()
        # validation memo: (decode memo generation, pods list, daemon) of
        # the last PASSED _validate_pack. A decode served from the memo is
        # bit-identical to the plan that passed; a FAILED validation never
        # arms it, so a bad result is re-checked every round no matter how
        # often the device repeats it bit for bit
        self._validate_memo: Optional[tuple] = None
        # the host stages and the pack's begin; the fetch, decode, validate
        # and canary run outside it (module docstring)
        self._solve_lock = threading.Lock()
        # per-stage timings of the most recent solve, published at its
        # begin (so possibly mid-flight)
        self.last_profile: Dict[str, float] = {}
        # the most recent completed solve's profile, published after its
        # last stage write; the thread-local holds each thread's own
        self.last_completed_profile: Dict[str, float] = {}
        self._completed_tl = threading.local()
        # the most recent completed solve's decision context (encoded batch
        # + assignment + route provenance) for the decision audit log
        # (obs/decisions.py): per thread like the profile, and consumed on
        # read so a finished round's EncodedBatch is not pinned until the
        # next solve
        self._decision_tl = threading.local()
        # measured-cost routing of a device="cpu" scheduler (router.py),
        # shared by every scheduler of the process; at most one shadow
        # probe in flight per scheduler
        self.router = default_router()
        self._probe_lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None  # guarded-by: self._probe_lock
        # flight-recorder state panels: a slow solve's record carries the
        # router's beliefs, the breaker states, the session cache and the
        # integrity counters at that moment. Re-registering a name replaces
        # the provider (the newest scheduler's view wins)
        obs.register_state("router_ema", self.router.report)
        obs.register_state("pack_breakers_open", self._pack_breakers.open_dependencies)
        obs.register_state("remote_breaker", lambda: self._remote_breaker.state)
        obs.register_state("session_cache", session_stats.snapshot)
        obs.register_state("integrity", integrity.snapshot)

    def solve(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        pods: Sequence[Pod],
    ) -> List[VirtualNode]:
        if not pods:
            return []
        prof: Dict[str, float] = {}
        try:
            return self._solve(constraints, instance_types, pods, prof)
        finally:
            # after every stage write, the floor's included; one assignment
            # each, so a reader never sees a concurrent solve's partial dict
            self.last_completed_profile = prof
            self._completed_tl.profile = prof

    def completed_profile(self) -> Dict[str, float]:
        """This thread's most recently completed solve profile (else the
        latest of any thread): what a caller sharing this scheduler with
        other threads reads."""
        prof = getattr(self._completed_tl, "profile", None)
        return dict(prof if prof is not None else self.last_completed_profile)

    def _publish_decision(self, ctx: Dict) -> None:
        from karpenter_tpu_torch.obs import decisions

        if decisions.enabled():
            self._decision_tl.ctx = ctx

    def completed_decision(self) -> Dict:
        """This thread's most recent solve's decision context, consumed on
        read (one record per round; holding the batch longer would pin it).
        {} when nothing completed since the last read, the round failed, or
        the decision plane is disabled."""
        ctx = getattr(self._decision_tl, "ctx", None)
        self._decision_tl.ctx = None
        return ctx or {}

    def _solve(self, constraints, instance_types, pods, prof: Dict[str, float]):
        # stage spans mirror the prof dict: each prof clock runs INSIDE its
        # span, so the exported tree agrees with completed_profile() to
        # within the span enter/exit slivers. Nothing inside a span waits
        # on the card: solve.pack_begin only enqueues, and solve.pack_fetch
        # holds the one synchronize and device-to-host copy
        tr = obs.tracer()
        resident = self._resident
        with tr.span("solve.sort"):
            t0 = time.perf_counter()
            constraints = constraints.clone()
            if resident is not None:
                pods, sts, sort_hit = resident.sort(pods)
            else:
                pods, sts = sort_pods_ffd_with_statics(pods)
                sort_hit = False
            instance_types = sorted(instance_types, key=lambda it: it.effective_price())
            prof["sort_delta_s" if sort_hit else "sort_s"] = time.perf_counter() - t0
        with self._solve_lock:
            # published under the lock, with the stages that write it
            self.last_profile = prof
            out = self._prepare_and_begin(constraints, instance_types, pods, sts, prof)
        if isinstance(out, list):
            return out  # the round ended before the pack was in flight
        return self._finish(*out, prof)

    def _prepare_and_begin(self, constraints, instance_types, pods, sts, prof):
        """The stages under the solve lock: inject, encode, the pack
        breaker's check and the pack's begin. Returns the finished nodes
        when the round ends here (a floor or a raise), else what
        ``_finish`` needs."""
        tr = obs.tracer()
        resident = self._resident
        # topology decisions land in the plan, never in the pods' selectors
        with tr.span("solve.inject"):
            t0 = time.perf_counter()
            topo = True
            plan_reused = False
            if resident is not None and resident.eligible(sts):
                # topology-free batch: the injected plan is empty by
                # construction, so the per-pod discovery sweep is skipped
                topo = False
                plan = resident.empty_plan(pods, sts)
                daemon = daemon_overhead(self.cluster, constraints)
            elif resident is not None:
                # topology batch: the injected round is a deterministic
                # function of (sorted batch, pre-inject constraints content,
                # cluster state); when none moved, reuse the cached
                # post-inject constraints + plan + daemon. The key is built
                # BEFORE inject mutates the constraints clone.
                pkey = resident.plan_key(constraints, self.cluster.version())
                hit = resident.plan_reuse(pkey, sts)
                if hit is not None:
                    constraints, plan, daemon = hit
                    plan_reused = True
                else:
                    plan = self.topology.inject_plan(constraints, pods, sts=sts)
                    daemon = daemon_overhead(self.cluster, constraints)
                    resident.remember_plan(pkey, sts, constraints, plan, daemon)
            else:
                plan = self.topology.inject_plan(constraints, pods, sts=sts)
                daemon = daemon_overhead(self.cluster, constraints)
            prof[
                "inject_delta_s" if (not topo or plan_reused) else "inject_s"
            ] = time.perf_counter() - t0

        def degrade() -> List[VirtualNode]:
            return self._ffd_degrade(constraints, instance_types, pods, daemon, plan)

        with tr.span("solve.encode") as enc_sp:
            t0 = time.perf_counter()
            try:
                if resident is not None:
                    batch, enc_kind = self._resident_encode(
                        constraints, instance_types, pods, sts, daemon, plan,
                        topo=topo, plan_reused=plan_reused,
                    )
                else:
                    batch = self._encode_retry(constraints, instance_types, pods, daemon, plan)
                    enc_kind = "full"
            except SignatureOverflow as e:
                enc_sp.set_attribute("signature_overflow", True)
                # as the reference: no packer_backend is recorded for the
                # round, and the floor serves inside the encode span
                return self._fail(e, prof, degrade, "signature closure overflowed",
                                  backend=None, exc_info=True)
            if enc_kind != "full":
                enc_sp.set_attribute("delta", enc_kind)
            prof["encode_delta_s" if enc_kind != "full" else "encode_s"] = (
                time.perf_counter() - t0
            )

        # the shape class's pack breaker: while open, no pack is attempted.
        # A closed (or half-open-probing) breaker sees the pack's outcome.
        breaker = self._pack_breakers.get(self._breaker_key(batch))
        if not breaker.allow():
            return self._fail(
                BreakerOpen(breaker.dependency, breaker.retry_in()), prof, degrade,
                f"pack breaker {breaker.dependency} is open", reason="breaker_open",
            )
        # begin and finish are two guarded steps, as the reference's
        # dispatch and fetch are
        # a typed shed is backpressure, not a shape failure: the breaker
        # stays as it is (an overloaded sidecar or pool packs in process,
        # so what arrives here is the round's expired deadline)
        try:
            with tr.span("solve.pack_begin"):
                t0 = time.perf_counter()
                finish = self._pack(batch, prof)
                begin_s = time.perf_counter() - t0
        except (OverloadedError, DeadlineExceededError) as e:
            return self._fail(e, prof, degrade, f"accelerated pack shed ({e})",
                              reason=_shed_reason(e))
        except Exception as e:
            breaker.record_failure()
            return self._fail(e, prof, degrade, "accelerated pack failed",
                              exc_info=True, reason="pack_failure")
        return (constraints, instance_types, pods, daemon, plan, batch, breaker, finish, begin_s)

    def _finish(self, constraints, instance_types, pods, daemon, plan, batch, breaker,
                finish, begin_s: float, prof: Dict[str, float]) -> List[VirtualNode]:
        """The stages off the solve lock: the fetch, the screen, decode,
        validation and the canary. A round that falls to the floor here
        takes the lock back (the floor shares the scheduler's state)."""
        tr = obs.tracer()

        def degrade() -> List[VirtualNode]:
            with self._solve_lock:
                return self._ffd_degrade(constraints, instance_types, pods, daemon, plan)

        try:
            with tr.span("solve.pack_fetch") as fetch_sp:
                t0 = time.perf_counter()
                result, typemask = finish()
                fetch_wait_s = time.perf_counter() - t0
                fetch_sp.set_attribute("backend", prof.get("packer_backend"))
        except (OverloadedError, DeadlineExceededError) as e:
            return self._fail(e, prof, degrade, f"accelerated pack shed ({e})",
                              reason=_shed_reason(e))
        except Exception as e:
            breaker.record_failure()
            return self._fail(e, prof, degrade, "accelerated pack failed",
                              exc_info=True, reason="pack_failure")
        # the wire's serialization is attributed apart (wire_ser_s and
        # wire_deser_s, set by the sidecar client), so pack_fetch_s is the
        # dispatch and in-flight wait alone
        prof["pack_fetch_s"] = max(
            begin_s + fetch_wait_s
            - prof.get("wire_ser_s", 0.0) - prof.get("wire_deser_s", 0.0),
            0.0,
        )

        # the NaN/bounds screen over the RAW result, before decode can
        # launder non-finite totals into a plausible-looking plan; it runs
        # on every accelerated solve, so detection never depends on the
        # sampled canary
        screen = integrity.screen_result(result, n_pods=batch.n_pods)
        address = str(prof.get("solver_address") or "")
        if screen:
            integrity.record_screen_failure(address)
            self._quarantine_source("screen", screen, batch, address=address)
            return self._fail(
                InvalidPackError(
                    f"{prof.get('packer_backend')} failed the integrity screen: {screen}"
                ),
                prof, degrade,
                f"accelerated pack failed the integrity screen ({screen}); source quarantined",
                reason="integrity_screen", address=address or "local",
            )
        breaker.record_success()

        with tr.span("solve.decode"):
            t0 = time.perf_counter()
            nodes = self._decode(batch, result, typemask, constraints, instance_types)
            dec_hit = getattr(self._dec_tl, "hit", False)
            prof["decode_delta_s" if dec_hit else "decode_s"] = time.perf_counter() - t0

        # a decode-memo hit is bit-identical to a previously decoded plan;
        # when THAT plan passed this guard (the memo is only armed on a
        # pass, and is keyed to the decode memo generation), the verdict is
        # a pure function of inputs proved unchanged — skip the re-check
        t0 = time.perf_counter()
        vmemo = self._validate_memo
        if (
            dec_hit
            and vmemo is not None
            and vmemo[0] is self._dec_memo
            and vmemo[1] is pods
            and vmemo[2] == daemon
        ):
            violation = None
            prof["validate_delta_s"] = time.perf_counter() - t0
        else:
            violation = self._validate_pack(nodes, pods, daemon)
            if violation is None:
                self._validate_memo = (self._dec_memo, pods, dict(daemon))
            prof["validate_s"] = time.perf_counter() - t0
        if violation:
            # a correctness failure: its source is quarantined at once
            self._quarantine_source("invalid_pack", violation, batch, address=address)
            return self._fail(
                InvalidPackError(
                    f"{prof.get('packer_backend')} produced an invalid plan: {violation}"
                ),
                prof, degrade,
                f"accelerated pack produced an invalid plan ({violation}); source quarantined",
                reason="invalid_pack", address=address or "local",
            )
        # the canary cross-check: a sampled fraction of kernel-served solves
        # is re-solved on the native packer off the hot path and compared —
        # the layer that catches a plausible-shaped, screen-clean wrong pack
        self._maybe_canary(batch, result, prof)
        # decision context for the audit log: the encoded batch, the served
        # assignment and the provenance. ``result`` is the host copy the
        # fetch already made; the assignment slice is copied so the result
        # buffers are not pinned through the record's life
        self._publish_decision({
            "batch": batch,
            "assignment": np.asarray(result[0])[: batch.n_pods].copy(),
            "n_max": int(np.asarray(result[1]).shape[0]),
            "route": prof.get("packer_backend"),
            "transport": prof.get("solver_transport"),
            "address": prof.get("solver_address"),
            "session_key": prof.get("session_key"),
        })
        return nodes

    @staticmethod
    def _breaker_key(batch: enc.EncodedBatch) -> str:
        return "pack:" + "x".join(map(str, TorchScheduler._route_key(batch)))

    def _fail(self, error: Exception, prof: Dict, degrade, what: str,
              backend: Optional[str] = "ffd-degraded", exc_info: bool = False,
              reason: Optional[str] = None, address: str = ""):
        """The end of every degrade trigger, after its bookkeeping: count
        ``karpenter_solver_degraded_total{reason, address}`` (every trigger
        but the overflow, as the reference), log ``what`` at ERROR, then
        serve the batch from the FFD floor on a cpu scheduler (recording
        ``backend`` as what served, None for nothing) or raise ``error`` on
        the card, leaving no decision context. ``exc_info`` from an
        ``except`` block puts the traceback in the log."""
        if reason is not None:
            metrics.SOLVER_DEGRADED.labels(reason=reason, address=address).inc()
        logger.error(
            "%s; %s", what,
            "FFD floor serves this batch" if self._floor_serves else "the round fails",
            exc_info=exc_info,
        )
        if not self._floor_serves:
            self._decision_tl.ctx = None
            raise error
        if backend is not None:
            prof["packer_backend"] = backend
        return degrade()

    def _ffd_degrade(self, constraints, instance_types, pods, daemon, plan) -> List[VirtualNode]:
        """The degrade ladder's floor: materialize the topology plan into
        the pods' selectors (restored afterwards — the accelerated path's
        never-mutate contract) and serve the batch with the host FFD. The
        round still lands in the decision log with its route; tensor-level
        attribution needs the accelerated result."""
        self._publish_decision({"route": "ffd-degraded"})
        saved = snapshot_selectors(pods)
        try:
            plan.materialize(list(pods))
            return self._ffd_fallback.solve_injected(
                constraints, instance_types, pods, daemon
            )
        finally:
            restore_selectors(pods, saved)

    # -- integrity ------------------------------------------------------------

    def _integrity_event(self, reason: str, address: str, detail: str) -> None:
        """Every quarantine is a cluster Warning event: an operator sees
        'this source produced corrupt data' next to the pods it almost
        mis-scheduled."""
        try:
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Solver", address or "in-process", "IntegrityQuarantine",
                f"pack integrity violation ({reason}): {detail} — "
                "docs/integrity.md has the runbook",
                type="Warning",
            )
        except Exception:
            logger.debug("integrity event write failed", exc_info=True)

    def _quarantine_source(
        self, reason: str, detail: str, batch: Optional[enc.EncodedBatch] = None,
        address: str = "",
    ) -> None:
        """Quarantine what produced corrupt data (a wire integrity failure,
        the screen, the canary, an invalid decoded plan), by the pack's
        provenance: the sidecar's breaker, tripped at once, when the pack
        names the sidecar's address; the shape class's pack breaker on the
        in-process path (local corruption has no address to blame). A
        pool's member is quarantined by the pool (its own breaker tripped,
        the event through ``on_quarantine``), so one bad member does not
        close the whole remote path."""
        remote = self._remote
        if address and remote is not None and hasattr(remote, "quarantine"):
            remote.quarantine(address, reason, detail)
            return
        if address and self.service_address:
            self._remote_breaker.trip()
            metrics.SOLVER_BREAKER_OPEN.labels(address=self.service_address).set(1)
            metrics.SOLVER_BREAKER_TRIPS.labels(address=self.service_address).inc()
        elif batch is not None:
            self._pack_breakers.get(self._breaker_key(batch)).trip()
        integrity.record_quarantine(address, reason, detail)
        self._integrity_event(reason, address, detail)

    def _maybe_canary(self, batch: enc.EncodedBatch, result, prof: Dict) -> None:
        """Start the canary cross-check for a ``canary_rate`` fraction of
        the solves a kernel (or its plain version) or the sidecar served:
        re-solve the SAME encoded batch on the native packer OFF the hot
        path (a daemon thread, at most one in flight) and compare. Native
        packs are never canaried. While the router's probes are paused
        (brownout rung 1 and up), the canary, pure verification spend,
        pauses with them. A caller that reads the counters joins
        ``_canary_thread`` first."""
        backend = prof.get("packer_backend")
        if self.canary_rate <= 0 or (backend not in DEVICE_BACKENDS and backend != SIDECAR):
            return
        if self.router.probes_paused():
            return
        if not native.native_available():
            return
        address = str(prof.get("solver_address") or "")
        with self._canary_lock:
            if self._canary_rng.random() >= self.canary_rate:
                return
            if self._canary_thread is not None and self._canary_thread.is_alive():
                return  # previous canary still comparing; sample the next draw
            t = threading.Thread(
                target=self._canary_check, args=(batch, result, address),
                name="karpenter-integrity-canary", daemon=True,
            )
            self._canary_thread = t
            # started under the lock, like the shadow probe: is_alive() is
            # False for an assigned-but-unstarted thread
            t.start()

    def _canary_check(self, batch: enc.EncodedBatch, result, address: str = "") -> None:
        """The canary body (synchronous; tests call it directly): a native
        re-solve on host arrays at the served result's node-table size, an
        exact compare, the serving source (the sidecar at ``address``, else
        the shape class) quarantined on disagreement."""
        try:
            n_max = int(np.asarray(result[1]).shape[0])  # node_sig is [n_max]
            reference = native.pack_native(*batch.pack_args(), n_max=n_max)
            diff = integrity.compare_results(result, reference, n_pods=batch.n_pods)
        except Exception:
            # a canary that cannot run proves nothing either way — it must
            # never fail a healthy solve
            logger.debug("integrity canary re-solve failed", exc_info=True)
            return
        integrity.record_canary(address, mismatch=diff is not None)
        if diff is None:
            return
        logger.error(
            "integrity canary mismatch (%s) for pack served by %s; "
            "quarantining", diff, address or "in-process",
        )
        self._quarantine_source("canary", diff, batch, address=address)

    def _resident_encode(
        self, constraints, instance_types, pods, sts, daemon, plan,
        topo=False, plan_reused=False,
    ):
        """The resident path with the same overflow-retry contract as
        ``_encode_retry``: a cached table accumulates signatures across
        batches, so an overflow may be an accumulation artifact — drop the
        cache AND the resident state (its stable vocab belongs to the
        dropped table) and retry from cold."""
        try:
            return self._resident.encode(
                constraints, instance_types, pods, sts, daemon, plan,
                topo=topo, plan_reused=plan_reused,
            )
        except SignatureOverflow:
            self._encode_cache.clear()
            self._resident.reset()
            return self._resident.encode(
                constraints, instance_types, pods, sts, daemon, plan,
                topo=topo, plan_reused=plan_reused,
            )

    def _encode_retry(self, constraints, instance_types, pods, daemon, plan) -> enc.EncodedBatch:
        """Encode with the reusable cache; a cached table accumulates
        signatures across batches, so an overflow may be an accumulation
        artifact — drop the cache and retry fresh. A second overflow means
        the batch itself is too diverse, and raises: ``solve`` then serves
        the batch from the FFD floor, or raises on the card."""
        try:
            return enc.encode(
                constraints, instance_types, pods, daemon, cache=self._encode_cache,
                plan=plan,
            )
        except SignatureOverflow:
            self._encode_cache.clear()
            return enc.encode(
                constraints, instance_types, pods, daemon, cache=self._encode_cache,
                plan=plan,
            )

    def _pack(self, batch: enc.EncodedBatch, prof: Dict):
        """BEGIN the packing solve and return ``finish()`` → ``(PackResult,
        typemask-or-None)`` over host numpy arrays; only ``finish`` blocks.
        ``KARPENTER_PACKER`` is read here, once per solve. On the card
        ``auto`` is the device path. On a ``device="cpu"`` scheduler it
        routes by MEASURED cost: the device path and the native C++ packer
        are both first-class contenders, and the per-shape EMA of end-to-end
        pack time decides (router.py)."""
        packer = os.environ.get("KARPENTER_PACKER", "auto").lower()
        if packer == "auto" and self.device.type == "cpu":
            candidates = self._pack_candidates()
            if len(candidates) > 1:
                key = self._route_key(batch)
                backend = self.router.choose(key, candidates)
                # the router's decision and its inputs land on the active
                # span (solve.pack_begin): a trace of a slow solve shows
                # which backend served it and what the EMAs believed
                cur = obs.tracer().current()
                if cur is not None:
                    cur.set_attribute("router_backend", backend)
                    cur.set_attribute("router_key", "x".join(map(str, key)))
                    for c in candidates:
                        ema = self.router.ema(key, c)
                        if ema is not None:
                            cur.set_attribute(f"router_ema_{c}_ms", round(ema * 1e3, 3))
                t0 = time.perf_counter()
                if backend == "native":
                    # synchronous host compute: nothing in flight to
                    # overlap, so it runs wholly in the finish phase
                    def finish_native():
                        try:
                            out = self._pack_native(batch, prof)
                        except Exception:
                            # a failed pack records a PENALTY, not its tiny
                            # elapsed time, or a fast-failing backend would
                            # win the EMA; probes rehabilitate it
                            self.router.record_failure(key, backend)
                            # containment: a broken native library is served
                            # by the device path, never crashes the solve
                            logger.exception(
                                "routed native pack failed; device path serves"
                            )
                            out = self._pack_device(batch, prof, packer)()
                        else:
                            self.router.record(key, backend, time.perf_counter() - t0)
                        # packer_backend names the path that actually served
                        if self.router.should_probe(key):
                            self._shadow_probe(batch, key, candidates, backend)
                        return out

                    return finish_native
                try:
                    device_finish = self._pack_device(batch, prof, packer)
                except (OverloadedError, DeadlineExceededError):
                    # a shed is backpressure, not a path failure: no penalty
                    raise
                except Exception:
                    self.router.record_failure(key, backend)
                    raise

                def finish_device():
                    try:
                        out = device_finish()
                    except (OverloadedError, DeadlineExceededError):
                        raise  # a shed, not a failure: no penalty
                    except Exception:
                        self.router.record_failure(key, backend)
                        raise
                    self.router.record(key, backend, time.perf_counter() - t0)
                    if self.router.should_probe(key):
                        self._shadow_probe(batch, key, candidates, backend)
                    return out

                return finish_device
        return self._pack_device(batch, prof, packer)

    def _shadow_probe(self, batch, key, candidates, winner: str) -> None:
        """Re-measure the losing backend(s) OFF the critical path — on a
        daemon thread, at most one in flight — so drift (host load) can
        re-win the route without production solves ever paying a loser's
        latency. A losing probe is slow precisely when it lost, so it does
        not run inline. Only a ``device="cpu"`` scheduler routes, so only
        it probes. What a probe may touch is in the module docstring."""
        losers = [c for c in candidates if c != winner]
        if not losers:
            return

        def probe():
            nonlocal batch
            try:
                for loser in losers:
                    t0 = time.perf_counter()
                    try:
                        if loser == "native":
                            self._pack_native(batch, prof={})
                        else:
                            self._pack_device(batch, {}, "auto", probe=True)()
                    except Exception:
                        logger.debug("%s shadow probe failed", loser, exc_info=True)
                    else:
                        self.router.record(key, loser, time.perf_counter() - t0)
            finally:
                # drop the closure's cell: _probe_thread keeps the finished
                # Thread (and this closure) alive until the next probe, which
                # for a rare shape class would pin the multi-MB EncodedBatch
                # indefinitely
                batch = None

        with self._probe_lock:
            if self._probe_thread is not None and self._probe_thread.is_alive():
                return  # previous probe still running; next cadence hit retries
            t = threading.Thread(target=probe, name="karpenter-router-probe", daemon=True)
            self._probe_thread = t
            # started under the lock: is_alive() is False for an assigned-
            # but-unstarted thread, so a concurrent finisher checking the
            # guard before this start() would spawn a second probe
            t.start()

    @staticmethod
    def _route_key(batch: enc.EncodedBatch) -> tuple:
        """Shape CLASS for the router's cost memos: P is already bucketed
        by encode's padding, but S (signature count) and F (frontier width)
        are exact per-batch values — a churning cluster would mint a fresh
        key per round, re-paying cold start on production solves and
        growing the process-shared EMA tables without bound. Pow2 bucketing
        keeps the landscape to a few dozen classes whose cost is smooth
        within each.

        The last element is CONSTRAINT DENSITY: whether affinity/topology
        decisions pinned any pod to a hostname. Hostname-dense solves cost
        the two backends differently from hostname-free batches of the same
        (P, S, F), so they hold their own EMAs."""
        S, F = batch.frontiers.shape[0], batch.frontiers.shape[1]
        return (
            len(batch.pod_valid),
            1 << max(S - 1, 0).bit_length(),
            1 << max(F - 1, 0).bit_length(),
            int(bool((batch.pod_host >= 0).any())),
        )

    @staticmethod
    def _pack_candidates() -> List[str]:
        """Backends that can serve right now, in cold-start preference
        order: the device path first (its kernel build and first launch
        then land in the first solve), then the native packer (non-blocking
        — while its g++ build is still running it simply is not a
        candidate)."""
        candidates = ["device"]
        if native.native_available():
            candidates.append("native")
        return candidates

    def _pack_native(self, batch: enc.EncodedBatch, prof: Dict):
        """The native C++ packer as a routed backend, with the same
        small-table-then-retry contract as the device path. A shadow probe
        passes a throwaway ``prof``."""
        p = len(batch.pod_valid)
        n_max = max(256, p // 4)
        prof["packer_backend"] = "native"
        prof["pack_route"] = "native"
        prof["pack_dispatches"] = 0
        args = batch.pack_args()
        while True:
            prof["pack_dispatches"] += 1
            result = native.pack_native(*args, n_max=n_max)
            saturated = int(result.n_nodes) == n_max and bool(
                (np.asarray(result.assignment)[: batch.n_pods] < 0).any()
            )
            if not saturated or n_max >= p:
                return result, None
            n_max = p

    def _pack_device(
        self, batch: enc.EncodedBatch, prof: Dict, packer: str, probe: bool = False
    ):
        """BEGIN the device path — the fused single dispatch when the batch
        and ``packer`` take it, else the unfused ladder — and return
        ``finish()``. The begin phase launches the first attempt; only
        ``finish`` blocks on the fetch.

        The node table starts small (per-pod kernel cost grows with the
        table, and real packings open far fewer nodes than pods) and
        retries at full P on saturation (table full with unscheduled pods).
        A fused dispatch or fetch failure puts the shape in the failed-fused
        memo and takes the unfused ladder. With a sidecar configured and
        its breaker available there is no fused route: the unfused
        dispatch goes to the sidecar (``_pack_once_begin``). ``probe`` (a
        shadow probe) keeps the call off ``PodResidency`` and out of the
        session hit rate, as a saturation re-dispatch is."""
        p = len(batch.pod_valid)
        route0 = self._device_route(batch, packer)
        n_max0 = min(p, N_MAX_FIRST) if route0 else max(256, p // 4)
        prof["pack_dispatches"] = 0
        args_box: list = [None]
        rec_box: list = [not probe]  # consumed by the first dispatch

        def local_args():
            if args_box[0] is None:
                args_box[0] = self._device_args(batch)
            return args_box[0]

        def dispatch(n_max: int, route: Optional[str]):
            """One dispatch → ``(fetch, route-or-None)``. A fused DISPATCH
            failure blacklists the shape and falls straight to the unfused
            ladder."""
            prof["pack_dispatches"] += 1
            rec, rec_box[0] = rec_box[0], False
            if route:
                try:
                    fetch = self._pack_fused_begin(batch, n_max, route, prof, probe, record=rec)
                except Exception:
                    self._fused_blacklist(batch, n_max, route)
                else:
                    return fetch, route
            return self._pack_once_begin(batch, local_args, p, n_max, prof, packer, rec), None

        fetch0, taken0 = dispatch(n_max0, route0)

        def finish():
            n_max, fetch, taken = n_max0, fetch0, taken0
            while True:
                try:
                    result, typemask = fetch()
                except Exception:
                    if taken is None:
                        raise
                    # one pathological shape must not fail the batch or
                    # move other shapes: record it and take the unfused
                    # ladder (which routes around its own failed kernels)
                    self._fused_blacklist(batch, n_max, taken)
                    prof["pack_dispatches"] += 1
                    # record=False: this solve already counted at dispatch
                    fetch = self._pack_once_begin(
                        batch, local_args, p, n_max, prof, packer, False
                    )
                    taken = None
                    continue
                saturated = int(result.n_nodes) == n_max and bool(
                    (np.asarray(result.assignment)[: batch.n_pods] < 0).any()
                )
                if not saturated or n_max >= p:
                    return result, typemask
                n_max = p
                # re-derive the route for the full-table retry
                fetch, taken = dispatch(n_max, self._device_route(batch, packer))

        return finish

    def _device_route(self, batch: enc.EncodedBatch, packer: str) -> Optional[str]:
        """``_fused_route``, or None while a sidecar is configured and its
        breaker would admit a call: the sidecar owns the card then, so no
        fused route is taken in process."""
        if self.service_address and self._remote_breaker.available():
            return None
        return self._fused_route(batch, packer)

    def _remote_or_init(self):
        if self._remote is None:
            # under the lock: a shadow probe can reach here beside a solve
            with self._remote_init_lock:
                if self._remote is None:
                    knobs = dict(
                        timeout=REMOTE_SOLVE_TIMEOUT, checksum=self.pack_checksum,
                        stream=self.solver_stream, shm_dir=self.solver_shm_dir,
                        delta=self.solver_delta,
                    )
                    if "," in self.service_address:
                        from karpenter_tpu_torch.solver.pool import SolverPool

                        pool = SolverPool(self.service_address.split(","), **knobs)
                        # the pool has no cluster handle: its quarantines
                        # reach the cluster as events through the scheduler
                        pool.on_quarantine = self._integrity_event
                        self._remote = pool
                    else:
                        from karpenter_tpu_torch.solver.service import RemoteSolver

                        self._remote = RemoteSolver(self.service_address, **knobs)
        return self._remote

    def _remote_failure(self, e: Exception) -> None:
        """Open the circuit: a dead sidecar must not stall every batch for a
        full RPC deadline; half-open probes re-admit it once it answers."""
        tripped = self._remote_breaker.record_failure()
        metrics.SOLVER_BREAKER_OPEN.labels(address=self.service_address).set(1)
        if tripped:
            metrics.SOLVER_BREAKER_TRIPS.labels(address=self.service_address).inc()
        logger.error(
            "solver service %s failed (%s); in-process pack for %.0fs",
            self.service_address, e, REMOTE_BREAKER_SECONDS,
        )

    def _remote_integrity_failure(self, e: IntegrityError) -> None:
        """Corruption attributed to the sidecar: quarantine it (``trip()``,
        the immediate-open edge) and let the caller pack in process."""
        logger.error(
            "solver service %s quarantined for corruption (%s); in-process "
            "pack for %.0fs", self.service_address, e, REMOTE_BREAKER_SECONDS,
        )
        self._quarantine_source(
            e.kind, str(e), address=e.address or self.service_address or ""
        )

    def _pack_once_begin(
        self, batch: enc.EncodedBatch, local_args, p: int, n_max: int, prof: Dict,
        packer: str, record: bool = True,
    ):
        """One unfused dispatch, returning ``fetch()`` → ``(PackResult,
        None)``: the sidecar's Pack future when a sidecar is configured and
        its breaker admits the call, else the in-process ladder over
        ``local_args()``. The sidecar gets the batch's host arrays
        (``pack_args()``), never a card upload. A shed for the round's
        deadline raises (the round fails, or a cpu scheduler takes its
        floor); an overload or a failed sidecar packs in process, a failure
        opening the breaker and a corrupt exchange tripping it. ``record``
        rides to the sidecar, so probes and retries stay out of its
        hit-rate stats."""
        def local():
            return self._pack_local_begin(local_args(), p, n_max, prof, packer)

        if self.service_address and self._remote_breaker.allow():
            try:
                pending = self._remote_or_init().pack_begin(
                    *batch.pack_args(), n_max=n_max, prof=prof, record=record
                )
            except DeadlineExceededError:
                raise  # the round's budget expired: no breaker, no re-solve
            except OverloadedError as e:
                # the sidecar is full, not broken: its breaker stays closed
                logger.info(
                    "solver service %s overloaded (retry after %.2fs); "
                    "in-process pack serves this batch",
                    self.service_address, e.retry_after,
                )
            except IntegrityError as e:
                self._remote_integrity_failure(e)
            except Exception as e:
                self._remote_failure(e)
            else:
                def fetch_remote():
                    try:
                        result = pending()
                    except DeadlineExceededError:
                        raise  # a shed, not a failure
                    except OverloadedError as e:
                        logger.info(
                            "solver service %s shed the solve (overloaded, "
                            "retry after %.2fs); in-process pack serves it",
                            self.service_address, e.retry_after,
                        )
                        return local()()
                    except IntegrityError as e:
                        # the corrupt bytes never reach decode
                        self._remote_integrity_failure(e)
                        return local()()
                    except Exception as e:
                        self._remote_failure(e)
                        return local()()
                    self._remote_breaker.record_success()
                    # unconditional: the gauge is process-global per
                    # address, and another scheduler may have set it
                    metrics.SOLVER_BREAKER_OPEN.labels(
                        address=self.service_address
                    ).set(0)
                    prof["packer_backend"] = SIDECAR
                    prof["pack_route"] = "unfused"
                    return result, None

                return fetch_remote
        return local()

    def _fused_blacklist(self, batch: enc.EncodedBatch, n_max: int, route: str) -> None:
        shape = self._fused_shape(batch, n_max)
        logger.exception("fused %s solve failed for shape %s; unfused ladder", route, shape)
        with _fused_failed_lock:
            _fused_failed_shapes.add(shape)

    @staticmethod
    def _fused_shape(batch: enc.EncodedBatch, n_max: int) -> tuple:
        return (
            len(batch.pod_valid), batch.frontiers.shape[0],
            batch.frontiers.shape[1], n_max,
        )

    @staticmethod
    def _fused_route(batch: enc.EncodedBatch, packer: str = "auto") -> Optional[str]:
        """``"v1"``, ``"v2"`` or None (the unfused ladder) for this batch.
        None unless ``packer`` is ``auto`` or ``fused``, when a
        fused solve of this (P, S, F) already failed, or when the interned
        ids do not fit the compact int16 upload. Otherwise the card's shape
        rule, ``pack_kernel_v2.fused_route``: the reference's gate also
        weighs the node-table size (its v2 kernel keeps a one-hot
        ``[S, n_max]`` state in VMEM); the card's weighs only the per-core
        tables, so both table sizes of one batch take the same route."""
        if packer not in ("auto", "fused"):
            return None
        P = len(batch.pod_valid)
        S, F, R = batch.frontiers.shape
        with _fused_failed_lock:
            failed = any(s[:3] == (P, S, F) for s in _fused_failed_shapes)
        if failed or not fused.ids_fit(batch):
            return None
        return pack_kernel_v2.fused_route(S, F, R, batch.join_table.shape[1])

    def _pack_fused_begin(
        self, batch: enc.EncodedBatch, n_max: int, route: str, prof: Dict,
        probe: bool = False, record: bool = True,
    ):
        """Launch one fused solve on ``route`` and return ``fetch()``, which
        blocks until its buffer is on the host and splits it. ``record``
        gates the invariants lookup's session hit rate."""
        dev = self.device
        if self._pod_residency is not None and not probe:
            # a no-churn round reuses the resident upload by batch identity
            # (the saturation retry's second call too), a small-churn round
            # patches it in place on the device
            pod_side = self._pod_residency.get(batch)
        else:
            tab, open_by_core, bhh = fused.pack_pod_table(batch)
            uniq = fused.pad_uniq_req(batch.uniq_req)
            pod_side = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)
                for a in (tab, open_by_core, bhh, uniq)
            )
        if route == "v2":
            F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
            buf = fused.fused_solve_v2(
                *pod_side, *self._invariants.get_v2(batch, record=record),
                n_max=n_max, F=F, R=R,
            )
        else:
            buf = fused.fused_solve(
                *pod_side, *self._invariants.get(batch, record=record), n_max=n_max
            )
        prof["packer_backend"] = kernel_name(route, dev)
        prof["pack_route"] = "fused"
        wait = self._to_host(buf)

        def fetch():
            return fused.split_fused(
                wait(), len(batch.pod_valid), n_max,
                batch.usable.shape[1], batch.usable.shape[0],
            )

        return fetch

    def _device_args(self, batch: enc.EncodedBatch) -> tuple:
        """``batch.pack_args()`` as tensors on the scheduler's device."""
        return tuple(
            torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)
            for a, (_, dtype) in zip(batch.pack_args(), PACK_ARG_DTYPES)
        )

    def _pack_local_begin(self, args, p: int, n_max: int, prof: Dict, packer: str):
        """Launch the unfused ladder (``pack_unfused``) and return
        ``fetch()`` → ``(PackResult, None)``: the result flattened into one
        buffer on the device, one transfer (nothing to transfer for a native
        result, already host arrays)."""
        served, result = pack_unfused(*args, n_max=n_max, packer=packer)
        prof["packer_backend"] = served
        prof["pack_route"] = "unfused"
        if served == "native":
            return lambda: (result, None)
        wait = self._to_host(kernel.fuse_result(result))
        R = args[6].shape[1]
        return lambda: (kernel.split_result(wait(), p, n_max, R), None)

    def _to_host(self, buf: torch.Tensor):
        """Queue ``buf``'s copy to the host and return ``wait()`` → numpy:
        on the card a ``non_blocking`` copy into pinned memory behind a
        CUDA event, which ``wait`` synchronizes on."""
        if self.device.type != "cuda":
            return buf.numpy
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def wait():
            done.synchronize()
            return host.numpy()

        return wait

    @staticmethod
    def _validate_pack(nodes, pods, daemon) -> Optional[str]:
        """Host-verified invariants of a decoded plan: every pod placed at
        most once, every placed pod from THIS batch, and every node's
        recomputed totals (pod requests + daemon overhead) fit at least one
        of its surviving instance types. Returns a description of the first
        violation, or None."""
        batch_keys = {p.key for p in pods}
        seen: set = set()
        for i, node in enumerate(nodes):
            for pod in node.pods:
                if pod.key in seen:
                    return f"pod {pod.key} assigned to more than one node"
                if pod.key not in batch_keys:
                    return f"pod {pod.key} not part of this batch"
                seen.add(pod.key)
            if not node.instance_type_options:
                return f"node {i} has no surviving instance type"
            totals = res.merge(
                daemon, *[res.requests_for_pods(p) for p in node.pods]
            )
            if not any(
                res.fits(totals, it.resources)
                for it in node.instance_type_options
            ):
                return (
                    f"node {i} capacity exceeded: {res.to_string(totals)} "
                    "fits none of its surviving instance types"
                )
        return None

    def _decode(
        self,
        batch: enc.EncodedBatch,
        result,
        typemask,  # [N, T] bool from the fused solve, or None
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
    ) -> List[VirtualNode]:
        assignment, node_sig, node_host, node_req, n_nodes_arr = result
        assignment = assignment[: batch.n_pods]
        n_nodes = int(np.asarray(n_nodes_arr).reshape(-1)[0])

        unschedulable = int((assignment < 0).sum())
        if unschedulable:
            logger.error("Failed to schedule %d pods", unschedulable)

        # decode residency: a bit-identical result for the SAME resident
        # batch under compatible constraints rebuilds the nodes from the
        # previous decode's derived rows. Gated with the rest of the
        # resident machinery, so the knob-off path measures the full decode.
        self._dec_tl.hit = False
        memo_on = self._resident is not None
        if memo_on:
            nodes = self._decode_from_memo(
                batch, assignment, node_sig, node_host, node_req, n_nodes,
                typemask, constraints, instance_types,
            )
            if nodes is not None:
                self._dec_tl.hit = True
                return nodes

        # group pods per node (order-preserving, like FFD append order);
        # indices ≥ n_nodes are outside the kernel contract and skipped
        a = np.asarray(assignment)
        valid_idx = np.flatnonzero((a >= 0) & (a < n_nodes))
        order = valid_idx[np.argsort(a[valid_idx], kind="stable")]
        groups, starts = np.unique(a[order], return_index=True)
        bounds = np.append(starts, len(order)).tolist()
        order_l = order.tolist()
        batch_pods = batch.pods
        pods_by_node: Dict[int, List[Pod]] = {
            int(g): [batch_pods[i] for i in order_l[bounds[k]:bounds[k + 1]]]
            for k, g in enumerate(groups)
        }
        live = sorted(pods_by_node)
        nodes: List[VirtualNode] = []
        if not live:
            return nodes

        axis_names = batch.axis_names
        # the value holds the list so the id cannot be recycled under the memo
        hit = self._scales_memo.get(id(axis_names))
        if hit is not None and hit[0] is axis_names:
            scales = hit[1]
        else:
            scales = np.array(
                [res.AXIS_SCALES.get(nm, res._DEFAULT_SCALE) for nm in axis_names]
            )
            if len(self._scales_memo) >= 8:
                self._scales_memo.clear()
            self._scales_memo[id(axis_names)] = (axis_names, scales)
        live_idx = np.asarray(live, np.int64)
        # surviving types for ALL nodes: the fused solve computed the
        # [N, T] mask on the device; otherwise one batched host comparison
        # (signature-compatible and fits the node total)
        if typemask is not None:
            ok_all = typemask[live_idx]
        else:
            totals = np.asarray(node_req)[live_idx]  # [L, R]
            fit_all = np.all(batch.usable[None, :, :] >= totals[:, None, :], axis=-1)  # [L, T]
            mask_all = batch.type_mask_matrix()[np.asarray(node_sig)[live_idx]]  # [L, T]
            ok_all = fit_all & mask_all
        types_arr = np.array(instance_types, dtype=object)
        # most nodes share identical surviving-type masks: build each
        # distinct list once and share it (VirtualNode.add REPLACES
        # instance_type_options, never mutates it)
        _, uniq_row, row_of = np.unique(
            np.packbits(ok_all, axis=1), axis=0,
            return_index=True, return_inverse=True,
        )
        uniq_lists = [list(types_arr[ok_all[int(r)]]) for r in uniq_row]
        row_of_l = row_of.reshape(-1).tolist()

        totals_live = np.asarray(node_req)[live_idx]  # [L, R]
        totals_l = totals_live.tolist()
        scaled_l = (totals_live / scales[None, :]).tolist()
        sig_l = np.asarray(node_sig)[live_idx].tolist()
        host_l = np.asarray(node_host)[live_idx].tolist()
        sig_host_cache: Dict[int, tuple] = {}
        memo_rows = []
        for row, n in enumerate(live):
            sig = batch.signatures[sig_l[row]]
            total = totals_l[row]
            scaled = scaled_l[row]
            surviving = uniq_lists[row_of_l[row]]
            node_constraints = constraints.clone()
            reqs = sig.requirements
            h = host_l[row]
            if h >= 0:
                reqs = _with_hostname(reqs, batch.hostnames[h], sig_host_cache)
            node_constraints.requirements = reqs
            requests = {
                name: scaled[i]
                for i, name in enumerate(axis_names)
                if total[i]
            }
            pods_list = pods_by_node[n]
            if memo_on:
                # the memo holds its OWN copies of the mutable per-node state
                # (a consumer appending to node.pods must not poison it); the
                # requirements object and the surviving list are shared under
                # the replace-never-mutate convention, as uniq_lists shares
                # them across this round's nodes
                memo_rows.append((reqs, dict(requests), surviving, list(pods_list)))
            nodes.append(
                VirtualNode(
                    constraints=node_constraints,
                    instance_type_options=surviving,
                    pods=pods_list,
                    requests=requests,
                )
            )
        if memo_on:
            # the copies decouple the memo from the result buffers
            self._dec_memo = (
                batch,
                list(instance_types),
                constraints,
                np.asarray(assignment).copy(),
                np.asarray(node_sig)[:n_nodes].copy(),
                np.asarray(node_host)[:n_nodes].copy(),
                np.asarray(node_req)[:n_nodes].copy(),
                n_nodes,
                None if typemask is None else np.asarray(typemask).copy(),
                memo_rows,
            )
        return nodes

    def _decode_from_memo(
        self, batch, assignment, node_sig, node_host, node_req, n_nodes,
        typemask, constraints, instance_types,
    ) -> Optional[List[VirtualNode]]:
        """The decode-side reuse rung: None unless every input the decoded
        nodes are a function of matches the memo — the resident batch by
        identity, the raw result and typemask bit for bit (a memo without a
        typemask matches only a result without one), the catalog by
        element identity, and the constraints by content (the requirements
        object itself rides the resident plan cache, so identity holds in
        steady state). On a hit the nodes are rebuilt from the memoized
        per-node rows: fresh clones/copies for everything a consumer may
        mutate, shared objects for everything replace-never-mutate."""
        memo = self._dec_memo
        if memo is None or memo[0] is not batch:
            return None
        (_, mits, mcon, mass, msig, mhost, mreq, mn, mmask, rows) = memo
        if n_nodes != mn or (typemask is None) != (mmask is None):
            return None
        if len(instance_types) != len(mits) or any(
            a is not b for a, b in zip(instance_types, mits)
        ):
            return None
        if not (
            constraints.requirements is mcon.requirements
            and constraints.kubelet_configuration is mcon.kubelet_configuration
            and constraints.provider is mcon.provider
            and constraints.labels == mcon.labels
            and constraints.taints == mcon.taints
        ):
            return None
        if not (
            np.array_equal(np.asarray(assignment), mass)
            and np.array_equal(np.asarray(node_sig)[:n_nodes], msig)
            and np.array_equal(np.asarray(node_host)[:n_nodes], mhost)
            and np.array_equal(np.asarray(node_req)[:n_nodes], mreq)
            and (mmask is None or np.array_equal(np.asarray(typemask), mmask))
        ):
            return None
        metrics.SOLVER_DELTA_APPLIED.labels(path="decode").inc()
        nodes: List[VirtualNode] = []
        for reqs, requests, surviving, pods_list in rows:
            node_constraints = constraints.clone()
            node_constraints.requirements = reqs
            nodes.append(
                VirtualNode(
                    constraints=node_constraints,
                    instance_type_options=surviving,
                    pods=list(pods_list),
                    requests=dict(requests),
                )
            )
        return nodes
