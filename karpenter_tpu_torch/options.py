"""Process options: flags with environment fallbacks.

Mirrors ``pkg/utils/options``: cluster identity, ports, client QPS/burst,
plus this framework's solver knobs; validated at startup
(reference: utils/options/options.go:34-89, utils/env/env.go).

``device`` (``--device``, ``KARPENTER_DEVICE``) names the torch device
every controller that solves is built on: ``cuda`` (the default) runs the
hand-written kernels on the card; ``cpu`` runs their plain PyTorch
versions and is for tests. Nothing falls back from one to the other.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional


def _env(key: str, default: str) -> str:
    return os.environ.get(key, default)


def env_bool(key: str, default: bool = False) -> bool:
    """One spelling of the boolean env contract — shared with consumers
    that read the twin directly (e.g. TpuScheduler's integrity knobs), so
    the accepted literals can't drift between parsers."""
    return _env(key, "true" if default else "false").strip().lower() == "true"


def env_float(key: str, default: float = 0.0) -> float:
    raw = _env(key, "").strip()
    return float(raw) if raw else default


@dataclass
class Options:
    cluster_name: str = field(default_factory=lambda: _env("CLUSTER_NAME", ""))
    cluster_endpoint: str = field(default_factory=lambda: _env("CLUSTER_ENDPOINT", ""))
    metrics_port: int = field(default_factory=lambda: int(_env("METRICS_PORT", "8080")))
    health_probe_port: int = field(default_factory=lambda: int(_env("HEALTH_PROBE_PORT", "8081")))
    kube_client_qps: float = field(default_factory=lambda: float(_env("KUBE_CLIENT_QPS", "200")))
    kube_client_burst: int = field(default_factory=lambda: int(_env("KUBE_CLIENT_BURST", "300")))
    cloud_provider: str = field(default_factory=lambda: _env("CLOUD_PROVIDER", "fake"))
    # apiserver URL backing the Cluster; "" = in-memory store,
    # "in-cluster" = service-account config from the pod environment
    kube_api_server: str = field(default_factory=lambda: _env("KUBE_API_SERVER", ""))
    # the torch device the controllers solve on: cuda | cuda:<n> | cpu
    device: str = field(default_factory=lambda: _env("KARPENTER_DEVICE", "cuda"))
    # solver knobs (new in this framework)
    default_solver: str = field(default_factory=lambda: _env("KARPENTER_SOLVER", "ffd"))
    # one sidecar address, or a comma-separated POOL of them (consistent-hash
    # session routing + per-member breakers + ring failover, solver/pool.py)
    solver_service_address: str = field(
        default_factory=lambda: _env("SOLVER_SERVICE_ADDRESS", "")
    )  # empty = in-process
    # streaming solver transport (docs/solver-transport.md § Streaming):
    # persistent multiplexed streams per sidecar (credit flow control,
    # out-of-order completion, transparent unary fallback). Off by
    # default like --pack-checksum; ON in deploy/chart — the capability
    # negotiation makes mixed-version fleets interop in either order.
    solver_stream: bool = field(
        default_factory=lambda: env_bool("KARPENTER_SOLVER_STREAM")
    )
    # zero-copy colocated fast path: a directory shared with the sidecar
    # (same host) through which pod-side arrays move as an mmap'd arena —
    # the stream then carries offsets, not bytes. '' disables.
    solver_shm_dir: str = field(
        default_factory=lambda: _env("KARPENTER_SOLVER_SHM_DIR", "")
    )
    # resident delta encoding (docs/delta-encoding.md): keep the encoded
    # cluster resident across rounds and patch it from per-round deltas,
    # epoch-guarded so staleness fails loud into a full re-encode. Off by
    # default like --solver-stream; ON in deploy/chart.
    solver_delta: bool = field(
        default_factory=lambda: env_bool("KARPENTER_SOLVER_DELTA")
    )
    consolidation_enabled: bool = field(
        default_factory=lambda: env_bool("KARPENTER_CONSOLIDATION")
    )
    # evict-mode retirement pacing: nodes retired per reconcile wave
    consolidation_wave_size: int = field(
        default_factory=lambda: int(_env("KARPENTER_CONSOLIDATION_WAVE_SIZE", "5"))
    )
    # controller-level default disruption budget for provisioners that
    # leave spec.disruptionBudget unset: a count ("3") or percent ("20%")
    # of a provisioner's nodes disruptable at once across settling waves;
    # "0" disables voluntary disruption, "" = no budget (wave size paces)
    consolidation_budget: str = field(
        default_factory=lambda: _env("KARPENTER_CONSOLIDATION_BUDGET", "")
    )
    # leader election: path to a shared lease file; empty = single-process,
    # no election (reference: cmd/controller/main.go:84-85)
    leader_election_lease: str = field(
        default_factory=lambda: _env("LEADER_ELECTION_LEASE", "")
    )
    # fleet sharding (docs/fleet.md): per-provisioner shard leases instead
    # of (not alongside) whole-process leader election. A shared lease-set
    # file path, or kube:<namespace>/<prefix> for Lease objects; empty =
    # this replica owns every provisioner.
    shard_lease: str = field(default_factory=lambda: _env("SHARD_LEASE", ""))
    shard_lease_duration: float = field(
        default_factory=lambda: float(_env("SHARD_LEASE_DURATION", "15"))
    )
    # write-ahead launch journal (docs/launch-journal.md): a shared file
    # path, kube:<namespace>/<prefix> for apiserver-durable Lease twins, or
    # memory: for tests; empty = journaling off (creates still carry
    # tokens, but a crashed launch leaves no breadcrumb to adopt from)
    launch_journal: str = field(default_factory=lambda: _env("LAUNCH_JOURNAL", ""))
    # orphan-instance GC sweep cadence and the age past which an untracked,
    # unjournaled instance is declared a leak and terminated
    gc_interval: float = field(
        default_factory=lambda: float(_env("KARPENTER_GC_INTERVAL", "30"))
    )
    gc_grace_period: float = field(
        default_factory=lambda: float(_env("KARPENTER_GC_GRACE_PERIOD", "120"))
    )
    # live log-level reload source (the mounted config-logging key); empty =
    # static level from LOG_LEVEL
    log_config_file: str = field(default_factory=lambda: _env("LOG_CONFIG_FILE", ""))
    log_level: str = field(default_factory=lambda: _env("LOG_LEVEL", "info"))
    # end-to-end tracing (obs/): span pipeline + /debug/traces
    trace_enabled: bool = field(
        default_factory=lambda: env_bool("KARPENTER_TRACE", default=True)
    )
    # slow-solve flight recorder: capped on-disk ring of over-budget solve
    # traces + router/breaker/session state; empty = disabled
    flight_dir: str = field(default_factory=lambda: _env("KARPENTER_FLIGHT_DIR", ""))
    flight_budget_ms: float = field(
        default_factory=lambda: float(_env("KARPENTER_FLIGHT_BUDGET_MS", "100"))
    )
    # online SLO engine (obs/slo.py): fast evaluation window in seconds
    # (the slow burn-rate window is 12x this), and an optional objectives
    # file ('' = the built-in defaults; docs/observability.md has the
    # grammar)
    slo_window: float = field(
        default_factory=lambda: float(_env("KARPENTER_SLO_WINDOW", "300"))
    )
    slo_config: str = field(default_factory=lambda: _env("KARPENTER_SLO_CONFIG", ""))
    # pack integrity (docs/integrity.md): per-frame checksums on the v3
    # solver wire (capability-gated — off keeps the wire byte-identical),
    # and the fraction of device/pool solves re-solved on the in-process
    # native packer and compared (0 disables the canary)
    pack_checksum: bool = field(
        default_factory=lambda: env_bool("KARPENTER_PACK_CHECKSUM")
    )
    canary_rate: float = field(
        default_factory=lambda: env_float("KARPENTER_CANARY_RATE")
    )
    # always-on sampling profiler (obs/profiler.py): stack-sample rate in
    # Hz (0 disables; 19 is deliberately off-aligned from 10/20/100Hz
    # periodic work). Served at GET /debug/profile; self-accounted cost
    # rides karpenter_telemetry_profile_overhead_ratio.
    profile_hz: float = field(
        default_factory=lambda: float(_env("KARPENTER_PROFILE_HZ", "19"))
    )
    # fleet telemetry plane (obs/collector.py, docs/telemetry.md):
    # - telemetry_dir: shared flock'd directory every member (controller
    #   replicas + sidecars) flushes span trees / SLO histograms / profile
    #   folds into; '' = no file backend
    # - telemetry_peers: comma-separated [name=]http://host:port entries
    #   whose /debug/* endpoints the collector scrapes (pull mode, no
    #   shared volume needed)
    # GET /debug/fleet serves the aggregate when either is set.
    telemetry_dir: str = field(default_factory=lambda: _env("KARPENTER_TELEMETRY_DIR", ""))
    telemetry_peers: str = field(
        default_factory=lambda: _env("KARPENTER_TELEMETRY_PEERS", "")
    )
    telemetry_flush_interval: float = field(
        default_factory=lambda: float(_env("KARPENTER_TELEMETRY_FLUSH", "10"))
    )
    # decision observability plane (obs/decisions.py, docs/decisions.md):
    # - explain_enabled: per-round decision records + elimination
    #   attribution (--no-explain turns the whole plane off; the bench
    #   overhead gate measures the delta)
    # - decision_dir: capped on-disk ring of REPLAYABLE decision records
    #   (tools/replay_decision.py re-solves them offline); '' keeps the
    #   memory-only ring backing /debug/decisions and /debug/explain
    # - unschedulable_event_rounds: consecutive failed rounds before a pod
    #   gets its PodUnschedulable Warning event
    explain_enabled: bool = field(
        default_factory=lambda: env_bool("KARPENTER_EXPLAIN", default=True)
    )
    decision_dir: str = field(
        default_factory=lambda: _env("KARPENTER_DECISION_DIR", "")
    )
    unschedulable_event_rounds: int = field(
        default_factory=lambda: int(
            _env("KARPENTER_UNSCHEDULABLE_EVENT_ROUNDS", "3")
        )
    )
    # SLO-driven brownout ladder (resilience/brownout.py): when an
    # objective burns, walk the ordered degradation ladder (pause probes/
    # consolidation -> shrink admission window -> bias native -> shed
    # low-priority queue) instead of letting the queues decide what drops
    brownout_enabled: bool = field(
        default_factory=lambda: env_bool("KARPENTER_BROWNOUT", default=True)
    )
    brownout_interval: float = field(
        default_factory=lambda: float(_env("KARPENTER_BROWNOUT_INTERVAL", "5"))
    )
    # predictive provisioning (forecast/, docs/forecasting.md):
    # - warm_pool: the speculative warm-pool controller (launch ahead of
    #   forecast demand; the provisioning worker claims warm nodes before
    #   solving). Requires the arrival forecaster, which is always on.
    # - warm_pool_ttl: seconds an unclaimed speculative node may stand
    #   before the GC replay ladder reclaims it
    # - warm_pool_max_nodes: per-provisioner standing-pool ceiling
    # - forecast_model: ewma | holt-winters (the seasonal option)
    # - forecast_alpha: EWMA/Holt-Winters level smoothing factor
    warm_pool: bool = field(
        default_factory=lambda: env_bool("KARPENTER_WARM_POOL")
    )
    warm_pool_ttl: float = field(
        default_factory=lambda: float(_env("KARPENTER_WARM_POOL_TTL", "600"))
    )
    warm_pool_max_nodes: int = field(
        default_factory=lambda: int(_env("KARPENTER_WARM_POOL_MAX_NODES", "10"))
    )
    forecast_model: str = field(
        default_factory=lambda: _env("KARPENTER_FORECAST_MODEL", "ewma")
    )
    forecast_alpha: float = field(
        default_factory=lambda: float(_env("KARPENTER_FORECAST_ALPHA", "0.3"))
    )
    # regression sentinel (obs/sentinel.py, docs/observability.md):
    # online per-(stage, route, shape) latency baselines off the span
    # stream + change-point detection; sustained deviations mint
    # correlated incident records at /debug/incidents. sentinel_dir
    # persists the baseline table across restarts ('' = memory-only,
    # re-learns each boot).
    sentinel_enabled: bool = field(
        default_factory=lambda: env_bool("KARPENTER_SENTINEL", default=True)
    )
    sentinel_dir: str = field(
        default_factory=lambda: _env("KARPENTER_SENTINEL_DIR", "")
    )

    def validate(self) -> List[str]:
        errs = []
        if self.metrics_port <= 0 or self.metrics_port > 65535:
            errs.append(f"metrics port {self.metrics_port} out of range")
        if self.health_probe_port <= 0 or self.health_probe_port > 65535:
            errs.append(f"health probe port {self.health_probe_port} out of range")
        if self.kube_client_qps <= 0:
            errs.append("kube client QPS must be positive")
        if self.kube_client_burst <= 0:
            errs.append("kube client burst must be positive")
        if self.consolidation_wave_size <= 0:
            errs.append("consolidation wave size must be positive")
        if self.consolidation_budget:
            from karpenter_tpu_torch.controllers.disruption import parse_budget

            try:
                parse_budget(self.consolidation_budget)
            except ValueError as e:
                errs.append(f"consolidation budget: {e}")
        if self.shard_lease_duration <= 0:
            errs.append("shard lease duration must be positive seconds")
        if self.gc_interval <= 0:
            errs.append("GC interval must be positive seconds")
        if self.gc_grace_period <= 0:
            errs.append("GC grace period must be positive seconds")
        if self.shard_lease and self.leader_election_lease:
            errs.append(
                "shard leases replace leader election — set only one of "
                "--shard-lease / --leader-election-lease"
            )
        if self.flight_budget_ms <= 0:
            errs.append("flight budget must be positive milliseconds")
        if self.slo_window <= 0:
            errs.append("SLO window must be positive seconds")
        if self.brownout_interval <= 0:
            errs.append("brownout tick interval must be positive seconds")
        if self.warm_pool_ttl <= 0:
            errs.append("warm-pool TTL must be positive seconds")
        if self.warm_pool_max_nodes < 1:
            errs.append("warm-pool max nodes must be >= 1")
        if self.forecast_model not in ("ewma", "holt-winters"):
            errs.append(
                f"forecast model must be ewma|holt-winters, got {self.forecast_model}"
            )
        if not 0.0 < self.forecast_alpha <= 1.0:
            errs.append("forecast alpha must be a fraction in (0, 1]")
        if self.unschedulable_event_rounds < 1:
            errs.append("unschedulable event rounds must be >= 1")
        if not 0.0 <= self.profile_hz <= 250.0:
            errs.append("profiler rate must be 0 (off) to 250 Hz")
        if self.telemetry_flush_interval <= 0:
            errs.append("telemetry flush interval must be positive seconds")
        if not 0.0 <= self.canary_rate <= 1.0:
            errs.append("canary rate must be a fraction in [0, 1]")
        if self.slo_config:
            # a typo'd objective must fail startup, not silently never
            # evaluate — parse the whole file eagerly
            try:
                from karpenter_tpu_torch.obs.slo import load_objectives

                load_objectives(self.slo_config)
            except Exception as e:
                errs.append(f"--slo-config {self.slo_config}: {e}")
        if self.device != "cpu" and not (
            self.device == "cuda" or self.device.startswith("cuda:")
        ):
            errs.append(f"device must be cuda|cuda:<n>|cpu, got {self.device}")
        if self.default_solver not in ("ffd", "tpu"):
            errs.append(f"solver must be ffd|tpu, got {self.default_solver}")
        from karpenter_tpu_torch.logging_config import validate_log_config

        err = validate_log_config(self.log_level)
        if err:
            errs.append(err)
        return errs


def parse_args(argv: Optional[List[str]] = None) -> Options:
    opts = Options()
    ap = argparse.ArgumentParser(prog="karpenter-tpu")
    ap.add_argument("--cluster-name", default=opts.cluster_name)
    ap.add_argument("--cluster-endpoint", default=opts.cluster_endpoint)
    ap.add_argument("--metrics-port", type=int, default=opts.metrics_port)
    ap.add_argument("--health-probe-port", type=int, default=opts.health_probe_port)
    # --kube-qps/--kube-burst: the client-go-style flow-control spellings
    # (docs/partition.md) — same knobs, feeding the transport's
    # mutation-priority token bucket (kube/transport.py)
    ap.add_argument(
        "--kube-client-qps", "--kube-qps", type=float,
        default=opts.kube_client_qps,
        help="client-side apiserver flow control: sustained requests/sec "
        "(mutations are prioritized over reads inside the bucket)",
    )
    ap.add_argument(
        "--kube-client-burst", "--kube-burst", type=int,
        default=opts.kube_client_burst,
        help="client-side apiserver flow control: burst bucket size",
    )
    ap.add_argument("--cloud-provider", default=opts.cloud_provider)
    ap.add_argument("--kube-api-server", default=opts.kube_api_server,
                    help="apiserver URL ('' = in-memory store, 'in-cluster' = pod env)")
    ap.add_argument(
        "--device", default=opts.device,
        help="torch device the controllers solve on: cuda (the default; the "
        "hand-written kernels) or cpu (their plain versions, for tests)",
    )
    ap.add_argument("--default-solver", default=opts.default_solver)
    ap.add_argument("--solver-service-address", default=opts.solver_service_address)
    ap.add_argument(
        "--solver-stream",
        action=argparse.BooleanOptionalAction,
        default=opts.solver_stream,
        help="persistent multiplexed solve streams toward the sidecar(s): "
        "credit flow control, out-of-order completion, transparent unary "
        "fallback (capability-gated on PROTO_STREAM, so mixed-version "
        "fleets interop; docs/solver-transport.md)",
    )
    ap.add_argument(
        "--solver-delta",
        action=argparse.BooleanOptionalAction,
        default=opts.solver_delta,
        help="resident delta encoding: keep the encoded cluster resident "
        "across rounds (host tensors + the sidecar's wire store) and ship "
        "per-round deltas instead of re-encoding from scratch; "
        "epoch-guarded — staleness forces a counted full re-encode "
        "(capability-gated on PROTO_DELTA for the wire side, so "
        "mixed-version fleets interop; docs/delta-encoding.md)",
    )
    ap.add_argument(
        "--solver-shm-dir", default=opts.solver_shm_dir,
        help="zero-copy colocated fast path: a directory shared with the "
        "sidecar on the same host; pod arrays move via an mmap'd arena "
        "and the stream carries only offsets ('' disables)",
    )
    ap.add_argument("--leader-election-lease", default=opts.leader_election_lease)
    ap.add_argument(
        "--shard-lease", default=opts.shard_lease,
        help="fleet sharding: lease-set file path or kube:<ns>/<prefix> "
        "('' = this replica owns every provisioner; replaces leader election)",
    )
    ap.add_argument(
        "--shard-lease-duration", type=float, default=opts.shard_lease_duration,
        help="seconds a shard lease lives without renewal (failover "
        "completes within ~2x this)",
    )
    ap.add_argument(
        "--launch-journal", default=opts.launch_journal,
        help="write-ahead launch journal: shared file path, kube:<ns>/<prefix>, "
        "or memory: ('' disables; docs/launch-journal.md)",
    )
    ap.add_argument(
        "--gc-interval", type=float, default=opts.gc_interval,
        help="orphan-instance GC sweep cadence in seconds (adoption "
        "completes within one period)",
    )
    ap.add_argument(
        "--gc-grace-period", type=float, default=opts.gc_grace_period,
        help="age past which an untracked, unjournaled instance is "
        "terminated as a leak",
    )
    ap.add_argument("--log-config-file", default=opts.log_config_file)
    ap.add_argument("--log-level", default=opts.log_level)
    ap.add_argument(
        "--trace",
        action=argparse.BooleanOptionalAction,
        default=opts.trace_enabled,
        help="end-to-end span tracing (--no-trace disables; /debug/traces "
        "on the health port serves the ring)",
    )
    ap.add_argument(
        "--flight-dir", default=opts.flight_dir,
        help="capped on-disk ring for slow-solve flight records "
        "('' disables; served at GET /debug/flight)",
    )
    ap.add_argument(
        "--flight-budget-ms", type=float, default=opts.flight_budget_ms,
        help="solver.solve spans over this budget are flight-recorded",
    )
    ap.add_argument(
        "--slo-window", type=float, default=opts.slo_window,
        help="online SLO fast evaluation window in seconds (the slow "
        "burn-rate window is 12x this; /debug/slo serves the verdicts)",
    )
    ap.add_argument(
        "--slo-config", default=opts.slo_config,
        help="objectives file, one `source.stat op value` line each "
        "('' = built-in defaults; docs/observability.md has the grammar)",
    )
    ap.add_argument(
        "--pack-checksum",
        action=argparse.BooleanOptionalAction,
        default=opts.pack_checksum,
        help="end-to-end frame checksums on the v3 solver wire "
        "(capability-gated on PROTO_CHECKSUM, so mixed-version fleets "
        "interop; a mismatch quarantines the member — docs/integrity.md)",
    )
    ap.add_argument(
        "--canary-rate", type=float, default=opts.canary_rate,
        help="fraction of device/pool solves re-solved on the in-process "
        "native packer off the hot path and compared; a mismatch "
        "quarantines the serving member (0 disables; pauses while the "
        "brownout ladder has probes paused)",
    )
    ap.add_argument(
        "--profile-hz", type=float, default=opts.profile_hz,
        help="sampling-profiler stack-sample rate in Hz (0 disables; "
        "GET /debug/profile serves the folds, docs/telemetry.md)",
    )
    ap.add_argument(
        "--telemetry-dir", default=opts.telemetry_dir,
        help="shared directory the fleet telemetry plane flushes member "
        "payloads into ('' disables the file backend; docs/telemetry.md)",
    )
    ap.add_argument(
        "--telemetry-peers", default=opts.telemetry_peers,
        help="comma-separated [name=]http://host:port member endpoints the "
        "collector scrapes (pull mode); GET /debug/fleet serves the "
        "aggregate",
    )
    ap.add_argument(
        "--telemetry-flush-interval", type=float,
        default=opts.telemetry_flush_interval,
        help="seconds between member telemetry flushes",
    )
    ap.add_argument(
        "--explain",
        action=argparse.BooleanOptionalAction,
        default=opts.explain_enabled,
        help="per-pod decision observability: round decision records + "
        "elimination attribution (--no-explain disables the plane; "
        "/debug/decisions and /debug/explain serve it — docs/decisions.md)",
    )
    ap.add_argument(
        "--decision-dir", default=opts.decision_dir,
        help="capped on-disk ring of replayable decision records "
        "('' = memory-only; tools/replay_decision.py re-solves a "
        "persisted record offline and diffs the assignment)",
    )
    ap.add_argument(
        "--unschedulable-event-rounds", type=int,
        default=opts.unschedulable_event_rounds,
        help="consecutive failed selection/placement rounds before a pod "
        "gets a PodUnschedulable Warning event carrying its top "
        "elimination reason and the decision id",
    )
    ap.add_argument(
        "--brownout",
        action=argparse.BooleanOptionalAction,
        default=opts.brownout_enabled,
        help="SLO-driven brownout ladder: degrade deferrable work in order "
        "while an objective burns (--no-brownout disables; docs/overload.md)",
    )
    ap.add_argument(
        "--brownout-interval", type=float, default=opts.brownout_interval,
        help="seconds between brownout ladder evaluations",
    )
    ap.add_argument(
        "--warm-pool",
        action=argparse.BooleanOptionalAction,
        default=opts.warm_pool,
        help="speculative warm-pool provisioning: launch nodes ahead of "
        "forecast demand and claim them before solving "
        "(docs/forecasting.md; pauses at brownout rung 1)",
    )
    ap.add_argument(
        "--warm-pool-ttl", type=float, default=opts.warm_pool_ttl,
        help="seconds an unclaimed speculative node may stand before the "
        "GC replay ladder reclaims it",
    )
    ap.add_argument(
        "--warm-pool-max-nodes", type=int, default=opts.warm_pool_max_nodes,
        help="per-provisioner ceiling on standing warm-pool nodes",
    )
    ap.add_argument(
        "--forecast-model", default=opts.forecast_model,
        help="arrival-rate forecaster model: ewma | holt-winters "
        "(the additive-seasonal option)",
    )
    ap.add_argument(
        "--forecast-alpha", type=float, default=opts.forecast_alpha,
        help="forecaster level smoothing factor in (0, 1]",
    )
    ap.add_argument(
        "--sentinel",
        action=argparse.BooleanOptionalAction,
        default=opts.sentinel_enabled,
        help="regression sentinel: online latency baselines per (stage, "
        "route, shape) + change-point detection over the span stream; "
        "sustained deviations mint correlated incident records "
        "(--no-sentinel disables; /debug/incidents serves them — "
        "docs/observability.md)",
    )
    ap.add_argument(
        "--sentinel-dir", default=opts.sentinel_dir,
        help="directory the sentinel persists its learned baselines into "
        "so a restart resumes instead of re-learning ('' = memory-only)",
    )
    ap.add_argument(
        "--consolidation",
        action=argparse.BooleanOptionalAction,
        default=opts.consolidation_enabled,
        help="enable the consolidation (cost-optimal deprovisioning) controller"
        " (--no-consolidation overrides KARPENTER_CONSOLIDATION=true)",
    )
    ap.add_argument(
        "--consolidation-wave-size", type=int,
        default=opts.consolidation_wave_size,
        help="evict-mode pacing: nodes retired per consolidation wave",
    )
    ap.add_argument(
        "--consolidation-budget", default=opts.consolidation_budget,
        help="default disruption budget for provisioners without "
        "spec.disruptionBudget: a count ('3') or percent ('20%%') of "
        "nodes disruptable at once; '0' disables voluntary disruption, "
        "'' = unbudgeted (docs/consolidation.md)",
    )
    ns = ap.parse_args(argv)
    out = Options(
        cluster_name=ns.cluster_name,
        cluster_endpoint=ns.cluster_endpoint,
        metrics_port=ns.metrics_port,
        health_probe_port=ns.health_probe_port,
        kube_client_qps=ns.kube_client_qps,
        kube_client_burst=ns.kube_client_burst,
        cloud_provider=ns.cloud_provider,
        kube_api_server=ns.kube_api_server,
        device=ns.device,
        default_solver=ns.default_solver,
        solver_service_address=ns.solver_service_address,
        solver_stream=ns.solver_stream,
        solver_delta=ns.solver_delta,
        solver_shm_dir=ns.solver_shm_dir,
        consolidation_enabled=ns.consolidation,
        consolidation_wave_size=ns.consolidation_wave_size,
        consolidation_budget=ns.consolidation_budget,
        leader_election_lease=ns.leader_election_lease,
        shard_lease=ns.shard_lease,
        shard_lease_duration=ns.shard_lease_duration,
        launch_journal=ns.launch_journal,
        gc_interval=ns.gc_interval,
        gc_grace_period=ns.gc_grace_period,
        log_config_file=ns.log_config_file,
        log_level=ns.log_level,
        trace_enabled=ns.trace,
        flight_dir=ns.flight_dir,
        flight_budget_ms=ns.flight_budget_ms,
        slo_window=ns.slo_window,
        slo_config=ns.slo_config,
        pack_checksum=ns.pack_checksum,
        canary_rate=ns.canary_rate,
        profile_hz=ns.profile_hz,
        telemetry_dir=ns.telemetry_dir,
        telemetry_peers=ns.telemetry_peers,
        telemetry_flush_interval=ns.telemetry_flush_interval,
        brownout_enabled=ns.brownout,
        brownout_interval=ns.brownout_interval,
        warm_pool=ns.warm_pool,
        warm_pool_ttl=ns.warm_pool_ttl,
        warm_pool_max_nodes=ns.warm_pool_max_nodes,
        forecast_model=ns.forecast_model,
        forecast_alpha=ns.forecast_alpha,
        explain_enabled=ns.explain,
        decision_dir=ns.decision_dir,
        unschedulable_event_rounds=ns.unschedulable_event_rounds,
        sentinel_enabled=ns.sentinel,
        sentinel_dir=ns.sentinel_dir,
    )
    errs = out.validate()
    if errs:
        ap.error("; ".join(errs))
    return out
