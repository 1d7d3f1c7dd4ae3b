"""Prometheus metrics of the port: every family of ``karpenter_tpu/metrics.py``
with the same names, help text, labels and buckets, so a dashboard or an
alert written for the JAX package reads the port unchanged.

The families live in the port's own ``REGISTRY`` (never the global default
one, and never the JAX package's), so both packages can run in one process
without their series colliding.
"""

from __future__ import annotations

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

NAMESPACE = "karpenter"

REGISTRY = CollectorRegistry()

# controller-runtime-compatible duration buckets
# (reference: pkg/metrics/constants.go:33-40).
DURATION_BUCKETS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5,
    0.6, 0.7, 0.8, 0.9, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5,
    5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 15.0, 20.0, 25.0, 30.0, 40.0, 50.0, 60.0,
]

SCHEDULING_DURATION = Histogram(
    "scheduling_duration_seconds",
    "Duration of scheduling process in seconds. Broken down by provisioner.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="allocation_controller",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

BIND_DURATION = Histogram(
    "bind_duration_seconds",
    "Duration of bind process in seconds. Broken down by result.",
    ["result"],
    namespace=NAMESPACE,
    subsystem="allocation_controller",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

CLOUDPROVIDER_DURATION = Histogram(
    "duration_seconds",
    "Duration of cloud provider method calls.",
    ["controller", "method", "provider"],
    namespace=NAMESPACE,
    subsystem="cloudprovider",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

# Per-node resource gauges (reference: metrics/node/controller.go:53-110).
NODE_GAUGE_LABELS = [
    "node_name", "provisioner", "zone", "arch", "capacity_type",
    "instance_type", "phase", "resource_type",
]


def _node_gauge(name: str, doc: str) -> Gauge:
    return Gauge(name, doc, NODE_GAUGE_LABELS, registry=REGISTRY)


NODES_ALLOCATABLE = _node_gauge(
    "karpenter_nodes_allocatable", "Resources allocatable by nodes."
)
NODES_TOTAL_POD_REQUESTS = _node_gauge(
    "karpenter_nodes_total_pod_requests",
    "Total resources requested by non-daemonset pods on the node.",
)
NODES_TOTAL_POD_LIMITS = _node_gauge(
    "karpenter_nodes_total_pod_limits",
    "Total resource limits of non-daemonset pods on the node.",
)
NODES_TOTAL_DAEMON_REQUESTS = _node_gauge(
    "karpenter_nodes_total_daemon_requests",
    "Total resources requested by daemonset pods on the node.",
)
NODES_TOTAL_DAEMON_LIMITS = _node_gauge(
    "karpenter_nodes_total_daemon_limits",
    "Total resource limits of daemonset pods on the node.",
)
NODES_SYSTEM_OVERHEAD = _node_gauge(
    "karpenter_nodes_system_overhead",
    "Difference between node capacity and allocatable.",
)

# back-compat alias
NODES_GAUGE = NODES_ALLOCATABLE

PODS_STATE_GAUGE = Gauge(
    "karpenter_pods_state",
    "Pod state is the current state of pods.",
    ["name", "namespace", "owner", "node", "provisioner", "zone", "arch",
     "capacity_type", "instance_type", "phase"],
    registry=REGISTRY,
)

# Sidecar circuit-breaker observability: a dead solver
# service must be visible on the scrape, not only in logs.
SOLVER_BREAKER_OPEN = Gauge(
    "breaker_open",
    "1 while the solver-service circuit breaker is open (requests served in-process).",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_BREAKER_TRIPS = Counter(
    "breaker_trips_total",
    "Times the solver-service circuit breaker opened after an RPC failure.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Provisioner readiness on the scrape (reference: the knative Active
# condition, provisioner_status.go:38-41): 1 while the last Apply
# succeeded, 0 while it is failing.
PROVISIONER_ACTIVE = Gauge(
    "provisioner_active",
    "1 while the Provisioner's Active condition is True (last Apply succeeded).",
    ["provisioner"],
    namespace=NAMESPACE,
    registry=REGISTRY,
)

# Interruption subsystem (karpenter_tpu/interruption): cloud-initiated
# disruption handling must be visible on the scrape — notices in, drains
# through, and the two outcome measures: pods evicted with no replacement
# ready (the number that must stay 0 under clean preemption) and how long
# replaced workloads waited for new capacity.
INTERRUPTION_NOTICES = Counter(
    "notices_total",
    "Disruption notices received, by kind (preemption/maintenance/"
    "capacity-reclaim) and cloud provider.",
    ["kind", "provider"],
    namespace=NAMESPACE,
    subsystem="interruption",
    registry=REGISTRY,
)

INTERRUPTION_DRAINS_STARTED = Counter(
    "drains_started_total",
    "Nodes handed to termination because of a disruption notice.",
    namespace=NAMESPACE,
    subsystem="interruption",
    registry=REGISTRY,
)

INTERRUPTION_DRAINS_COMPLETED = Counter(
    "drains_completed_total",
    "Disrupted nodes fully terminated (gracefully or at the deadline).",
    namespace=NAMESPACE,
    subsystem="interruption",
    registry=REGISTRY,
)

INTERRUPTION_EVICTED_UNREADY = Counter(
    "evicted_without_replacement_total",
    "Pods still on a disrupted node when its grace period expired — "
    "evicted without replacement capacity ready.",
    namespace=NAMESPACE,
    subsystem="interruption",
    registry=REGISTRY,
)

INTERRUPTION_REPLACEMENT_LEAD_TIME = Histogram(
    "replacement_lead_time_seconds",
    "Seconds from disruption notice to the replaced pod's re-bind on "
    "fresh capacity.",
    namespace=NAMESPACE,
    subsystem="interruption",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

# Resilience layer (karpenter_tpu/resilience): every dependency the
# controllers talk to — cloud control plane, HTTP wire, solver service —
# shares one retry/breaker vocabulary, and its state must be scrapeable.
RESILIENCE_BREAKER_STATE = Gauge(
    "breaker_state",
    "Circuit breaker state per dependency: 0 closed, 1 open, 2 half-open.",
    ["dependency"],
    namespace=NAMESPACE,
    subsystem="resilience",
    registry=REGISTRY,
)

RESILIENCE_RETRIES = Counter(
    "retries_total",
    "Retry decisions, by dependency and outcome: `retried` spent a retry "
    "token and ran again; `budget_exhausted` means the per-dependency retry "
    "budget was dry — the failure propagated instead of amplifying the "
    "storm (docs/overload.md).",
    ["dependency", "outcome"],
    namespace=NAMESPACE,
    subsystem="resilience",
    registry=REGISTRY,
)

RESILIENCE_DEADLINE_EXCEEDED = Counter(
    "deadline_exceeded_total",
    "Operations abandoned because the retry deadline (or the reconcile-round "
    "budget) ran out before the attempts did.",
    ["dependency"],
    namespace=NAMESPACE,
    subsystem="resilience",
    registry=REGISTRY,
)

# Solver degradation: batches that fell back to the host FFD scheduler
# because the accelerated path was broken (breaker open) or failed mid-solve.
# `address` is the pack's PROVENANCE — the pool member (or single sidecar)
# that served the rejected result, "" for the in-process path — so one bad
# member's invalid packs attribute to IT instead of smearing across the
# whole remote path.
SOLVER_DEGRADED = Counter(
    "degraded_solves_total",
    "Solves served by the FFD fallback because the accelerated path was "
    "unavailable or untrusted, by reason "
    "(breaker_open/pack_failure/invalid_pack/integrity_screen/deadline/"
    "overload) and the serving member's address ('' = in-process).",
    ["reason", "address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_WARMUP_FAILURES = Counter(
    "warmup_failures_total",
    "Provisioner-worker solver warmup attempts that failed (the first real "
    "batch pays the compile when the background retry also fails).",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_BATCH_SIZE = Histogram(
    "batch_size_pods",
    "Pods per solver batch.",
    ["backend"],
    namespace=NAMESPACE,
    subsystem="solver",
    buckets=[1, 10, 50, 100, 500, 1000, 2000, 5000, 10000],
    registry=REGISTRY,
)

# Session-based solver transport (the v3 wire): the
# steady-state Pack must ship only pod deltas — catalog residency has to be
# visible on the scrape, or a silently-thrashing session cache re-pays the
# catalog upload every solve with nothing flagging it.
SOLVER_SESSION_UPLOADS = Counter(
    "session_catalog_uploads_total",
    "Catalog-side tensor uploads to the device side (OpenSession or an "
    "in-process invariants device_put) — steady state approaches zero.",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_SESSION_HIT_RATE = Gauge(
    "session_catalog_hit_rate",
    "Fraction of solves served against already-resident catalog tensors "
    "(no catalog bytes shipped) since process start.",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_SESSION_EVICTIONS = Counter(
    "session_evictions_total",
    "Resident catalog entries evicted (session LRU pressure or TTL expiry).",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Encode-cache effectiveness: the signature table / capacity matrix rebuild
# is ~40ms of the 10k-pod budget, so a thrashing EncodeCache is a latency
# regression the p99 alone can't attribute.
SOLVER_ENCODE_CACHE_HITS = Counter(
    "encode_cache_hits_total",
    "Solves that reused a cached (signature table, usable-capacity) entry.",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_ENCODE_CACHE_MISSES = Counter(
    "encode_cache_misses_total",
    "Solves that had to rebuild the signature table / capacity matrix.",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Resident delta encoding: the steady-state path
# keeps encoded tensors resident across rounds and patches them from
# per-pod deltas. A spiking full_reencodes rate is the "solves got slow"
# smoking gun (operations.md has the runbook row); epoch mismatches are the
# fail-loud guard firing — each one is a stale-tensor solve that did NOT
# happen.
SOLVER_DELTA_APPLIED = Counter(
    "delta_applied_total",
    "Rounds served by the resident delta path instead of a full re-encode "
    "(path: host = resident host tensors, wire = elided/patched v3 frame, "
    "device = reused/patched device-resident pod upload).",
    ["path"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_DELTA_FULL_REENCODES = Counter(
    "delta_full_reencodes_total",
    "Delta-mode rounds that fell back to a full re-encode, by reason "
    "(cold, epoch, table, topology, wire).",
    ["reason"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_DELTA_EPOCH_MISMATCHES = Counter(
    "delta_epoch_mismatches_total",
    "Delta frames refused because the resident base epoch was missing or "
    "the patched content failed its epoch check (side: client, sidecar). "
    "Every one is a would-have-been stale-tensor solve caught loud.",
    ["side"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_DELTA_RESIDENT_BYTES = Gauge(
    "delta_resident_bytes",
    "Bytes of pod-side tensors held resident for the delta path "
    "(side: host = controller resident batch, sidecar = the wire store, "
    "device = the resident device upload).",
    ["side"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Tracing subsystem (karpenter_tpu/obs): span volume and ring-buffer loss
# must be observable — a silently-dropping exporter reads as "nothing slow
# happened", and the flight recorder's write rate IS the slow-solve rate.
TRACE_SPANS = Counter(
    "spans_total",
    "Spans completed and exported by the in-process tracer.",
    namespace=NAMESPACE,
    subsystem="trace",
    registry=REGISTRY,
)

TRACE_DROPPED = Counter(
    "dropped_total",
    "Spans evicted from the in-memory trace ring before anyone read them.",
    namespace=NAMESPACE,
    subsystem="trace",
    registry=REGISTRY,
)

FLIGHT_RECORDS = Counter(
    "flight_records_total",
    "Slow-solve incidents written to the on-disk flight ring (a watched "
    "span exceeded its latency budget).",
    namespace=NAMESPACE,
    registry=REGISTRY,
)

FLIGHT_PANEL_ERRORS = Counter(
    "flight_panel_errors_total",
    "Registered flight-recorder state panels that RAISED while being "
    "snapshotted for a record, by panel name — the record still lands "
    "(span tree + the other panels), the broken panel contributes its "
    "error string.",
    ["panel"],
    namespace=NAMESPACE,
    registry=REGISTRY,
)

# Decision observability plane:
# every provisioning round is recorded into the decision audit ring with
# per-pod elimination attribution for whatever the solve left unplaced.
DECISIONS_RECORDED = Counter(
    "decisions_recorded_total",
    "Provisioning-round decision records appended to the decision audit "
    "log (in-memory ring always; the on-disk replayable ring when "
    "--decision-dir is set).",
    namespace=NAMESPACE,
    registry=REGISTRY,
)

DECISIONS_DROPPED = Counter(
    "decisions_dropped_total",
    "Decision records lost, by reason: \"evicted\" = the capped on-disk "
    "ring pruned an old record, \"write_failed\" = a full/read-only "
    "--decision-dir refused the write (the round itself never fails — "
    "best-effort by contract), \"queue_full\" = the async writer's "
    "bounded queue refused the enqueue, \"error\" = the record builder "
    "broke.",
    ["reason"],
    namespace=NAMESPACE,
    registry=REGISTRY,
)

PODS_UNSCHEDULABLE = Gauge(
    "pods_unschedulable",
    "Pods currently on an unbroken selection/placement failure streak, "
    "by top elimination reason (solver/explain.py vocabulary: "
    "resource_fit, requirement, zone_topology, daemon_overhead, "
    "capacity_frontier, hostname, taint; \"unknown\" = the round could "
    "not attribute, e.g. an FFD-degraded solve).",
    ["reason"],
    namespace=NAMESPACE,
    registry=REGISTRY,
)

DECISION_EXPLAIN_DURATION = Histogram(
    "decision_explain_duration_seconds",
    "Time spent building one round's decision record: elimination "
    "attribution (mask reductions off the hot path) plus the bounded "
    "record assembly — the explain_overhead_pct bench bar (<1%) is "
    "judged on this work.",
    namespace=NAMESPACE,
    buckets=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0],
    registry=REGISTRY,
)

# Fleet telemetry plane: flush /
# stitch / profiler accounting. Every process — controller replicas and
# sidecars — publishes these about its OWN half of the plane.
TELEMETRY_FLUSHES = Counter(
    "flushes_total",
    "Member telemetry payloads (span trees + SLO histogram snapshot + "
    "profile folds) this process published to the shared backend.",
    namespace=NAMESPACE,
    subsystem="telemetry",
    registry=REGISTRY,
)

TELEMETRY_STITCHED = Counter(
    "stitched_traces_total",
    "NEW cross-process trace joins performed by the collector: a foreign "
    "member's span tree (e.g. the sidecar's sidecar.pack) attached into "
    "its parent trace's tree (re-stitching the same flushed tree on a "
    "later poll does not re-count).",
    namespace=NAMESPACE,
    subsystem="telemetry",
    registry=REGISTRY,
)

TELEMETRY_PROFILE_SAMPLES = Counter(
    "profile_samples_total",
    "Thread-stack samples folded by the in-process sampling profiler "
    "(one per thread per tick at --profile-hz).",
    namespace=NAMESPACE,
    subsystem="telemetry",
    registry=REGISTRY,
)

TELEMETRY_PROFILE_OVERHEAD = Gauge(
    "profile_overhead_ratio",
    "Sampling-profiler busy time over wall time since it started — the "
    "self-accounted cost of always-on profiling (bench bar: < 0.01).",
    namespace=NAMESPACE,
    subsystem="telemetry",
    registry=REGISTRY,
)

# Trace ring residency (obs/export.py): /debug/traces serves whatever the
# ring holds, and the drop counter alone cannot say whether the ring is
# near capacity — the gauges make eviction pressure scrapeable per process
# (controller and sidecar each publish their own ring's numbers).
TRACE_RING_TREES = Gauge(
    "ring_trees",
    "Root span trees currently held in the in-memory trace ring.",
    namespace=NAMESPACE,
    subsystem="trace",
    registry=REGISTRY,
)

TRACE_RING_SPANS = Gauge(
    "ring_spans",
    "Total spans (across all held trees) currently in the trace ring.",
    namespace=NAMESPACE,
    subsystem="trace",
    registry=REGISTRY,
)

# Online SLO engine: declarative
# objectives evaluated from the tracer finish-hook. The gauges are the
# autopilot's sensor surface AND the alerting surface: `burning` is the
# multiwindow page condition (fast AND slow windows over budget).
SLO_OBJECTIVE_OK = Gauge(
    "objective_ok",
    "1 while the objective's fast-window value meets its threshold "
    "(e.g. solve p99 under 100ms); unset until the window has data.",
    ["objective"],
    namespace=NAMESPACE,
    subsystem="slo",
    registry=REGISTRY,
)

SLO_BURN_RATE = Gauge(
    "burn_rate",
    "Error-budget burn rate per objective and window (fast/slow): "
    "observed bad-event fraction divided by the objective's budget — "
    "1.0 means the budget is being consumed exactly as fast as allowed.",
    ["objective", "window"],
    namespace=NAMESPACE,
    subsystem="slo",
    registry=REGISTRY,
)

SLO_BURNING = Gauge(
    "burning",
    "1 while BOTH burn-rate windows of the objective exceed 1.0 — the "
    "multiwindow page condition.",
    ["objective"],
    namespace=NAMESPACE,
    subsystem="slo",
    registry=REGISTRY,
)

SLO_EVENTS = Counter(
    "events_total",
    "SLO-relevant events observed per objective, by verdict (good/bad — "
    "bad events consume error budget).",
    ["objective", "verdict"],
    namespace=NAMESPACE,
    subsystem="slo",
    registry=REGISTRY,
)

# Device-memory telemetry for the session store (solver/service.py): the
# histograms can see that pack_fetch spiked, but only the resource side
# can say WHY — a session churn filling HBM shows up here first.
SOLVER_SESSION_HBM = Gauge(
    "session_hbm_bytes",
    "Bytes of catalog tensors pinned on device per live solver session "
    "(label: the 12-hex-char session key prefix).",
    ["session"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_HBM_HEADROOM = Gauge(
    "device_hbm_headroom_bytes",
    "Device memory limit minus bytes in use, from the backend's "
    "memory_stats. Labeled by device index so the child only exists once "
    "a backend actually reported memory — on the CPU test rig the metric "
    "is ABSENT, never a lying zero.",
    ["device"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Breaker-open fast-fails on the metered cloud path: these calls never run,
# so they vanish from the duration histogram — without this counter a
# launch gap during an outage has no latency attribution at all.
CLOUDPROVIDER_BREAKER_SHORTCIRCUIT = Counter(
    "breaker_shortcircuit_total",
    "Cloud-provider calls answered by an open circuit breaker without "
    "reaching the control plane, by provider and method.",
    ["provider", "method"],
    namespace=NAMESPACE,
    subsystem="cloudprovider",
    registry=REGISTRY,
)

# Fleet-scale HA (karpenter_tpu/fleet): per-provisioner shard leases across
# controller replicas, and the failover-aware solver sidecar pool. Shard
# ownership must be visible per replica — a rebalance storm or a stuck
# duplicate-launch guard is invisible in logs at fleet scale.
FLEET_SHARDS_OWNED = Gauge(
    "shards_owned",
    "Provisioner shards this controller replica currently holds the lease "
    "for (the fleet's shard counts should sum to the provisioner count).",
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)

FLEET_REBALANCES = Counter(
    "shard_rebalances_total",
    "Shard takeovers: acquisitions of a shard lease previously held by a "
    "different replica (rebalance-on-death or membership change).",
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)

FLEET_SHARD_LOSSES = Counter(
    "shard_losses_total",
    "Shard leases this replica failed to renew and released its workers "
    "for (at most once per holding epoch).",
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)

FLEET_DUPLICATE_LAUNCH_GUARD = Counter(
    "duplicate_launch_guard_total",
    "Launches or binds skipped by the fleet split-brain guards, by reason "
    "(lost_ownership: shard lease gone mid-round; already_bound: the live "
    "pod was bound by another replica between solve and bind).",
    ["reason"],
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)

FLEET_FOREIGN_NOTICES = Counter(
    "foreign_notices_total",
    "Disruption notices drained by a replica that does not own the node's "
    "shard — requeued to the provider stream for the owner to pick up.",
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)

# Solver sidecar pool: consistent-hash routing on the catalog session key
# with per-member breakers — a failover means a catalog re-upload on the
# next member, so the rate must be scrapeable next to the session metrics.
SOLVER_POOL_FAILOVERS = Counter(
    "pool_failovers_total",
    "Solves rerouted off a dead or breaker-open sidecar pool member, "
    "labeled by the FAILED member's address.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_POOL_MEMBERS = Gauge(
    "pool_members_available",
    "Sidecar pool members currently admitting solves (breaker closed or "
    "probe-ready).",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Streaming solver transport:
# the persistent multiplexed stream per pool member. Establishment state
# and break rate say whether the fleet is actually riding the stream or
# silently living on the unary fallback; credit stalls are the
# flow-control backpressure signal (the streamed twin of
# STATUS_OVERLOADED); the coalescing counters say how often concurrent
# streamed solves shared one device dispatch.
SOLVER_STREAM_STATE = Gauge(
    "stream_established",
    "1 while a persistent solve stream to this sidecar address is "
    "established, 0 while solves fall back to the unary path.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_BREAKS = Counter(
    "stream_breaks_total",
    "Established solve streams that broke (sidecar restart, transport "
    "error, or a client-side teardown after a wedged future); in-flight "
    "solves fall back to unary and the stream re-establishes in the "
    "background.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_SOLVES = Counter(
    "stream_solves_total",
    "Solve dispatches by transport: stream_shm (zero-copy arena), stream "
    "(inline frames over the stream), or unary (no stream up).",
    ["address", "transport"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_CREDIT_STALLS = Counter(
    "stream_credit_stalls_total",
    "Streamed solves refused at the SENDER because the flow-control "
    "credit window was empty — backpressure before any bytes move; the "
    "pool's soft backoff consumes the hint, no breaker ever trips.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_FALLBACKS = Counter(
    "stream_fallback_total",
    "Streamed solves that completed over the unary path after a stream "
    "error, by reason (broken/timeout/retry/open/envelope).",
    ["address", "reason"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_COALESCED_DISPATCHES = Counter(
    "stream_coalesced_dispatches_total",
    "Device dispatches that carried MORE than one coalesced streamed "
    "solve (same session, same padded shapes, one vmapped kernel call).",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_STREAM_COALESCED_SOLVES = Counter(
    "stream_coalesced_solves_total",
    "Streamed solves that rode a shared (coalesced) device dispatch.",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Crash-consistent launch path (karpenter_tpu/launch + the GC controller):
# the journal/adopt/reap loop's three outcomes must be scrapeable — an
# adoption is a crash the system healed, a leak termination is capacity
# nobody accounted for, and the replay rate is the crash rate itself.
LAUNCH_ORPHANS_ADOPTED = Counter(
    "orphans_adopted_total",
    "Orphan instances adopted by the GC controller: a journaled launch "
    "whose process died before the Node object was written.",
    namespace=NAMESPACE,
    subsystem="launch",
    registry=REGISTRY,
)

LAUNCH_INSTANCES_LEAKED = Counter(
    "instances_leaked_total",
    "Leaked instances terminated by the GC sweep: live past the grace "
    "period with no Node tracking them and no journal entry explaining "
    "them (out-of-band or pre-token launches).",
    namespace=NAMESPACE,
    subsystem="launch",
    registry=REGISTRY,
)

LAUNCH_JOURNAL_REPLAYS = Counter(
    "journal_replays_total",
    "Unresolved journal entries replayed by recovery, by outcome "
    "(adopted/node_exists/never_launched).",
    ["outcome"],
    namespace=NAMESPACE,
    subsystem="launch",
    registry=REGISTRY,
)

# Disruption-safe consolidation: the whole-cluster
# re-pack's safety ledger. Voluntary disruption is the one place this
# controller CHOOSES to hurt availability for cost, so every wave, move,
# budget refusal, and reclaimed node must be attributable on the scrape —
# and evicted_unready_total is the contract itself: it must stay 0, every
# displaced pod replaced before its node drains.
CONSOLIDATION_WAVES = Counter(
    "waves_total",
    "Consolidation waves executed, per provisioner: one journaled "
    "taint→replace→drain pass over the budget-admitted victims.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

CONSOLIDATION_MOVES = Counter(
    "moves_total",
    "Pod moves executed by consolidation waves, per provisioner: each is "
    "one release+replacement injection (the minimal-move objective exists "
    "to keep this small relative to nodes reclaimed).",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

CONSOLIDATION_BUDGET_BLOCKED = Counter(
    "budget_blocked_total",
    "Consolidation victims refused by the disruption budget, per "
    "provisioner: the plan wanted the node but the maxUnavailable-style "
    "budget (per wave AND across settling waves) had no room.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

CONSOLIDATION_EVICTED_UNREADY = Counter(
    "evicted_unready_total",
    "Pods a consolidation wave evicted without a replacement ready — the "
    "hard bar of voluntary disruption; any non-zero value is a bug.",
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

CONSOLIDATION_RECLAIMED_NODES = Counter(
    "reclaimed_nodes_total",
    "Nodes fully retired by settled consolidation waves, per provisioner.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

CONSOLIDATION_COST_DELTA = Gauge(
    "cost_delta_usd",
    "Cumulative hourly-price delta from executed consolidation waves, per "
    "provisioner (negative = cheaper cluster; the $-readout of the "
    "re-pack).",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="consolidation",
    registry=REGISTRY,
)

# Predictive provisioning: the arrival forecaster's
# readout and the warm-pool controller's speculation ledger. A speculative
# node is capacity bought on a prediction — every launch, hit, and
# expiry-reclaim must be attributable on the scrape or the warm pool is
# just a slow leak with extra steps.
FORECAST_RATE = Gauge(
    "predicted_rate_pods_per_s",
    "Predicted pod-arrival rate per provisioner shard, by band (point: "
    "the model level; upper: point + band-sigma standard deviations — "
    "what the warm pool speculates against).",
    ["provisioner", "band"],
    namespace=NAMESPACE,
    subsystem="forecast",
    registry=REGISTRY,
)

FORECAST_HORIZON = Gauge(
    "horizon_seconds",
    "The forecast horizon: measured launch-to-ready p99 off node.ready "
    "spans (clamped; the configured default until the first ready "
    "transition lands). Predictions are pod counts expected within one "
    "horizon.",
    namespace=NAMESPACE,
    subsystem="forecast",
    registry=REGISTRY,
)

FORECAST_ARRIVALS = Counter(
    "observed_arrivals_total",
    "Pod admissions observed by the forecaster off provision.round spans, "
    "per provisioner shard — the arrival series the models train on.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="forecast",
    registry=REGISTRY,
)

WARMPOOL_SPECULATIVE_LAUNCHES = Counter(
    "speculative_launches_total",
    "Speculative (warm-pool) node launches, per provisioner: capacity "
    "created ahead of demand on the forecaster's upper band, journaled "
    "with the speculative marker.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

WARMPOOL_HITS = Counter(
    "hits_total",
    "Warm-pool hits, per provisioner: pods bound onto a standing warm "
    "node by the pre-solve steal, skipping the launch path entirely.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

WARMPOOL_MISSES = Counter(
    "misses_total",
    "Warm-pool misses, per provisioner: pods that reached the solver with "
    "no compatible warm node standing — the counterpart of hits_total for "
    "the hit-rate denominator.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

WARMPOOL_EXPIRED = Counter(
    "expired_total",
    "Speculative launches reclaimed by the GC ladder after --warm-pool-ttl "
    "with no demand landing (the speculation_expired replay outcome).",
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

WARMPOOL_SIZE = Gauge(
    "size",
    "Unclaimed warm nodes currently standing, per provisioner.",
    ["provisioner"],
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

WARMPOOL_PAUSED = Gauge(
    "paused",
    "1 while warm-pool speculation is paused (brownout rung 1+ — "
    "speculative capacity is the cheapest thing to stop buying under "
    "burn), 0 otherwise.",
    namespace=NAMESPACE,
    subsystem="warmpool",
    registry=REGISTRY,
)

# Overload control: past saturation the system decides
# what to drop instead of letting the queues decide. Every shed — batcher
# or sidecar admission — must be attributable on the scrape, and the
# brownout ladder's current rung is the one number an operator checks
# first when latency climbs.
BATCHER_SHED = Counter(
    "shed_total",
    "Pods shed from a full admission batcher, by reason (queue_full: a "
    "full-queue add displaced the oldest lowest-priority entry; brownout: "
    "the ladder's shed rung drained queued low-priority work).",
    ["reason"],
    namespace=NAMESPACE,
    subsystem="batcher",
    registry=REGISTRY,
)

SOLVER_ADMISSION_SHED = Counter(
    "admission_shed_total",
    "Sidecar solve/open requests refused by admission control, by reason "
    "(queue_full: depth + inflight caps hit, answered STATUS_OVERLOADED "
    "with a retry-after hint; deadline: the propagated round budget "
    "expired before device dispatch, answered STATUS_DEADLINE_EXCEEDED; "
    "hbm_pressure: device headroom under the floor, new session uploads "
    "refused while resident-session solves keep flowing).",
    ["reason"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_ADMISSION_DEPTH = Gauge(
    "admission_queue_depth",
    "Solve requests currently queued or executing behind the sidecar "
    "admission gate (bounded by --solver-max-inflight + "
    "--solver-queue-depth).",
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_POOL_OVERLOAD_SKIPS = Counter(
    "pool_overload_skips_total",
    "Solves routed past a pool member sitting out an overload retry-after "
    "window (the soft breaker: overload is backpressure, not failure — "
    "the member's real circuit breaker is untouched).",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

BROWNOUT_LEVEL = Gauge(
    "brownout_level",
    "Current rung of the SLO-driven brownout ladder (0 = normal service; "
    "each rung above sheds progressively more deferrable work — "
    "docs/overload.md has the ladder order and rationale).",
    namespace=NAMESPACE,
    registry=REGISTRY,
)

BROWNOUT_TRANSITIONS = Counter(
    "brownout_transitions_total",
    "Brownout ladder steps taken, by direction (escalate/recover) — every "
    "step also lands as a span and a Warning/Normal event, so each "
    "degradation is auditable.",
    ["direction"],
    namespace=NAMESPACE,
    registry=REGISTRY,
)

# Pack integrity: the corruption-defense subsystem's
# scrape surface. Every counter is labeled by the address the corrupt data
# is ATTRIBUTED to ("" for the in-process device path) — silent data
# corruption is only actionable when it names a specific sidecar/device.
SOLVER_INTEGRITY_CHECKSUM_FAILURES = Counter(
    "integrity_checksum_failures_total",
    "Wire frames rejected by the end-to-end checksum (request rejected "
    "server-side as STATUS_INTEGRITY, response rejected client-side, or "
    "a frame too mangled to parse under negotiated integrity), by the "
    "member address the corruption is attributed to.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_INTEGRITY_SESSION_MISMATCHES = Counter(
    "integrity_session_mismatches_total",
    "Pack responses that echoed a DIFFERENT catalog session key than the "
    "solve was dispatched against (stale-session replay, store rollback, "
    "evict/re-open race) — rejected before decode, recovered via a forced "
    "re-open.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_INTEGRITY_CANARY_SOLVES = Counter(
    "integrity_canary_solves_total",
    "Device/pool packs re-solved on the in-process native packer off the "
    "hot path and compared (the --canary-rate cross-check).",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_INTEGRITY_CANARY_MISMATCHES = Counter(
    "integrity_canary_mismatches_total",
    "Canary cross-checks where the native re-solve DISAGREED with the "
    "served pack — a plausible-shaped but wrong result (silent data "
    "corruption); the serving member is quarantined.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_INTEGRITY_SCREEN_FAILURES = Counter(
    "integrity_screen_failures_total",
    "Accelerated pack results that failed the host-side NaN/bounds screen "
    "(non-finite node requests, assignment outside the node table, "
    "impossible node counts) before decode.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

SOLVER_INTEGRITY_QUARANTINES = Counter(
    "integrity_quarantines_total",
    "Integrity quarantines fired: a member (or the in-process shape class) "
    "breaker forced OPEN by a corruption verdict — checksum failure, "
    "canary mismatch, screen failure, or session mismatch that survived "
    "the re-open.",
    ["address"],
    namespace=NAMESPACE,
    subsystem="solver",
    registry=REGISTRY,
)

# Per-stage solve latency, observed by the provisioning worker after each
# batch (sort / inject / encode / wire_ser / pack_fetch / wire_deser /
# decode) — the <100ms p99 target's attribution on the scrape, not only in
# a benchmark's output.
SOLVER_STAGE_DURATION = Histogram(
    "stage_duration_seconds",
    "Per-stage duration of one accelerated solve, by stage "
    "(sort/inject/encode/wire_ser/pack_fetch/wire_deser/decode).",
    ["stage"],
    namespace=NAMESPACE,
    subsystem="solver",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

# Kube client transport: every apiserver request —
# reads, writes, watch re-lists, lease renewals, event writes — crosses the
# kube/transport.py choke point, and these are its scrape surface. The
# duration histogram is per ATTEMPT (client-go's request-duration shape) so
# a retried call shows each round trip; `code` is the HTTP status, or
# "error" for a connection-level failure.
KUBE_REQUEST_DURATION = Histogram(
    "request_duration_seconds",
    "Kubernetes apiserver request latency per attempt, by HTTP verb, "
    "resource kind, and response code (\"error\" = connection failure).",
    ["verb", "kind", "code"],
    namespace=NAMESPACE,
    subsystem="kube",
    buckets=DURATION_BUCKETS,
    registry=REGISTRY,
)

KUBE_REQUEST_RETRIES = Counter(
    "request_retries_total",
    "Kube transport retries, by verb class (read/mutate/watch — creates "
    "and events are never retried at the transport).",
    ["verb_class"],
    namespace=NAMESPACE,
    subsystem="kube",
    registry=REGISTRY,
)

KUBE_THROTTLED = Counter(
    "throttled_total",
    "Kube requests delayed or refused by flow control, by source: "
    "\"server\" = an apiserver 429 (its Retry-After is honored), "
    "\"client\" = the local QPS/burst limiter made the call wait.",
    ["source"],
    namespace=NAMESPACE,
    subsystem="kube",
    registry=REGISTRY,
)

KUBE_EVENTS_DROPPED = Counter(
    "events_dropped_total",
    "Kubernetes Event writes dropped by the zero-retry/short-deadline "
    "events policy — an Event must never hold a reconcile hostage to a "
    "slow apiserver; drops lose audit detail, not correctness.",
    namespace=NAMESPACE,
    subsystem="kube",
    registry=REGISTRY,
)

KUBE_DEGRADED_READS = Counter(
    "degraded_reads_total",
    "Live reads served from the informer cache because the apiserver "
    "breaker is open (degraded read-from-cache mode).",
    namespace=NAMESPACE,
    subsystem="kube",
    registry=REGISTRY,
)

KUBE_RELISTS = Counter(
    "relists_total",
    "Informer full re-LISTs, by kind — each one re-dispatches MODIFIED "
    "for every cached object; a down apiserver paces these with jittered "
    "exponential backoff instead of a hot loop.",
    ["kind"],
    namespace=NAMESPACE,
    subsystem="kube",
    registry=REGISTRY,
)

# Regression sentinel: online
# per-(stage, route, shape) latency baselines learned off the tracer
# finish-hook, a windowed-median change-point detector, and the correlated
# incident plane (obs/incidents.py) sustained deviations escalate into.
SENTINEL_BASELINES = Counter(
    "baselines_total",
    "Sentinel baseline lifecycle events, by event: \"learned\" = a new "
    "(stage, route, shape) key entered the table, \"loaded\" = baselines "
    "restored from --sentinel-dir at startup, \"persisted\" = a successful "
    "baseline-file write, \"persist_failed\" = an unwritable/full "
    "--sentinel-dir degraded the store to memory-only (counted, never "
    "fatal), \"corrupt\" = the baseline file failed to parse and the "
    "sentinel re-learns from scratch.",
    ["event"],
    namespace=NAMESPACE,
    subsystem="sentinel",
    registry=REGISTRY,
)

SENTINEL_DEVIATIONS = Counter(
    "deviations_total",
    "Sustained latency deviations detected by the sentinel's change-point "
    "check (windowed median past the learned level's threshold, held for "
    "the sustain count), by span stage — each one either minted an "
    "incident or attached to the open one.",
    ["stage"],
    namespace=NAMESPACE,
    subsystem="sentinel",
    registry=REGISTRY,
)

SENTINEL_INCIDENTS = Counter(
    "incidents_total",
    "Incident records minted by the sentinel (one per regime change, not "
    "per deviating window — correlated deviations attach instead), by the "
    "first deviating span stage.",
    ["stage"],
    namespace=NAMESPACE,
    subsystem="sentinel",
    registry=REGISTRY,
)

FLEET_FENCED = Gauge(
    "fenced",
    "1 while this replica is FENCED: the apiserver has been unreachable "
    "past its shard leases' expiry margin, so a peer may legitimately own "
    "its shards — cloud creates and GC terminates are refused until the "
    "control plane answers again (docs/partition.md).",
    namespace=NAMESPACE,
    subsystem="fleet",
    registry=REGISTRY,
)
