"""Process wiring: build the manager with all controllers registered.

Mirrors ``cmd/controller/main.go:67-105``: options → cloud provider from the
registry → manager → register the controllers (provisioning, selection, pvc,
termination, interruption, node, consolidation, metrics-pod, metrics-node,
counter) with their watches → start. ``run_controller_process`` is the
``main()`` equivalent; it
returns the assembled runtime so embedding callers (tests, simulations)
can drive or stop it.

Every controller that solves is built on ``options.device`` (``cuda``
unless the caller asks for ``cpu``): on the card every ``solver: tpu``
round launches the hand-written kernels, and nothing falls back to the
CPU. ``--kube-api-server`` runs the process over an API server
(``ApiCluster``, informer caches started and synced before leadership), and
a ``kube:<namespace>/<name>`` leader-election lease is a Lease object there.
The shard leases are not ported: ``--shard-lease`` raises ValueError naming
what is missing.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
from karpenter_tpu_torch.cloudprovider import registry
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
from karpenter_tpu_torch.controllers.counter import CounterController
from karpenter_tpu_torch.controllers.garbage_collection import GarbageCollectionController
from karpenter_tpu_torch.controllers.interruption import InterruptionController
from karpenter_tpu_torch.controllers.manager import Manager
from karpenter_tpu_torch.controllers.metrics_node import NodeMetricsController
from karpenter_tpu_torch.controllers.metrics_pod import PodMetricsController
from karpenter_tpu_torch.controllers.node import NodeController
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.pvc import PVCController
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.controllers.warmpool import WarmPoolController
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.options import Options
from karpenter_tpu_torch.webhook import Webhook

logger = logging.getLogger("karpenter")


@dataclass
class Runtime:
    """Everything a running controller process owns."""

    options: Options
    cluster: Cluster
    cloud_provider: CloudProvider
    manager: Manager
    provisioning: ProvisioningController
    selection: SelectionController
    termination: TerminationController
    interruption: InterruptionController
    webhook: Webhook
    garbage_collection: GarbageCollectionController = None
    journal: object = None  # LaunchJournal when --launch-journal is set
    servers: list = None  # HTTP servers (metrics, health) when serving
    elector: object = None  # LeaderElector when a lease is configured
    log_watcher: object = None  # LogLevelWatcher when a config file is set
    slo: object = None  # the SloEngine THIS runtime installed (obs/slo.py)
    profiler: object = None  # the SamplingProfiler THIS runtime installed
    telemetry: object = None  # the TelemetryPlane THIS runtime installed
    brownout: object = None  # BrownoutController when --brownout is on
    warmpool: WarmPoolController = None  # when --warm-pool is on
    forecast: object = None  # the ArrivalForecaster THIS runtime installed
    sentinel: object = None  # the SentinelEngine THIS runtime installed
    consolidation: ConsolidationController = None
    _gc_freeze_cancel: object = None  # set by _freeze_gc_when_warm

    def stop(self) -> None:
        if self._gc_freeze_cancel is not None:
            # cancel BEFORE restore: a freeze landing after restore() would
            # leak the frozen heap this stop exists to undo
            self._gc_freeze_cancel.set()
        if self.brownout is not None:
            # stops the ladder AND fully reverses it: a stopped replica
            # leaves no degradation behind (resilience/brownout.py)
            self.brownout.stop()
        self.manager.stop()
        self.provisioning.stop()
        self.termination.stop()
        for server in self.servers or []:
            server.shutdown()
        if self.elector is not None:
            self.elector.stop()
        if self.log_watcher is not None:
            self.log_watcher.stop()
        if hasattr(self.cluster, "stop"):
            self.cluster.stop()
        # detach the SLO engine this runtime installed (ownership-checked:
        # if a later-started replica's engine is current, it stays; a
        # runtime that never installed one detaches nothing)
        if self.slo is not None:
            from karpenter_tpu_torch import obs

            obs.shutdown_slo(engine=self.slo)
        # detach the arrival forecaster this runtime installed (same
        # ownership-checked discipline)
        if self.forecast is not None:
            from karpenter_tpu_torch import obs

            obs.shutdown_forecast(engine=self.forecast)
        # detach the regression sentinel this runtime installed (same
        # discipline; shutdown final-persists its baselines)
        if self.sentinel is not None:
            from karpenter_tpu_torch import obs

            obs.shutdown_sentinel(engine=self.sentinel)
        # same ownership-checked teardown for the profiler and the
        # telemetry plane this runtime installed
        if self.profiler is not None or self.telemetry is not None:
            from karpenter_tpu_torch import obs

            if self.profiler is not None:
                obs.shutdown_profiler(self.profiler)
            if self.telemetry is not None:
                obs.shutdown_telemetry(self.telemetry)
        # undo the post-warmup GC policy: a test booting a runtime
        # in-process must not leak a frozen heap into the rest of the run
        from karpenter_tpu_torch.utils.gcpolicy import restore

        restore()


def _freeze_gc_when_warm(runtime: Runtime, timeout: float = 300.0) -> None:
    """Apply the GC freeze policy once the first provisioning worker has
    warmed (its solve compiled — the warm heap now exists). Waits in a
    daemon thread; gives up silently after ``timeout`` (no provisioner ever
    applied → nothing worth freezing). ``Runtime.stop`` cancels the wait —
    a freeze landing after stop's restore() would leak the frozen heap."""
    import threading
    import time as _t

    from karpenter_tpu_torch.utils.gcpolicy import freeze_after_warmup

    cancel = runtime._gc_freeze_cancel = threading.Event()

    def wait() -> None:
        deadline = _t.monotonic() + timeout
        while _t.monotonic() < deadline and not cancel.is_set():
            workers = list(getattr(runtime.provisioning, "workers", {}).values())
            if any(w.warmed.is_set() for w in workers):
                # cancel is re-checked under gcpolicy's lock: stop() sets
                # the event BEFORE calling restore, so a freeze can never
                # land after restore
                freeze_after_warmup(unless=cancel)
                return
            cancel.wait(1.0)

    threading.Thread(target=wait, name="gc-freeze-when-warm", daemon=True).start()


def _serve_endpoints(runtime: Runtime) -> None:
    """Prometheus registry on :metrics_port, healthz/readyz on
    :health_probe_port (reference: cmd/controller/main.go:86-89,
    controllers/manager.go:54-59)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from prometheus_client import start_http_server

    from karpenter_tpu_torch import metrics as m

    metrics_server, _ = start_http_server(
        runtime.options.metrics_port, registry=m.REGISTRY
    )

    manager = runtime.manager

    class HealthHandler(BaseHTTPRequestHandler):
        timeout = 10  # a stalled probe client must not wedge the server

        def _send(self, body: bytes, ctype: str = "application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            # every /debug/* body comes from a shared obs.debug_*_payload
            # helper — the sidecar health server serves the SAME bodies
            # (karplint `debug-endpoint` keeps the parity from drifting)
            import json
            from urllib.parse import urlsplit

            from karpenter_tpu_torch import obs

            query = urlsplit(self.path).query
            if self.path in ("/healthz", "/readyz"):
                ok = manager.healthz()
                self.send_response(200 if ok else 503)
                self.end_headers()
                self.wfile.write(b"ok" if ok else b"unhealthy")
            elif self.path.startswith("/debug/traces"):
                # the in-memory trace ring: recent span trees, newest
                # first; ?limit=/?name= narrow to one trace family,
                # ?trace_id= is the exact lookup
                self._send(json.dumps(obs.debug_traces_payload(query)).encode())
            elif self.path.startswith("/debug/slo"):
                # live objective verdicts + burn rates from the online
                # SLO engine ({} until one is configured)
                self._send(json.dumps(obs.debug_slo_payload(query)).encode())
            elif self.path.startswith("/debug/flight"):
                # recorded slow-solve incidents (empty when no --flight-dir)
                self._send(json.dumps(obs.debug_flight_payload(query)).encode())
            elif self.path.startswith("/debug/profile"):
                # sampling-profiler folds: top-N self-time JSON, or the
                # collapsed-flamegraph corpus with ?format=collapsed
                ctype, body = obs.debug_profile_payload(query)
                self._send(body, ctype)
            elif self.path.startswith("/debug/fleet"):
                # the fleet telemetry plane: member inventory, fleet SLO
                # verdicts, stitched-trace index ({} until configured)
                self._send(json.dumps(obs.debug_fleet_payload(query)).encode())
            elif self.path.startswith("/debug/decisions"):
                # the decision audit log: newest provisioning-round
                # records (?limit=/?provisioner= narrow the window)
                self._send(json.dumps(obs.debug_decisions_payload(query)).encode())
            elif self.path.startswith("/debug/incidents"):
                # the regression sentinel's correlated incident records
                # (?id= for one full record with its evidence) + the
                # learned baseline table
                self._send(json.dumps(obs.debug_incidents_payload(query)).encode())
            elif self.path.startswith("/debug/forecast"):
                # per-provisioner arrival-rate predictions + warm-pool
                # horizon from the arrival forecaster ({} until one is
                # configured)
                self._send(json.dumps(obs.debug_forecast_payload(query)).encode())
            elif self.path.startswith("/debug/explain"):
                # per-pod scheduling explainability: ?pod=<name> returns
                # the newest decision's per-candidate elimination
                # breakdown (or the chosen placement when it scheduled)
                self._send(json.dumps(obs.debug_explain_payload(query)).encode())
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args):  # silence per-request stderr noise
            return

    health = ThreadingHTTPServer(("0.0.0.0", runtime.options.health_probe_port), HealthHandler)
    health.daemon_threads = True
    threading.Thread(target=health.serve_forever, daemon=True, name="healthz").start()
    runtime.servers = [metrics_server, health]


def _build_cluster(options: Options) -> Cluster:
    """In-memory store by default; a real apiserver when configured
    (reference: cmd/controller/main.go:68-70 rate-limited kube client)."""
    if not options.kube_api_server:
        return Cluster()
    from karpenter_tpu_torch.kube.apiserver import ApiCluster

    if options.kube_api_server == "in-cluster":
        return ApiCluster.from_env(
            qps=options.kube_client_qps, burst=options.kube_client_burst
        )
    return ApiCluster(
        options.kube_api_server,
        qps=options.kube_client_qps,
        burst=options.kube_client_burst,
    )


def build_runtime(
    options: Optional[Options] = None,
    cluster: Optional[Cluster] = None,
    cloud_provider: Optional[CloudProvider] = None,
    start_workers: bool = True,
    allow_pod_affinity: bool = True,
    consolidation_enabled: Optional[bool] = None,
) -> Runtime:
    """Assemble (but do not start) the full controller process."""
    options = options or Options()
    if consolidation_enabled is None:
        consolidation_enabled = options.consolidation_enabled
    if cluster is None:
        cluster = _build_cluster(options)
    cloud_provider = cloud_provider or registry.new_cloud_provider(options.cloud_provider)
    # latency histograms on every provider method
    # (reference: cmd/controller/main.go:81 → metrics/cloudprovider.go:66)
    cloud_provider = cpmetrics.decorate(cloud_provider)

    # fleet sharding (docs/fleet.md) is not ported: this replica owns every
    # provisioner, and every controller below runs with ownership=None
    if options.shard_lease:
        raise ValueError(
            "--shard-lease needs fleet/ownership.py (ShardManager, "
            "WatchedShardKeys, build_lease_set), which is not ported"
        )

    # write-ahead launch journal (docs/launch-journal.md): records intent
    # before every cloud create; the GC controller replays what crashes
    # leave behind
    from karpenter_tpu_torch.launch import build_journal

    journal = build_journal(options.launch_journal, cluster=cluster)

    manager = Manager(cluster)
    provisioning = ProvisioningController(
        cluster,
        cloud_provider,
        start_workers=start_workers,
        default_solver=options.default_solver,
        solver_service_address=options.solver_service_address or None,
        journal=journal,
        # pack-integrity knobs (docs/integrity.md): wire checksums on the
        # sidecar path + the native canary cross-check rate
        pack_checksum=options.pack_checksum,
        canary_rate=options.canary_rate,
        # streaming solver transport + zero-copy shm arena
        # (docs/solver-transport.md § Streaming)
        solver_stream=options.solver_stream,
        solver_shm_dir=options.solver_shm_dir,
        # resident delta encoding (docs/delta-encoding.md)
        solver_delta=options.solver_delta,
        # decision observability (docs/decisions.md): the consecutive-
        # failure threshold behind PodUnschedulable Warning events
        unschedulable_event_rounds=options.unschedulable_event_rounds,
        # warm-pool claiming (docs/forecasting.md): workers steal onto
        # standing speculative nodes before solving
        warm_pool=options.warm_pool,
        # the torch device every solve of this process runs on
        device=options.device,
    )
    selection = SelectionController(
        cluster, provisioning, allow_pod_affinity=allow_pod_affinity,
        # non-blocking enqueue: a 32-thread reconcile pool must not cap
        # batch formation at 32 pods/solve under an event storm (the
        # reference affords blocking because its 10k goroutines are free,
        # selection/controller.go:183); completion is verified by the 5s
        # requeue, in-flight pods are guarded by worker.is_pending
        wait=False,
    )
    termination = TerminationController(
        cluster, cloud_provider, start_queue=start_workers,
    )
    interruption = InterruptionController(
        cluster, cloud_provider, provisioning=provisioning, termination=termination,
    )
    node = NodeController(cluster, cloud_provider=cloud_provider)
    consolidation = ConsolidationController(
        cluster,
        cloud_provider,
        enabled=consolidation_enabled,
        solver_service_address=options.solver_service_address or None,
        wave_size=options.consolidation_wave_size,
        # disruption-safe waves (docs/consolidation.md): retirements run
        # through the interruption orchestrator's taint→replace→drain
        # ladder, every wave journals intent first so a crash mid-wave is
        # replayed by GC, and the budget caps concurrent disruption
        orchestrator=interruption.orchestrator,
        journal=journal,
        default_budget=options.consolidation_budget or None,
        device=options.device,
    )
    garbage_collection = GarbageCollectionController(
        cluster,
        cloud_provider,
        journal=journal,
        termination=termination,
        gc_interval=options.gc_interval,
        grace_period=options.gc_grace_period,
        warm_pool_ttl=options.warm_pool_ttl,
    )
    # predictive provisioning (docs/forecasting.md): the warm-pool wave
    # turns the arrival forecaster's upper band into standing speculative
    # capacity; the worker's steal claims it, the GC ladder reclaims it
    warmpool = None
    if options.warm_pool:
        warmpool = WarmPoolController(
            cluster,
            cloud_provider,
            provisioning,
            journal=journal,
            warm_pool_ttl=options.warm_pool_ttl,
            max_nodes=options.warm_pool_max_nodes,
        )
    # the SLO-driven brownout ladder (docs/overload.md): consumes burn
    # state from whatever SLO engine is installed (run_controller_process
    # installs it; the sensor reads lazily, so construction order is free)
    # and actuates the batchers, the router, and consolidation. Built here,
    # STARTED in run_controller_process alongside the engine.
    brownout = None
    if options.brownout_enabled:
        from karpenter_tpu_torch.resilience.brownout import BrownoutController
        from karpenter_tpu_torch.solver.router import default_router

        brownout = BrownoutController(
            provisioning=provisioning,
            consolidation=consolidation,
            router=default_router(),
            warmpool=warmpool,
            cluster=cluster,
            interval=options.brownout_interval,
        )

    counter = CounterController(cluster)
    pvc = PVCController(cluster)
    metrics_node = NodeMetricsController(cluster)
    metrics_pod = PodMetricsController(cluster)

    # concurrency mirrors the reference: selection widest, the rest 10
    # (selection/controller.go:183, provisioning/controller.go:152)
    manager.register("provisioning", provisioning.reconcile, concurrency=10)
    manager.register("selection", selection.reconcile, concurrency=32)
    manager.register("termination", termination.reconcile, concurrency=10)
    manager.register("interruption", interruption.reconcile, concurrency=2)
    manager.register("node", node.reconcile, concurrency=10)
    manager.register("consolidation", consolidation.reconcile, concurrency=2)
    manager.register("garbage_collection", garbage_collection.reconcile, concurrency=1)
    if warmpool is not None:
        manager.register("warmpool", warmpool.reconcile, concurrency=1)
    manager.register("counter", counter.reconcile, concurrency=2)
    manager.register("pvc", pvc.reconcile, concurrency=2)
    manager.register("metrics_node", metrics_node.reconcile, concurrency=2)
    manager.register("metrics_pod", metrics_pod.reconcile, concurrency=2)

    # watches
    cluster.watch(
        "provisioners", lambda e, o: manager.enqueue("provisioning", o.metadata.name)
    )
    cluster.watch(
        "pods", lambda e, o: manager.enqueue("selection", (o.metadata.name, o.metadata.namespace))
    )
    node.register(manager)
    interruption.register(manager)
    garbage_collection.register(manager)
    if warmpool is not None:
        warmpool.register(manager)
    consolidation.register(manager)
    counter.register(manager)
    pvc.register(manager)
    termination.register(manager)
    metrics_node.register(manager)
    metrics_pod.register(manager)

    return Runtime(
        options=options,
        cluster=cluster,
        cloud_provider=cloud_provider,
        manager=manager,
        provisioning=provisioning,
        selection=selection,
        termination=termination,
        interruption=interruption,
        webhook=Webhook(cloud_provider, default_solver=options.default_solver),
        garbage_collection=garbage_collection,
        journal=journal,
        brownout=brownout,
        warmpool=warmpool,
        consolidation=consolidation,
    )


def run_controller_process(options: Optional[Options] = None, serve: bool = True) -> Runtime:
    """The ``main()`` equivalent: build, wait for leadership when a lease is
    configured, start, and serve metrics/health."""
    runtime = build_runtime(options)
    from karpenter_tpu_torch.logging_config import LogLevelWatcher, setup_logging

    setup_logging(runtime.options.log_level)
    # tracing + the slow-solve flight recorder (obs/):
    # /debug/traces and /debug/flight on the health port serve these
    from karpenter_tpu_torch import obs

    obs.set_enabled(runtime.options.trace_enabled)
    if runtime.options.flight_dir:
        obs.configure_flight(
            runtime.options.flight_dir,
            budget_s=runtime.options.flight_budget_ms / 1e3,
        )
    # online SLO engine (docs/observability.md): objective verdicts and
    # burn rates from the span stream, served at /debug/slo and as
    # karpenter_slo_* metrics; flight records snapshot its burning panel
    objectives = (
        obs.load_objectives(runtime.options.slo_config)
        if runtime.options.slo_config
        else None
    )
    runtime.slo = obs.configure_slo(
        objectives=objectives, window_s=runtime.options.slo_window
    )
    # the arrival-rate forecaster (docs/forecasting.md): always on — it is
    # a finish-hook over spans the tracer already emits, and its
    # predictions back /debug/forecast whether or not --warm-pool spends
    # them on speculative capacity
    runtime.forecast = obs.configure_forecast(
        model=runtime.options.forecast_model,
        alpha=runtime.options.forecast_alpha,
    )
    # the regression sentinel (docs/observability.md): online latency
    # baselines + change-point detection off the same span stream, minting
    # correlated incident records at /debug/incidents; --sentinel-dir
    # persists baselines so a restart resumes instead of re-learning
    if runtime.options.sentinel_enabled:
        from karpenter_tpu_torch.kube.events import recorder_for

        runtime.sentinel = obs.configure_sentinel(
            directory=runtime.options.sentinel_dir,
            recorder=recorder_for(runtime.cluster),
        )
    # the decision audit log (docs/decisions.md): /debug/decisions and
    # /debug/explain answer from the memory ring either way; a configured
    # --decision-dir additionally persists replayable records
    # (tools/replay_decision.py) across restarts
    from karpenter_tpu_torch.obs import decisions as _decisions

    _decisions.set_enabled(runtime.options.explain_enabled)
    if runtime.options.decision_dir:
        obs.configure_decisions(runtime.options.decision_dir)
    # always-on sampling profiler (docs/telemetry.md): stack folds at
    # /debug/profile, in-window top folds on every flight record
    if runtime.options.profile_hz > 0:
        runtime.profiler = obs.configure_profiler(hz=runtime.options.profile_hz)
    # fleet telemetry plane: flush this member's trees/histograms/folds to
    # the shared dir and/or collect peers; /debug/fleet serves the merge
    if runtime.options.telemetry_dir or runtime.options.telemetry_peers:
        peers = [
            p for p in runtime.options.telemetry_peers.split(",") if p.strip()
        ]
        runtime.telemetry = obs.configure_telemetry(
            role="controller",
            directory=runtime.options.telemetry_dir,
            peers=peers,
            flush_interval=runtime.options.telemetry_flush_interval,
        )
    if runtime.brownout is not None:
        # the ladder's audit panel rides every flight record: a slow-solve
        # incident file answers "was the system already degrading?"
        obs.register_state("brownout", runtime.brownout.report)
        runtime.brownout.start()
    if runtime.options.log_config_file:
        runtime.log_watcher = LogLevelWatcher(runtime.options.log_config_file)
        runtime.log_watcher.start()
    from karpenter_tpu_torch.kube.apiserver import ApiCluster

    if isinstance(runtime.cluster, ApiCluster):
        runtime.cluster.start()
        if not runtime.cluster.wait_for_sync(60):
            raise RuntimeError("apiserver cache never synced")
    if runtime.options.leader_election_lease:
        from karpenter_tpu_torch.utils.lease import FileLease, LeaderElector

        def on_lost() -> None:
            # stop reconciling immediately; healthz flips 503 so the
            # liveness probe restarts the process as a fresh follower
            # (the reference exits on lost leadership)
            logger.critical("lost leadership lease; stopping controllers")
            runtime.manager.stop()

        spec = runtime.options.leader_election_lease
        if spec.startswith("kube:"):
            # cluster-scoped Lease object: kube:<namespace>/<name> (a bare
            # kube:<name> lands in kube-system)
            # (reference: cmd/controller/main.go:84-85)
            from karpenter_tpu_torch.kube.leader import KubeLease

            if not isinstance(runtime.cluster, ApiCluster):
                # an in-memory store is per-process: every replica would
                # elect itself — silent split brain
                raise ValueError(
                    "kube: leader election requires --kube-api-server "
                    "(the in-memory cluster cannot coordinate replicas)"
                )
            ns_name = spec[len("kube:"):]
            if "/" in ns_name:
                namespace, _, name = ns_name.partition("/")
            else:
                namespace, name = "kube-system", ns_name
            lease = KubeLease(
                runtime.cluster,
                name=name or "karpenter-leader-election",
                namespace=namespace or "kube-system",
            )
        else:
            lease = FileLease(spec)
        runtime.elector = LeaderElector(lease, on_lost=on_lost)
        runtime.elector.start()
        logger.info("waiting for leadership (%s)", spec)
        runtime.elector.wait_for_leadership()
    runtime.manager.start()
    if serve:
        _serve_endpoints(runtime)
    # freeze the warm heap out of future GC scans once the first worker has
    # actually warmed (built its solve) — collector passes over the
    # long-lived catalog/table objects were the solve-latency tail
    _freeze_gc_when_warm(runtime)
    logger.info(
        "karpenter-tpu controller started (provider=%s, solver=%s, device=%s)",
        runtime.cloud_provider.name(),
        runtime.options.default_solver,
        runtime.options.device,
    )
    return runtime


if __name__ == "__main__":
    import time as _time

    from karpenter_tpu_torch.options import parse_args

    rt = run_controller_process(parse_args())
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        rt.stop()
