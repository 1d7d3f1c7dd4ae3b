"""Drive the PyTorch port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):

1. build   — compile every kernel of the port from the checkout's sources
             (one nvcc per kernel source, sm_90a, all started together) and
             print what ptxas reports for each, and the card's name and
             power limit;
2. parity  — on the headline batch (instance_types(400) x
             diverse_pods(10000, Random(42)), encoded by the port), run
             pack_first_fit on the card and its plain version on CPU copies
             of the same inputs; all five outputs must be bit-exact at
             n_max 512, n_max P and a saturating n_max 64, and on a seeded
             synthetic problem with large tables; time the kernel (CUDA
             events, and per pod step) and the plain version; time it at
             each block size (bit-exact at each) beside the launch plan's;
3. main    — Scheduler.solve(solver: tpu) on cuda: one warm-up round whose
             plan must equal the device="cpu" plan of the same solve and
             open the reference's 431 nodes, then
             5 rounds with the launch counts set to 0 just before them;
             every round must pass validation and launch the kernel; then
             one more round under torch.profiler for the device's busy time
             by kernel and its idle share;
4. retry   — a batch that opens more than 512 nodes through
             Scheduler.solve: pack_dispatches == 2 and cuda == cpu;
5. v2 parity — pack_first_fit_v2 on the card against its plain version on
             CPU copies of the same inputs, all five outputs bit-exact: the
             full-width constraint-diverse batch (instance_types_tradeoff(400)
             x 10,000 pods with 64 team selectors, Random(9)) at n_max 512,
             n_max P and a saturating n_max 64; the tradeoff(64) batch at
             n_max 512; the bench's synthetic shape (P=256, S=256, C=8, F=8,
             R=4, n_max 128); a synthetic shape with pinned hostnames. Then
             CUDA-event times of pack_first_fit_v2 and of pack_first_fit on
             the full-width batch (and per pod step), the plain version's
             time on the card, and the bound; v2 with its cached
             signature-major copy against the wrapper making it per call,
             the copy itself, and both kernels at each block size;
6. diverse — Scheduler.solve on the full-width mix: a warm-up whose plan
             equals the device="cpu" plan and opens 128 nodes, then 5 rounds
             (launch counts set to 0 just before) through pack_first_fit_v2
             with their stage timings, and one profiled round;
7. multi   — sharded_multi_solve on two stacks of 8 batches of 1,250 pods:
             diverse_pods x instance_types(400) (route v1) and the team mix
             x tradeoff(400) (route v2); each equals the CPU result for every
             batch and for the cheapest types, and is timed;
8. resident — the resident delta path (Scheduler(solver_delta=True)) at
             full width. (a) headline: a warm-up whose plan equals the
             knob-off device="cpu" plan (431 nodes), then 5 steady rounds
             (launch counts set to 0 just before) that must each serve
             sort, inject, encode, decode and validate from resident state
             (*_delta_s keys), reuse PodResidency's upload, launch
             pack_first_fit once and return the warm-up's plan; one
             profiled steady round; then a cluster create + bind, after
             which the round must re-inject and encode in full and equal a
             device="cpu" resident scheduler taken through the same
             rounds. (b) team mix: 5 churn rounds (100 pods leave, 100
             arrive) and one one-pod swap that patches the resident pod
             table in place, each through pack_first_fit_v2 on the row
             delta encode rung and equal to a knob-off cuda scheduler's
             plan (first and last also to the device="cpu" plan);
9. route   — the native packer and the unfused ladder beside the kernels.
             (a) build the native packer (printing the build time) and hold
             its five outputs bit-exact against pack_first_fit (headline) and
             the unfused v2 caller (team mix) at the backend's n_max; host
             clock of native over 5 calls beside the kernels' CUDA-event
             times and the unfused callers' host times. (b) 3 headline
             rounds under KARPENTER_PACKER=pallas: pack_first_fit on the
             unfused route, one launch a round, the plan equal to phase 3's
             fused and cpu plans. (d) pack_best on the card on synthetic
             problems whose hostname ids pass 32,767 (v1 and v2 rungs), bit-
             exact against the plain version. (e) 3 headline and 3 team-mix
             rounds under auto with a fresh router: every round launches its
             kernel on the fused route, the plan equals the cpu plan, and the
             router stays empty with no native call (only a device="cpu"
             scheduler routes); pack_fetch_s is printed against (a)'s native
             time. (f) 4 resident headline rounds under
             KARPENTER_PACKER=native: from round 1 the decode and validation
             memos hit with typemask None. (c), run last: a team-mix round
             with its fused shape in the failed-fused memo takes
             pack_first_fit_v2 through pack_best (one launch, the plan equal
             to phase 6's), and pack_best on the team mix's pack_args() on
             the card is bit-exact with the plain version; at the end both
             failed-shape memos hold only what (c) put there;
11. degrade — (after phase 9; it fails first if the integrity counters
             show a quarantine, a screen failure or a canary mismatch from
             the earlier phases) the degrade ladder around both kernels, on
             fresh schedulers, both failed-shape memos restored after each
             part. (a) canary_rate=1.0 on healthy full-width rounds: 3
             headline, 3 team-mix, the retry batch (its canary at n_max =
             P) and 2 resident headline rounds; every round launches its
             kernel, equals the device="cpu" plan, and its native re-solve
             agrees (canary_solves == rounds, 0 mismatches, 0 quarantines;
             the canary's and the screen's host times printed). (b)-(f)
             reach each trigger only by injection at the Python level, at
             full width; a card scheduler has no FFD floor, so each round
             the reference would serve from its floor must raise here,
             after the reference's bookkeeping: (b) both kernels raise on
             the headline — 2 rounds raise, then the breaker is open and
             the third round raises BreakerOpen with no kernel called; (c)
             a NaN in node_req of the fetched headline buffer — screen
             failure, 1 quarantine, breaker open, one IntegrityQuarantine
             Warning event, InvalidPackError, the next round BreakerOpen
             with no launch; (d) a pod placed twice after decode on the
             team mix — 1 quarantine, InvalidPackError, the next round
             BreakerOpen with no launch; (e) SignatureOverflow on both
             encode attempts — it raises, no packer_backend, no launch; (f)
             one cpu core (1000 in the device's millicore units) added to
             node_req[0, 0] after the screen with the canary on — served
             by the kernel, 1 canary mismatch, the shape quarantined, the
             next round BreakerOpen with no launch;
12. sidecar — (after phase 11) the solver sidecar on the card at full
             width (the headline and the team mix, nothing cut). (a) always:
             a warm-up SolverService must turn ready; frames built with the
             port's codec from each batch's pack_args() go straight to
             SolverService.open_session_bytes / solve_bytes on the card:
             the session tensors pinned on the card, 3 untraced rounds at
             the node table the backend sends a sidecar (max(256, P // 4))
             whose fused buffers must equal kernel.fuse_result of the
             in-process backend.pack_unfused on the same tensors byte for
             byte, one traced round for the sidecar's [solve_s, fetch_s,
             serialize_s] trailer, served naming pack_first_fit (headline)
             or pack_first_fit_v2 (team mix) on every dispatch; then one
             frame each reaching NEEDS_CATALOG, DEADLINE_EXCEEDED,
             NEEDS_DELTA_BASE, INTEGRITY and OVERLOADED, none dispatched.
             (b) when grpc imports on this host (else it prints that the
             CPU tests hold it): serve() on the card and a device="cpu"
             Scheduler pointed at it under KARPENTER_PACKER=fused: 3
             headline and 3 team-mix rounds, 3 resident headline rounds
             (delta establish, elide, elide), a team-mix one-pod swap
             (delta patch), a checksummed round, and a round after a
             sidecar restart on the same address (re-opened through
             NEEDS_CATALOG); every round served by the sidecar with the
             card's plan, its wire and pack stages printed;
13. stream — (after phase 12) the sidecar's persistent stream at full
             width. (a) always: 8 headline and 4 team-mix Pack frames of
             equal shapes and different content (a different seeded 1% of
             each one's pods invalid) parsed by stream_parse_solve and
             served by solve_stream_group as groups of 8 and 3 (padded to
             B=4) headline and 4 team mix: each group is ONE launch of its
             kernel (pack_first_fit, pack_first_fit_v2) over the batch
             axis, every answer equals that frame's solve_bytes answer
             byte for byte, the coalesced counters move by the group; each
             group's time and its traced dispatch_s / fetch_s beside its
             frames' single solve_bytes times, and the catalog tensors'
             copy to the batch axis; a headline frame through a ShmArena
             descriptor, byte-equal; an expired deadline shed with no
             launch. (b) when grpc imports: serve(shm_dir=...) on the card
             and device="cpu" controllers with solver_stream under
             KARPENTER_PACKER=fused: 3 headline and 3 team-mix rounds on
             the stream, 3 headline rounds through the arena (wire_ser_s
             beside phase 12's), 3 resident headline rounds (establish,
             elide, elide), a round after a restart re-opened over the
             re-established stream, an 8-client salvo repeated until a
             group coalesces (every result the card's), a two-member pool
             whose session member is killed (failover through
             NEEDS_CATALOG, the outer breaker closed), and two threads on
             one scheduler through a chaos-slowed (0.5 s) sidecar in under
             2 floors; every round served by the sidecar with the card's
             plan, its transport and wire and pack stages printed;
14. obs    — (after phase 13) the observability plane around both kernels,
             at full width. Every round launches its kernel once, and each
             part (a)-(g) reads both kernels' launch counters before and
             after it and fails where they differ from its rounds; the
             kernels line reports these measured launches. (a) fresh card
             schedulers with the ring
             exporter: a warm-up and 5 traced knob-off rounds of the
             headline and of the team mix; each round launches its kernel
             once (its wrapper timed by CUDA events), equals the
             device="cpu" plan, exports one solver.solve tree with the six
             stage spans as children, each host stage within 1 ms of
             last_stage_profile() (pack_begin + pack_fetch within 1 ms of
             pack_fetch_s); a tracer hook asks the kernel's end event, as
             solve.pack_begin and solve.pack_fetch close, whether it is
             done: every fetch closes with it done, and in at least one
             round of each batch the begin closes with it running (a
             begin that waited would never); each tree's critical path
             printed. (b)
             those rounds move the encode-cache, session and
             SCHEDULING_DURATION counters by the reference's amounts; 3
             resident headline rounds move SOLVER_DELTA_APPLIED (host,
             device, decode) by 3 and set both resident-bytes gauges; a
             session opened on a card SolverService sets its HBM gauge and
             SOLVER_HBM_HEADROOM within 64 MiB of torch.cuda.mem_get_info;
             generate_latest's first 40 lines printed. (c) with
             configure_flight(budget_s=0.100), 3 knob-off headline rounds
             of a fresh scheduler: each round over budget lands on disk
             with the scheduler's five panels (the first, cold, always
             is), a resident round under it does not. (d) 5 + 5 interleaved untraced and traced rounds of each
             batch (walls printed), and under torch.profiler a traced and an
             untraced headline round do the same device work (kernel
             launches, device-to-host and host-to-device copies, after a
             discarded warm-up step and a burst of device work that any
             loss of a window's first records falls on; the most of each
             kind over three profiled rounds a mode). (e) the headline with a
             seeded 1% of its pods replaced by cpu: 100000 pods: one card
             round recorded by a DecisionLog ring; the stuck pods get
             resource_fit, every other unplaced pod is a zone
             anti-affinity pod with zone_topology (the batch's own, as
             tests/test_torch_explain.py holds against the JAX package),
             the verdicts equal a device="cpu" scheduler's, the
             .npz replays bit-exact on the native packer (obs/replay.py) and
             through pack_best on the card (one more launch), and a
             corrupted assignment is caught. (f) an SloEngine with the
             default objectives and a 5 s window: 12 knob-off headline
             rounds of a fresh scheduler (the first cold) must burn
             solve.p99 < 100ms; a BrownoutController ticked
             by hand climbs to rung 2, the router's probes pause and a
             canary_rate=1.0 round runs its kernel with no canary solve;
             resident rounds clean the window, the ladder walks back to 0
             and the next canaried round is checked again. (g) when grpc
             imports: serve() on the card with its health port and traced
             device="cpu" controller rounds — a unary headline round and a
             streamed team-mix round: each controller solver.wire span
             holds the grafted sidecar.solve / sidecar.fetch /
             sidecar.serialize records, GET /debug/traces?trace_id= on the
             sidecar's port returns its sidecar.pack tree under the
             controller's trace, parented on solve.pack_begin, and GET
             /metrics serves the port's families;
15. controller — (after phase 14) the provisioning control plane on the
             card, at full width; each part reads both kernels' launch
             counters before and after it and fails where they differ from
             its rounds (each round's pack_dispatches), the warm-up
             included. (a) the event storm (bench.py:1123-1195): the
             port's build_runtime(Options(device="cuda")) and its Manager
             (every controller main.py builds; selection wait=False, 32
             threads) over a decorated FakeCloudProvider(instance_types(400));
             a solver: tpu
             provisioner, its worker's warm-up of 2,000 pods awaited, the
             batch idle window 0.2 s; 10,000 pods (cpu 0.25/0.5/1 from
             Random(5)) created one by one until every one is bound: the
             create->bind p50 and p99, bound pods per second and the wall;
             each round's batch, kernel, route and SCHEDULING_DURATION; it
             fails on a pod bound twice, a round that names no kernel or
             raised, a node over its allocatable, nodes != virtual nodes !=
             creates, or a counter status.resources other than the nodes'
             summed capacity. (b) the headline (instance_types(400) x
             diverse_pods(10000, Random(42))) and (c) the team mix
             (instance_types_tradeoff(400) x 10,000 pods with 64 team
             selectors, Random(9)) inline: start_workers=False, the pods
             queued up front, provision_once in batches of 2,000 until the
             queue drains, then the counter; each equals a device="cpu"
             controller taking the same pods in the same order, by pod
             index (the partition into nodes, each node's labels save the
             values to_node draws at random, taints and finalizers, the
             unplaced pods, the creates, status.resources, Active); every
             (b) round launches pack_first_fit and every (c) round
             pack_first_fit_v2. (b) runs twice on the card, each after the
             worker's warm-up solve (one more launch): without the GC
             policy, then with freeze_after_warmup where the reference's
             main.py calls it (restored after its rounds); each prints the
             generation-2 collections and pauses its rounds saw;
16. deprovision — (after phase 15) the deprovisioning plane at the
             reference's consolidation size; each part reads both kernels'
             launch counters around itself. (a) BASELINE config 5
             (bench.py:1255-1303, unchanged): 1,000 live nodes of
             instance_types(400) types 300-399 (Random(7)), 16 cpu each, 1-3
             bound pods of cpu 0.5/1/2; a warm-up and 5 plans of a card
             ConsolidationController, each a new Scheduler: every plan
             launches pack_first_fit once a dispatch and no v2, re-seats
             every pod, and equals a device="cpu" controller's plan (native
             packer) node for node; each plan's wall, stage profile, the
             shadow cluster and deep copies, minimal_move_match and
             order_retirement, the TorchScheduler build and the session
             uploads printed. (b) the same layout on the team mix
             (instance_types_tradeoff(400), Random(9), node i labelled team
             t{i % 64}, its pods cpu 0.25/0.5/1 with that selector): every
             plan launches pack_first_fit_v2. (c) (a)'s plan executed with
             the bind migration under a Manager with provisioning,
             selection, node, termination, counter, pvc and both metrics
             controllers: replacements through the metered fake cloud, each
             moved pod bound once to a launched node, every retired node
             drained and removed by termination (cloud deletes = retired),
             live = kept + launched, counter = summed capacity, node gauges
             = the live nodes; the time from execute to the last retired
             node gone; a second plan equal to the device="cpu" twin's. (d)
             the evict migration: (a)'s cluster with ReplicaSet-owned pods,
             under a Manager with a card provisioning worker: the first
             reconcile retires EVICT_WAVE_SIZE nodes, termination drains
             them, the evicted pods come back pending and a card round seats
             them, the wave settles, the next reconcile retires at most
             EVICT_WAVE_SIZE more. (e) when grpc imports: one (a) plan of a
             device="cpu" controller through serve() on the card equals the
             in-process plan;
17. interruption — (after phase 16) interruption and crash-safe launch at
             full width; each part reads both kernels' launch counters
             around itself and fails where they differ from its rounds'
             pack_dispatches, the warm-ups included. (a) spot churn
             (bench.py:1308-1402 with the headline's catalog and count):
             build_runtime(Options(launch_journal=<file>)) and its Manager
             (every controller main.py builds, the interruption poll set to
             0.1 s) over a decorated FakeCloudProvider(instance_types(400)),
             a solver: tpu
             provisioner with batch idle 0.2 s; 10,000 pods (cpu
             0.1/0.25/0.5, Random(17)) bound, then 5 rounds each preempting
             ceil(5%) of the live nodes (grace 120 s) and waiting until every
             victim is gone and every released pod is bound again: notices,
             pods replaced, notice->re-bind lead time p50 and p99, each
             replacement round's batch, kernel, route and
             SCHEDULING_DURATION, the wall; it fails on evicted_unready > 0,
             a pod bound other than once a release or left unbound, a
             victim still present, a node over its allocatable, a round
             that names no kernel or raised, creates != launched nodes, or
             a journal entry left open. (b) the headline and the team mix
             seated inline in batches of 2,000, then 5% of the nodes (the
             first by pod index) noticed through handle_notice and the
             released pods seated: equal to a device="cpu" controller
             taking the same notices, by pod index (partition, taints,
             cordon, events, unplaced pods). (c) a card round through a
             LaunchCrashCluster dies before the Node write; a fresh
             collector over the file journal adopts the orphan (one Node,
             the entry resolved, one instance for the token) and the next
             round binds the pods once; a crash after the Node write
             resolves as node_exists with no second Node; a token-less
             instance past the leak grace is reaped and a young one spared;
             the counters by outcome and each sweep's wall. (d) phase 16
             (d)'s evict wave with the interruption orchestrator and a
             MemoryLaunchJournal: journaled before the first cordon, each
             victim tainted karpenter.sh/interruption=consolidation, its
             pods submitted to the card worker and never evicted, one card
             round seats them, the wave settles and its entry resolves;
             then a wave that dies after its first cordon is replayed by a
             GC sweep (consolidation_replayed) and the victim un-cordoned;
18. warmpool — (after phase 17) predictive provisioning; each part reads
             both kernels' launch counters around itself and fails where
             they differ from its rounds' pack_dispatches, the warm-ups
             included. (a) the forecast storm (bench.py:1956-2068 with its
             parameters: 30 s of ArrivalPattern(3.0, 0.7, period 15, tick 1,
             flashes at 16.5 and 24 of 24 pods over 3 s, seed 20260807),
             pods of cpu 0.25 alternating the selectors of provisioners
             fc-0 and fc-1) over a SimulatedCloudProvider whose create_fleet
             sleeps 0.5 s, build_runtime with the leg's options (a memory
             journal, garbage collection every 1 s with replay_after 3 s,
             warm-pool TTL 8 s) and its Manager, run twice on the same schedule: cold (no warm pool, no
             forecaster) and warm (the forecaster, bucket 1 s, alpha 0.35,
             horizon 8 s; the steal; a WarmPoolController, a wave every
             0.5 s, 12 warm nodes at most), then speculation paused until no
             warm node stands and no entry is open. The provisioners are
             solver: tpu on the card, where the reference's leg defaults to
             ffd. Per pass: time-to-ready p50 and p99, the spike p99, warm
             hits, misses and hit rate, speculative launches, expirations,
             each round's batch, kernel and route; the warm-over-cold spike
             speedup beside the reference's 2.0 bar (reported, not
             enforced). It fails on a pod unbound or bound twice, a leaked
             instance, an entry left open, no warm hit in the warm pass, or
             a round that names no kernel or raised. (b) the headline and
             the team mix seated inline in batches of 2,000 by a
             warm_pool=True worker over FakeCloudProvider after one wave of
             10 warm nodes (a forecaster on a fake clock): each batch steals
             first and sends the remainder to the card; equal to a
             device="cpu" controller by pod index (warm claims by rank, the
             remainder's plan, unplaced pods, the warm_claim and
             warm_pool_wave records, hits and misses by batch);
19. telemetry — (after phase 18) the telemetry plane around the card
             sidecar; each part reads both kernels' launch counters around
             itself and fails where they differ from its rounds'
             dispatches (and from what the sidecars served), the warm-ups
             included. (a) the stitched leg (bench.py:679-753): a
             device="cpu" controller under KARPENTER_PACKER=fused through a
             live in-process card sidecar, instance_types(400) x
             diverse_pods(10000, Random(7)) (pack_first_fit) and the team
             mix (pack_first_fit_v2): a warm-up and 5 measured solves each;
             every solver.solve must stitch (obs.stitch) a sidecar.pack
             carrying admission_wait_s inside its solver.wire, with real
             sidecar.solve and sidecar.fetch children; fleet_critical_path_ms,
             wire_share_pct, the joins and p99_s printed. (b) two processes:
             python -m karpenter_tpu_torch.solver.service --telemetry-dir D
             --telemetry-flush-interval 1 --profile-hz 7 on the card, ready
             after its kernel's warm-up; one headline solve through it, then
             a TelemetryCollector over the file backend until the child's
             sidecar.pack stitches under this process's solver.wire (30 s at
             most); the child's /debug/profile must hold samples, and its
             /debug/incidents and /debug/fleet answer. (c) 4 headline rounds
             of a card Scheduler without the profiler, then 32 with it at 19
             Hz: the self-accounted overhead (gate < 1 %), the samples, the
             top frames and folds, both throughputs, and each open span's
             share of the samples. (d) 4 rounds without, then 16 with
             configure_sentinel(min_events=8): gate < 1 %. (e) the regression storm
             (bench.py:2794-2968, its parameters): 160 pods in waves of 4
             (cpu 0.25) through build_runtime(Options(device="cpu",
             solver_service_address=<pool>)) over a SimulatedCloudProvider,
             the solves sent to a SidecarChaos pool of 2 card sidecars, a
             flight recorder (budget 10 s), the
             profiler at 19 Hz, 3 warm waves, freeze_after_warmup, then
             configure_sentinel(min_events=6, window=4, sustain=2,
             abs_floor_s=0.005, cooldown_s=300); at least 12 steady waves
             with no incident, then a 0.05 s latency floor on every proxy
             for up to 15 waves: exactly one incident, on a wire or device
             stage, with a pinned flight record, a decision id and a profile
             fold; sentinel overhead < 1 %; every pod bound once; every
             round a pack_first_fit launch in the sidecars;
20. process — (after phase 19) the controller process on the card; each
             part reads both kernels' launch counters around itself. (a)
             run_controller_process(parse_args([--cloud-provider
             simulated-http, --leader-election-lease <file>,
             --launch-journal <file>, --metrics-port, --health-probe-port,
             --device cuda, --telemetry-dir])) in this process, the cloud
             an in-process CloudAPIServer over SimCloudAPI reached through
             KARPENTER_CLOUD_API_URL (its create-fleet burst raised for the
             storm), then phase 15 (a)'s storm through the runtime's
             cluster: every pod bound once, the counter = summed capacity,
             nodes = virtual nodes = create_fleet calls over the wire =
             the server's running instances, every round one launch;
             /healthz, /readyz, /metrics and /debug/{profile,fleet,
             incidents} answer from the served ports; rt.stop() releases
             the lease and leaves no journal entry open; create->bind p50,
             p99 and pods per second. (b) GKE TPU podslices (gke_catalog()
             with the vendor default): 2,000 pods (Random(11): 1,600 of cpu
             0.25/0.5/1/2, 400 asking google.com/tpu 1, 4 or 8 with cpu 8,
             64 of them 4 chips pinned to gke-tpu-topology 4x4), the
             reference's 6-pod CPU-only case and 1,600 CPU-only pods, each
             one card round (one launch) equal to a device="cpu"
             Scheduler's plan pod for pod, every TPU pod on a type with
             enough chips, the 6-pod case on no TPU type, the encoded axes
             printed (the TPU axis present in the mixed batch); a 16-chip
             pod certified NO_CAPACITY by oracle.classify_drops; then the
             mixed batch through build_runtime(cloud_provider=
             GkeCloudProvider) under its Manager (a tainted tpu provisioner
             declaring the topology label, the TPU pods tolerating it):
             every pod bound, every 4x4 podslice one atomic create of 4
             hosts, every pinned pod on one. (c) two LeaderElectors on one
             file lease: exactly one leads; when it stops the other leads
             within the lease duration. The phase's wall is printed;
21. apiserver — (after phase 20) the process over the in-repo API server
             (kube/testserver.py), every client an ApiCluster over HTTP.
             (a) run_controller_process(Options(kube_api_server=<url>,
             leader_election_lease="kube:kube-system/karpenter-leader-
             election", launch_journal="kube:kube-system/launch", the client
             QPS knobs raised so the client's bucket does not pace the
             storm)) with a solver: tpu provisioner and the headline's
             10,000 diverse pods over instance_types(400), created in the
             server's store and seen through the watch: every pod bound, or
             given a PodUnschedulable event (one round), every bound pod
             bound once through one binding POST, Nodes on the server =
             virtual nodes = cloud creates, the informer cache equal to
             list_live for pods and nodes but for resourceVersions and the
             toleration relaxation adds in place (both counted);
             create->bind p50, p99 and pods per second, the REST requests by
             verb, the transport's retries and throttles, the rounds and
             their launches. (c) the same runtime under
             ApiServerChaos(throttle_rate, retry_after=0.05, seed), two PATCHes
             failed with 503 (fail_next) and one
             3 s blackout during a 2,000-pod storm: every pod bound once, no
             pod on two nodes, no launch token created twice, the leader
             never fenced, retries and throttles above 0; the journal
             entries that chaos left are swept by the process's own garbage
             collector; rt.stop() releases the Lease and leaves no journal
             entry open. (b) Scheduler over an ApiCluster whose informers hold
             200 standing nodes, their bound pods and a daemonset: the
             headline (pack_first_fit) and the team mix (pack_first_fit_v2),
             each one launch and equal to a device="cpu" Scheduler's plan
             over the same ApiCluster, pod for pod, with its stage times. (d)
             two LeaderElectors over KubeLeases on one Lease, each its own
             ApiCluster: exactly one leads, the other takes over within the
             lease duration, a blackout past expiry fences the holder and
             the first answer lifts the fence. (e) ConsolidationController
             (migration=None) over an ApiCluster picks evict; its plan runs on
             the card, the drain goes through the eviction subresource, a
             workload stand-in recreates the pods and the runtime's card
             rounds bind them all. The phase's wall is printed;
10. kernels — one JSON line listing every kernel of the port, with its
             launches on the main paths (phases 3 and 8 for pack_first_fit,
             6 and 8 for pack_first_fit_v2), on the unfused route (phase 9)
             and through the sidecar and the stream (phases 12 and 13, by
             part), phase 15's launches by part (``controller``, with
             (a)'s latencies and (b) and (c)'s round times), the native
             packer's time on the same batches,
             ``degrade``: phase 11's canary solves and mismatches and its
             launches under injection, and ``stream``: phase 13's launches
             by part and the B of each coalesced launch, and ``obs``: phase
             14's launches by part, traced kernel and fetch times, and what
             (a)-(g) measured, and ``deprovision``: phase 16's launches by
             part, each plan's wall, build, shadow and repack times, and
             ``interruption``: phase 17's launches by part, (a)'s lead
             times and rounds, (b)'s replacement rounds, (c)'s sweeps, and
             ``warmpool``: phase 18's launches by part, both passes of (a)
             and (b)'s claims and rounds, ``telemetry``: phase 19's
             launches by part and what (a)-(e) measured, ``process``:
             phase 20's launches by part and what (a)-(c) measured, and
             ``apiserver``: phase 21's launches by part and what (a)-(e)
             measured.

Every phase runs the default KARPENTER_PACKER (unset) unless it names a
value: on the card that is the device path, routed by shape. The
device="cpu" schedulers that give the reference plans route between their
plain versions and the native packer, as the default does on the CPU.
Every round of phases 3, 4, 6, 8 and 9 must name what served it (its
kernel, or native where 9 forces it): a round the FFD floor served
(ffd-degraded) or that names nothing fails the run.

Every garbage collection that stops the process for more than 0.1 s is
logged as a [gc] line with the objects still tracked.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_SOURCE = "karpenter_tpu_torch/solver/csrc/pack_first_fit.cu"
REPLACES = "karpenter_tpu/solver/pallas_kernel.py:51"  # _pack_kernel (pallas_call at :197)
V2_SOURCE = "karpenter_tpu_torch/solver/csrc/pack_first_fit_v2.cu"
V2_REPLACES = "karpenter_tpu/solver/pallas_kernel_v2.py:63"  # _pack_kernel_v2 (pallas_call at :243)
# nodes the JAX package's lax.scan kernel opens on the headline batch
HEADLINE_NODES = 431
# ... and on the full-width team mix (64 teams, two 110-pod nodes each)
DIVERSE_NODES = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def log_gc_pauses(over_s: float = 0.1):
    """Log every garbage collection that stops the process for longer than
    ``over_s``, with the objects it still tracks: a full collection of the
    script's heap stops every thread, which explains a host-clock outlier
    in whichever stage it lands. Returns the hook, for
    ``gc.callbacks.remove`` before the last lines are printed; its ``full``
    list holds the pause (s) of every generation-2 collection it saw."""
    began = {}

    def hook(phase: str, info: dict) -> None:
        me = threading.get_ident()
        if phase == "start":
            began[me] = time.perf_counter()
            return
        took = time.perf_counter() - began.pop(me, time.perf_counter())
        if info["generation"] == 2:
            hook.full.append(took)
        if took > over_s:
            log(f"[gc] generation {info['generation']} collection {took * 1e3:.1f} ms, "
                f"{len(gc.get_objects())} objects tracked")

    hook.full = []  # the pause of every generation-2 collection, in order
    gc.callbacks.append(hook)
    return hook


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def encode_batch(catalog, pods, topo_seed: int = 1):
    """The main path's host stages up to the kernel, with the port alone:
    catalog requirements, FFD sort, topology injection (Random(topo_seed)),
    daemon overhead, encode."""
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd_with_statics
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.testing import make_provisioner

    catalog = sorted(catalog, key=lambda it: it.effective_price())
    c = make_provisioner(solver="tpu").spec.constraints.clone()
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    pods, sts = sort_pods_ffd_with_statics(pods)
    cluster = Cluster()
    plan = Topology(cluster, rng=random.Random(topo_seed)).inject_plan(c, pods, sts=sts)
    return enc.encode(c, catalog, pods, daemon_overhead(cluster, c), plan=plan)


def headline_batch(n_pods: int, n_types: int, seed: int):
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.testing import diverse_pods

    return encode_batch(instance_types(n_types), diverse_pods(n_pods, random.Random(seed)))


def team_pods(n_pods: int, seed: int, k_teams: int = 64):
    """The constraint-diverse pod mix (bench.py:171-199): cpu requests of
    0.25, 0.5 or 1 and k distinct nodeSelector team values."""
    from karpenter_tpu_torch.testing import make_pod

    rng = random.Random(seed)
    return [
        make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                 node_selector={"team": f"t{i % k_teams}"})
        for i in range(n_pods)
    ]


def v2_inputs(batch, device):
    """pack_first_fit_v2's inputs exactly as the main path builds them (the
    compact pod table unpacked on the device, the per-core tables from the
    invariants cache, the fresh-node fits derived on the device) and the
    cached signature-major copy the kernel walks: (inputs, front_s)."""
    import torch

    from karpenter_tpu_torch.solver import fused, pack_kernel_v2

    tab, open_by_core, bhh = fused.pack_pod_table(batch)
    uniq = fused.pad_uniq_req(batch.uniq_req)
    pod_side = [torch.tensor(np.ascontiguousarray(a), device=device)
                for a in (tab, open_by_core, bhh, uniq)]
    front_j, compat_j, jvals, frontiers, daemon, _, _, front_s = (
        fused.DeviceInvariants(device).get_v2(batch))
    return pack_kernel_v2.kernel_inputs(
        *fused._unpack_pods(*pod_side), frontiers, daemon, front_j, compat_j, jvals
    ), front_s


def kernel_inputs(batch, device):
    """pack_first_fit's inputs exactly as the main path builds them: the
    compact pod table unpacked on the device, the invariants uploaded."""
    import torch

    from karpenter_tpu_torch.solver import fused

    tab, open_by_core, bhh = fused.pack_pod_table(batch)
    uniq = fused.pad_uniq_req(batch.uniq_req)
    pod_side = [torch.tensor(np.ascontiguousarray(a), device=device)
                for a in (tab, open_by_core, bhh, uniq)]
    join, front, daemon, _, _ = fused.DeviceInvariants(device).get(batch)
    return fused._unpack_pods(*pod_side) + (join, front, daemon)


def compare(ref, out) -> float:
    """Max |difference| over the five outputs; raises unless bit-exact."""
    import torch

    worst = 0.0
    for name, a, b in zip(ref._fields, ref, out):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        worst = max(worst, diff)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{name} differs (max |diff| {diff}) at {bad}")
    return worst


def events_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of ``fn()`` over ``iters`` calls, after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(args, n_max: int, iters: int, kernel=None, warmup: int = 3, **kw) -> float:
    """Mean CUDA-event time of ``kernel`` (pack_first_fit by default) over
    ``iters`` launches, after ``warmup`` launches."""
    from karpenter_tpu_torch.solver.pack_kernel import pack_first_fit

    kernel = kernel or pack_first_fit
    return events_ms(lambda: kernel(*args, n_max=n_max, **kw), iters, warmup)


def sweep(name: str, args, n_max: int, shape, ref, iters: int, card: str,
          kernel=None, **kw) -> None:
    """The kernel at each block size (G and the node table's place from the
    launch plan for ``shape`` = (F, R)), each result bit-exact with ``ref``;
    CUDA-event times."""
    from karpenter_tpu_torch.solver import pack_kernel

    kernel = kernel or pack_kernel.pack_first_fit
    F, R = shape
    default = pack_kernel.launch_plan(F, R, n_max)
    parts = []
    for threads in (t for t in (128, 256, 512, 1024) if t <= pack_kernel.max_threads(default.G)):
        plan = pack_kernel.launch_plan(F, R, n_max, threads=threads)
        compare(ref, kernel(*args, n_max=n_max, plan=plan, **kw))
        ms = kernel_ms(args, n_max, iters, kernel, 1, plan=plan, **kw)
        mark = " (the plan's)" if plan == default else ""
        parts.append(f"{threads} threads {ms:.4f} ms{mark}")
    log(f"[sweep] {name} n_max={n_max} G={default.G} smem nodes={default.node_state_in_smem}: "
        + ", ".join(parts) + f"; CUDA events, mean of {iters}; card {card}")


def bound(n_bytes: int, ops: int):
    """(bound_ms, bound_by): the bytes over HBM bandwidth against the
    operations over the f32 rate, whichever takes longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def walk(le):
    """A first-fit frontier walk over ``le`` [k, F, R] (does total r fit
    row f?) for k nodes: the compares each needs (each row until its first
    failing axis, rows until the first that fits), the rows each reads, and
    whether a row fits."""
    k, F, R = le.shape
    row_fit = le.all(2)
    fits = row_fit.any(1)
    rows = np.where(fits, row_fit.argmax(1) + 1, F)
    per_row = np.where(row_fit, R, (~le).argmax(2) + 1)
    return (per_row * (np.arange(F)[None, :] < rows[:, None])).sum(1), rows, fits


def replay_work(pods, assignment, joins, limits, shape):
    """Replay the first-fit recurrence along a kernel's own assignment and
    count the work this run's data needs. Per valid pod: one joinability
    compare per open node, one hostname compare per joining node when the
    pod pins a hostname, and, for the nodes that join and admit it up to
    the first that fits, R adds and the frontier walk; R adds when it opens
    a node. ``joins(core, sigs)`` gives (joinable, joined id) and
    ``limits(core, sigs, ids)`` the [k, F, R] limits. Returns (ops, compat,
    rows, jv): which (core, sig) joinabilities were read, how many frontier
    rows each (core, sig) column had read, and which joined ids were read.
    Raises where the replay's first fit is not the kernel's."""
    valid, open_sig, core, host, hib, open_host, req, daemon = pods
    n_cap, C, S = shape
    R = req.shape[1]
    node_sig = np.full(n_cap, -1, np.int64)
    node_host = np.full(n_cap, -1, np.int64)
    node_req = np.zeros((n_cap, R), np.float32)
    compat = np.zeros((C, S), bool)
    rows_read = np.zeros((C, S), np.int64)
    jv = np.zeros((C, S), bool)
    count = ops = 0
    for i in np.flatnonzero(valid):
        c, h, a = int(core[i]), int(host[i]), int(assignment[i])
        target, jid = -1, None
        if count:
            sigs = node_sig[:count]
            ok, jid = joins(c, np.maximum(sigs, 0))
            ok = ok & (sigs >= 0)
            ops += count
            compat[c, sigs[sigs >= 0]] = True
            if h >= 0:
                ops += int(ok.sum())
                nh = node_host[:count]
                ok &= ((nh == -1) & bool(hib[i])) | (nh == h)
            cand = np.flatnonzero(ok)
            if cand.size:
                totals = node_req[cand] + req[i]
                cmps, rows, fits = walk(totals[:, None, :] <= limits(c, sigs[cand], jid[cand]))
                stop = int(fits.argmax()) + 1 if fits.any() else cand.size
                ops += stop * R + int(cmps[:stop].sum())
                np.maximum.at(rows_read[c], sigs[cand[:stop]], rows[:stop])
                if fits.any():
                    target = int(cand[stop - 1])
        if target >= 0:
            if a != target:
                raise AssertionError(f"work replay: pod {i} fits node {target}, kernel gave {a}")
            jv[c, node_sig[target]] = True
            node_req[target] += req[i]
            node_sig[target] = jid[target]
            if h >= 0:
                node_host[target] = h
        elif a == count:
            node_sig[a], node_host[a] = open_sig[i], open_host[i]
            node_req[a] = daemon + req[i]
            ops += R
            count += 1
        elif a != -1:
            raise AssertionError(f"work replay: pod {i} fits no open node, kernel gave {a}")
    return ops, compat, rows_read, jv


def nbytes(tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def v1_work(args, result):
    """(bytes, ops) pack_first_fit needs on this run: every input read once
    (the join table and frontiers whole; they are a few hundred bytes at the
    headline) and every output written once; the replay's operations plus
    each valid pod's fresh-node walk (R adds, then its open signature's
    frontier rows)."""
    valid, open_sig, core, host, hib, open_host, req, join, frontiers, daemon = (
        a.cpu().numpy() for a in args)
    F, R = frontiers.shape[1:]
    ops, _, _, _ = replay_work(
        (valid, open_sig, core, host, hib, open_host, req, daemon),
        result.assignment.cpu().numpy(),
        lambda c, sigs: (join[sigs, c] >= 0, join[sigs, c]),
        lambda c, sigs, ids: frontiers[ids],
        (result.node_sig.shape[-1], join.shape[1], join.shape[0]),
    )
    cmps, _, _ = walk((daemon + req)[valid][:, None, :] <= frontiers[open_sig[valid]])
    ops += int(valid.sum()) * R + int(cmps.sum())
    return nbytes(args) + nbytes(result), ops


def v2_work(args, result, F: int, R: int):
    """(bytes, ops) pack_first_fit_v2 needs on this run: the pod side read
    once, of the tables only the joinabilities, the frontier rows and the
    joined ids that the recurrence reads, and every output written once; the
    replay's operations (the fresh-node fits are an input)."""
    pod_scal, pod_req, front_j, compat_j, jvals, open_fits, daemon = (
        a.cpu().numpy() for a in args)
    C, _, S_pad = front_j.shape
    ops, compat, rows_read, jv = replay_work(
        (pod_scal[0] != 0, *pod_scal[1:4], pod_scal[4] != 0, pod_scal[5],
         np.ascontiguousarray(pod_req.T), daemon[:, 0]),
        result.assignment.cpu().numpy(),
        lambda c, sigs: (compat_j[c, 0, sigs] > 0.5, np.rint(jvals[c, 0, sigs]).astype(np.int64)),
        lambda c, sigs, ids: front_j[c, : F * R, sigs].reshape(-1, F, R),
        (result.node_sig.shape[-1], C, S_pad),
    )
    n_bytes = nbytes((args[0], args[1], args[5], args[6])) + nbytes(result)
    n_bytes += 4 * (int(compat.sum()) + int(rows_read.sum()) * R + int(jv.sum()))
    return n_bytes, ops


def profile_round(run, card: str) -> None:
    """One more main-path round under torch.profiler: device busy time by
    kernel, and the device's idle share of the round's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for row in prof.key_averages():
        us = row.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, row.count, row.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        log(f"[profile] round {wall_ms:.3f} ms; device time not measured "
            "(the profiler recorded no device activity)")
        return
    log(f"[profile] round {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}; card {card}")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms:9.4f} ms  x{count:<3d} {key[:90]}")


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         n.requests, n.constraints.requirements.requirements)
        for n in nodes
    ]


def served(sched, want: str, where: str) -> dict:
    """The round's profile; raises unless ``want`` served it — never the
    FFD floor (``ffd-degraded``), never a round without a name."""
    prof = sched.last_stage_profile()
    got = prof.get("packer_backend")
    if got != want:
        floor = " (the FFD floor)" if got in ("ffd-degraded", None) else ""
        raise AssertionError(f"{where}: served by {got!r}{floor}, expected {want}")
    return prof


def not_degraded(sched, where: str) -> dict:
    """A device="cpu" reference round's profile; raises when the floor
    served it or it names nothing."""
    prof = sched.last_stage_profile()
    if prof.get("packer_backend") in ("ffd-degraded", None):
        raise AssertionError(f"{where}: the reference round took the FFD floor "
                             f"({prof.get('packer_backend')!r})")
    return prof


def v2_parity(name: str, gpu, n_max: int, F: int, R: int, front_s=None) -> tuple:
    """pack_first_fit_v2 on the card against pack_v2_reference on CPU copies
    of the same inputs; raises unless bit-exact. Returns (result, max |diff|)."""
    import torch

    from karpenter_tpu_torch.solver import pack_kernel_v2
    from karpenter_tpu_torch.solver.kernel import pack_v2_reference

    out = pack_kernel_v2.pack_first_fit_v2(*gpu, n_max=n_max, F=F, R=R, front_s=front_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pack_v2_reference(*(a.cpu() for a in gpu), n_max=n_max, F=F, R=R)
    cpu_s = time.perf_counter() - t0
    worst = compare(ref, out)
    n = int(out.n_nodes)
    hosts = set(out.node_host[:n].tolist())
    log(f"[v2 parity] {name} n_max={n_max}: bit-exact, nodes={n} "
        f"unscheduled={int(((out.assignment < 0) & (gpu[0][0] != 0)).sum())} "
        f"host states -2:{-2 in hosts} -1:{-1 in hosts} h:{bool(hosts) and max(hosts) >= 0} "
        f"(plain version on CPU {cpu_s:.2f}s)")
    return out, worst


def synthetic_args(P: int, S: int, F: int, R: int, C: int, seed: int, n_hosts: int, device,
                   host_base: int = 0):
    """A seeded synthetic problem in pack_args() form. With ``n_hosts`` > 0
    half the pods pin a hostname id in [host_base, host_base + n_hosts)
    (node states -2, -1 and h), a tenth of the signatures have only
    FRONTIER_PAD rows and the back half of every frontier is PAD; with 0 it
    is the bench's shape (bench.py:206-220: no hostnames, no daemon)."""
    import torch

    rng = np.random.default_rng(seed)
    if n_hosts:
        host = np.where(rng.random(P) < 0.5, host_base + rng.integers(0, n_hosts, P), -1)
        hib = rng.random(P) < 0.7
        frontiers = rng.uniform(2.0, 8.0, (S, F, R))
        frontiers[:, F // 2:, :] = -1.0
        frontiers[rng.random(S) < 0.1] = -1.0
        core = rng.integers(0, C, P)
        open_sig = rng.integers(0, S, C)[core]
        req = rng.uniform(0.1, 1.5, (P, R))
        join = rng.integers(-1, S, (S, C))
        daemon = rng.uniform(0.0, 0.5, R)
        valid = rng.random(P) < 0.95
    else:
        host, hib, valid = np.full(P, -1), np.ones(P, bool), np.ones(P, bool)
        open_sig = rng.integers(0, S, P)
        core = rng.integers(0, C, P)
        req = rng.uniform(0.1, 1.0, (P, R))
        join = rng.integers(-1, S, (S, C))
        frontiers = rng.uniform(2.0, 16.0, (S, F, R))
        daemon = np.zeros(R)
    i32, f32 = torch.int32, torch.float32
    return (
        torch.tensor(valid, device=device),
        torch.tensor(open_sig, dtype=i32, device=device),
        torch.tensor(core, dtype=i32, device=device),
        torch.tensor(host, dtype=i32, device=device),
        torch.tensor(hib, device=device),
        torch.tensor(np.where(host >= 0, np.where(hib, host, -2), -1), dtype=i32, device=device),
        torch.tensor(req, dtype=f32, device=device),
        torch.tensor(join, dtype=i32, device=device),
        torch.tensor(frontiers, dtype=f32, device=device),
        torch.tensor(daemon, dtype=f32, device=device),
    )


def synthetic_v2(P: int, S: int, F: int, R: int, C: int, seed: int, n_hosts: int, device):
    """``synthetic_args``' problem as pack_first_fit_v2's inputs."""
    from karpenter_tpu_torch.solver import pack_kernel_v2

    return pack_kernel_v2.v2_args(*synthetic_args(P, S, F, R, C, seed, n_hosts, device))


def multi_stack(batches, catalog):
    """Stack batches that share their encoded shapes (asserted) for
    sharded_multi_solve: (arrays, type masks, usable, prices)."""
    shapes = {tuple(np.asarray(a).shape for a in b.pack_args()) for b in batches}
    if len(shapes) != 1:
        raise AssertionError(f"batches of one stack encode to different shapes: {shapes}")
    arrays = tuple(np.stack([np.asarray(b.pack_args()[i]) for b in batches]) for i in range(10))
    mask = np.stack([b.type_mask_matrix() for b in batches])
    prices = np.array(sorted(it.effective_price() for it in catalog), np.float32)
    return arrays, mask, batches[0].usable, prices


def diverse_phases(dev, card: str) -> tuple:
    """Phases 5-7: the v2 kernel against its plain version, the diverse main
    path, the multi-solve. Returns pack_first_fit_v2's kernels-line numbers
    and what phase 9 reuses of the team mix."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.parallel.sharding import sharded_multi_solve
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver.backend import KERNELS
    from karpenter_tpu_torch.solver.kernel import pack_v2_reference
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    # -- 5. v2 kernel against its plain version ---------------------------
    t0 = time.perf_counter()
    batch = encode_batch(instance_types_tradeoff(400), team_pods(10000, 9))
    P = len(batch.pod_valid)
    S, C = batch.join_table.shape
    F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
    route = pack_kernel_v2.fused_route(S, F, R, C)
    log(f"[v2 parity] full-width batch P={P} S={S} F={F} R={R} C={C} S*F={S * F} "
        f"tables={pack_kernel_v2.v2_table_bytes(S, F, R, C)} bytes route={route} "
        f"(encoded in {time.perf_counter() - t0:.2f}s)")
    if route != "v2":
        raise AssertionError(f"full-width batch routed {route}")
    gpu, front_s = v2_inputs(batch, dev)
    worst = 0.0
    results = {}
    for n_max in (512, P, 64):
        results[n_max], err = v2_parity("full width", gpu, n_max, F, R, front_s)
        worst = max(worst, err)
    if int(results[512].n_nodes) != DIVERSE_NODES or int(results[64].n_nodes) != 64:
        raise AssertionError(f"full width opened {int(results[512].n_nodes)} nodes at 512 "
                             f"and {int(results[64].n_nodes)} at 64")
    b64 = encode_batch(instance_types_tradeoff(64), team_pods(10000, 9))
    F64 = b64.frontiers.shape[1]
    gpu64, front_s64 = v2_inputs(b64, dev)
    worst = max(worst, v2_parity(f"tradeoff(64) F={F64}", gpu64, 512, F64, R, front_s64)[1])
    worst = max(worst, v2_parity("bench synthetic P=256 S=256 C=8 F=8 R=4",
                                 synthetic_v2(256, 256, 8, 4, 8, 7, 0, dev), 128, 8, 4)[1])
    pinned = synthetic_v2(4096, 200, 8, 4, 16, 7, 120, dev)
    for n_max in (1024, 4096):
        worst = max(worst, v2_parity("pinned synthetic P=4096 S=200 C=16 F=8 R=4",
                                     pinned, n_max, 8, 4)[1])

    t0 = time.perf_counter()
    pack_kernel_v2.pack_first_fit_v2(*gpu, n_max=512, F=F, R=R, front_s=front_s)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    iters = max(3, min(20, int(2000 / max(first_ms, 1e-3))))
    v2_kw = dict(F=F, R=R, front_s=front_s)
    ms_v2 = kernel_ms(gpu, 512, iters, pack_kernel_v2.pack_first_fit_v2, 1, **v2_kw)
    ms_v2_p = kernel_ms(gpu, P, iters, pack_kernel_v2.pack_first_fit_v2, 1, **v2_kw)
    v1 = kernel_inputs(batch, dev)
    ms_v1 = kernel_ms(v1, 512, iters, warmup=1)
    same = compare(pack_kernel.pack_first_fit(*v1, n_max=512), results[512])

    # the signature-major copy the walk reads: cached per closure on the main
    # path, made per call by the wrapper on the multi-solve; and the copy alone
    ms_copy = events_ms(lambda: pack_kernel_v2.signature_major(gpu[2]), 20)
    ms_per_call = kernel_ms(gpu, 512, iters, pack_kernel_v2.pack_first_fit_v2, 1, F=F, R=R)
    log(f"[v2 layout] full width n_max=512: with the cached signature-major copy "
        f"{ms_v2:.4f} ms; the wrapper copying per call {ms_per_call:.4f} ms; the copy "
        f"{ms_copy:.4f} ms; CUDA events, mean of {iters}; card {card}")
    sweep("pack_first_fit_v2 diverse", gpu, 512, (F, R), results[512], iters, card,
          pack_kernel_v2.pack_first_fit_v2, **v2_kw)
    sweep("pack_first_fit diverse", v1, 512, (F, R), results[512], iters, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pack_v2_reference(*gpu, n_max=512, F=F, R=R)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare(plain, results[512]), same)
    n_bytes, n_ops = v2_work(gpu, results[512], F, R)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"[v2 parity] full width: pack_first_fit_v2 {ms_v2:.4f} ms at n_max=512 "
        f"({ms_v2 * 1e6 / P:.1f} ns per pod step), {ms_v2_p:.4f} ms at n_max={P}; "
        f"pack_first_fit on the same batch {ms_v1:.4f} ms ({ms_v1 * 1e6 / P:.1f} ns per pod "
        f"step; same five outputs); CUDA events, mean of {iters}; plain version on the card "
        f"{plain_ms:.1f} ms; bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, "
        f"{n_ops} ops); card {card}")

    # -- 6. diverse main path ---------------------------------------------
    catalog = instance_types_tradeoff(400)
    pods = team_pods(10000, 9)
    prov = make_provisioner(solver="tpu")
    sched = Scheduler(Cluster(), rng=random.Random(1))
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit_v2", "diverse warm-up")
    log(f"[diverse] warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    t0 = time.perf_counter()
    cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    cpu_nodes = cpu_sched.solve(prov, catalog, pods)
    cpu_s = time.perf_counter() - t0
    not_degraded(cpu_sched, "diverse cpu plan")
    if plan_of(warm, pods) != plan_of(cpu_nodes, pods):
        raise AssertionError("diverse: cuda plan differs from the device='cpu' plan")
    if len(warm) != DIVERSE_NODES:
        raise AssertionError(f"diverse path opened {len(warm)} nodes, expected {DIVERSE_NODES}")
    log(f"[diverse] cuda plan == cpu plan ({len(cpu_nodes)} nodes, "
        f"{sum(len(n.pods) for n in cpu_nodes)} pods placed; cpu solve {cpu_s:.2f}s)")

    pack_kernel_v2.launches = 0
    rounds = []
    for r in range(5):
        before = pack_kernel_v2.launches
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit_v2", f"diverse round {r}")
        if pack_kernel_v2.launches <= before:
            raise AssertionError(f"diverse round {r} did not launch pack_first_fit_v2")
        if len(nodes) != DIVERSE_NODES:
            raise AssertionError(f"diverse round {r}: {len(nodes)} nodes")
        rounds.append(wall)
        stages = " ".join(
            f"{k}={prof[k] * 1e3:.3f}ms"
            for k in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s")
        )
        log(f"[diverse] round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, dispatches={prof['pack_dispatches']}, {stages}")
    launches = pack_kernel_v2.launches
    mean = sum(rounds) / len(rounds)
    log(f"[diverse] 5 rounds: mean {mean * 1e3:.3f} ms, {len(pods) / mean:.1f} pods/s, "
        f"pack_first_fit_v2 launches {launches}; kernel alone {ms_v2:.4f} ms (CUDA events); "
        f"card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    # -- 7. multi-solve -----------------------------------------------------
    stacks = {
        "v1": (instance_types(400), [diverse_pods(1250, random.Random(100 + b)) for b in range(8)]),
        "v2": (instance_types_tradeoff(400), [team_pods(1250, 100 + b) for b in range(8)]),
    }
    for want, (cat, pod_sets) in stacks.items():
        t0 = time.perf_counter()
        batches = [encode_batch(cat, ps, topo_seed=b) for b, ps in enumerate(pod_sets)]
        arrays, mask, usable, prices = multi_stack(batches, cat)
        encode_s = time.perf_counter() - t0
        B, Pm = arrays[6].shape[:2]
        n_max = max(256, Pm // 4)
        module = pack_kernel_v2 if want == "v2" else pack_kernel
        ref, ref_cheapest, _ = sharded_multi_solve("cpu", arrays, mask, usable, prices, n_max)
        before = module.launches
        out, cheapest, report = sharded_multi_solve(dev, arrays, mask, usable, prices, n_max)
        torch.cuda.synchronize()
        if report["route"] != KERNELS[want][0] or module.launches != before + 1:
            raise AssertionError(f"multi {want}: route {report}, {module.launches - before} launches")
        compare(ref, out)
        if not torch.equal(ref_cheapest, cheapest.cpu()):
            raise AssertionError(f"multi {want}: cheapest types differ from the cpu result")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            sharded_multi_solve(dev, arrays, mask, usable, prices, n_max)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3 / 3
        log(f"[multi] {want}: B={B} P={Pm} S={report['S']} F={report['F']} n_max={n_max} "
            f"route={report['route']} nodes={out.n_nodes.tolist()} == cpu for every batch and "
            f"cheapest; sharded_multi_solve {solve_ms:.3f} ms (host clock, mean of 3, "
            f"stack encoded in {encode_s:.2f}s); card {card}")

    return {
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms_v2,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "ns_per_pod": ms_v2 * 1e6 / P,
    }, {
        # for phase 9: the team mix's pods and device="cpu" plan, and the v2
        # result at n_max 512 that phase 5 held bit-exact with the plain version
        "pods": pods,
        "cpu_plan": plan_of(cpu_nodes, pods),
        "plain_512": results[512],
    }


DELTA_KEYS = ("sort_delta_s", "inject_delta_s", "encode_delta_s", "decode_delta_s",
              "validate_delta_s")


def stage_line(prof) -> str:
    """Every ``*_s`` stage of a round's profile, in the order it ran."""
    order = ("sort", "inject", "encode", "pack_fetch", "decode", "validate")
    keys = [k for st in order for k in (f"{st}_s", f"{st}_delta_s") if k in prof]
    return " ".join(f"{k}={prof[k] * 1e3:.3f}ms" for k in keys)


def resident_phase(dev, card: str) -> dict:
    """Phase 8: the resident delta path at full width on both routes.
    Returns each kernel's launches in the phase's measured rounds."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner

    prov = make_provisioner(solver="tpu")

    # -- (a) headline, steady state ----------------------------------------
    catalog = instance_types(400)
    pods = diverse_pods(10000, random.Random(42))
    cluster = Cluster()
    sched = Scheduler(cluster, rng=random.Random(1), solver_delta=True)
    residency = sched.torch._pod_residency
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    log(f"[resident] headline warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}, "
        f"{stage_line(served(sched, 'pack_first_fit', 'resident headline warm-up'))}")
    warm_plan = plan_of(warm, pods)
    off_cpu = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_delta=False)
    if warm_plan != plan_of(off_cpu.solve(prov, catalog, pods), pods):
        raise AssertionError("resident headline: warm-up plan differs from the knob-off cpu plan")
    not_degraded(off_cpu, "resident headline knob-off cpu plan")
    if len(warm) != HEADLINE_NODES:
        raise AssertionError(f"resident headline opened {len(warm)} nodes, expected {HEADLINE_NODES}")
    # the cpu twin takes the warm-up and, later, the same mutation; the
    # steady rounds in between reuse the plan and draw no hostname
    twin_cluster = Cluster()
    twin = Scheduler(twin_cluster, rng=random.Random(1), device="cpu", solver_delta=True)
    if plan_of(twin.solve(prov, catalog, pods), pods) != warm_plan:
        raise AssertionError("resident headline: the cpu twin's warm-up plan differs")
    not_degraded(twin, "resident headline cpu twin warm-up")
    log(f"[resident] headline warm-up plan == knob-off cpu plan == cpu twin ({len(warm)} nodes)")

    pack_kernel.launches = 0
    rounds = []
    for r in range(5):
        before, reused = pack_kernel.launches, residency.stats["reused"]
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit", f"resident headline round {r}")
        missing = [k for k in DELTA_KEYS if k not in prof]
        if missing:
            raise AssertionError(f"resident headline round {r}: no {missing} in {sorted(prof)}")
        if pack_kernel.launches != before + 1:
            raise AssertionError(f"resident headline round {r}: {pack_kernel.launches - before} "
                                 f"launches of {prof['packer_backend']}")
        if residency.stats["reused"] != reused + 1:
            raise AssertionError(f"resident headline round {r}: PodResidency {residency.stats}")
        if plan_of(nodes, pods) != warm_plan:
            raise AssertionError(f"resident headline round {r}: plan differs from the warm-up's")
        rounds.append(wall)
        log(f"[resident] headline round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, {stage_line(prof)}")
    launches_v1 = pack_kernel.launches
    mean = sum(rounds) / len(rounds)
    log(f"[resident] headline 5 steady rounds: mean {mean * 1e3:.3f} ms, "
        f"{len(pods) / mean:.1f} pods/s, pack_first_fit launches {launches_v1}, "
        f"PodResidency {residency.stats}; card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    for c in (cluster, twin_cluster):
        late = c.create("pods", make_pod(name="resident-late", requests={"cpu": "0.5"}))
        c.bind(late, "resident-node-0")
    t0 = time.perf_counter()
    nodes = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = served(sched, "pack_first_fit", "resident headline after create + bind")
    if "inject_s" not in prof or "encode_s" not in prof:
        raise AssertionError(f"resident headline: the round after a bind kept {sorted(prof)}")
    if plan_of(nodes, pods) != plan_of(twin.solve(prov, catalog, pods), pods):
        raise AssertionError("resident headline: the post-bind plan differs from the cpu twin's")
    not_degraded(twin, "resident headline cpu twin after create + bind")
    log(f"[resident] headline after create + bind: {wall * 1e3:.3f} ms, re-injected and "
        f"encoded in full, plan == cpu twin ({len(nodes)} nodes), {stage_line(prof)}")

    # -- (b) team mix, churn -------------------------------------------------
    catalog = instance_types_tradeoff(400)
    pods = team_pods(10000, 9)
    sched = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
    residency = sched.torch._pod_residency
    off = Scheduler(Cluster(), rng=random.Random(1), solver_delta=False)
    off_cpu = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_delta=False)
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit_v2", "resident team mix warm-up")
    log(f"[resident] team mix warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    if plan_of(warm, pods) != plan_of(off.solve(prov, catalog, pods), pods):
        raise AssertionError("resident team mix: warm-up plan differs from the knob-off plan")
    served(off, "pack_first_fit_v2", "resident team mix knob-off warm-up")

    rng = random.Random(11)
    churn = []
    for r in range(5):
        leave = set(rng.sample(range(len(pods)), 100))
        arrive = [make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                           node_selector={"team": f"t{rng.randrange(64)}"}) for _ in range(100)]
        pods = [p for i, p in enumerate(pods) if i not in leave] + arrive
        churn.append(("churn", pods))
    # the last pod swapped for one with its cpu request and another team
    # that has pods earlier in the batch: same sorted position, one column
    last = pods[-1]
    team = last.spec.node_selector["team"]
    other = next(p.spec.node_selector["team"] for p in pods
                 if p.spec.node_selector["team"] != team)
    swap = make_pod(requests={"cpu": str(last.spec.containers[0].requests["cpu"])},
                    node_selector={"team": other})
    churn.append(("swap", pods[:-1] + [swap]))

    def timed(scheduler, batch_pods):
        t0 = time.perf_counter()
        nodes = scheduler.solve(prov, catalog, batch_pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return nodes, wall, served(scheduler, "pack_first_fit_v2", "resident team mix round")

    # the knob-off comparisons launch the kernel too: only the resident
    # scheduler's launches are summed. The knob-off round on the same pods
    # runs beside each resident round, first on odd rounds, so the two are
    # timed in turns on one host
    pack_kernel_v2.launches = 0
    launches_v2 = 0
    off_walls, res_walls = [], []
    for r, (kind, batch_pods) in enumerate(churn):
        if r % 2:
            off_nodes, off_wall, off_prof = timed(off, batch_pods)
        before, stats = pack_kernel_v2.launches, dict(residency.stats)
        table = residency._entry[1][0]
        ptr = table.data_ptr()
        nodes, wall, prof = timed(sched, batch_pods)
        launched = pack_kernel_v2.launches - before
        launches_v2 += launched
        if launched != 1 or prof["packer_backend"] != "pack_first_fit_v2":
            raise AssertionError(f"resident team mix round {r}: {launched} "
                                 f"launches of {prof['packer_backend']}")
        if "encode_delta_s" not in prof:
            raise AssertionError(f"resident team mix round {r}: not the row delta, {sorted(prof)}")
        if not r % 2:
            off_nodes, off_wall, off_prof = timed(off, batch_pods)
        off_walls.append(off_wall)
        res_walls.append(wall)
        plan = plan_of(nodes, batch_pods)
        if plan != plan_of(off_nodes, batch_pods):
            raise AssertionError(f"resident team mix round {r}: plan differs from knob off")
        checked = "knob-off cuda plan"
        if r in (0, len(churn) - 1):
            if plan != plan_of(off_cpu.solve(prov, catalog, batch_pods), batch_pods):
                raise AssertionError(f"resident team mix round {r}: plan differs from the cpu plan")
            not_degraded(off_cpu, f"resident team mix round {r} cpu plan")
            checked += " and cpu plan"
        if kind == "swap":
            patched_in_place = (residency.stats["patched"] == stats["patched"] + 1
                                and residency._entry[1][0] is table and table.data_ptr() == ptr)
            if not patched_in_place:
                raise AssertionError(f"resident team mix swap round: not patched in place, "
                                     f"{stats} -> {residency.stats}")
        log(f"[resident] team mix round {r} ({kind}): {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(batch_pods) / wall:.1f}, == {checked}, {stage_line(prof)}, "
            f"PodResidency {residency.stats}")
        log(f"[resident] team mix round {r} knob off ({'first' if r % 2 else 'second'}): "
            f"{off_wall * 1e3:.3f} ms, {stage_line(off_prof)}")
    log(f"[resident] team mix: mean {sum(res_walls) / len(res_walls) * 1e3:.3f} ms resident, "
        f"{sum(off_walls) / len(off_walls) * 1e3:.3f} ms knob off over the same {len(churn)} "
        f"rounds; card {card}")
    log(f"[resident] team mix: {len(churn)} rounds, pack_first_fit_v2 launches {launches_v2}, "
        f"PodResidency {residency.stats}; card {card}")
    return {"pack_first_fit": launches_v1, "pack_first_fit_v2": launches_v2}


def host_ms(fn, iters: int) -> tuple:
    """(mean, min) host-clock ms of ``fn()`` over ``iters`` calls, after
    one call not timed."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / len(times), min(times)


def device_args(batch, device):
    """``batch.pack_args()`` as tensors on ``device``."""
    import torch

    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

    return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
                 for a, (_, dtype) in zip(batch.pack_args(), PACK_ARG_DTYPES))


def host_result(result):
    """A PackResult over numpy arrays (the native packer's) as tensors."""
    import torch

    from karpenter_tpu_torch.solver.kernel import PackResult

    return PackResult(*(torch.as_tensor(np.asarray(a)) for a in result))


def route_phase(dev, card: str, classes: dict, n_pods: int = 10000) -> dict:
    """Phase 9: the cost router, the native packer and the unfused ladder.
    ``classes`` holds, for the headline and the team mix of ``n_pods``
    pods, phase 3's and phase 6's pods and device="cpu" plans (and the
    team mix's plain-version result at n_max 512). Returns each kernel's
    kernels-line additions."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, native, pack_kernel, pack_kernel_v2, router
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    head_cat, team_cat = instance_types(400), instance_types_tradeoff(400)
    batches = {
        "headline": headline_batch(n_pods, 400, 42),
        "team mix": encode_batch(team_cat, team_pods(n_pods, 9)),
    }
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    module_of = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    catalog_of = {"headline": head_cat, "team mix": team_cat}
    out = {name: {} for name in module_of}

    def timed(sched, pods, cls):
        # a knob-off scheduler draws new hostnames on every topology round:
        # each round replays the same draws (the topology rng reseeded as a
        # new scheduler's), so its plan is held against the cpu plan. solve
        # returns once its result is on the host
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog_of[cls], pods)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        prof = sched.last_stage_profile()
        if prof.get("packer_backend") in ("ffd-degraded", None):
            raise AssertionError(f"route {cls}: the round took the FFD floor "
                                 f"({prof.get('packer_backend')!r})")
        if plan_of(nodes, pods) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"route {cls}: plan differs from the device='cpu' plan "
                                 f"({prof.get('packer_backend')}, {prof.get('pack_route')})")
        return prof, wall

    # -- (a) the native packer against the kernels on the same batches -----
    t0 = time.perf_counter()
    if not native.native_available(wait=180):
        raise AssertionError("the native packer did not build (g++ -O3 -shared -fPIC)")
    log(f"[route] native packer built and loaded in {time.perf_counter() - t0:.2f}s "
        f"({native.lib_path().parent.name})")
    for cls, batch in batches.items():
        name = kernel_of[cls]
        P = len(batch.pod_valid)
        n_max = max(256, P // 4)  # the backend's native and unfused table
        args = batch.pack_args()
        gpu = device_args(batch, dev)
        unfused = (pack_kernel.pack_first_fit if name == "pack_first_fit"
                   else pack_kernel_v2.pack_unfused_v2)
        ref = unfused(*gpu, n_max=n_max)
        torch.cuda.synchronize()
        worst = compare(ref, host_result(native.pack_native(*args, n_max=n_max)))
        nat_ms, nat_min = host_ms(lambda: native.pack_native(*args, n_max=n_max), 5)
        nat512_ms, nat512_min = host_ms(lambda: native.pack_native(*args, n_max=512), 5)
        if name == "pack_first_fit":
            k_ms = kernel_ms(gpu, n_max, 5, warmup=1)
        else:
            inputs = pack_kernel_v2.v2_args(*gpu)
            F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
            k_ms = kernel_ms(inputs, n_max, 5, pack_kernel_v2.pack_first_fit_v2, 1, F=F, R=R,
                             front_s=pack_kernel_v2.signature_major(inputs[2]))

        def unfused_call():
            unfused(*gpu, n_max=n_max)
            torch.cuda.synchronize()

        unf_ms, unf_min = host_ms(unfused_call, 3)
        log(f"[route] (a) {cls} P={P} n_max={n_max}: native == {name} bit for bit "
            f"(max |diff| {worst}), {int(ref.n_nodes)} nodes; native {nat_ms:.4f} ms "
            f"(min {nat_min:.4f}) at n_max={n_max}, {nat512_ms:.4f} ms (min {nat512_min:.4f}) "
            f"at n_max=512, host clock, mean of 5; {name} {k_ms:.4f} ms at n_max={n_max} "
            f"(CUDA events, mean of 5); the unfused caller whole {unf_ms:.4f} ms "
            f"(min {unf_min:.4f}; host clock after a synchronize, mean of 3); card {card}")
        out[name].update(native_ms=nat_ms, native_ms_n_max=n_max, native_ms_512=nat512_ms,
                         unfused_ms=unf_ms, ms_at_native_n_max=k_ms)

    # -- (b) the unfused v1 route: KARPENTER_PACKER=pallas -----------------
    head_pods = classes["headline"]["pods"]
    sched = Scheduler(Cluster(), rng=random.Random(1))
    with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "pallas"}):
        pack_kernel.launches = 0
        for r in range(3):
            before = pack_kernel.launches
            prof, wall = timed(sched, head_pods, "headline")
            if (pack_kernel.launches != before + 1 or prof["packer_backend"] != "pack_first_fit"
                    or prof["pack_route"] != "unfused"):
                raise AssertionError(f"route (b) round {r}: {pack_kernel.launches - before} "
                                     f"launches, {prof['packer_backend']} {prof['pack_route']}")
            log(f"[route] (b) pallas headline round {r}: {wall * 1e3:.3f} ms, "
                f"{prof['packer_backend']} via {prof['pack_route']}, plan == fused == cpu, "
                f"dispatches={prof['pack_dispatches']}, {stage_line(prof)}")
        out["pack_first_fit"]["launches_unfused"] = pack_kernel.launches

    # -- (d) ids past int16 through pack_best on the card -------------------
    for rung, (S, F) in (("pack_first_fit", (12, 4)), ("pack_first_fit_v2", (300, 8))):
        args = synthetic_args(4096, S, F, 3, 16, 23, 6000, dev, host_base=32_000)
        host_hi = int(args[3].max())
        served, res = pack_kernel.pack_best(*args, n_max=1024)
        torch.cuda.synchronize()
        if served != rung or host_hi <= 32_767:
            raise AssertionError(f"route (d): {served} served (want {rung}), hostname ids to {host_hi}")
        worst = compare(pack_reference(*(a.cpu() for a in args), n_max=1024), res)
        log(f"[route] (d) pack_best P=4096 S={S} F={F} hostname ids to {host_hi}: {served}, "
            f"bit-exact with the plain version (max |diff| {worst}), {int(res.n_nodes)} nodes")

    # -- (e) auto on the card: the device path, no router -----------------
    # the router weighs native only for a device="cpu" scheduler; a fresh
    # one must stay empty however many card rounds run
    router.reset_default()
    shared = router.default_router()
    for cls in ("headline", "team mix"):
        name = kernel_of[cls]
        module = module_of[name]
        module.launches, native.calls = 0, 0
        sched = Scheduler(Cluster(), rng=random.Random(1))
        fetch = []
        for r in range(3):
            before = module.launches
            prof, wall = timed(sched, classes[cls]["pods"], cls)
            if (module.launches != before + 1 or prof["packer_backend"] != name
                    or prof["pack_route"] != "fused"):
                raise AssertionError(f"route (e) {cls} round {r}: {module.launches - before} "
                                     f"launches, {prof['packer_backend']} via {prof['pack_route']}")
            fetch.append(prof["pack_fetch_s"] * 1e3)
            log(f"[route] (e) {cls} round {r} (auto): {wall * 1e3:.3f} ms, {name} via fused, "
                f"plan == cpu, {stage_line(prof)}")
        if shared.report() or native.calls or sched.torch._probe_thread is not None:
            raise AssertionError(f"route (e) {cls}: the card consulted the router "
                                 f"({shared.report()}, {native.calls} native calls)")
        nat = out[name]["native_ms"]
        log(f"[route] (e) {cls}: 3 rounds under auto, {name} launches {module.launches}, native "
            f"calls 0, router empty; pack_fetch_s {min(fetch):.4f}-{max(fetch):.4f} ms against "
            f"native {nat:.4f} ms from (a) ({min(fetch) / nat:.2f}-{max(fetch) / nat:.2f}x); "
            f"card {card}")
        out[name].update(launches_route=module.launches, native_calls=native.calls)

    # -- (f) the resident path with the native packer forced ----------------
    # phase 8 holds the memos with the device typemask; here native (no
    # typemask) must hit them too
    sched = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
    with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "native"}):
        for r in range(4):
            prof, wall = timed(sched, head_pods, "headline")
            memo = sched.torch._dec_memo
            hit = "decode_delta_s" in prof and "validate_delta_s" in prof
            if (prof["packer_backend"] != "native" or memo is None or memo[8] is not None
                    or hit != (r > 0)):
                raise AssertionError(f"route (f) round {r}: {prof['packer_backend']}, "
                                     f"memo hit {hit}, {sorted(prof)}")
            log(f"[route] (f) resident headline round {r} (native forced): {wall * 1e3:.3f} ms, "
                f"memos {'hit' if hit else 'filled'} with typemask None, {stage_line(prof)}")

    # -- (c) the unfused v2 route: a failed fused shape ---------------------
    team = batches["team mix"]
    shape = backend.TorchScheduler._fused_shape(team, backend.N_MAX_FIRST)
    with backend._fused_failed_lock:
        backend._fused_failed_shapes.add(shape)
    sched = Scheduler(Cluster(), rng=random.Random(1))
    pack_kernel_v2.launches = 0
    prof, wall = timed(sched, classes["team mix"]["pods"], "team mix")
    launched = pack_kernel_v2.launches
    if (launched != 1 or prof["packer_backend"] != "pack_first_fit_v2"
            or prof["pack_route"] != "unfused"):
        raise AssertionError(f"route (c): {launched} launches, {prof['packer_backend']} "
                             f"via {prof['pack_route']}")
    log(f"[route] (c) team mix with fused shape {shape} failed: {wall * 1e3:.3f} ms, "
        f"{prof['packer_backend']} via {prof['pack_route']}, 1 launch, plan == fused == cpu, "
        f"{stage_line(prof)}")
    out["pack_first_fit_v2"]["launches_unfused"] = launched
    served, res = pack_kernel.pack_best(*device_args(team, dev), n_max=512)
    if served != "pack_first_fit_v2":
        raise AssertionError(f"route (c): pack_best served {served}")
    worst = compare(classes["team mix"]["plain_512"], res)
    log(f"[route] (c) pack_best on the team mix's pack_args() at n_max=512: {served}, "
        f"bit-exact with the plain version (max |diff| {worst})")
    with backend._fused_failed_lock:
        fused_memo = set(backend._fused_failed_shapes)
    with pack_kernel._failed_shapes_lock:
        ladder_memo = set(pack_kernel._failed_shapes)
    if fused_memo != {shape} or ladder_memo:
        raise AssertionError(f"route: failed-shape memos {fused_memo}, {ladder_memo}")
    log(f"[route] failed-shape memos: fused {fused_memo}, ladder {ladder_memo}")
    return out


def degrade_phase(card: str, classes: dict) -> dict:
    """Phase 11: the degrade ladder around both kernels, at full width. (a)
    runs healthy with the canary on every round; (b)-(f) reach each trigger
    only by injection at the Python level (a kernel or split function
    made to raise, a fetched host buffer altered, a forced overflow; never
    a device fault), and each round that the reference would serve from its
    FFD floor must raise: the card has no floor. ``classes`` holds the
    earlier phases' pods and device="cpu" plans. Returns each kernel's
    kernels-line ``degrade`` entry."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.resilience import BreakerOpen
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, fused, integrity, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.backend import InvalidPackError
    from karpenter_tpu_torch.solver.signature import SignatureOverflow
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    catalogs = {"headline": instance_types(400), "team mix": instance_types_tradeoff(400),
                "retry": instance_types(50)}
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2",
                 "retry": "pack_first_fit"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {"canary_solves": 0, "canary_mismatches": 0, "launches_injected": 0}
           for name in modules}
    memos = ((pack_kernel._failed_shapes_lock, pack_kernel._failed_shapes),
             (backend._fused_failed_lock, backend._fused_failed_shapes))
    saved = []
    for lock, memo in memos:
        with lock:
            saved.append(set(memo))

    def restore_memos():
        for (lock, memo), was in zip(memos, saved):
            with lock:
                memo.clear()
                memo.update(was)

    def launches():
        return {name: m.launches for name, m in modules.items()}

    def run(sched, cls, pods):
        """One round: the topology rng of a knob-off scheduler reseeded (its
        plan is held against a plan that drew from Random(1)); returns
        (nodes, profile, wall ms, launches by kernel)."""
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        before = launches()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], pods)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = launches()
        return nodes, sched.last_stage_profile(), wall, {k: after[k] - before[k] for k in after}

    def delta(before):
        now = integrity.totals()
        return {k: now[k] - before[k] for k in now if now[k] != before[k]}

    integrity.reset()
    try:
        # -- (a) the canary on every healthy round, full width ---------------
        canary_ms, canary_n_max, screen_ms = [], [], []
        real_check, real_screen = backend.TorchScheduler._canary_check, integrity.screen_result

        def timed_check(self, batch, result, address=""):
            t0 = time.perf_counter()
            real_check(self, batch, result, address)
            canary_ms.append((time.perf_counter() - t0) * 1e3)
            canary_n_max.append(int(np.asarray(result[1]).shape[0]))

        def timed_screen(result, n_pods):
            t0 = time.perf_counter()
            verdict = real_screen(result, n_pods=n_pods)
            screen_ms.append((time.perf_counter() - t0) * 1e3)
            return verdict

        plan = [("headline", False, 3), ("team mix", False, 3), ("retry", False, 1),
                ("headline", True, 2)]
        n_rounds = sum(n for _, _, n in plan)
        with mock.patch.object(backend.TorchScheduler, "_canary_check", timed_check), \
                mock.patch.object(integrity, "screen_result", timed_screen):
            for cls, resident, n in plan:
                sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0,
                                  solver_delta=resident)
                name = kernel_of[cls]
                for r in range(n):
                    before = integrity.totals()
                    nodes, prof, wall, launched = run(sched, cls, classes[cls]["pods"])
                    thread = sched.torch._canary_thread
                    if thread is None:
                        raise AssertionError(f"degrade (a) {cls} round {r}: no canary started")
                    thread.join(timeout=300)
                    if thread.is_alive():
                        raise AssertionError(f"degrade (a) {cls} round {r}: the canary hangs")
                    got = delta(before)
                    want_launches = prof["pack_dispatches"]
                    if (prof.get("packer_backend") != name or launched[name] != want_launches
                            or got != {"canary_solves": 1}):
                        raise AssertionError(f"degrade (a) {cls} round {r}: "
                                             f"{prof.get('packer_backend')}, {launched}, {got}")
                    if plan_of(nodes, classes[cls]["pods"]) != classes[cls]["cpu_plan"]:
                        raise AssertionError(f"degrade (a) {cls} round {r}: plan differs "
                                             "from the device='cpu' plan")
                    out[name]["canary_solves"] += 1
                    log(f"[degrade] (a) {cls}{' resident' if resident else ''} round {r}: "
                        f"{wall:.3f} ms, {name} x{launched[name]}, plan == cpu, canary "
                        f"clean (native re-solve and compare {canary_ms[-1]:.3f} ms off the "
                        f"path, n_max={canary_n_max[-1]}), screen {screen_ms[-1]:.4f} ms; "
                        f"{stage_line(prof)}")
        totals = integrity.totals()
        if (totals["canary_solves"] != n_rounds or totals["canary_mismatches"]
                or totals["quarantines"] or totals["screen_failures"]):
            raise AssertionError(f"degrade (a): {totals} over {n_rounds} rounds")
        log(f"[degrade] (a) {n_rounds} healthy rounds with canary_rate=1.0: canary_solves "
            f"{totals['canary_solves']}, 0 mismatches, 0 quarantines; canary "
            f"{min(canary_ms):.3f}-{max(canary_ms):.3f} ms off the path, screen "
            f"{min(screen_ms):.4f}-{max(screen_ms):.4f} ms a round (host clock); card {card}")

        head_pods, team = classes["headline"]["pods"], classes["team mix"]["pods"]

        def inject_count(launched):
            for k, v in launched.items():
                out[k]["launches_injected"] += v

        def refused(where, sched, cls, pods, error, match):
            """One round that must raise ``error`` (its message holding
            ``match``): the card serves no floor. Returns (profile, wall
            ms, launches by kernel, the message)."""
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            before = launches()
            t0 = time.perf_counter()
            try:
                sched.solve(prov, catalogs[cls], pods)
            except error as e:
                message = str(e)
            else:
                raise AssertionError(f"degrade {where}: served "
                                     f"({sched.last_stage_profile().get('packer_backend')}), "
                                     f"expected {error.__name__}")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            after = launches()
            launched = {k: after[k] - before[k] for k in after}
            inject_count(launched)
            prof = sched.last_stage_profile()
            if match not in message or prof.get("packer_backend") == "ffd-degraded":
                raise AssertionError(f"degrade {where}: {error.__name__}({message!r}), "
                                     f"{prof.get('packer_backend')}")
            return prof, wall, launched, message

        def breaker_refuses(where, sched, cls, pods):
            """The quarantined or failing shape's next round: BreakerOpen,
            no kernel launched."""
            prof, wall, launched, message = refused(where, sched, cls, pods, BreakerOpen, "pack:")
            if any(launched.values()):
                raise AssertionError(f"degrade {where}: launched {launched}")
            log(f"[degrade] {where}: {wall:.3f} ms, {message}, no launch; "
                f"{stage_line(prof)}; card {card}")

        # -- (b) both kernels raise for the headline shape --------------------
        calls = []

        def broken(*a, **kw):
            calls.append(1)
            raise RuntimeError("kernel launch failed (injected)")

        sched = Scheduler(Cluster(), rng=random.Random(1))
        with mock.patch.object(fused, "pack_first_fit", broken), \
                mock.patch.object(pack_kernel, "pack_first_fit", broken), \
                mock.patch.object(pack_kernel_v2, "pack_first_fit_v2", broken):
            for r in range(2):
                n_calls = len(calls)
                prof, wall, launched, message = refused(
                    f"(b) round {r}", sched, "headline", head_pods, RuntimeError, "no kernel served")
                # round 1 may find both shapes in the ladder's failed memo
                if any(launched.values()) or (r == 0 and len(calls) == n_calls):
                    raise AssertionError(f"degrade (b) round {r}: launched {launched}, "
                                         f"kernel calls {len(calls) - n_calls}")
                log(f"[degrade] (b) both kernels raise, round {r}: {wall:.3f} ms, raised "
                    f"{message!r} after {len(calls) - n_calls} kernel calls; "
                    f"{stage_line(prof)}; card {card}")
            n_calls = len(calls)
            breaker_refuses("(b) round 2", sched, "headline", head_pods)
            opened = sched.torch._pack_breakers.open_dependencies()
            if len(calls) != n_calls or len(opened) != 1 or integrity.totals()["quarantines"]:
                raise AssertionError(f"degrade (b) round 2: kernel calls {len(calls) - n_calls}, "
                                     f"open {opened}")
        restore_memos()

        # -- (c) a NaN in the fetched headline buffer -------------------------
        real_split = fused.split_fused

        def nan_split(*a, **kw):
            result, typemask = real_split(*a, **kw)
            result.node_req[0, 0] = np.nan  # a view into the fetched host buffer
            return result, typemask

        cluster = Cluster()
        sched = Scheduler(cluster, rng=random.Random(1))
        before = integrity.totals()
        with mock.patch.object(fused, "split_fused", nan_split):
            prof, wall, launched, message = refused(
                "(c)", sched, "headline", head_pods, InvalidPackError, "integrity screen")
        got = delta(before)
        events = [e for e in cluster.list("events")
                  if (e.type, e.reason) == ("Warning", "IntegrityQuarantine")]
        opened = sched.torch._pack_breakers.open_dependencies()
        if (got != {"screen_failures": 1, "quarantines": 1} or len(events) != 1 or not opened
                or launched["pack_first_fit"] != 1 or prof["packer_backend"] != "pack_first_fit"):
            raise AssertionError(f"degrade (c): {got}, {len(events)} events, open {opened}, "
                                 f"launched {launched}")
        log(f"[degrade] (c) NaN in node_req of the fetched buffer: {wall:.3f} ms, "
            f"pack_first_fit x1, screen failed, 1 quarantine, breaker open {opened}, 1 "
            f"IntegrityQuarantine Warning ({events[0].message!r}), raised {message!r}; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(c) next round", sched, "headline", head_pods)
        restore_memos()

        # -- (d) an invalid plan on the team mix -------------------------------
        sched = Scheduler(Cluster(), rng=random.Random(1))
        real_decode = sched.torch._decode

        def double_placed(*a, **kw):
            nodes = real_decode(*a, **kw)
            nodes[1].pods.append(nodes[0].pods[0])
            return nodes

        sched.torch._decode = double_placed
        before = integrity.totals()
        prof, wall, launched, message = refused(
            "(d)", sched, "team mix", team, InvalidPackError, "invalid plan")
        got = delta(before)
        if got != {"quarantines": 1} or launched["pack_first_fit_v2"] != 1:
            raise AssertionError(f"degrade (d): {got}, launched {launched}")
        log(f"[degrade] (d) a pod placed twice after decode (team mix): {wall:.3f} ms, "
            f"pack_first_fit_v2 x1, 1 quarantine, raised {message!r}; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(d) next round", sched, "team mix", team)
        restore_memos()

        # -- (e) a signature overflow on both encode attempts ------------------
        encodes = []

        def overflow(*a, **kw):
            encodes.append(1)
            raise SignatureOverflow("forced signature overflow (injected)")

        sched = Scheduler(Cluster(), rng=random.Random(1))
        before = integrity.totals()
        with mock.patch.object(enc, "encode", overflow):
            prof, wall, launched, message = refused(
                "(e)", sched, "headline", head_pods, SignatureOverflow, "forced")
        if (any(launched.values()) or len(encodes) != 2 or delta(before)
                or "packer_backend" in prof):
            raise AssertionError(f"degrade (e): launched {launched}, {len(encodes)} encodes, "
                                 f"{prof.get('packer_backend')}")
        log(f"[degrade] (e) overflow on both encode attempts: {wall:.3f} ms, raised "
            f"{message!r}, no packer_backend, no launch; {stage_line(prof)}; card {card}")

        # -- (f) a screen-clean wrong total, caught by the canary --------------
        # one cpu core: node totals are in millicores, and +1.0 (one
        # millicore) on a node of 100 cores is inside the comparator's
        # rtol of 1e-5
        def wrong_after_screen(result, n_pods):
            verdict = real_screen(result, n_pods=n_pods)
            np.asarray(result[3])[0, 0] += 1000.0  # the served host buffer
            return verdict

        sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0)
        before = integrity.totals()
        with mock.patch.object(integrity, "screen_result", wrong_after_screen):
            nodes, prof, wall, launched = run(sched, "headline", head_pods)
        inject_count(launched)
        sched.torch._canary_thread.join(timeout=300)
        if sched.torch._canary_thread.is_alive():
            raise AssertionError("degrade (f): the canary hangs")
        got = delta(before)
        if (prof.get("packer_backend") != "pack_first_fit" or launched["pack_first_fit"] != 1
                or got != {"canary_solves": 1, "canary_mismatches": 1, "quarantines": 1}):
            raise AssertionError(f"degrade (f): {prof.get('packer_backend')}, {launched}, {got}")
        log(f"[degrade] (f) one cpu core on node_req[0, 0] after the screen: {wall:.3f} ms, "
            f"served by pack_first_fit, the canary mismatched, 1 quarantine; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(f) next round", sched, "headline", head_pods)
    finally:
        restore_memos()
    log(f"[degrade] launches under injection: "
        f"{ {k: v['launches_injected'] for k, v in out.items()} }; card {card}")
    return out




def free_address() -> str:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def sidecar_inputs() -> tuple:
    """Phases 12 and 13's catalogs and encoded batches at full width: the
    headline (instance_types(400) x diverse_pods(10000, Random(42))) and
    the team mix (instance_types_tradeoff(400) x 10,000 pods, 64 teams)."""
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff

    catalogs = {"headline": instance_types(400), "team mix": instance_types_tradeoff(400)}
    batches = {"headline": headline_batch(10000, 400, 42),
               "team mix": encode_batch(catalogs["team mix"], team_pods(10000, 9))}
    return catalogs, batches


def sidecar_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict) -> dict:
    """Phase 12: the solver sidecar on the card, at full width. (a) the
    device half, byte level: frames built with the port's codec from each
    batch's pack_args() go straight to a SolverService on the card; every
    untraced response's fused buffer must equal kernel.fuse_result of the
    in-process backend.pack_unfused on the same tensors, and every status
    is reached once. (b) when grpc imports on this host: a device="cpu"
    scheduler (a controller has no card) against serve() on the card,
    every round served by the sidecar with the in-process card plan.
    ``classes`` holds phases 3 and 6's pods and device="cpu" plans (equal
    to the card plans there). Returns each kernel's launches by part, and
    the knob-off rounds' ``wire_ser_s`` (ms) by batch under
    ``"wire_ser_ms"``."""
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, integrity, kernel, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import service as svc_mod
    from karpenter_tpu_torch.testing import make_pod, make_provisioner

    S = svc_mod
    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {} for name in modules}
    out["wire_ser_ms"] = {cls: [] for cls in kernel_of}

    def zero():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    def key_arr(key):
        return np.frombuffer(key, np.int32)

    def status_of(resp):
        return int(S.unpack_arrays(resp)[0].reshape(-1)[0])

    # -- (a) the device half, byte level -------------------------------------
    svc = S.SolverService()
    warm = S.SolverService()
    t0 = time.perf_counter()
    warm.warmup()
    if not warm.ready.is_set():
        raise AssertionError(f"sidecar warm-up left the service unready ({warm.served})")
    log(f"[sidecar] (a) warm-up {time.perf_counter() - t0:.3f}s: ready, served {warm.served}")
    frames = {}
    for cls, batch in batches.items():
        args = [np.ascontiguousarray(a) for a in batch.pack_args()]
        P = len(args[0])
        n_max = max(256, P // 4)  # what TorchScheduler sends a sidecar
        key = S.catalog_session_key(*args[7:])
        opened = S.unpack_arrays(svc.open_session_bytes(S.pack_arrays([key_arr(key)] + args[7:])))
        if int(opened[0][0]) != S.STATUS_OK or int(opened[1][0]) != S.SIDECAR_FEATURES:
            raise AssertionError(f"sidecar {cls}: open answered {opened}")
        pinned = svc.session_tensors(key)
        if any(t.device.type != dev.type for t in pinned):
            raise AssertionError(f"sidecar {cls}: session tensors not on the card")
        gpu = device_args(batch, dev)
        ref_name, ref = backend.pack_unfused(*gpu, n_max=n_max)
        want = kernel.fuse_result(ref).cpu().numpy().tobytes()
        if ref_name != kernel_of[cls]:
            raise AssertionError(f"sidecar {cls}: in-process pack_unfused served {ref_name}")
        frame = S.pack_arrays([key_arr(key), np.asarray([n_max, 1], np.int32)] + args[:7])
        frames[cls] = (args, key, n_max, frame)
        zero()
        before = dict(svc.served)
        walls = []
        for r in range(3):
            t0 = time.perf_counter()
            resp = svc.solve_bytes(frame)
            walls.append((time.perf_counter() - t0) * 1e3)
            arrays = S.unpack_arrays(resp)
            if int(arrays[0][0]) != S.STATUS_OK or arrays[1].tobytes() != want:
                raise AssertionError(f"sidecar {cls} round {r}: status {int(arrays[0][0])}, "
                                     "fused buffer differs from the in-process pack_unfused")
            log(f"[sidecar] (a) {cls} untraced round {r}: {walls[-1]:.3f} ms solve_bytes, "
                f"{len(resp)} bytes, == in-process pack_unfused ({ref_name}, n_max={n_max})")
        ctx = S._trace_ctx_array(S.TraceContext("5a" * 16, "a5" * 8))
        t0 = time.perf_counter()
        resp = svc.solve_bytes(S.pack_arrays(
            [key_arr(key), np.asarray([n_max, 1], np.int32)] + args[:7] + [ctx]))
        wall = (time.perf_counter() - t0) * 1e3
        arrays = S.unpack_arrays(resp)
        if arrays[1].tobytes() != want:
            raise AssertionError(f"sidecar {cls}: traced round's buffer differs")
        solve_s, fetch_s, ser_s = (float(x) for x in arrays[2])
        log(f"[sidecar] (a) {cls} traced round: {wall:.3f} ms solve_bytes; stage trailer "
            f"solve_s={solve_s * 1e3:.3f}ms fetch_s={fetch_s * 1e3:.3f}ms "
            f"serialize_s={ser_s * 1e3:.3f}ms; card {card}")
        launched = counts()
        got = {k: svc.served.get(k, 0) - before.get(k, 0) for k in svc.served}
        got = {k: v for k, v in got.items() if v}
        if got != {kernel_of[cls]: 4} or launched[kernel_of[cls]] < 4:
            raise AssertionError(f"sidecar {cls}: served {got}, launches {launched}")
        out[kernel_of[cls]]["launches_sidecar_device"] = launched[kernel_of[cls]]
        out[kernel_of[cls]]["sidecar_solve_bytes_ms"] = walls
    # every refusal once, none of them dispatched
    args, key, n_max, frame = frames["headline"]
    dispatches = svc.dispatches
    head = [key_arr(key), np.asarray([n_max, 1], np.int32)]
    refusals = {
        S.STATUS_NEEDS_CATALOG: svc.solve_bytes(S.pack_arrays(
            [key_arr(bytes(16)), head[1]] + args[:7])),
        S.STATUS_DEADLINE_EXCEEDED: svc.solve_bytes(S.pack_arrays(
            head + args[:7] + [np.asarray([0.0], np.float32)])),
        S.STATUS_NEEDS_DELTA_BASE: svc.solve_bytes(S.pack_arrays(
            [head[0], np.asarray([n_max, 1, S.PACK_FLAG_DELTA], np.int32),
             S.delta_header(S.DELTA_ELIDE, 0, bytes(16), bytes(range(16)))])),
    }
    corrupt = bytearray(S.append_checksum(frame))
    corrupt[len(corrupt) // 2] ^= 0x01
    refusals[S.STATUS_INTEGRITY] = svc.solve_bytes(bytes(corrupt))
    full = S.SolverService(max_inflight=1, queue_depth=0)
    if full.admission.enter() != "admitted":
        raise AssertionError("sidecar: could not hold the one admission slot")
    try:
        refusals[S.STATUS_OVERLOADED] = full.solve_bytes(frame)
    finally:
        full.admission.leave()
    for want_status, resp in refusals.items():
        if status_of(resp) != want_status:
            raise AssertionError(f"sidecar: expected status {want_status}, got {status_of(resp)}")
    if svc.dispatches != dispatches or full.dispatches:
        raise AssertionError("sidecar: a refused frame reached the device")
    log(f"[sidecar] (a) statuses NEEDS_CATALOG, DEADLINE_EXCEEDED, NEEDS_DELTA_BASE, "
        f"INTEGRITY, OVERLOADED each answered, 0 dispatched; shed {svc.shed}, "
        f"checksum failures {svc.checksum_failures}; sessions {svc.session_count()} pinning "
        f"{svc.resident_bytes()} bytes, device headroom "
        f"{S.publish_device_headroom(dev)} bytes")

    # -- (b) the client and the transport ------------------------------------
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[sidecar] grpc not installed on this host: (b) is held by the CPU tests")
        log(f"[sidecar] served {svc.served}, dispatches {svc.dispatches}")
        return out
    address = free_address()
    server = S.serve(address, service=S.SolverService())
    os.environ["KARPENTER_PACKER"] = "fused"
    try:
        # the card plan of the swapped team mix (phases 3 and 6 held the
        # card's plans of the other batches equal to the cpu plans)
        team = classes["team mix"]["pods"]
        last = team[-1]
        other = next(p.spec.node_selector["team"] for p in team
                     if p.spec.node_selector["team"] != last.spec.node_selector["team"])
        swapped = team[:-1] + [make_pod(
            requests={"cpu": str(last.spec.containers[0].requests["cpu"])},
            node_selector={"team": other})]
        card_sched = Scheduler(Cluster(), rng=random.Random(1))
        swapped_plan = plan_of(card_sched.solve(prov, catalogs["team mix"], swapped), swapped)
        served(card_sched, "pack_first_fit_v2", "sidecar swapped team mix card plan")

        def sidecar_round(sched, cls, pods, want_plan, what):
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            svc_now = server.solver_service
            before = dict(svc_now.served)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalogs[cls], pods)
            wall = (time.perf_counter() - t0) * 1e3
            prof = served(sched, "sidecar", f"sidecar {what}")
            got = {k: svc_now.served.get(k, 0) - before.get(k, 0) for k in svc_now.served}
            got = {k: v for k, v in got.items() if v}
            if got != {kernel_of[cls]: prof["pack_dispatches"]}:
                raise AssertionError(f"sidecar {what}: the sidecar served {got}")
            if plan_of(nodes, pods) != want_plan:
                raise AssertionError(f"sidecar {what}: plan differs from the card plan")
            log(f"[sidecar] (b) {what}: {wall:.3f} ms, nodes={len(nodes)}, "
                f"wire_ser_s={prof['wire_ser_s'] * 1e3:.3f}ms "
                f"wire_deser_s={prof['wire_deser_s'] * 1e3:.3f}ms "
                f"pack_fetch_s={prof['pack_fetch_s'] * 1e3:.3f}ms "
                f"delta_kind={prof.get('delta_kind')} served {got}; {stage_line(prof)}")
            return prof

        zero()
        sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address)
        for cls in ("headline", "team mix"):
            for r in range(3):
                prof = sidecar_round(sched, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                                     f"{cls} round {r}")
                out["wire_ser_ms"][cls].append(prof["wire_ser_s"] * 1e3)
        res = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                        solver_service_address=address, solver_delta=True)
        kinds = [sidecar_round(res, "headline", classes["headline"]["pods"],
                               classes["headline"]["cpu_plan"],
                               f"resident headline round {r}").get("delta_kind")
                 for r in range(3)]
        if kinds != ["establish", "elide", "elide"]:
            raise AssertionError(f"sidecar resident headline: delta kinds {kinds}")
        churn = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address, solver_delta=True)
        kinds = [sidecar_round(churn, "team mix", pods, plan, f"team mix churn {what}")
                 .get("delta_kind") for pods, plan, what in (
                     (team, classes["team mix"]["cpu_plan"], "base"),
                     (swapped, swapped_plan, "one-pod swap"))]
        if kinds != ["establish", "patch"]:
            raise AssertionError(f"sidecar team mix churn: delta kinds {kinds}")
        checked = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                            solver_service_address=address, pack_checksum=True)
        sidecar_round(checked, "headline", classes["headline"]["pods"],
                      classes["headline"]["cpu_plan"], "checksummed headline round")
        if integrity.totals()["checksum_failures"] or server.solver_service.checksum_failures:
            raise AssertionError("sidecar: checksum failures on a healthy wire")
        # a restart on the same address: the next round re-opens through
        # NEEDS_CATALOG and the new sidecar serves it
        old = server.solver_service
        log(f"[sidecar] (b) before restart: served {old.served}, dispatches {old.dispatches}")
        server.stop(grace=None)
        server = S.serve(address, service=S.SolverService())
        uploads = sched.torch._remote.session_uploads
        sidecar_round(sched, "headline", classes["headline"]["pods"],
                      classes["headline"]["cpu_plan"], "headline round after a restart")
        if sched.torch._remote.session_uploads != uploads + 1:
            raise AssertionError("sidecar restart: no re-open")
        launched = counts()
        for name in modules:
            if not launched[name]:
                raise AssertionError(f"sidecar (b): {name} never launched")
            out[name]["launches_sidecar_wire"] = launched[name]
        log(f"[sidecar] (b) kernel launches {launched}; after restart served "
            f"{server.solver_service.served}, dispatches {server.solver_service.dispatches}; "
            f"card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        server.stop(grace=None)
    log(f"[sidecar] served {svc.served}, dispatches {svc.dispatches} (device half)")
    return out


def wait_for(predicate, timeout: float, what: str) -> None:
    """Poll ``predicate`` every 20 ms; raise after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f}s waiting for {what}")
        time.sleep(0.02)


def stream_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict,
                 wire_ser_unary: dict) -> dict:
    """Phase 13: the sidecar's persistent stream at full width. (a) the
    device half, byte level: distinct headline and team-mix frames parsed
    by stream_parse_solve and served by solve_stream_group in groups of 8,
    3 (padded to 4) and 4; each group is ONE launch of its kernel with
    B > 1 and answers every entry with its solve_bytes bytes; an arena
    descriptor solve; an expired deadline shed with no launch. (b) when
    grpc imports: device="cpu" controllers against serve() on the card
    over the stream, the arena, the resident delta frames, a restart, an
    8-client salvo that coalesces, a two-member pool that fails over, and
    two threads on one scheduler overlapping a chaos-slowed sidecar.
    Returns per kernel its launches by part and the B of each coalesced
    launch."""
    import shutil

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import kernel, native, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.solver import stream as ST
    from karpenter_tpu_torch.solver.pool import HashRing
    from karpenter_tpu_torch.testing import make_provisioner
    from karpenter_tpu_torch.testing.chaos import ChaosPolicy, chaos_wrap

    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {"coalesced_B": []} for name in modules}
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           f"stream-smoke-{os.getpid()}")
    os.makedirs(scratch, exist_ok=True)

    def zero():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    def key_arr(key):
        return np.frombuffer(key, np.int32)

    def status_of(resp):
        return int(S.unpack_arrays(resp)[0].reshape(-1)[0])

    def bucket(n):
        return next(b for b in (1, 2, 4, 8) if b >= n)

    # -- (a) the device half, byte level -------------------------------------
    if not native.native_available(wait=180):
        raise AssertionError("the native packer did not build (g++ -O3 -shared -fPIC)")
    svc = S.SolverService()
    rng = np.random.default_rng(13)
    inputs = {}
    zero()
    for cls, n_frames, groups in (("headline", 8, ([*range(8)], [0, 1, 2])),
                                  ("team mix", 4, ([*range(4)],))):
        args = [np.ascontiguousarray(a) for a in batches[cls].pack_args()]
        P, R = args[6].shape
        n_max = max(256, P // 4)  # what TorchScheduler sends a sidecar
        key = S.catalog_session_key(*args[7:])
        opened = S.unpack_arrays(svc.open_session_bytes(S.pack_arrays([key_arr(key)] + args[7:])))
        if int(opened[0][0]) != S.STATUS_OK or int(opened[1][0]) != S.PROTO_FEATURES:
            raise AssertionError(f"stream {cls}: open answered {opened}")
        head = [key_arr(key), np.asarray([n_max, 1], np.int32)]
        # equal shapes, different content: a different seeded 1% of the
        # valid rows cleared in each, so a demultiplexing error shows
        pods_of = []
        for _ in range(n_frames):
            pods = [a.copy() for a in args[:7]]
            valid = np.flatnonzero(pods[0])
            pods[0][rng.choice(valid, max(1, len(valid) // 100), replace=False)] = False
            pods_of.append(pods)
        frames = [S.pack_arrays(head + pods) for pods in pods_of]
        unary, unary_ms = [], []
        for f in frames:
            t0 = time.perf_counter()
            unary.append(svc.solve_bytes(f))
            unary_ms.append((time.perf_counter() - t0) * 1e3)
        if len(set(unary)) != n_frames or any(status_of(r) != S.STATUS_OK for r in unary):
            raise AssertionError(f"stream {cls}: the {n_frames} frames' answers are not distinct")
        # the unmodified pods' answer: what the arena and the salvo send
        inputs[cls] = (args, key, n_max, head, svc.solve_bytes(S.pack_arrays(head + args[:7])))
        kern = kernel_of[cls]
        for idx in groups:
            B = bucket(len(idx))
            answers = {}
            entries = [svc.stream_parse_solve(frames[i], respond=lambda b, i=i: answers.__setitem__(i, b))
                       for i in idx]
            if any(isinstance(e, bytes) for e in entries):
                raise AssertionError(f"stream {cls}: a frame was refused at parse")
            stats0 = dict(svc.stream_stats)
            served0 = svc.served.get(kern, 0)
            before = counts()
            t0 = time.perf_counter()
            svc.solve_stream_group(entries)
            wall = (time.perf_counter() - t0) * 1e3
            launched = {k: v - before[k] for k, v in counts().items()}
            if launched != {k: int(k == kern) for k in modules}:
                raise AssertionError(f"stream {cls} group of {len(idx)}: launches {launched}")
            if [answers.get(i) for i in idx] != [unary[i] for i in idx]:
                raise AssertionError(f"stream {cls} group of {len(idx)}: an answer differs "
                                     "from solve_bytes")
            if idx is groups[0]:
                # each demultiplexed answer against the native packer (a
                # plain version, bit-exact with both kernels: phase 9) on
                # host copies of that entry's own frame
                t0 = time.perf_counter()
                for i in idx:
                    plain = kernel.fuse_result(host_result(
                        native.pack_native(*pods_of[i], *args[7:], n_max=n_max)))
                    if S.unpack_arrays(answers[i])[1].tobytes() != plain.numpy().tobytes():
                        raise AssertionError(f"stream {cls} group of {len(idx)}: entry {i} "
                                             "differs from the native packer")
                log(f"[stream] (a) {cls} group of {len(idx)}: every answer == the native "
                    f"packer on its own frame ({(time.perf_counter() - t0) * 1e3:.3f} ms "
                    "on the host)")
            moved = (svc.stream_stats["coalesced_dispatches"] - stats0["coalesced_dispatches"],
                     svc.stream_stats["coalesced_solves"] - stats0["coalesced_solves"])
            if moved != (1, len(idx)) or svc.served.get(kern, 0) != served0 + 1:
                raise AssertionError(f"stream {cls}: coalesced counters moved {moved}")
            # the same group traced: the shared [dispatch_s, fetch_s, 0] trailer
            ctx = S._trace_ctx_array(S.TraceContext("5a" * 16, "a5" * 8))
            traced = []
            svc.solve_stream_group([
                svc.stream_parse_solve(S.pack_arrays(head + pods_of[i] + [ctx]), respond=traced.append)
                for i in idx])
            dispatch_s, fetch_s, _ = (float(x) for x in S.unpack_arrays(traced[0])[2])
            out[kern]["coalesced_B"] += [B, B]
            log(f"[stream] (a) {cls} group of {len(idx)} (B={B}): one {kern} launch, "
                f"{len(idx)} answers == solve_bytes byte for byte; group {wall:.3f} ms "
                f"(traced: dispatch_s={dispatch_s * 1e3:.3f}ms fetch_s={fetch_s * 1e3:.3f}ms); "
                f"{len(idx)} single solve_bytes {sum(unary_ms[i] for i in idx):.3f} ms "
                f"({', '.join(f'{unary_ms[i]:.3f}' for i in idx)}); card {card}")
        resident = svc.session_tensors(key)
        for B in sorted({bucket(len(idx)) for idx in groups}):
            ms = events_ms(lambda: [t.expand(B, *t.shape).contiguous() for t in resident], 10)
            log(f"[stream] (a) {cls}: the session's catalog tensors to B={B} "
                f"({B * sum(t.nbytes for t in resident)} bytes, expand().contiguous()) "
                f"{ms:.4f} ms (CUDA events, mean of 10)"
                + (f"; the v2 tables stacked B times hold "
                   f"{B * pack_kernel_v2.v2_table_bytes(*resident[1].shape[:2], R, resident[0].shape[1])}"
                   " bytes" if kern == "pack_first_fit_v2" else ""))
    out["pack_first_fit"]["launches_stream_device"] = counts()["pack_first_fit"]
    out["pack_first_fit_v2"]["launches_stream_device"] = counts()["pack_first_fit_v2"]

    # the arena: one headline frame's pod arrays through a ShmArena
    args, key, n_max, head, want = inputs["headline"]
    arena = ST.ShmArena(scratch, size=64 << 20)
    reader = ST.ShmArenaReader(arena.path)
    try:
        t0 = time.perf_counter()
        token, desc = arena.write(args[:7])
        write_ms = (time.perf_counter() - t0) * 1e3
        got = []
        entry = svc.stream_parse_solve(S.pack_arrays(head + [desc]), respond=got.append,
                                       arena=reader)
        if isinstance(entry, bytes) or not entry.shm:
            raise AssertionError("stream arena: the descriptor frame was refused")
        svc.solve_stream_group([entry])
        if got != [want]:
            raise AssertionError("stream arena: the answer differs from solve_bytes")
        arena.free(token)
        log(f"[stream] (a) arena: the headline pod arrays written in {write_ms:.3f} ms, the "
            f"descriptor solve == solve_bytes byte for byte ({arena.live_blocks()} live blocks)")
    finally:
        reader.close()
        arena.close()
    # an expired deadline is shed at parse time, with no launch
    got = []
    entry = svc.stream_parse_solve(S.pack_arrays(head + args[:7] + [np.asarray([0.0], np.float32)]),
                                   respond=got.append)
    dispatches, before = svc.dispatches, counts()
    shed = svc.shed_if_expired(entry)
    if shed is None or status_of(shed) != S.STATUS_DEADLINE_EXCEEDED or counts() != before \
            or svc.dispatches != dispatches:
        raise AssertionError("stream: the expired solve was not shed before the card")
    log(f"[stream] (a) expired deadline shed by shed_if_expired, 0 launches; stream_stats "
        f"{svc.stream_stats}, served {svc.served}")

    # -- (b) the transport -----------------------------------------------------
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[stream] grpc not installed on this host: (b) is held by the CPU tests")
        shutil.rmtree(scratch, ignore_errors=True)
        return out
    # every open stream holds one of the gRPC server's worker threads for
    # its life, so a sidecar serving N streaming clients needs more than N
    # workers (serve's default is 4): phase 13 keeps up to 12 streams open
    workers = 32
    address = free_address()
    servers = {address: S.serve(address, max_workers=workers, service=S.SolverService(),
                                shm_dir=scratch, coalesce_window_s=0.25)}
    os.environ["KARPENTER_PACKER"] = "fused"
    closers = []  # the controllers and clients to close

    def close_all():
        for c in closers:
            remote = c.torch._remote if hasattr(c, "torch") else c
            if remote is not None:
                remote.close()
        closers.clear()

    try:
        def stream_round(sched, cls, pods, want_plan, what, transport):
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalogs[cls], pods)
            wall = (time.perf_counter() - t0) * 1e3
            prof = served(sched, "sidecar", f"stream {what}")
            if transport is not None and prof["solver_transport"] != transport:
                raise AssertionError(f"stream {what}: carried by {prof['solver_transport']}, "
                                     f"expected {transport}")
            if plan_of(nodes, pods) != want_plan:
                raise AssertionError(f"stream {what}: plan differs from the card plan")
            log(f"[stream] (b) {what}: {wall:.3f} ms, transport={prof['solver_transport']} "
                f"nodes={len(nodes)} wire_ser_s={prof['wire_ser_s'] * 1e3:.3f}ms "
                f"wire_deser_s={prof['wire_deser_s'] * 1e3:.3f}ms "
                f"pack_fetch_s={prof['pack_fetch_s'] * 1e3:.3f}ms "
                f"delta_kind={prof.get('delta_kind')} address={prof['solver_address']}; "
                f"{stage_line(prof)}")
            return prof

        def controller(address_spec, **kw):
            sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                              solver_service_address=address_spec, solver_stream=True, **kw)
            closers.append(sched)
            return sched

        zero()
        streamed = controller(address)
        for cls in ("headline", "team mix"):
            for r in range(3):
                stream_round(streamed, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                             f"{cls} streamed round {r}", "stream")
        shm = controller(address, solver_shm_dir=scratch)
        head_pods, head_plan = classes["headline"]["pods"], classes["headline"]["cpu_plan"]
        stream_round(shm, "headline", head_pods, head_plan, "headline shm warm-up", None)
        wait_for(lambda: shm.torch._remote._stream.shm_active, 20, "the arena's ack")
        shm_ser = [stream_round(shm, "headline", head_pods, head_plan,
                                f"headline shm round {r}", "stream_shm")["wire_ser_s"] * 1e3
                   for r in range(3)]
        log(f"[stream] (b) wire_ser_s through the arena {', '.join(f'{x:.3f}' for x in shm_ser)} "
            f"ms against phase 12's unary headline rounds "
            f"{', '.join(f'{x:.3f}' for x in wire_ser_unary['headline'])} ms; card {card}")
        res = controller(address, solver_delta=True)
        kinds = [stream_round(res, "headline", head_pods, head_plan,
                              f"resident headline round {r}", "stream").get("delta_kind")
                 for r in range(3)]
        if kinds != ["establish", "elide", "elide"]:
            raise AssertionError(f"stream resident headline: delta kinds {kinds}")
        # a restart on the same address: the stream re-establishes and the
        # re-open (NEEDS_CATALOG) rides it
        client = streamed.torch._remote
        established, uploads = client._stream.established_count, client.session_uploads
        servers.pop(address).stop(grace=None)
        servers[address] = S.serve(address, max_workers=workers, service=S.SolverService(),
                                   shm_dir=scratch, coalesce_window_s=0.25)
        wait_for(lambda: client._stream.established_count > established and client._stream.up,
                 30, "the stream's re-establishment")
        stream_round(streamed, "headline", head_pods, head_plan,
                     "headline round after a restart", "stream")
        opens = servers[address].stream_server_box[0].snapshot()["stream_opens"]
        if client.session_uploads != uploads + 1 or opens < 1:
            raise AssertionError(f"stream restart: uploads {client.session_uploads}, "
                                 f"streamed opens {opens}")
        launched = counts()
        if not all(launched.values()):
            raise AssertionError(f"stream (b): launches {launched}")

        # the salvo: 8 clients on one session, until a group coalesces
        args, key, n_max, head, want = inputs["headline"]
        P, R = args[6].shape
        want_result = kernel.split_result(S.unpack_arrays(want)[1], P, n_max, R)
        clients = [S.RemoteSolver(address, timeout=30, cold_timeout=120, stream=True)
                   for _ in range(8)]
        closers.extend(clients)
        for c in clients:
            c.pack(*args, n_max=n_max)
        wait_for(lambda: all(c._stream is not None and c._stream.up for c in clients), 20,
                 "8 streams")
        svc_b = servers[address].solver_service
        stats0, before = dict(svc_b.stream_stats), counts()
        for salvo in range(10):
            waits, errs = [None] * 8, []
            gate = threading.Barrier(8, timeout=30)

            def fire(i):
                try:
                    gate.wait()
                    waits[i] = clients[i].pack_begin(*args, n_max=n_max)
                except Exception as e:
                    errs.append(e)

            threads = [threading.Thread(target=fire, args=(i,), daemon=True) for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            if errs or any(w is None for w in waits):
                raise AssertionError(f"stream salvo {salvo}: {errs}")
            for w in waits:
                if any(not np.array_equal(a, b) for a, b in zip(w(), want_result)):
                    raise AssertionError(f"stream salvo {salvo}: a result differs from the card's")
            wall = (time.perf_counter() - t0) * 1e3
            dd = svc_b.stream_stats["coalesced_dispatches"] - stats0["coalesced_dispatches"]
            ds = svc_b.stream_stats["coalesced_solves"] - stats0["coalesced_solves"]
            log(f"[stream] (b) salvo {salvo}: 8 clients, {wall:.3f} ms, every result == the card's; "
                f"coalesced dispatches {dd} carrying {ds} solves so far")
            if dd:
                break
        else:
            raise AssertionError("stream salvo: 10 salvos and no group coalesced")
        salvo_launches = {k: v - before[k] for k, v in counts().items()}
        if dd == 1:
            out["pack_first_fit"]["coalesced_B"].append(bucket(ds))
        out["pack_first_fit"]["salvo"] = {"coalesced_dispatches": dd, "coalesced_solves": ds,
                                          "launches": salvo_launches["pack_first_fit"]}
        log(f"[stream] (b) salvo: {salvo_launches['pack_first_fit']} pack_first_fit launches "
            f"for {8 * (salvo + 1)} solves")

        # the pool: two members on the one card. The earlier controllers
        # and clients close first: their streams would all reconnect to the
        # restarted survivor below and hold its channel in backoff
        close_all()
        second = free_address()
        servers[second] = S.serve(second, max_workers=workers, service=S.SolverService())
        members = [address, second]
        pool_sched = controller(",".join(members))
        profs = [stream_round(pool_sched, "headline", head_pods, head_plan,
                              f"pool headline round {r}", "stream") for r in range(2)]
        owner = profs[0]["solver_address"]
        if owner != HashRing(members).route(bytes.fromhex(profs[0]["session_key"])) or \
                profs[1]["solver_address"] != owner:
            raise AssertionError(f"stream pool: rounds served by {owner}, not the ring's member")
        survivor = next(a for a in members if a != owner)
        pool = pool_sched.torch._remote
        # the survivor's client holds the session as open while its store is
        # empty (a restart): the failover re-opens it through NEEDS_CATALOG
        key = bytes.fromhex(profs[0]["session_key"])
        catalog_side = next(arrays for arrays, k in pool._key_memo._memo.values() if k == key)
        pool._client(survivor)._open_session(key, catalog_side, timeout=30)
        servers.pop(survivor).stop(grace=None)
        servers[survivor] = S.serve(survivor, max_workers=workers, service=S.SolverService(),
                                    shm_dir=scratch)
        servers.pop(owner).stop(grace=None)
        uploads = pool._client(survivor).session_uploads
        prof = stream_round(pool_sched, "headline", head_pods, head_plan,
                            "pool round after killing the session's member", None)
        if prof["solver_address"] != survivor or pool.failovers != 1 or \
                pool._client(survivor).session_uploads != uploads + 1:
            raise AssertionError(f"stream pool failover: served by {prof['solver_address']}, "
                                 f"failovers {pool.failovers}")
        if pool_sched.torch._remote_breaker.state != "closed":
            raise AssertionError("stream pool failover: the outer remote breaker moved")
        log(f"[stream] (b) pool: {owner} owned the session (the ring's member), killed; "
            f"failover to {survivor} through NEEDS_CATALOG, plan equal, outer breaker closed")

        # the pipeline: two threads on one scheduler, a 0.5 s chaos floor,
        # one solving the headline and one the team mix at full width
        floor = 0.5
        pipe_addr = free_address()
        servers[pipe_addr] = S.serve(pipe_addr, max_workers=workers, service=chaos_wrap(
            S.SolverService(), ChaosPolicy(
            latency_floor=floor, methods=frozenset({"solve_bytes", "solve_stream_group"}))))
        pipe = controller(pipe_addr)
        for cls in ("headline", "team mix"):  # warm: both sessions, the stream
            stream_round(pipe, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                         f"pipeline warm-up {cls}", None)
        results, profs_of, errs = {}, {}, []

        def run(cls):
            try:
                pods = classes[cls]["pods"]
                nodes = pipe.solve(prov, catalogs[cls], pods)
                results[cls] = plan_of(nodes, pods)
                profs_of[cls] = pipe.last_stage_profile()
            except Exception as e:
                errs.append(e)

        # only the headline's topology draws hostnames: reseeded once, the
        # rng gives it the device="cpu" plan's draws whichever thread
        # encodes first
        pipe.torch.topology.rng = random.Random(1)
        threads = [threading.Thread(target=run, args=(cls,), daemon=True)
                   for cls in ("headline", "team mix")]
        # by now the script holds over a million tracked objects, and a
        # full collection of them stops every thread for a second or more
        # (the [gc] lines); collected here, none falls due inside the timed
        # window
        gc.collect()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        if errs or any(results.get(cls) != classes[cls]["cpu_plan"] for cls in results) \
                or len(results) != 2 \
                or any(p["packer_backend"] != "sidecar" for p in profs_of.values()):
            raise AssertionError(f"stream pipeline: {errs} {profs_of}")
        host = {cls: {k: v for k, v in p.items() if k.endswith("_s") and k.split("_")[0] in
                      ("sort", "inject", "encode", "decode", "validate")}
                for cls, p in profs_of.items()}
        host_s = {cls: sum(h.values()) for cls, h in host.items()}
        bar = 2 * floor + max(host_s.values())
        log(f"[stream] (b) pipeline: the headline and the team mix on one scheduler, two "
            f"threads, through a sidecar with a {floor}s floor: wall {wall:.3f}s against "
            f"2 x floor + the larger thread's host stages = {bar:.3f}s (serial >= "
            f"{2 * floor + sum(host_s.values()):.3f}s); host stages "
            + "; ".join(f"{cls} {host_s[cls] * 1e3:.3f} ms ("
                        + ", ".join(f"{k}={v * 1e3:.3f}" for k, v in host[cls].items()) + ")"
                        for cls in host)
            + "; " + ", ".join(f"{cls} pack_fetch_s={p['pack_fetch_s'] * 1e3:.3f}ms "
                               f"transport={p['solver_transport']}"
                               for cls, p in profs_of.items())
            + f"; card {card}")
        if wall >= bar:
            raise AssertionError(f"stream pipeline: {wall:.3f}s >= {bar:.3f}s, the host "
                                 "stages did not overlap the other solve in flight")
        launched = counts()
        for name in modules:
            out[name]["launches_stream_wire"] = launched[name]
        log(f"[stream] (b) kernel launches {launched}; card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        close_all()
        for server in servers.values():
            server.stop(grace=None)
        shutil.rmtree(scratch, ignore_errors=True)
    return out


OBS_STAGES = ("solve.sort", "solve.inject", "solve.encode", "solve.pack_begin",
              "solve.pack_fetch", "solve.decode")
# each host stage span and the profile key (full, or served from resident
# state) its prof clock writes
OBS_STAGE_KEYS = {
    "solve.sort": ("sort_s", "sort_delta_s"),
    "solve.inject": ("inject_s", "inject_delta_s"),
    "solve.encode": ("encode_s", "encode_delta_s"),
    "solve.decode": ("decode_s", "decode_delta_s"),
}
# the flight-recorder panels the scheduler registers
OBS_PANELS = ("router_ema", "pack_breakers_open", "remote_breaker", "session_cache", "integrity")
# phase 14 (f)'s SLO window: 12 knob-off headline rounds (≈ 2-3 s) fit in
# it, and the ladder's recovery waits it out with resident rounds
SLO_WINDOW_S = 5.0


class KernelClock:
    """CUDA events recorded around each call of a kernel's wrapper, and a
    tracer finish-hook that asks the end event, as solve.pack_begin and
    solve.pack_fetch close, whether the kernel is done (``query()``
    neither waits nor queues work). A round keeps its one synchronize (its
    fetch); the times are read after the round returned."""

    STAGES = ("solve.pack_begin", "solve.pack_fetch")

    def __init__(self):
        self.calls = []

    def wrap(self, fn):
        import torch

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.calls.append((e0, e1, {}))
            return out

        return timed

    def __call__(self, span) -> None:
        if span.name in self.STAGES and self.calls:
            self.calls[-1][2][span.name] = self.calls[-1][1].query()

    def take(self) -> list:
        """``(CUDA-event ms, done when pack_begin closed, done when
        pack_fetch closed)`` per call."""
        calls, self.calls = self.calls, []
        out = []
        for e0, e1, done in calls:
            e1.synchronize()
            out.append((e0.elapsed_time(e1), done.get(self.STAGES[0]), done.get(self.STAGES[1])))
        return out


def metric(name: str, labels=None) -> float:
    from karpenter_tpu_torch import metrics

    return metrics.REGISTRY.get_sample_value(name, labels or {}) or 0.0


def check_tree(tree: dict, prof: dict, what: str) -> float:
    """One exported solve tree against the round's profile: a solver.solve
    root with the six stage spans as children, each host stage within 1 ms
    of its prof key, and pack_begin + pack_fetch within 1 ms of
    pack_fetch_s. Returns the largest disagreement (ms)."""
    if tree["name"] != "solver.solve":
        raise AssertionError(f"{what}: root span {tree['name']}")
    names = tuple(c["name"] for c in tree["children"])
    if names != OBS_STAGES:
        raise AssertionError(f"{what}: stage spans {names}")
    spans = {c["name"]: c for c in tree["children"]}
    worst = 0.0
    for name, keys in OBS_STAGE_KEYS.items():
        key = next((k for k in keys if k in prof), None)
        if key is None:
            raise AssertionError(f"{what}: no profile key for {name}")
        worst = max(worst, abs(spans[name]["duration_ms"] - prof[key] * 1e3))
    packed = spans["solve.pack_begin"]["duration_ms"] + spans["solve.pack_fetch"]["duration_ms"]
    worst = max(worst, abs(packed - prof["pack_fetch_s"] * 1e3))
    if worst >= 1.0:
        raise AssertionError(f"{what}: a stage span differs from the profile by {worst:.3f} ms")
    return worst


def check_kernel_timing(rounds: list, what: str) -> None:
    """On the card the begin only enqueues and the fetch holds the wait.
    ``rounds``: per round, whether the kernel was done when
    solve.pack_begin closed and when solve.pack_fetch closed. Every fetch
    must close with the kernel done. A begin closes with the kernel
    running unless its host work after the launch outlasted the kernel (a
    slow host round can); a begin that waited for the kernel would close
    with it done in every round, so at least one round must show it
    running."""
    if not all(fetch for _, fetch in rounds):
        raise AssertionError(f"{what}: a solve.pack_fetch closed before its kernel was done: "
                             f"{rounds}")
    if all(begin for begin, _ in rounds):
        raise AssertionError(f"{what}: every solve.pack_begin closed with its kernel done "
                             f"(a wait inside the begin): {rounds}")


def profiled_device_work(run) -> dict:
    """``run()`` under torch.profiler: the device work it caused, counted
    by kind (kernel launches, device-to-host and host-to-device copies,
    other copies and memsets). Device activity just after tracing starts
    can go unrecorded (a round's first uploads and kernels, now and then):
    a warm-up step, whose events are discarded, comes first, and in the
    recorded step a burst of uploads and adds runs ahead of ``run()``, so
    that any such loss falls on it; only the device records that start
    after ``run()``'s host range opens are counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    mark = "chip_smoke.measured"
    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: events.extend(prof.events())) as p:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        p.step()
        primer = torch.ones(1 << 16)
        for _ in range(8):
            primer.to("cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function(mark):
            run()
            torch.cuda.synchronize()
        p.step()
    cuda = torch.autograd.DeviceType.CUDA
    start = min(e.time_range.start for e in events if e.name == mark and e.device_type != cuda)
    tally = {"kernels": 0, "memcpy_dtoh": 0, "memcpy_htod": 0, "other": 0}
    for e in events:
        if e.device_type != cuda or e.name == mark or e.time_range.start < start:
            continue
        n = e.name.lower()
        if "memcpy" in n and "dtoh" in n:
            tally["memcpy_dtoh"] += 1
        elif "memcpy" in n and "htod" in n:
            tally["memcpy_htod"] += 1
        elif "memcpy" in n or "memset" in n:
            tally["other"] += 1
        else:
            tally["kernels"] += 1
    return tally


def obs_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict) -> dict:
    """Phase 14: the observability plane around both kernels on the card,
    at full width. (a) traced knob-off rounds, (b) metrics, (c) the flight
    recorder, (d) what tracing costs, (e) decisions, explain and replay,
    (f) the SLO engine and the brownout ladder driven by the card's own
    spans, (g) the sidecar traced. ``classes`` holds the headline's and the
    team mix's pods and device="cpu" plans (phases 3 and 6). Each part
    reads both kernels' launch counters before and after it, and fails
    where a kernel's launches differ from the rounds the part ran on it.
    Returns each kernel's measured launches by part and the numbers the
    kernels line carries."""
    import collections
    import contextlib
    import shutil
    import tempfile

    import torch
    from karpenter_tpu_torch import metrics, obs
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.obs import replay as replay_tool
    from karpenter_tpu_torch.resilience.brownout import BrownoutController
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import (
        backend, explain, fused, integrity, pack_kernel, pack_kernel_v2,
    )
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.solver import session_stats
    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
    from karpenter_tpu_torch.solver.router import default_router
    from karpenter_tpu_torch.testing import make_pod, make_provisioner

    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    # where the fused route calls each wrapper (fused imports pack_first_fit
    # by name; the v2 route calls it through its module)
    targets = {"pack_first_fit": (fused, "pack_first_fit"),
               "pack_first_fit_v2": (pack_kernel_v2, "pack_first_fit_v2")}
    out = {name: {} for name in modules}
    summary = {}
    scratch = tempfile.mkdtemp(prefix="karpenter-obs-")
    # the main path's fused route for both batches: phase 9 (c) left the
    # team mix's fused shape in the failed-fused memo; both memos are
    # emptied here and restored at the end
    memos = ((pack_kernel._failed_shapes_lock, pack_kernel._failed_shapes),
             (backend._fused_failed_lock, backend._fused_failed_shapes))
    saved = []
    for lock, memo in memos:
        with lock:
            saved.append(set(memo))
            memo.clear()

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    @contextlib.contextmanager
    def part(label: str):
        """One part of the phase. Yields a dict the part fills with the
        launches its rounds make, per kernel; on leaving, each kernel's
        launches measured over the part must equal it. The measured
        launches are what the kernels line reports."""
        rounds = {}
        start = counts()
        yield rounds
        got = {name: n - start[name] for name, n in counts().items()}
        want = {name: rounds.get(name, 0) for name in modules}
        if got != want:
            raise AssertionError(f"obs ({label}): launches {got}, its rounds make {want}")
        for name, n in got.items():
            if n:
                out[name][f"launches_{label}"] = n

    def solve(sched, cls, pods=None, what=""):
        """One round; it must launch its kernel once, and the plan must
        equal the device="cpu" plan."""
        pods = pods if pods is not None else classes[cls]["pods"]
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        start = counts()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, kernel_of[cls], what)
        launched = {name: n - start[name] for name, n in counts().items()}
        if launched != {name: int(name == kernel_of[cls]) for name in modules}:
            raise AssertionError(f"{what}: launches {launched}")
        if plan_of(nodes, pods) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"{what}: plan differs from the device='cpu' plan")
        return wall, prof, nodes

    try:
        # -- (a) traced rounds -----------------------------------------------
        obs.reset_for_tests()
        clock = KernelClock()
        obs.tracer().add_hook(clock)
        knob_off = {}
        for cls in ("headline", "team mix"):
            name = kernel_of[cls]
            with part("traced") as rounds:
                sched = knob_off[cls] = Scheduler(Cluster(), rng=random.Random(1))
                solve(sched, cls, what=f"obs (a) {cls} warm-up")
                before = {
                    "hits": metric("karpenter_solver_encode_cache_hits_total"),
                    "misses": metric("karpenter_solver_encode_cache_misses_total"),
                    "solves": metric(
                        "karpenter_allocation_controller_scheduling_duration_seconds_count",
                        {"provisioner": prov.name}),
                        "uploads": metric("karpenter_solver_session_catalog_uploads_total"),
                    **{f"session_{k}": v for k, v in session_stats.snapshot().items()
                       if k in ("hits", "misses")},
                }
                fetch_ms, kernel_ms_, done, worst = [], [], [], 0.0
                with mock.patch.object(*targets[name], clock.wrap(getattr(*targets[name]))):
                    for r in range(5):
                        obs.exporter().clear()
                        wall, prof, nodes = solve(sched, cls, what=f"obs (a) {cls} round {r}")
                        if prof["pack_route"] != "fused":
                            raise AssertionError(f"obs (a) {cls} round {r}: "
                                                 f"route {prof['pack_route']}")
                        trees = obs.exporter().trees()
                        if len(trees) != 1:
                            raise AssertionError(f"obs (a) {cls} round {r}: {len(trees)} trees")
                        tree = trees[0]
                        worst = max(worst, check_tree(tree, prof, f"obs (a) {cls} round {r}"))
                        (k_ms, done_at_begin, done_at_fetch), = clock.take()
                        spans = {c["name"]: c for c in tree["children"]}
                        begin, fetch = spans["solve.pack_begin"], spans["solve.pack_fetch"]
                        done.append((done_at_begin, done_at_fetch))
                        fetch_ms.append(fetch["duration_ms"])
                        kernel_ms_.append(k_ms)
                        path = " > ".join(f"{s['name']} {s['duration_ms']:.3f}/{s['self_ms']:.3f}"
                                          for s in obs.critical_path(tree))
                        log(f"[obs] (a) {cls} round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
                            f"1 launch of {name}; kernel {k_ms:.3f} ms (CUDA events), "
                            f"solve.pack_begin {begin['duration_ms']:.3f} ms (kernel done when it "
                            f"closed: {done_at_begin}), solve.pack_fetch "
                            f"{fetch['duration_ms']:.3f} ms "
                            f"(kernel done: {done_at_fetch}); critical path (ms total/self) {path}")
                check_kernel_timing(done, f"obs (a) {cls}")
                # -- (b) the counters these rounds move, by the reference's amounts
                session = session_stats.snapshot()
                moved = {
                    "encode cache hits": metric("karpenter_solver_encode_cache_hits_total")
                    - before["hits"],
                    "encode cache misses": metric("karpenter_solver_encode_cache_misses_total")
                    - before["misses"],
                    "scheduling_duration count": metric(
                        "karpenter_allocation_controller_scheduling_duration_seconds_count",
                        {"provisioner": prov.name}) - before["solves"],
                    "session hits": session["hits"] - before["session_hits"],
                    "session misses": session["misses"] - before["session_misses"],
                    "session uploads": metric("karpenter_solver_session_catalog_uploads_total")
                    - before["uploads"],
                }
                want = {"encode cache hits": 5, "encode cache misses": 0,
                        "scheduling_duration count": 5, "session hits": 5, "session misses": 0,
                        "session uploads": 0}
                if moved != want:
                    raise AssertionError(f"obs (b) {cls}: metric deltas {moved}, expected {want}")
                rounds[name] = 1 + 5
                out[name]["traced_kernel_ms"] = kernel_ms_
                out[name]["traced_pack_fetch_ms"] = fetch_ms
                out[name]["kernel_done_at_begin_fetch_close"] = done
                out[name]["stage_span_max_diff_ms"] = worst
                log(f"[obs] (a) {cls}: 5 traced rounds, each one launch, one solver.solve tree "
                    f"with "
                    f"the six stage spans, stage spans within {worst:.4f} ms of the profile; "
                    f"(b) metric deltas {moved}; card {card}")
        obs.tracer().remove_hook(clock)

        # -- (b) resident rounds and the registry ---------------------------
        with part("resident") as rounds:
            res = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
            solve(res, "headline", what="obs (b) resident warm-up")
            paths = ("host", "device", "decode")
            before = {p: metric("karpenter_solver_delta_applied_total", {"path": p})
                      for p in paths}
            for r in range(3):
                obs.exporter().clear()
                wall, prof, _ = solve(res, "headline", what=f"obs (b) resident round {r}")
                check_tree(obs.exporter().trees()[0], prof, f"obs (b) resident round {r}")
            rounds["pack_first_fit"] = 1 + 3
        applied = {p: metric("karpenter_solver_delta_applied_total", {"path": p}) - before[p]
                   for p in paths}
        resident_bytes = {
            side: metric("karpenter_solver_delta_resident_bytes", {"side": side})
            for side in ("host", "device")
        }
        if applied != {p: 3.0 for p in paths} or min(resident_bytes.values()) <= 0:
            raise AssertionError(f"obs (b) resident: applied {applied}, bytes {resident_bytes}")
        log(f"[obs] (b) resident headline: 3 steady rounds, SOLVER_DELTA_APPLIED {applied}, "
            f"resident bytes {resident_bytes}")
        headroom_svc = S.SolverService()
        args = [np.ascontiguousarray(a) for a in batches["headline"].pack_args()]
        key = S.catalog_session_key(*args[7:])
        headroom_svc.open_session_bytes(
            S.pack_arrays([np.frombuffer(key, np.int32)] + args[7:]))
        free = torch.cuda.mem_get_info()[0]
        gauge = metric("karpenter_solver_device_hbm_headroom_bytes",
                       {"device": str(torch.cuda.current_device())})
        hbm = metric("karpenter_solver_session_hbm_bytes", {"session": key.hex()[:12]})
        if abs(gauge - free) > 64 * 2**20 or hbm <= 0:
            raise AssertionError(f"obs (b): headroom gauge {gauge}, mem_get_info {free}, "
                                 f"session bytes {hbm}")
        log(f"[obs] (b) SOLVER_HBM_HEADROOM {gauge:.0f} bytes, torch.cuda.mem_get_info "
            f"{free} (|diff| {abs(gauge - free) / 2**20:.3f} MiB); session HBM {hbm:.0f} bytes")
        del headroom_svc
        from prometheus_client import generate_latest

        exposition = generate_latest(metrics.REGISTRY).decode().splitlines()
        log(f"[obs] (b) generate_latest: {len(exposition)} lines, first 40:")
        for line in exposition[:40]:
            log(f"[obs] (b)   {line}")

        # -- (c) the flight recorder -----------------------------------------
        flight_dir = os.path.join(scratch, "flight")
        rec = obs.configure_flight(flight_dir, budget_s=0.100)
        # a fresh scheduler's first round (its cold encode and upload take
        # most of a second) is over budget on any host; the warm rounds
        # after it land or not by their own time
        with part("flight") as rounds:
            cold = Scheduler(Cluster(), rng=random.Random(1))
            durations = []
            for r in range(3):
                obs.exporter().clear()
                solve(cold, "headline", what=f"obs (c) knob-off round {r}")
                durations.append(obs.exporter().trees()[0]["duration_ms"])
            records = rec.recent(limit=64)
            over = [d for d in durations if d > 100.0]
            if len(records) != len(over) or durations[0] <= 100.0:
                raise AssertionError(f"obs (c): {len(records)} flight records for rounds "
                                     f"{durations}")
            for record in records:
                missing = [p for p in OBS_PANELS if p not in record["state"]]
                if missing or record["name"] != "solver.solve":
                    raise AssertionError(f"obs (c): record {record['name']} lacks panels {missing}")
            obs.exporter().clear()
            solve(res, "headline", what="obs (c) resident round")
            res_ms = obs.exporter().trees()[0]["duration_ms"]
            landed = len(rec.recent(limit=64)) - len(records)
            if landed != (1 if res_ms > 100.0 else 0):
                raise AssertionError(f"obs (c): resident round {res_ms:.3f} ms, {landed} records")
            rounds["pack_first_fit"] = 3 + 1
        summary["flight"] = {"knob_off_ms": durations, "records": len(records),
                             "resident_ms": res_ms, "resident_records": landed}
        log(f"[obs] (c) knob-off rounds (the first cold) "
            f"{', '.join(f'{d:.3f}' for d in durations)} ms: "
            f"{len(records)} flight records, each with panels {list(OBS_PANELS)}; a resident "
            f"round {res_ms:.3f} ms: {landed} records")
        obs.reset_for_tests()

        # -- (d) what tracing costs -------------------------------------------
        with part("cost") as rounds:
            walls = {(cls, on): [] for cls in kernel_of for on in (False, True)}
            for i in range(5):
                for cls in kernel_of:
                    for on in ((False, True) if i % 2 == 0 else (True, False)):
                        obs.set_enabled(on)
                        wall, _, _ = solve(knob_off[cls], cls, what=f"obs (d) {cls} traced={on}")
                        walls[(cls, on)].append(wall * 1e3)
            obs.set_enabled(True)
            cost = {}
            for cls in kernel_of:
                off, on = walls[(cls, False)], walls[(cls, True)]
                cost[cls] = {"untraced_ms": off, "traced_ms": on,
                             "median_diff_ms": float(np.median(on) - np.median(off))}
                log(f"[obs] (d) {cls}: untraced {', '.join(f'{w:.3f}' for w in off)} ms; traced "
                    f"{', '.join(f'{w:.3f}' for w in on)} ms; median traced - untraced "
                    f"{cost[cls]['median_diff_ms']:.3f} ms; card {card}")

            def device_work(on: bool) -> dict:
                obs.set_enabled(on)
                try:
                    return profiled_device_work(
                        lambda: solve(knob_off["headline"], "headline",
                                      what=f"obs (d) profiled traced={on}"))
                finally:
                    obs.set_enabled(True)

            # a record the profiler drops only lowers a count (knob-off
            # rounds have showed no upload at all, though each uploads its
            # pod table): each mode is profiled three times, in turns, and
            # the most of each kind is compared
            tallies = {False: [], True: []}
            for on in (False, True, True, False, False, True):
                tallies[on].append(device_work(on))
            untraced, traced = ({k: max(t[k] for t in tallies[on]) for k in tallies[on][0]}
                                for on in (False, True))
            if untraced != traced or not traced["kernels"] or not traced["memcpy_dtoh"]:
                raise AssertionError(f"obs (d): device work traced {tallies[True]}, untraced "
                                     f"{tallies[False]}")
            cost["profiled_device_work"] = traced
            summary["tracing_cost"] = cost
            log(f"[obs] (d) under torch.profiler a traced and an untraced headline round do the "
                f"same device work: {traced} (the most of three profiled rounds each; traced "
                f"{tallies[True]}, untraced {tallies[False]})")
            rounds["pack_first_fit"] = 5 * 2 + 6
            rounds["pack_first_fit_v2"] = 5 * 2

        # -- (e) decisions, explain, replay -----------------------------------
        with part("decisions") as rounds:
            rng = random.Random(5)
            head_pods = list(classes["headline"]["pods"])
            stuck_at = sorted(rng.sample(range(len(head_pods)), len(head_pods) // 100))
            for i in stuck_at:
                head_pods[i] = make_pod(name=f"stuck-{i}", requests={"cpu": "100000"})
            card_sched = Scheduler(Cluster(), rng=random.Random(1))
            start = counts()
            nodes = card_sched.solve(prov, catalogs["headline"], head_pods)
            served(card_sched, "pack_first_fit", "obs (e) card round")
            if counts()["pack_first_fit"] - start["pack_first_fit"] != 1:
                raise AssertionError("obs (e): the card round did not launch pack_first_fit once")
            ctx = card_sched.last_decision_context()
            decision_dir = os.path.join(scratch, "decisions")
            log_ = obs.DecisionLog(directory=decision_dir, write_interval=0.0)
            record = log_.record_round(prov.name, head_pods, nodes, context=ctx)
            if not log_.flush(60.0):
                raise AssertionError("obs (e): the decision ring did not flush")
            # every unplaced pod's verdict (the record lists the first 50)
            stuck_keys = {head_pods[i].key for i in stuck_at}
            unplaced = {v["pod"]: v for v in explain.explain_batch(ctx["batch"], ctx["assignment"])}
            verdicts = record["unschedulable"]
            if (record["unschedulable_count"] != len(unplaced) or stuck_keys - set(unplaced)
                    or any(unplaced[k]["top_reason"] != "resource_fit" for k in stuck_keys)):
                reasons = sorted({unplaced[k]["top_reason"] for k in stuck_keys & set(unplaced)})
                raise AssertionError(f"obs (e): {record['unschedulable_count']} unschedulable, "
                                     f"{len(stuck_keys - set(unplaced))} stuck pods placed, "
                                     f"reasons {reasons}")
            # the others are the batch's own zone anti-affinity pods: a required
            # anti-affinity term over the zone admits one pod of a selector
            # group per zone, and the catalog offers three (the JAX package's
            # scheduler leaves the same pods unplaced with the same verdicts on
            # this batch, tests/test_torch_explain.py)
            by_key = {p.key: p for p in head_pods}
            others = [k for k in unplaced if k not in stuck_keys]
            other_reasons = dict(collections.Counter(unplaced[k]["top_reason"] for k in others))

            def zone_anti_affinity(pod) -> bool:
                anti = pod.spec.affinity and pod.spec.affinity.pod_anti_affinity
                return bool(anti) and [t.topology_key for t in anti.required] == [
                    lbl.TOPOLOGY_ZONE]

            if set(other_reasons) - {"zone_topology"} or not all(
                    zone_anti_affinity(by_key[k]) for k in others):
                raise AssertionError(f"obs (e): besides the stuck pods, {len(others)} unplaced "
                                     f"with reasons {other_reasons}, not all of them zone "
                                     f"anti-affinity pods")
            os.environ["KARPENTER_PACKER"] = "fused"
            try:
                cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
                cpu_nodes = cpu_sched.solve(prov, catalogs["headline"], head_pods)
            finally:
                os.environ.pop("KARPENTER_PACKER", None)
            not_degraded(cpu_sched, "obs (e) cpu round")
            if plan_of(cpu_nodes, head_pods) != plan_of(nodes, head_pods):
                raise AssertionError("obs (e): the card plan differs from the cpu plan")
            cpu_ctx = cpu_sched.last_decision_context()
            cpu_record = obs.DecisionLog().record_round(prov.name, head_pods, cpu_nodes,
                                                        context=cpu_ctx)
            if (cpu_record["unschedulable"] != verdicts or explain.explain_batch(
                    cpu_ctx["batch"], cpu_ctx["assignment"]) != list(unplaced.values())):
                raise AssertionError("obs (e): explain verdicts differ from the cpu scheduler's")
            path = replay_tool.find_record(decision_dir, record_id=record["id"])
            verdict = replay_tool.replay(replay_tool.load_record(path), record_path=path)
            if verdict["ok"] is not True or verdict["replay_unschedulable"] != len(unplaced):
                raise AssertionError(f"obs (e): native replay {verdict}")
            with np.load(os.path.join(decision_dir, replay_tool.load_record(path)["replay_file"]),
                         allow_pickle=False) as blob:
                arrays = {k: blob[k] for k in blob.files}
            arrays["pod_req"] = arrays["uniq_req"][arrays["pod_req_id"]]
            tensors = [torch.tensor(arrays[n], dtype=dt, device=dev) for n, dt in PACK_ARG_DTYPES]
            start = counts()
            best, result = pack_kernel.pack_best(*tensors, n_max=int(arrays["n_max"]))
            n_pods = int(arrays["n_pods"])
            once = counts()["pack_first_fit"] - start["pack_first_fit"] == 1
            if best != "pack_first_fit" or not once or not np.array_equal(
                    result.assignment.cpu().numpy()[:n_pods], arrays["assignment"][:n_pods]):
                raise AssertionError(f"obs (e): the blob through pack_best ({best}) is not "
                                     f"bit-exact")
            bad_ctx = dict(ctx)
            bad = np.asarray(ctx["assignment"]).copy()
            bad[0] = bad[0] + 1 if bad[0] >= 0 else 0
            bad_ctx["assignment"] = bad
            bad_record = log_.record_round(prov.name, head_pods, nodes, context=bad_ctx)
            log_.flush(60.0)
            bad_path = replay_tool.find_record(decision_dir, record_id=bad_record["id"])
            caught = replay_tool.replay(replay_tool.load_record(bad_path), record_path=bad_path)
            if caught["ok"] is not False:
                raise AssertionError(f"obs (e): a corrupted assignment replayed as {caught}")
            log_.close()
            rounds["pack_first_fit"] = 2
            summary["decisions"] = {"stuck": len(stuck_at), "unschedulable": len(unplaced),
                                    "others": other_reasons, "listed": len(verdicts),
                                    "replay": "bit-exact", "corrupt_caught": caught["diff"]}
            log(f"[obs] (e) {len(head_pods)} pods, {len(stuck_at)} stuck: one launch, "
                f"{record['unschedulable_count']} unschedulable ({len(verdicts)} listed; every "
                f"stuck pod resource_fit; the {len(others)} others zone anti-affinity pods, "
                f"reasons "
                f"{other_reasons}; all verdicts equal to the device='cpu' scheduler's); "
                f"explain took "
                f"{record['explain_s'] * 1e3:.3f} ms; the .npz replays on the native packer "
                f"bit-exact and through pack_best ({best}, one launch) bit-exact; a corrupted "
                f"assignment caught: {caught['diff']}")

        # -- (f) the SLO engine and the brownout ladder ------------------------
        with part("slo") as rounds:
            obs.reset_for_tests()
            engine = obs.configure_slo(window_s=SLO_WINDOW_S)
            walls_f = []
            # the first of the 12 rounds is a fresh scheduler's (cold, over
            # 100 ms on any host); the warm ones burn the objective as well
            # wherever the host holds them over 100 ms
            fresh = Scheduler(Cluster(), rng=random.Random(1))
            for r in range(12):
                wall, _, _ = solve(fresh, "headline", what=f"obs (f) knob-off round {r}")
                walls_f.append(wall * 1e3)
            snap = engine.snapshot()["objectives"]["solve_p99"]
            log(f"[obs] (f) SLO window {SLO_WINDOW_S} s (slow {engine.slow_window_s} s); "
                f"12 knob-off "
                f"rounds (the first cold) {', '.join(f'{w:.1f}' for w in walls_f)} ms, "
                f"{sum(w > 100.0 for w in walls_f)} over 100 ms: solve.p99 "
                f"{snap['value'] * 1e3:.3f} ms, burn fast {snap['burn_rate']['fast']} slow "
                f"{snap['burn_rate']['slow']}, burning {snap['burning']}")
            if not snap["burning"]:
                raise AssertionError(f"obs (f): solve.p99 < 100ms is not burning: {snap}")
            router = default_router()
            ladder = BrownoutController(router=router, escalate_after=1, recover_after=1)
            climbed = [ladder.tick(), ladder.tick()]
            if climbed[-1] < 1 or not router.probes_paused():
                raise AssertionError(f"obs (f): the ladder reached {climbed}, probes paused "
                                     f"{router.probes_paused()}")
            log(f"[obs] (f) brownout ticks -> levels {climbed}, transitions "
                f"{ladder.transitions}; karpenter_brownout_level "
                f"{metric('karpenter_brownout_level')}; probes paused")

            def canary_round(what):
                sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0)
                before = integrity.totals()["canary_solves"]
                solve(sched, "headline", what=what)
                if sched.torch._canary_thread is not None:
                    sched.torch._canary_thread.join(timeout=120)
                    if sched.torch._canary_thread.is_alive():
                        raise AssertionError(f"{what}: the canary did not finish")
                return integrity.totals()["canary_solves"] - before

            paused_canaries = canary_round("obs (f) canary round under brownout")
            if paused_canaries:
                raise AssertionError(f"obs (f): {paused_canaries} canary solves while paused")
            t0 = time.perf_counter()
            clean = 0
            while time.perf_counter() - t0 < 3 * SLO_WINDOW_S:
                solve(res, "headline", what="obs (f) resident round")
                clean += 1
                state = engine.snapshot()["objectives"]["solve_p99"]
                if not state["burning"] and state["events"]["fast"] >= 10 and not any(
                        v["burning"] for v in engine.burning_panel().values()):
                    break
            else:
                raise AssertionError(f"obs (f): still burning after {clean} resident rounds: "
                                     f"{state}")
            recovered = []
            while ladder.level() > 0 and len(recovered) < 8:
                recovered.append(ladder.tick())
            if ladder.level() != 0 or router.probes_paused():
                raise AssertionError(f"obs (f): the ladder did not recover: {recovered}")
            resumed = canary_round("obs (f) canary round after recovery")
            if resumed != 1:
                raise AssertionError(f"obs (f): {resumed} canary solves after recovery")
            ladder.stop()
            summary["slo"] = {"window_s": SLO_WINDOW_S, "knob_off_ms": walls_f,
                              "p99_ms": snap["value"] * 1e3, "burn_fast": snap["burn_rate"]["fast"],
                              "burn_slow": snap["burn_rate"]["slow"], "levels_up": climbed,
                              "levels_down": recovered, "resident_rounds": clean}
            log(f"[obs] (f) {clean} resident rounds cleaned the fast window "
                f"({state['events']['fast']} events, p99 {state['value'] * 1e3:.3f} ms, burn "
                f"{state['burn_rate']}); ladder -> {recovered}; transitions {ladder.transitions}; "
                f"karpenter_brownout_level {metric('karpenter_brownout_level')}; canary solves "
                f"{paused_canaries} paused, {resumed} after recovery")
            rounds["pack_first_fit"] = 12 + 2 + clean

        # -- (g) the sidecar, traced ------------------------------------------
        try:
            import grpc  # noqa: F401
        except ImportError:
            log("[obs] grpc not installed on this host: (g) is held by the CPU tests")
        else:
            with part("sidecar") as rounds:
                summary["sidecar"] = sidecar_traced(card, classes, catalogs, rounds)
    finally:
        obs.reset_for_tests()
        shutil.rmtree(scratch, ignore_errors=True)
        for (lock, memo), was in zip(memos, saved):
            with lock:
                memo.clear()
                memo.update(was)
    for name in modules:
        out[name]["launches_obs"] = sum(v for k, v in out[name].items()
                                        if k.startswith("launches_"))
    out["summary"] = summary
    return out


def sidecar_traced(card: str, classes: dict, catalogs: dict, rounds: dict) -> dict:
    """Phase 14 (g): serve() on the card with its health port, and traced
    device="cpu" controller rounds through it: a unary headline round and
    a streamed team-mix round. The controller's solver.wire span holds the
    sidecar's grafted stage records; the sidecar's ring (GET /debug/traces
    on its health port) holds its sidecar.pack tree under the controller's
    trace id; GET /metrics serves the port's families. Fills ``rounds``
    with the rounds each kernel served."""
    import urllib.request

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    address = free_address()
    health_port = int(free_address().rsplit(":", 1)[1])
    server = S.serve(address, max_workers=8, health_port=health_port, service=S.SolverService())
    os.environ["KARPENTER_PACKER"] = "fused"
    closers = []
    found = {}

    def get(path: str) -> bytes:
        with urllib.request.urlopen(f"http://127.0.0.1:{health_port}{path}", timeout=30) as r:
            return r.read()

    def traced_round(sched, cls, what):
        sched.torch.topology.rng = random.Random(1)
        obs.exporter().clear()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], classes[cls]["pods"])
        wall = (time.perf_counter() - t0) * 1e3
        prof = served(sched, "sidecar", what)
        if plan_of(nodes, classes[cls]["pods"]) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"{what}: plan differs from the card plan")
        root = next(t for t in obs.exporter().trees() if t["name"] == "solver.solve")
        wires = obs.spans_named(root, "solver.wire")
        if len(wires) != 1 or wires[0]["attrs"].get("transport") != prof["solver_transport"]:
            raise AssertionError(f"{what}: solver.wire spans {wires}")
        grafted = [c["name"] for c in wires[0]["children"]]
        if grafted != ["sidecar.solve", "sidecar.fetch", "sidecar.serialize"]:
            raise AssertionError(f"{what}: solver.wire holds {grafted}")
        log(f"[obs] (g) {what}: {wall:.3f} ms, transport={prof['solver_transport']}, "
            f"solver.wire {wires[0]['duration_ms']:.3f} ms holding "
            + ", ".join(f"{c['name']} {c['duration_ms']:.3f}" for c in wires[0]["children"])
            + f" ms; trace {root['trace_id']}")
        return prof, root

    try:
        unary = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address)
        closers.append(unary)
        _, root = traced_round(unary, "headline", "unary headline round")
        rounds["pack_first_fit"] = 1
        body = json.loads(get(f"/debug/traces?trace_id={root['trace_id']}"))
        packs = [t for t in body["traces"] if t["name"] == "sidecar.pack"]
        if len(packs) != 1 or packs[0]["trace_id"] != root["trace_id"]:
            raise AssertionError(f"obs (g): sidecar ring holds {[t['name'] for t in body['traces']]}")
        begin = next(c for c in root["children"] if c["name"] == "solve.pack_begin")
        if packs[0]["parent_id"] != begin["span_id"]:
            raise AssertionError("obs (g): sidecar.pack is not parented on solve.pack_begin")
        found["sidecar_pack"] = [c["name"] for c in packs[0]["children"]]
        streamed = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                             solver_service_address=address, solver_stream=True)
        closers.append(streamed)
        transport = None
        for r in range(4):
            prof, _ = traced_round(streamed, "team mix", f"streamed team mix round {r}")
            rounds["pack_first_fit_v2"] = r + 1
            transport = prof["solver_transport"]
            if transport == "stream":
                break
        if transport != "stream":
            raise AssertionError(f"obs (g): the team mix never rode the stream ({transport})")
        text = get("/metrics").decode()
        for family in ("karpenter_solver_session_hbm_bytes{", "karpenter_solver_stream_solves_total{",
                       "karpenter_trace_spans_total", "karpenter_solver_admission_queue_depth"):
            if family not in text:
                raise AssertionError(f"obs (g): /metrics lacks {family}")
        found["metrics_lines"] = len(text.splitlines())
        log(f"[obs] (g) sidecar ring: sidecar.pack under the controller's trace, parented on "
            f"its solve.pack_begin, children {found['sidecar_pack']}; /metrics "
            f"{found['metrics_lines']} lines with the session HBM, stream, trace and admission "
            f"families; card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        for c in closers:
            if c.torch._remote is not None:
                c.torch._remote.close()
        server.health_server.shutdown()
        server.stop(grace=None)
    return found


STORM_PODS = 10000
CONTROLLER_BATCH = 2000  # the batcher's default max_items


def wire_controllers(cluster, provider, device: str, start_workers: bool, journal=None,
                     warm_pool: bool = False, solver_service_address=None):
    """The five ported controllers wired as the reference's main.py wires
    them: a Manager with provisioning (concurrency 10, its launch
    ``journal``, the warm-hit steal with ``warm_pool``, its solves sent to
    ``solver_service_address`` when one is given), selection (32,
    wait=False), counter and pvc (2 each), the provisioners and pods
    watches, counter's and pvc's own watches, and the cloud provider behind
    cpmetrics.decorate. Returns (manager, provisioning, counter)."""
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.controllers.counter import CounterController
    from karpenter_tpu_torch.controllers.manager import Manager
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.controllers.pvc import PVCController
    from karpenter_tpu_torch.controllers.selection import SelectionController

    manager = Manager(cluster)
    provisioning = ProvisioningController(
        cluster, cpmetrics.decorate(provider), start_workers=start_workers, device=device,
        journal=journal, warm_pool=warm_pool, solver_service_address=solver_service_address)
    selection = SelectionController(cluster, provisioning, wait=False)
    counter = CounterController(cluster)
    pvc = PVCController(cluster)
    manager.register("provisioning", provisioning.reconcile, concurrency=10)
    manager.register("selection", selection.reconcile, concurrency=32)
    manager.register("counter", counter.reconcile, concurrency=2)
    manager.register("pvc", pvc.reconcile, concurrency=2)
    cluster.watch("provisioners", lambda e, o: manager.enqueue("provisioning", o.metadata.name))
    cluster.watch("pods", lambda e, o: manager.enqueue(
        "selection", (o.metadata.name, o.metadata.namespace)))
    counter.register(manager)
    pvc.register(manager)
    return manager, provisioning, counter


def record_rounds(worker, rounds: list) -> None:
    """Wrap the worker's scheduler.solve: each round appends its batch
    size, the nodes it planned, what served it (packer_backend, pack_route,
    pack_dispatches), its SCHEDULING_DURATION observation and its host
    wall time, and the batch's pods that no node holds (``unplaced``); a
    round that raises appends its error and re-raises."""
    sched = worker.scheduler
    solve = sched.solve
    labels = {"provisioner": worker.provisioner.name}

    def wrapped(provisioner, instance_types, pods):
        before = metric("karpenter_allocation_controller_scheduling_duration_seconds_sum", labels)
        t0 = time.perf_counter()
        try:
            nodes = solve(provisioner, instance_types, pods)
        except Exception as e:
            rounds.append({"pods": len(pods), "error": repr(e)})
            raise
        if sched.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        prof = sched.last_stage_profile()
        rounds.append({
            "pods": len(pods), "nodes": len(nodes),
            "unplaced": len(pods) - sum(len(n.pods) for n in nodes),
            "backend": prof.get("packer_backend"), "route": prof.get("pack_route"),
            "dispatches": prof.get("pack_dispatches", 0),
            "scheduling_ms": (metric("karpenter_allocation_controller_scheduling_duration_seconds_sum", labels)
                              - before) * 1e3,
            "solve_ms": (time.perf_counter() - t0) * 1e3,
        })
        return nodes

    sched.solve = wrapped


def check_rounds(rounds: list, kernels: set, what: str) -> dict:
    """Every round named one of ``kernels`` (never the floor, never
    nothing, never an error); returns the dispatches per kernel."""
    launched = {}
    for i, r in enumerate(rounds):
        if "error" in r or r["backend"] not in kernels:
            raise AssertionError(f"{what} round {i}: {r}")
        launched[r["backend"]] = launched.get(r["backend"], 0) + r["dispatches"]
    return launched


def expect_launches(what: str, got: dict, want: dict) -> None:
    """The wrappers' launch counters over a part against its rounds."""
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"controller ({what}): launches {got}, its rounds make {want}")


def fits_and_counts(cluster, prov_name: str, what: str) -> dict:
    """Every node holds pods within its allocatable, every pod is bound to
    a node that exists, and the counter's status.resources equals the
    summed capacity of the nodes (milli-units). Returns the summed
    capacity."""
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.utils import resources as res

    nodes = {n.metadata.name: n for n in cluster.nodes()}
    for pod in cluster.pods():
        if pod.spec.node_name and pod.spec.node_name not in nodes:
            raise AssertionError(f"{what}: pod {pod.key} bound to missing node {pod.spec.node_name}")
    total = {}
    for n in nodes.values():
        on = cluster.pods_on_node(n.metadata.name)
        if on and not res.fits(res.requests_for_pods(*on), n.status.allocatable):
            raise AssertionError(f"{what}: node {n.metadata.name} ({len(on)} pods) over its "
                                 f"allocatable")
        if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == prov_name:
            total = res.merge(total, n.status.capacity)
    return {k: round(v * 1000) for k, v in total.items()}


def counted(cluster, prov_name: str) -> dict:
    status = cluster.get("provisioners", prov_name, namespace="").status.resources
    return {k: round(v * 1000) for k, v in status.items()}


def bound_state(cluster, pods, random_keys) -> tuple:
    """By pod index: the partition of the pods into nodes, each node's
    labels (minus the values to_node draws at random), taints and
    finalizers; the unbound pods. Node names, launch tokens and trace ids
    are left out."""
    groups = {}
    for i, p in enumerate(pods):
        groups.setdefault(p.spec.node_name, []).append(i)
    unbound = groups.pop("", [])
    nodes = {}
    for name, idxs in groups.items():
        n = cluster.get("nodes", name, namespace="")
        labels = {k: (v if k not in random_keys else "<random>")
                  for k, v in n.metadata.labels.items()}
        nodes[tuple(idxs)] = (
            labels, sorted((t.key, t.value, t.effect) for t in n.spec.taints),
            sorted(n.metadata.finalizers))
    return nodes, unbound


def inline_controller(device: str, catalog, pods, requirements=None, freeze=None,
                      gc_hook=None) -> dict:
    """One provisioner's controller with start_workers=False: every pod
    created in the cluster and queued in the worker's batcher, then
    provision_once until the queue drains (batches of CONTROLLER_BATCH),
    then the counter. The worker's topology rng is seeded, as every plan
    comparison seeds it. ``freeze`` True or False first runs the worker's
    warm-up (what start() runs in its thread) and then, if True, calls
    freeze_after_warmup where the reference's main.py does, restoring the
    collector's policy when the rounds end; ``gc_hook`` (log_gc_pauses)
    gives the full collections the rounds saw."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.controllers.counter import CounterController
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.testing import make_provisioner
    from karpenter_tpu_torch.utils import gcpolicy

    cluster = Cluster()
    provider = FakeCloudProvider(catalog)
    provisioning = ProvisioningController(
        cluster, cpmetrics.decorate(provider), start_workers=False, device=device)
    counter = CounterController(cluster)
    prov = make_provisioner(solver="tpu", requirements=requirements)
    cluster.create("provisioners", prov)
    provisioning.reconcile(prov.name)
    worker = provisioning.workers[prov.name]
    worker.batcher.idle_duration = 0.01
    warm = {}
    if freeze is not None:
        worker._warmup()
        warm = worker.scheduler.last_stage_profile()
        if not worker.warmed.is_set() or warm.get("pack_dispatches") is None:
            raise AssertionError(f"inline {device}: the warm-up did not solve ({warm})")
    worker.scheduler.torch.topology.rng = random.Random(1)
    rounds = []
    record_rounds(worker, rounds)
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    walls = []
    full = gc_hook.full if gc_hook is not None else []
    try:
        at = len(full)
        if freeze:
            gcpolicy.freeze_after_warmup()
        freeze_gc = [t * 1e3 for t in full[at:]]  # freeze_after_warmup's own collection
        full_before = len(full)
        while worker.batcher.depth():
            t0 = time.perf_counter()
            worker.provision_once()
            walls.append((time.perf_counter() - t0) * 1e3)
        counter.reconcile(prov.name)
    finally:
        gcpolicy.restore()
        provisioning.stop()
    random_keys = {k for k, vs in worker.provisioner.spec.constraints.requirements._sets
                   if vs.op_type() == "Exists"}
    nodes, unbound = bound_state(cluster, pods, random_keys)
    cond = cluster.get("provisioners", prov.name, namespace="").status.condition()
    return {
        "rounds": rounds, "walls": walls, "nodes": nodes, "unbound": unbound,
        "resources": counted(cluster, prov.name),
        "capacity": fits_and_counts(cluster, prov.name, f"inline {device}"),
        "created": len(provider.create_calls), "active": (cond.type, cond.status),
        "warm": warm, "full_gc_ms": [t * 1e3 for t in full[full_before:]],
        "freeze_gc_ms": freeze_gc,
    }


def controller_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                     n_types: int = 400, gc_hook=None) -> dict:
    """Phase 15: the provisioning control plane on the card, at full
    width. Returns the kernels line's ``controller`` entries."""
    from karpenter_tpu_torch.cloudprovider.fake import (
        FakeCloudProvider, instance_types, instance_types_tradeoff)
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.main import build_runtime
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    # -- (a) the event storm through build_runtime's Manager -------------
    # no collection is forced before a part: a full collection of the
    # script's heap lands where the allocator puts it, inside the storm's
    # latencies or a round, and its [gc] line says where
    cluster = Cluster()
    provider = FakeCloudProvider(instance_types(n_types))
    rt = build_runtime(Options(device=device), cluster=cluster, cloud_provider=provider)
    provisioning = rt.provisioning
    rt.manager.start()
    start = counts()
    try:
        t0 = time.perf_counter()
        cluster.create("provisioners", make_provisioner(solver="tpu"))
        deadline = time.time() + 60
        while time.time() < deadline and not provisioning.workers:
            time.sleep(0.01)
        worker = provisioning.workers["default"]
        worker.batcher.idle_duration = 0.2
        if not worker.warmed.wait(timeout=600):
            raise AssertionError("controller (a): the warm-up never finished")
        warm = worker.scheduler.torch.completed_profile()
        if warm.get("packer_backend") != V1:
            raise AssertionError(f"controller (a): warm-up served by {warm.get('packer_backend')!r}")
        warm_launches = delta(start)
        expect_launches("a, warm-up", warm_launches, {V1: warm.get("pack_dispatches", 0)})
        log(f"[controller] (a) warm-up of {worker.batcher.max_items} pods "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms after the provisioner's create, "
            f"served by {warm['packer_backend']} ({warm['pack_route']}), launches {warm_launches}")
        rounds = []
        record_rounds(worker, rounds)
        binds = {}
        created, bound_at = {}, {}
        lock = threading.Lock()
        bind = cluster.bind

        def counting_bind(pod, node_name):
            with lock:
                binds[pod.key] = binds.get(pod.key, 0) + 1
            bind(pod, node_name)

        def on_pod(event, pod):
            if event == "MODIFIED" and pod.spec.node_name:
                now = time.perf_counter()
                with lock:
                    if pod.metadata.name in created and pod.metadata.name not in bound_at:
                        bound_at[pod.metadata.name] = now

        cluster.bind = counting_bind
        cluster.watch("pods", on_pod)
        rng = random.Random(5)
        storm_start = counts()
        t0 = time.perf_counter()
        for i in range(n_pods):
            name = f"storm-{i}"
            p = make_pod(name=name, requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"})
            with lock:
                created[name] = time.perf_counter()
            cluster.create("pods", p)
        enqueue_s = time.perf_counter() - t0
        deadline = time.time() + 600
        while time.time() < deadline:
            with lock:
                if len(bound_at) >= n_pods:
                    break
            time.sleep(0.02)
        wall = time.perf_counter() - t0
        storm_launches = delta(storm_start)
        with lock:
            lat = sorted(bound_at[k] - created[k] for k in bound_at)
            twice = {k: n for k, n in binds.items() if n > 1}
        if len(lat) != n_pods:
            raise AssertionError(f"controller (a): {len(lat)} of {n_pods} pods bound in {wall:.1f} s")
        if twice:
            raise AssertionError(f"controller (a): pods bound more than once: {list(twice)[:5]}")
        launched = check_rounds(rounds, {V1, V2}, "controller (a)")
        expect_launches("a, storm", storm_launches, launched)
        for i, r in enumerate(rounds):
            log(f"[controller] (a) round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")
        planned = sum(r["nodes"] for r in rounds)
        nodes = cluster.nodes()
        if not (planned == len(nodes) == len(provider.create_calls)):
            raise AssertionError(f"controller (a): {planned} virtual nodes, {len(nodes)} Nodes, "
                                 f"{len(provider.create_calls)} creates")
        capacity = fits_and_counts(cluster, "default", "controller (a)")
        deadline = time.time() + 60
        while time.time() < deadline and counted(cluster, "default") != capacity:
            time.sleep(0.05)
        if counted(cluster, "default") != capacity:
            raise AssertionError(f"controller (a): counter {counted(cluster, 'default')} != "
                                 f"capacity {capacity}")
        p50 = lat[len(lat) // 2]
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        log(f"[controller] (a) storm of {n_pods} pods: create->bind p50 {p50 * 1e3:.1f} ms, "
            f"p99 {p99 * 1e3:.1f} ms, {n_pods / wall:.1f} bound pods/s, wall {wall:.3f} s "
            f"(creates {enqueue_s:.3f} s), {len(rounds)} rounds, {len(nodes)} nodes = "
            f"{planned} virtual nodes = {len(provider.create_calls)} creates, counter "
            f"status.resources == summed capacity {capacity}; card {card}")
        out["summary"]["storm"] = {
            "pods": n_pods, "rounds": len(rounds), "batches": [r["pods"] for r in rounds],
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "pods_per_s": n_pods / wall,
            "wall_s": wall, "nodes": len(nodes),
        }
        for name in (V1, V2):
            n = warm_launches[name] + storm_launches[name]
            if n:
                out[name]["launches_storm"] = n
    finally:
        rt.stop()
        forget_node_gauges({n.metadata.name for n in cluster.nodes()})
    del cluster, provider, rt, provisioning

    # -- (b), (c) inline, against a device="cpu" controller ---------------
    # (b) runs twice on the card after the worker's warm-up: without the
    # GC freeze, then with freeze_after_warmup where the reference's
    # main.py calls it (restored when its rounds end)
    parts = (
        ("b", "headline", instance_types(n_types),
         lambda: diverse_pods(n_pods, random.Random(42)), V1, (False, True)),
        ("c", "team mix", instance_types_tradeoff(n_types),
         lambda: team_pods(n_pods, 9), V2, (None,)),
    )
    for label, what, catalog, make, kernel, freezes in parts:
        ref = inline_controller("cpu", catalog, make())
        for i, r in enumerate(ref["rounds"]):
            if "error" in r or r["backend"] in ("ffd-degraded", None):
                raise AssertionError(f"controller ({label}) cpu round {i}: {r}")
        for freeze in freezes:
            part = label + ("_frozen" if freeze else "")
            start = counts()
            card_run = inline_controller(device, catalog, make(), freeze=freeze, gc_hook=gc_hook)
            got = delta(start)
            launched = check_rounds(card_run["rounds"], {kernel}, f"controller ({part})")
            if freeze is not None:
                launched[V1] = launched.get(V1, 0) + card_run["warm"]["pack_dispatches"]
            expect_launches(part, got, launched)
            for key in ("nodes", "unbound", "resources", "created", "active"):
                if card_run[key] != ref[key]:
                    raise AssertionError(f"controller ({part}): {key} differs from the "
                                         f"device='cpu' controller")
            if card_run["resources"] != card_run["capacity"]:
                raise AssertionError(f"controller ({part}): counter {card_run['resources']} != "
                                     f"capacity {card_run['capacity']}")
            for i, (r, w) in enumerate(zip(card_run["rounds"], card_run["walls"])):
                log(f"[controller] ({part}) {what} round {i}: batch {r['pods']}, nodes "
                    f"{r['nodes']}, {r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                    f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms, provision_once {w:.3f} ms")
            gc_line = ""
            if freeze is not None:
                gc_line = (f"; after the warm-up ({card_run['warm']['packer_backend']}), "
                           f"{'with' if freeze else 'without'} freeze_after_warmup: "
                           f"{len(card_run['full_gc_ms'])} generation-2 collections in the "
                           f"rounds, pauses {[round(t, 3) for t in card_run['full_gc_ms']]} ms"
                           + (f" (the freeze's own collection "
                              f"{[round(t, 3) for t in card_run['freeze_gc_ms']]} ms)"
                              if freeze else ""))
            log(f"[controller] ({part}) {what}: {len(card_run['rounds'])} rounds, "
                f"{len(card_run['nodes'])} nodes, {len(card_run['unbound'])} pods unplaced, "
                f"launches {got}; == the device='cpu' controller pod for pod (partition, "
                f"instance types, zones, capacity types, labels, taints, finalizers, "
                f"status.resources, Active){gc_line}; card {card}")
            out[kernel][f"launches_{part}"] = got[kernel]
            out["summary"][part] = {
                "rounds": len(card_run["rounds"]), "nodes": len(card_run["nodes"]),
                "unplaced": len(card_run["unbound"]),
                "provision_once_ms": card_run["walls"],
                "scheduling_ms": [r["scheduling_ms"] for r in card_run["rounds"]],
            }
            if freeze is not None:
                out["summary"][part]["full_gc_ms"] = card_run["full_gc_ms"]
                out["summary"][part]["freeze_gc_ms"] = card_run["freeze_gc_ms"]
    return out


def wire_lifecycle(manager, cluster, provider, metrics: bool = True):
    """The node lifecycle controllers on ``manager`` as the reference's
    main.py registers them: termination and node (concurrency 10 each),
    the node and pod metrics controllers (2 each; left out with
    ``metrics=False``), and their own watches. Returns the
    TerminationController (its eviction queue has a thread to stop)."""
    from karpenter_tpu_torch.controllers.metrics_node import NodeMetricsController
    from karpenter_tpu_torch.controllers.metrics_pod import PodMetricsController
    from karpenter_tpu_torch.controllers.node import NodeController
    from karpenter_tpu_torch.controllers.termination import TerminationController

    termination = TerminationController(cluster, provider)
    node = NodeController(cluster, cloud_provider=provider)
    manager.register("termination", termination.reconcile, concurrency=10)
    manager.register("node", node.reconcile, concurrency=10)
    controllers = [node, termination]
    if metrics:
        metrics_node = NodeMetricsController(cluster)
        metrics_pod = PodMetricsController(cluster)
        manager.register("metrics_node", metrics_node.reconcile, concurrency=2)
        manager.register("metrics_pod", metrics_pod.reconcile, concurrency=2)
        controllers += [metrics_node, metrics_pod]
    for controller in controllers:
        controller.register(manager)
    return termination


def live_cluster(device: str, teams: bool = False, owned: bool = False,
                 finalizers: bool = False, n_nodes: int = 1000, **kw) -> tuple:
    """The reference's consolidation benchmark cluster (bench.py:1255-1303,
    BASELINE config 5): instance_types(400), Random(7), nodes live-{i} of a
    random fake-it-300..399 type with 16 cpu / 32Gi / 100 pods in
    test-zone-1 on-demand, each holding 1-3 bound pods of cpu 0.5/1/2 named
    p-{i}-{j}. ``teams``: the same layout on the team mix
    (instance_types_tradeoff(400), Random(9), types trade-it-300..399, node
    i labelled team: t{i % 64}, its pods cpu 0.25/0.5/1 with that
    nodeSelector, as bench.py:171-199). ``owned`` gives the pods a
    ReplicaSet owner, ``finalizers`` the nodes the termination finalizer.
    The ConsolidationController (``kw``) reaches the fake cloud through
    cpmetrics.decorate. Returns (cluster, bare provider, provisioner,
    controller)."""
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.api.objects import OwnerReference
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.cloudprovider.fake import (
        FakeCloudProvider, instance_types, instance_types_tradeoff)
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.testing import make_pod, make_provisioner
    from karpenter_tpu_torch.testing.factories import make_node

    rng = random.Random(9 if teams else 7)
    catalog = instance_types_tradeoff(400) if teams else instance_types(400)
    prefix, sizes = ("trade-it", (0.25, 0.5, 1)) if teams else ("fake-it", (0.5, 1, 2))
    cluster = Cluster()
    provider = FakeCloudProvider(catalog)
    prov = make_provisioner(solver="tpu")
    c = prov.spec.constraints
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    cluster.create("provisioners", prov)
    owner = OwnerReference(api_version="apps/v1", kind="ReplicaSet", name="rs") if owned else None
    for i in range(n_nodes):
        labels = {lbl.INSTANCE_TYPE: f"{prefix}-{rng.randrange(300, 400)}",
                  lbl.TOPOLOGY_ZONE: "test-zone-1", lbl.CAPACITY_TYPE: "on-demand"}
        selector = {"team": f"t{i % 64}"} if teams else None
        if teams:
            labels.update(selector)
        node = make_node(name=f"live-{i}", capacity={"cpu": "16", "memory": "32Gi", "pods": "100"},
                         provisioner_name="default", labels=labels,
                         finalizers=[lbl.TERMINATION_FINALIZER] if finalizers else None)
        cluster.create("nodes", node)
        for j in range(rng.randrange(1, 4)):
            cluster.create("pods", make_pod(
                name=f"p-{i}-{j}", requests={"cpu": f"{rng.choice(sizes)}"},
                node_selector=selector, node_name=node.metadata.name, unschedulable=False,
                owner=owner))
    ctl = ConsolidationController(cluster, cpmetrics.decorate(provider), device=device, **kw)
    return cluster, provider, prov, ctl


def plan_record(plan) -> dict:
    """A consolidation plan with each node named by what it is (its type
    and its pods), so plans over clusters whose launched nodes got other
    names compare: the candidates, the pods, each proposed node's types and
    pods in order, keep / retire (in retirement order) / launch, the moves,
    both prices and worthwhile."""
    from karpenter_tpu_torch.api import labels as lbl

    def names(objs):
        return [o.metadata.name for o in objs]

    def node(n):
        return (n.metadata.labels.get(lbl.INSTANCE_TYPE, ""),
                tuple(sorted(names(plan.node_pods.get(n.metadata.name, [])))))

    def vnodes(vs):
        return [([it.name for it in v.instance_type_options], names(v.pods)) for v in vs]

    return {
        "nodes": [node(n) for n in plan.nodes], "pods": names(plan.pods),
        "proposed": vnodes(plan.proposed), "keep": [node(n) for n in plan.keep],
        "retire": [node(n) for n in plan.retire], "launch": vnodes(plan.launch),
        "moves": names(plan.moves), "current_price": plan.current_price,
        "proposed_price": plan.proposed_price, "worthwhile": plan.worthwhile,
    }


class PlanProbe:
    """Times the host steps of ConsolidationController.plan around the
    solve: _shadow_cluster with the pods' deep copies, minimal_move_match
    with order_retirement, and the facade's build of its TorchScheduler;
    keeps each plan's Scheduler for its stage profile. Patches the
    consolidation module's names while open."""

    def __init__(self, controller):
        import copy

        from karpenter_tpu_torch.controllers import consolidation as cons

        self.times = {}
        self.scheds = []
        probe, base = self, cons.Scheduler

        class Captured(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.scheds.append(self)

            @property
            def torch(self):
                if self._torch is not None:
                    return self._torch
                return probe.timed("backend_build", base.torch.fget)(self)

        self._patches = [
            mock.patch.object(cons, "Scheduler", Captured),
            mock.patch.object(cons, "copy",
                              mock.Mock(deepcopy=self.timed("shadow", copy.deepcopy))),
            mock.patch.object(controller, "_shadow_cluster",
                              self.timed("shadow", controller._shadow_cluster)),
            mock.patch.object(cons, "minimal_move_match",
                              self.timed("repack", cons.minimal_move_match)),
            mock.patch.object(cons, "order_retirement",
                              self.timed("repack", cons.order_retirement)),
        ]

    def timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.times[key] = self.times.get(key, 0.0) + time.perf_counter() - t0

        return run

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def take(self) -> dict:
        times, self.times = self.times, {}
        return {k: v * 1e3 for k, v in times.items()}


def forget_node_gauges(names: set) -> None:
    """Drop the node gauges' series of ``names``. A runtime's node metrics
    controller publishes a series per node into the process-global
    registry and keeps it while the node lives; a runtime that stops over
    live nodes leaves them behind (a process that exits takes them along),
    and phase 16 (c) reads every series of provisioner ``default``."""
    from karpenter_tpu_torch.controllers.metrics_node import NODE_GAUGES

    for gauge in NODE_GAUGES:
        for fam in gauge.collect():
            for sample in fam.samples:
                if sample.labels.get("node_name") in names:
                    gauge.remove(*(sample.labels[k] for k in gauge._labelnames))


def node_gauge_names(provisioner: str) -> set:
    """The node names the karpenter_nodes_allocatable gauge holds for
    ``provisioner``."""
    from karpenter_tpu_torch import metrics

    return {s.labels["node_name"] for fam in metrics.NODES_ALLOCATABLE.collect()
            for s in fam.samples if s.labels.get("provisioner") == provisioner}


def deprovision_phase(card: str, device: str = "cuda", n_nodes: int = 1000) -> dict:
    """Phase 16: the deprovisioning plane on the card at the reference's
    consolidation size. Returns the kernels line's ``deprovision``
    entries."""
    from karpenter_tpu_torch.api.objects import PodCondition
    from karpenter_tpu_torch.controllers.consolidation import (
        EVICT_WAVE_SIZE, WAVE_CHECK_INTERVAL)
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import make_pod

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    def uploads() -> float:
        return metric("karpenter_solver_session_catalog_uploads_total")

    def card_plan(ctl, prov, probe, kernel, what) -> tuple:
        """One plan on the card: its record, wall, profile and launches;
        fails unless it launched ``kernel`` once per dispatch and nothing
        else, and re-seated every pod."""
        start, up = counts(), uploads()
        t0 = time.perf_counter()
        plan = ctl.plan(prov)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        got = delta(start)
        prof = probe.scheds[-1].last_stage_profile()
        if prof.get("packer_backend") != kernel:
            raise AssertionError(f"deprovision ({what}): served by {prof.get('packer_backend')!r}")
        expect_launches(f"deprovision {what}", got, {kernel: prof["pack_dispatches"]})
        placed = sum(len(v.pods) for v in plan.proposed)
        if placed != len(plan.pods):
            raise AssertionError(f"deprovision ({what}): {len(plan.pods) - placed} pods dropped")
        return plan, {"wall_ms": wall, "prof": prof, "launches": got[kernel],
                      "uploads": uploads() - up, **probe.take()}

    def plan_line(label, i, plan, m) -> str:
        prof = m["prof"]
        stages = " ".join(f"{k}={prof[k] * 1e3:.3f}ms" for k in (
            "sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s"))
        return (f"[deprovision] ({label}) plan {i}: {m['wall_ms']:.3f} ms, "
                f"{prof['packer_backend']} ({prof['pack_route']}, dispatches "
                f"{prof['pack_dispatches']}), {stages}; shadow cluster + deep copies "
                f"{m.get('shadow', 0.0):.3f} ms, minimal_move_match + order_retirement "
                f"{m.get('repack', 0.0):.3f} ms, TorchScheduler build "
                f"{m.get('backend_build', 0.0):.3f} ms, session uploads {m['uploads']:.0f}; "
                f"nodes_in {len(plan.nodes)}, nodes_out {len(plan.proposed)} (keep "
                f"{len(plan.keep)}, retire {len(plan.retire)}, launch {len(plan.launch)}), "
                f"pods {len(plan.pods)}, repack_drops 0, savings_frac "
                f"{plan.savings / max(plan.current_price, 1e-9):.6f}")

    # -- (a) config 5 and (b) its team-mix twin: 1 warm-up + 5 plans -------
    records = {}
    for label, teams, kernel in (("a", False, V1), ("b", True, V2)):
        _, _, cpu_prov, cpu_ctl = live_cluster("cpu", teams=teams, n_nodes=n_nodes)
        with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "native"}):
            ref = plan_record(cpu_ctl.plan(cpu_prov))
        del cpu_ctl
        cluster, _, prov, ctl = live_cluster(device, teams=teams, n_nodes=n_nodes)
        plans = []
        with PlanProbe(ctl) as probe:
            for i in range(6):
                plan, m = card_plan(ctl, prov, probe, kernel, f"{label} plan {i}")
                if plan_record(plan) != ref:
                    raise AssertionError(f"deprovision ({label}) plan {i} differs from the "
                                         f"device='cpu' plan")
                log(plan_line(label, "warm-up" if i == 0 else i, plan, m))
                plans.append(m)
        records[label] = ref
        out[kernel][f"launches_{label}"] = sum(m["launches"] for m in plans[1:])
        out[kernel][f"launches_{label}_warmup"] = plans[0]["launches"]
        walls = [m["wall_ms"] for m in plans]
        log(f"[deprovision] ({label}) {'team mix' if teams else 'config 5'}: 6 plans (the first "
            f"the warm-up), each a new Scheduler: walls {[round(w, 3) for w in walls]} ms, "
            f"TorchScheduler builds {[round(m.get('backend_build', 0.0), 3) for m in plans]} ms, "
            f"session uploads {[int(m['uploads']) for m in plans]}; every plan == the "
            f"device='cpu' plan (native packer), {kernel} only, 0 drops, worthwhile "
            f"{ref['worthwhile']}; card {card}")
        out["summary"][label] = {
            "nodes_in": len(ref["nodes"]), "nodes_out": len(ref["proposed"]),
            "pods": len(ref["pods"]), "plan_ms": walls,
            "backend_build_ms": [m.get("backend_build", 0.0) for m in plans],
            "shadow_ms": [m.get("shadow", 0.0) for m in plans],
            "repack_ms": [m.get("repack", 0.0) for m in plans],
            "pack_fetch_ms": [m["prof"]["pack_fetch_s"] * 1e3 for m in plans],
            "dispatches": [m["prof"]["pack_dispatches"] for m in plans],
            "savings_frac": (ref["current_price"] - ref["proposed_price"]) / ref["current_price"],
        }
        del cluster, ctl, plans

    # -- (c) execute (a)'s plan, bind migration, under a Manager -----------
    def ready(cluster, nodes):
        # no kubelet here: the launched nodes report Ready by hand
        for n in nodes:
            cluster.get("nodes", n.metadata.name, namespace="").status.conditions = [
                PodCondition(type="Ready", status="True")]

    cluster, provider, prov, ctl = live_cluster(device, finalizers=True, n_nodes=n_nodes)
    manager, provisioning, _ = wire_controllers(cluster, provider, device, start_workers=False)
    termination = wire_lifecycle(manager, cluster, provider)
    manager.start()
    start = counts()
    try:
        with PlanProbe(ctl) as probe:
            plan, m = card_plan(ctl, prov, probe, V1, "c plan")
        if plan_record(plan) != records["a"] or not plan.worthwhile:
            raise AssertionError("deprovision (c): the plan differs from (a)'s")
        binds = {}
        bind = cluster.bind

        def counting_bind(pod, node_name):
            binds.setdefault(pod.key, []).append(node_name)
            bind(pod, node_name)

        cluster.bind = counting_bind
        retired = {n.metadata.name for n in plan.retire}
        t0 = time.perf_counter()
        launched = ctl.execute(plan)
        execute_ms = (time.perf_counter() - t0) * 1e3
        ready(cluster, launched)
        deadline = time.time() + 120
        while time.time() < deadline and any(
                cluster.try_get("nodes", n, namespace="") is not None for n in retired):
            time.sleep(0.005)
        gone_ms = (time.perf_counter() - t0) * 1e3
        left = [n for n in retired if cluster.try_get("nodes", n, namespace="") is not None]
        if left:
            raise AssertionError(f"deprovision (c): {len(left)} retired nodes not terminated")
        launched_names = {n.metadata.name for n in launched}
        moved = {p.key for p in plan.moves}
        wrong = {k: v for k, v in binds.items() if len(v) != 1 or v[0] not in launched_names}
        if set(binds) != moved or wrong:
            raise AssertionError(f"deprovision (c): {len(moved)} moved pods, {len(binds)} bound, "
                                 f"{len(wrong)} bound twice or off a launched node")
        if sorted(provider.delete_calls) != sorted(retired):
            raise AssertionError(f"deprovision (c): {len(provider.delete_calls)} cloud deletes "
                                 f"for {len(retired)} retired nodes")
        live = {n.metadata.name for n in cluster.nodes()}
        if live != {n.metadata.name for n in plan.keep} | launched_names:
            raise AssertionError("deprovision (c): live nodes != kept + launched")
        capacity = fits_and_counts(cluster, "default", "deprovision (c)")
        deadline = time.time() + 60
        while time.time() < deadline and (counted(cluster, "default") != capacity
                                          or node_gauge_names("default") != live):
            time.sleep(0.01)
        if counted(cluster, "default") != capacity:
            raise AssertionError(f"deprovision (c): counter {counted(cluster, 'default')} != "
                                 f"capacity {capacity}")
        if node_gauge_names("default") != live:
            raise AssertionError("deprovision (c): the node gauges do not cover the live nodes")
        with PlanProbe(ctl) as probe:
            again, m2 = card_plan(ctl, prov, probe, V1, "c second plan")
    finally:
        manager.stop()
        provisioning.stop()
        termination.stop()
    c_launches = delta(start)
    # the cpu twin: the same plan executed, termination inline, planned again
    cpu_cluster, cpu_provider, cpu_prov, cpu_ctl = live_cluster("cpu", finalizers=True,
                                                                n_nodes=n_nodes)
    with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "native"}):
        cpu_plan = cpu_ctl.plan(cpu_prov)
        cpu_launched = cpu_ctl.execute(cpu_plan)
        cpu_term = TerminationController(cpu_cluster, cpu_provider, start_queue=False)
        for n in cpu_plan.retire:
            cpu_term.reconcile(n.metadata.name)
        ready(cpu_cluster, cpu_launched)
        cpu_again = cpu_ctl.plan(cpu_prov)
    if plan_record(again) != plan_record(cpu_again):
        raise AssertionError("deprovision (c): the second plan differs from the device='cpu' one")
    log(f"[deprovision] (c) bind migration of (a)'s plan under a Manager (provisioning, "
        f"selection, node, termination, counter, pvc, metrics): execute {execute_ms:.3f} ms, "
        f"execute -> last of {len(retired)} retired nodes gone {gone_ms:.3f} ms; "
        f"{len(launched)} launched through the metered fake cloud, {len(binds)} pods bound "
        f"once each to a launched node, {len(provider.delete_calls)} cloud deletes, live = "
        f"{len(plan.keep)} kept + {len(launched)} launched, counter == capacity {capacity}, "
        f"node gauges == the {len(live)} live nodes; plan {m['wall_ms']:.3f} ms; second plan "
        f"{m2['wall_ms']:.3f} ms: keep {len(again.keep)}, retire {len(again.retire)}, "
        f"worthwhile {again.worthwhile}, == the device='cpu' second plan; launches "
        f"{c_launches}; card {card}")
    out[V1]["launches_c"] = c_launches[V1]
    out["summary"]["c"] = {
        "execute_ms": execute_ms, "retired_gone_ms": gone_ms, "launched": len(launched),
        "retired": len(retired), "second_keep": len(again.keep),
        "second_retire": len(again.retire),
    }
    del cluster, ctl, cpu_cluster, cpu_ctl, manager, provisioning, termination

    # -- (d) the evict migration end to end --------------------------------
    cluster, provider, prov, ctl = live_cluster(device, owned=True, finalizers=True,
                                                n_nodes=n_nodes, migration="evict")
    manager, provisioning, _ = wire_controllers(cluster, provider, device, start_workers=True)
    termination = wire_lifecycle(manager, cluster, provider)
    by_node = {}
    for p in cluster.pods():
        by_node.setdefault(p.spec.node_name, []).append(p.metadata.name)
    recreated = {}

    def replicaset(event, pod):
        # the owner's controller: an evicted pod comes back pending
        if event == "DELETED" and pod.metadata.owner_references and pod.spec.node_name:
            clone = make_pod(name=f"{pod.metadata.name}-r",
                             requests={"cpu": str(pod.spec.containers[0].requests["cpu"])},
                             owner=pod.metadata.owner_references[0])
            recreated[pod.metadata.name] = clone
            cluster.create("pods", clone)

    cluster.watch("pods", replicaset)
    manager.start()
    start = counts()
    try:
        manager.enqueue("provisioning", "default")
        deadline = time.time() + 120
        while time.time() < deadline and not provisioning.workers:
            time.sleep(0.01)
        worker = provisioning.workers["default"]
        worker.batcher.idle_duration = 0.05
        if not worker.warmed.wait(timeout=600):
            raise AssertionError("deprovision (d): the worker's warm-up never finished")
        warm = worker.scheduler.last_stage_profile()
        rounds = []
        record_rounds(worker, rounds)
        with PlanProbe(ctl) as probe:
            t0 = time.perf_counter()
            requeue = ctl.reconcile("default")
            first = probe.scheds[-1].last_stage_profile()
            victims = list(ctl._pending_waves["default"][0])
            if len(victims) != EVICT_WAVE_SIZE or requeue != WAVE_CHECK_INTERVAL:
                raise AssertionError(f"deprovision (d): first wave {victims}, requeue {requeue}")
            evicted = sorted(p for v in victims for p in by_node[v])
            deadline = time.time() + 120
            while time.time() < deadline and not ctl.wave_settled("default"):
                time.sleep(0.005)
            settle_ms = (time.perf_counter() - t0) * 1e3
            if not ctl.wave_settled("default"):
                raise AssertionError("deprovision (d): the wave never settled")
            seated = [p for p in recreated.values() if p.spec.node_name]
            if sorted(recreated) != evicted or len(seated) != len(evicted):
                raise AssertionError(f"deprovision (d): {len(evicted)} evicted, "
                                     f"{len(recreated)} recreated, {len(seated)} seated")
            if any(cluster.try_get("nodes", v, namespace="") is not None for v in victims) \
                    or not set(victims) <= set(provider.delete_calls):
                raise AssertionError("deprovision (d): a victim was not terminated")
            first_rounds = list(rounds)
            check_rounds(first_rounds, {V1}, "deprovision (d)")
            before_next = set(ctl.ledger._in_flight.get("default", ()))
            ctl.reconcile("default")
            second = probe.scheds[-1].last_stage_profile()
            next_wave = ctl._pending_waves.get("default", ((),))[0]
            if not 0 < len(next_wave) <= EVICT_WAVE_SIZE or before_next or \
                    set(next_wave) & set(victims):
                raise AssertionError(f"deprovision (d): next wave {next_wave}")
    finally:
        manager.stop()
        provisioning.stop()
        termination.stop()
    # the next wave's evictions keep the worker busy until the Manager
    # stops: its rounds count too, once its thread is done
    worker._thread.join(timeout=120)
    if worker._thread.is_alive():
        raise AssertionError("deprovision (d): the provisioning worker did not stop")
    provisioned = check_rounds(rounds, {V1}, "deprovision (d)")
    d_launches = delta(start)
    want = {V1: warm["pack_dispatches"] + first["pack_dispatches"] + second["pack_dispatches"]
            + provisioned.get(V1, 0)}
    expect_launches("deprovision d", d_launches, want)
    log(f"[deprovision] (d) evict migration: the first reconcile retired {len(victims)} nodes "
        f"(EVICT_WAVE_SIZE {EVICT_WAVE_SIZE}), termination drained them and the cloud deleted "
        f"them, {len(evicted)} evicted pods recreated pending and seated by "
        f"{len(first_rounds)} card provisioning round(s) (batches "
        f"{[r['pods'] for r in first_rounds]}, SCHEDULING_DURATION "
        f"{[round(r['scheduling_ms'], 3) for r in first_rounds]} ms); reconcile -> "
        f"wave_settled {settle_ms:.3f} ms; the next reconcile retired {len(next_wave)}; "
        f"launches {d_launches} (the worker's warm-up, 2 plans, {len(rounds)} rounds in all "
        f"before the Manager stopped); card {card}")
    out[V1]["launches_d"] = d_launches[V1]
    out["summary"]["d"] = {
        "victims": len(victims), "evicted": len(evicted), "rounds": len(first_rounds),
        "settle_ms": settle_ms, "next_wave": len(next_wave),
    }
    del cluster, ctl, manager, provisioning, termination

    # -- (e) one plan of (a) through the card sidecar -----------------------
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[deprovision] grpc not installed on this host: (e) is held by the CPU tests")
        return out
    from karpenter_tpu_torch.solver import service as S

    address = free_address()
    server = S.serve(address, service=S.SolverService(device=device))
    start = counts()
    try:
        _, _, prov, ctl = live_cluster("cpu", n_nodes=n_nodes, solver_service_address=address)
        with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "fused"}), PlanProbe(ctl) as probe:
            t0 = time.perf_counter()
            plan = ctl.plan(prov)
            wall = (time.perf_counter() - t0) * 1e3
            prof = probe.scheds[-1].last_stage_profile()
        served_by = dict(server.solver_service.served)
    finally:
        server.stop(grace=None)
    e_launches = delta(start)
    if prof.get("packer_backend") != "sidecar" or plan_record(plan) != records["a"]:
        raise AssertionError(f"deprovision (e): served by {prof.get('packer_backend')!r}, "
                             f"equal to (a): {plan_record(plan) == records['a']}")
    if device == "cuda":
        expect_launches("deprovision e", e_launches, {V1: served_by.get(V1, 0)})
    log(f"[deprovision] (e) one (a) plan through the card sidecar: {wall:.3f} ms, the sidecar "
        f"served {served_by}, wire_ser_s {prof.get('wire_ser_s', 0) * 1e3:.3f} ms, "
        f"pack_fetch_s {prof['pack_fetch_s'] * 1e3:.3f} ms; == the in-process plan; launches "
        f"{e_launches}; card {card}")
    out[V1]["launches_e"] = e_launches[V1]
    out["summary"]["e"] = {"plan_ms": wall, "served": served_by}
    return out


def canonical_nodes(pods, victims) -> dict:
    """Node name -> a name that does not depend on the fake cloud's counter:
    ``victim-<k>`` for the k-th noticed node, ``holds-<i>`` for a node whose
    lowest-indexed pod is pods[i]."""
    names = {v: f"victim-{k}" for k, v in enumerate(victims)}
    for i, p in enumerate(pods):
        if p.spec.node_name and p.spec.node_name not in names:
            names[p.spec.node_name] = f"holds-{i}"
    return names


def inline_interruption(device: str, catalog, pods, requirements=None, frac: float = 0.05) -> dict:
    """One provisioner's controller with start_workers=False (topology rng
    seeded): every pod created and queued, provision_once until the queue
    drains (batches of CONTROLLER_BATCH); then ceil(frac) of the nodes, the
    first by pod index, get a preemption notice through
    InterruptionController.handle_notice in that order, and provision_once
    seats the released pods (``submit`` hands each to the first worker
    whose provisioner admits it: the team mix's provisioner needs its
    ``requirements`` for that). Returns the rounds, the bound state by pod
    index, the victims' cordon, taints, finalizers and deletion, the events
    (node names made canonical) and the orchestrator's counts."""
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.interruption import InterruptionController
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.interruption import PREEMPTION, DisruptionNotice
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.testing import make_provisioner

    cluster = Cluster()
    provider = cpmetrics.decorate(FakeCloudProvider(catalog))
    provisioning = ProvisioningController(cluster, provider, start_workers=False, device=device)
    ic = InterruptionController(cluster, provider, provisioning=provisioning,
                                termination=TerminationController(cluster, provider,
                                                                  start_queue=False))
    prov = make_provisioner(solver="tpu", requirements=requirements)
    cluster.create("provisioners", prov)
    provisioning.reconcile(prov.name)
    worker = provisioning.workers[prov.name]
    worker.batcher.idle_duration = 0.01
    worker.scheduler.torch.topology.rng = random.Random(1)
    rounds = []
    record_rounds(worker, rounds)
    for p in pods:
        cluster.create("pods", p)
        worker.add(p)
    walls = []
    try:
        while worker.batcher.depth():
            worker.provision_once()
        seating = len(rounds)
        order = list(dict.fromkeys(p.spec.node_name for p in pods if p.spec.node_name))
        victims = order[: math.ceil(len(order) * frac)]
        t0 = time.perf_counter()
        for name in victims:
            ic.handle_notice(DisruptionNotice(kind=PREEMPTION, node_name=name,
                                              grace_period_seconds=120.0))
        notice_ms = (time.perf_counter() - t0) * 1e3
        cordon = [(n.spec.unschedulable, sorted((t.key, t.value, t.effect) for t in n.spec.taints),
                   sorted(n.metadata.finalizers), n.metadata.deletion_timestamp is not None)
                  for n in (cluster.get("nodes", v, namespace="") for v in victims)]
        released = sum(1 for p in pods if not p.spec.node_name)
        while worker.batcher.depth():
            t0 = time.perf_counter()
            worker.provision_once()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        provisioning.stop()
    random_keys = {k for k, vs in worker.provisioner.spec.constraints.requirements._sets
                   if vs.op_type() == "Exists"}
    nodes, unbound = bound_state(cluster, pods, random_keys)
    canon = canonical_nodes(pods, victims)
    events = sorted((e.reason, e.type, e.involved_kind, canon.get(e.involved_name, e.involved_name),
                     e.message) for e in cluster.list("events"))
    return {
        "rounds": rounds, "seating": seating, "walls": walls, "nodes": nodes, "unbound": unbound,
        "victims": len(victims), "cordon": cordon, "events": events, "released": released,
        "notices": ic.notices_handled, "lead_times": len(ic.lead_times),
        "evicted_unready": ic.evicted_unready, "notice_ms": notice_ms,
        "fits": fits_and_counts(cluster, prov.name, f"interruption inline {device}"),
    }


def interruption_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                       n_types: int = 400, n_nodes: int = 1000) -> dict:
    """Phase 17: interruption and crash-safe launch on the card, at full
    width. Returns the kernels line's ``interruption`` entries."""
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.cloudprovider.fake import (
        FakeCloudProvider, instance_types, instance_types_tradeoff)
    from karpenter_tpu_torch.cloudprovider.types import NodeRequest
    from karpenter_tpu_torch.controllers.garbage_collection import (
        GC_POLL_KEY, LEAK_GRACE_PERIOD, GarbageCollectionController)
    from karpenter_tpu_torch.controllers.interruption import InterruptionController
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.interruption import Orchestrator
    from karpenter_tpu_torch.interruption.types import DisruptionNotice
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.launch import FileLaunchJournal, MemoryLaunchJournal
    from karpenter_tpu_torch.main import build_runtime
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner
    from karpenter_tpu_torch.testing.chaos import LaunchCrash, LaunchCrashCluster

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}
    outcomes = ("adopted", "node_exists", "never_launched", "speculation_expired",
                "consolidation_replayed")

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    def replays() -> dict:
        return {o: metric("karpenter_launch_journal_replays_total", {"outcome": o})
                for o in outcomes}

    def round_line(part, i, r) -> str:
        return (f"[interruption] ({part}) round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")

    scratch = tempfile.mkdtemp(prefix="chip-smoke-journal-")
    part_s, t_part = {}, time.perf_counter()

    def part_done(label):
        nonlocal t_part
        part_s[label] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    try:
        # -- (a) spot churn through a running Manager ---------------------
        cluster = Cluster()
        provider = FakeCloudProvider(instance_types(n_types))
        journal_path = os.path.join(scratch, "a.json")
        # bench_interruption_churn's runtime (bench.py:1326-1327): every
        # controller main.py builds, a file launch journal, the 0.1 s poll
        rt = build_runtime(Options(device=device, launch_journal=journal_path),
                           cluster=cluster, cloud_provider=provider)
        rt.interruption.poll_interval = 0.1
        provisioning, interruption = rt.provisioning, rt.interruption
        collector = rt.garbage_collection
        binds, releases = {}, {}
        totals = {"binds": 0, "releases": 0}
        lock = threading.Lock()
        bind, release = cluster.bind, interruption.orchestrator._release

        def counting_bind(pod, node_name):
            with lock:
                binds[pod.key] = binds.get(pod.key, 0) + 1
                totals["binds"] += 1
            bind(pod, node_name)

        def counting_release(pod):
            with lock:
                releases[pod.key] = releases.get(pod.key, 0) + 1
                totals["releases"] += 1
            return release(pod)

        cluster.bind = counting_bind
        interruption.orchestrator._release = counting_release
        rt.manager.start()
        start = counts()
        t_start = time.perf_counter()
        try:
            cluster.create("provisioners", make_provisioner(solver="tpu"))
            deadline = time.time() + 60
            while time.time() < deadline and not provisioning.workers:
                time.sleep(0.01)
            worker = provisioning.workers["default"]
            worker.batcher.idle_duration = 0.2
            if not worker.warmed.wait(timeout=600):
                raise AssertionError("interruption (a): the warm-up never finished")
            warm = worker.scheduler.torch.completed_profile()
            rounds = []
            record_rounds(worker, rounds)
            rng = random.Random(17)
            pods = [make_pod(name=f"churn-{i}", requests={"cpu": f"{rng.choice([0.1, 0.25, 0.5])}"})
                    for i in range(n_pods)]
            t0 = time.perf_counter()
            for p in pods:
                cluster.create("pods", p)

            def settled(timeout: float) -> bool:
                # every pod bound once, and once more for each release
                stop = time.time() + timeout
                while time.time() < stop:
                    with lock:
                        if totals["binds"] >= n_pods + totals["releases"]:
                            return True
                    time.sleep(0.005)
                return False

            if not settled(600):
                raise AssertionError("interruption (a): the load never bound")
            load_s = time.perf_counter() - t0
            load_rounds = len(rounds)
            churn = []
            for k in range(5):
                live = [n.metadata.name for n in cluster.nodes()
                        if n.metadata.deletion_timestamp is None]
                victims = rng.sample(live, max(1, math.ceil(len(live) * 0.05)))
                first = len(rounds)
                t0 = time.perf_counter()
                for name in victims:
                    provider.preempt(name, grace_period_seconds=120.0)
                stop = time.time() + 120
                while time.time() < stop and any(
                        cluster.try_get("nodes", v, namespace="") is not None for v in victims):
                    time.sleep(0.02)
                if any(cluster.try_get("nodes", v, namespace="") is not None for v in victims):
                    raise AssertionError(f"interruption (a) round {k}: a victim is still present")
                # the victims are gone, so every release of the round happened
                if not settled(120):
                    raise AssertionError(f"interruption (a) round {k}: released pods not re-bound")
                churn.append({"victims": len(victims), "live": len(live),
                              "wall_s": time.perf_counter() - t0, "rounds": rounds[first:]})
            wall = time.perf_counter() - t_start
        finally:
            rt.stop()
        worker._thread.join(timeout=120)
        if worker._thread.is_alive():
            raise AssertionError("interruption (a): the provisioning worker did not stop")
        a_launches = delta(start)
        launched = check_rounds(rounds, {V1, V2}, "interruption (a)")
        launched[V1] = launched.get(V1, 0) + warm.get("pack_dispatches", 0)
        expect_launches("interruption a", a_launches, launched)
        with lock:
            wrong = {k: n for k, n in binds.items() if n != 1 + releases.get(k, 0)}
        unbound = [p.key for p in cluster.pods() if not p.spec.node_name]
        if wrong or unbound or len(binds) != n_pods:
            raise AssertionError(f"interruption (a): {len(wrong)} pods bound other than once a "
                                 f"release, {len(unbound)} unbound, {len(binds)} of {n_pods} bound")
        if interruption.evicted_unready:
            raise AssertionError(f"interruption (a): evicted_unready "
                                 f"{interruption.evicted_unready}")
        planned = sum(r["nodes"] for r in rounds)
        live_nodes = cluster.nodes()
        if not (planned == len(provider.create_calls)
                == len(live_nodes) + len(provider.delete_calls)):
            raise AssertionError(f"interruption (a): {planned} virtual nodes, "
                                 f"{len(provider.create_calls)} creates, {len(live_nodes)} live + "
                                 f"{len(provider.delete_calls)} deleted nodes")
        capacity = fits_and_counts(cluster, "default", "interruption (a)")
        open_entries = FileLaunchJournal(journal_path).unresolved()
        if open_entries:
            raise AssertionError(f"interruption (a): {len(open_entries)} journal entries open")
        lead = sorted(interruption.lead_times)
        if len(lead) != sum(releases.values()):
            raise AssertionError(f"interruption (a): {len(lead)} lead times for "
                                 f"{sum(releases.values())} released pods")
        p50 = lead[len(lead) // 2]
        p99 = lead[min(len(lead) - 1, int(len(lead) * 0.99))]
        for k, c in enumerate(churn):
            for i, r in enumerate(c["rounds"]):
                log(round_line(f"a, churn {k}", i, r))
            log(f"[interruption] (a) churn round {k}: {c['victims']} of {c['live']} live nodes "
                f"preempted, gone and every released pod re-bound in {c['wall_s']:.3f} s, "
                f"{len(c['rounds'])} replacement round(s)")
        log(f"[interruption] (a) spot churn of {n_pods} pods (cpu 0.1/0.25/0.5, Random(17)) "
            f"through build_runtime's Manager: load bound in {load_s:.3f} s ({load_rounds} rounds); 5 churn "
            f"rounds of 5% preempted: {interruption.notices_handled} notices handled, "
            f"{len(lead)} pods replaced, notice->re-bind lead time p50 {p50 * 1e3:.1f} ms, p99 "
            f"{p99 * 1e3:.1f} ms; evicted_unready 0, every pod bound once a release, "
            f"{len(provider.create_calls)} creates = {planned} virtual nodes = {len(live_nodes)} "
            f"live + {len(provider.delete_calls)} deleted, 0 journal entries open, counter "
            f"capacity {capacity}; GC sweeps {collector.sweeps}; launches {a_launches} (the "
            f"warm-up and {len(rounds)} rounds); wall {wall:.3f} s; card {card}")
        for name in (V1, V2):
            if a_launches[name]:
                out[name]["launches_a"] = a_launches[name]
        out["summary"]["a"] = {
            "pods": n_pods, "notices": interruption.notices_handled, "replaced": len(lead),
            "lead_p50_ms": p50 * 1e3, "lead_p99_ms": p99 * 1e3, "wall_s": wall,
            "load_s": load_s, "churn_s": [c["wall_s"] for c in churn],
            "victims": [c["victims"] for c in churn],
            "replacement_scheduling_ms": [r["scheduling_ms"] for c in churn for r in c["rounds"]],
        }
        del cluster, provider, rt, provisioning, interruption
        del collector, pods, binds, releases
        part_done("a")

        # -- (b) inline determinism against a device="cpu" controller ------
        team = [NodeSelectorRequirement(key="team", operator="Exists")]
        parts = (
            ("b", "headline", instance_types(n_types),
             lambda: diverse_pods(n_pods, random.Random(42)), None, V1),
            ("b_teams", "team mix", instance_types_tradeoff(n_types),
             lambda: team_pods(n_pods, 9), team, V2),
        )
        for label, what, catalog, make, requirements, kernel in parts:
            ref = inline_interruption("cpu", catalog, make(), requirements)
            start = counts()
            got = inline_interruption(device, catalog, make(), requirements)
            b_launches = delta(start)
            # the seating rounds take the part's kernel; a replacement round
            # takes what the route's shape rule picks for its batch
            check_rounds(got["rounds"][:got["seating"]], {kernel}, f"interruption ({label})")
            expect_launches(f"interruption {label}", b_launches,
                            check_rounds(got["rounds"], {V1, V2}, f"interruption ({label})"))
            for key in ("nodes", "unbound", "victims", "cordon", "events", "released", "notices",
                        "lead_times", "evicted_unready", "fits", "seating"):
                if got[key] != ref[key]:
                    raise AssertionError(f"interruption ({label}): {key} differs from the "
                                         f"device='cpu' controller")
            replaced = got["rounds"][got["seating"]:]
            for i, (r, w) in enumerate(zip(replaced, got["walls"])):
                log(round_line(label, i, r) + f", provision_once {w:.3f} ms")
            log(f"[interruption] ({label}) {what}: {got['seating']} seating rounds, notices for "
                f"{got['victims']} of the nodes ({got['notice_ms']:.3f} ms for handle_notice), "
                f"{got['released']} pods released, {len(replaced)} replacement round(s) through "
                f"{sorted({r['backend'] for r in replaced})}, {len(got['unbound'])} pods "
                f"unplaced, launches {b_launches}; == the device='cpu' controller pod for pod "
                f"(partition, labels, taints, finalizers, the victims' cordon, taints and "
                f"deletion, events, unplaced pods); card {card}")
            for name in (V1, V2):
                if b_launches[name]:
                    out[name][f"launches_{label}"] = b_launches[name]
            out["summary"][label] = {
                "victims": got["victims"], "released": got["released"],
                "replacement_rounds": len(replaced),
                "replacement_kernels": [r["backend"] for r in replaced],
                "replacement_scheduling_ms": [r["scheduling_ms"] for r in replaced],
                "provision_once_ms": got["walls"], "unplaced": len(got["unbound"]),
            }
            del ref, got
        part_done("b")

        # -- (c) crash recovery through the file journal -------------------
        cluster = Cluster()
        proxy = LaunchCrashCluster(cluster)
        provider = FakeCloudProvider(instance_types(n_types))
        metered = cpmetrics.decorate(provider)
        journal_path = os.path.join(scratch, "c.json")
        provisioning = ProvisioningController(proxy, metered, start_workers=False, device=device,
                                              journal=FileLaunchJournal(journal_path))
        termination = TerminationController(cluster, metered, start_queue=False)
        cluster.create("provisioners", make_provisioner(solver="tpu"))
        provisioning.reconcile("default")
        worker = provisioning.workers["default"]
        worker.batcher.idle_duration = 0.01
        rounds = []
        record_rounds(worker, rounds)
        binds = {}
        bind = cluster.bind

        def counting_bind(pod, node_name):
            binds[pod.key] = binds.get(pod.key, 0) + 1
            bind(pod, node_name)

        cluster.bind = counting_bind
        collector = GarbageCollectionController(cluster, metered,
                                                journal=FileLaunchJournal(journal_path),
                                                termination=termination, replay_after=0.0)
        sweeps = []

        def sweep(what):
            before = replays()
            adopted = metric("karpenter_launch_orphans_adopted_total")
            leaked = metric("karpenter_launch_instances_leaked_total")
            t0 = time.perf_counter()
            collector.reconcile(GC_POLL_KEY)
            ms = (time.perf_counter() - t0) * 1e3
            moved = {o: n - before[o] for o, n in replays().items() if n != before[o]}
            moved["orphans_adopted"] = metric("karpenter_launch_orphans_adopted_total") - adopted
            moved["instances_leaked"] = metric("karpenter_launch_instances_leaked_total") - leaked
            sweeps.append((what, ms, moved))
            return moved

        def crash_round(point, tag):
            pods = [make_pod(name=f"{tag}-{i}", requests={"cpu": "0.5"}) for i in range(8)]
            for p in pods:
                cluster.create("pods", p)
                worker.add(p)
            proxy.arm(point)
            first = len(rounds)
            try:
                worker.provision_once()
            except LaunchCrash:
                pass
            if not proxy.crashed.is_set() or len(rounds) != first + 1:
                raise AssertionError(f"interruption (c): the {point} crash did not fire in one "
                                     f"round")
            return pods, proxy.crash_nodes[point]

        def reseat(pods, what):
            for p in pods:
                worker.add(p)
            worker.provision_once()
            twice = [p.key for p in pods if binds.get(p.key) != 1 or not p.spec.node_name]
            if twice:
                raise AssertionError(f"interruption (c): {what}: {len(twice)} pods not bound once")

        def tracking(name) -> list:
            node = cluster.try_get("nodes", name, namespace="")
            pid = node.spec.provider_id if node is not None else None
            return [n for n in cluster.nodes() if n.metadata.name == name
                    or (pid and n.spec.provider_id == pid)]

        start = counts()
        try:
            pods, orphan = crash_round("before_node_write", "adopt")
            (entry,) = FileLaunchJournal(journal_path).unresolved()
            instances = [i for i in provider.list_instances() if i.launch_token == entry.token]
            if cluster.try_get("nodes", orphan, namespace="") is not None or len(instances) != 1:
                raise AssertionError("interruption (c): the crash left no orphan")
            moved = sweep("adopt")
            if moved.get("adopted") != 1 or collector.adopted != 1 or len(tracking(orphan)) != 1:
                raise AssertionError(f"interruption (c): adoption {moved}, "
                                     f"{len(tracking(orphan))} Nodes for the instance")
            if FileLaunchJournal(journal_path).unresolved() or len(
                    [i for i in provider.list_instances() if i.launch_token == entry.token]) != 1:
                raise AssertionError("interruption (c): the entry is open or the token launched "
                                     "twice")
            reseat(pods, "after the adoption")
            pods, written = crash_round("after_node_write", "exists")
            moved = sweep("node exists")
            if moved.get("node_exists") != 1 or len(tracking(written)) != 1 or \
                    FileLaunchJournal(journal_path).unresolved():
                raise AssertionError(f"interruption (c): after the Node write {moved}, "
                                     f"{len(tracking(written))} Nodes for the instance")
            reseat(pods, "after the node-exists resolve")
            template = worker.provisioner.spec.constraints
            old, young = (provider.create(NodeRequest(template=template,
                                                      instance_type_options=instance_types(1)))
                          for _ in range(2))
            for live in provider.list_instances():
                if live.id == old.metadata.name:
                    live.created_at -= 2 * LEAK_GRACE_PERIOD  # launched out of band long ago
            moved = sweep("leak")
            left = {i.id for i in provider.list_instances()}
            if moved.get("instances_leaked") != 1 or old.metadata.name in left \
                    or young.metadata.name not in left:
                raise AssertionError(f"interruption (c): leak sweep {moved}")
        finally:
            provisioning.stop()
            termination.stop()
        c_launches = delta(start)
        launched = check_rounds(rounds, {V1}, "interruption (c)")
        expect_launches("interruption c", c_launches, launched)
        for what, ms, moved in sweeps:
            log(f"[interruption] (c) sweep '{what}': {ms:.3f} ms, counters moved {moved}")
        log(f"[interruption] (c) crash recovery through a FileLaunchJournal: a card round "
            f"({rounds[0]['backend']}, dispatches {rounds[0]['dispatches']}) died before the "
            f"Node write; a fresh collector (replay_after 0) adopted the orphan (one Node for "
            f"the instance, the entry resolved, one instance for the token) and the next round "
            f"bound its 8 pods once; a crash after the Node write resolved as node_exists with "
            f"no second Node; a token-less instance past the {LEAK_GRACE_PERIOD:g} s grace was "
            f"reaped and a young one spared; {len(rounds)} rounds, launches {c_launches}; card "
            f"{card}")
        out[V1]["launches_c"] = c_launches[V1]
        out["summary"]["c"] = {"sweep_ms": [ms for _, ms, _ in sweeps],
                               "moved": [moved for _, _, moved in sweeps]}
        del cluster, proxy, provider, metered, provisioning, termination, collector
        part_done("c")

        # -- (d) consolidation through the orchestrator --------------------
        cluster, provider, prov, ctl = live_cluster(device, owned=True, finalizers=True,
                                                    n_nodes=n_nodes, migration="evict")
        manager, provisioning, _ = wire_controllers(cluster, provider, device, start_workers=True)
        termination = wire_lifecycle(manager, cluster, provider)
        metered = cpmetrics.decorate(provider)
        ctl.orchestrator = Orchestrator(cluster, metered, provisioning, termination)
        ctl.journal = journal = MemoryLaunchJournal()
        by_node = {}
        for p in cluster.pods():
            by_node.setdefault(p.spec.node_name, []).append(p.key)
        trail = []  # ("intent", cordoned) / ("taint", node, value) / ("submit", pod) / ("evict", pod)
        record_intent, migrate = journal.record_intent, ctl.orchestrator._migrate
        submit, evict = provisioning.submit, cluster.evict

        def spy_intent(*a, **kw):
            trail.append(("intent", sum(1 for n in cluster.nodes() if n.spec.unschedulable)))
            return record_intent(*a, **kw)

        def spy_migrate(node, on_release=None):
            live = cluster.get("nodes", node.metadata.name, namespace="")
            taints = {t.key: t.value for t in live.spec.taints}
            trail.append(("taint", node.metadata.name, taints.get(lbl.INTERRUPTION_TAINT_KEY),
                          live.spec.unschedulable))
            return migrate(node, on_release)

        def spy_submit(pod):
            w = submit(pod)
            trail.append(("submit", pod.key, w is not None and w.scheduler.device.type == device))
            return w

        def spy_evict(pod):
            trail.append(("evict", pod.key))
            return evict(pod)

        journal.record_intent = spy_intent
        ctl.orchestrator._migrate = spy_migrate
        provisioning.submit = spy_submit
        cluster.evict = spy_evict
        manager.start()
        start = counts()
        try:
            manager.enqueue("provisioning", "default")
            deadline = time.time() + 120
            while time.time() < deadline and not provisioning.workers:
                time.sleep(0.01)
            worker = provisioning.workers["default"]
            worker.batcher.idle_duration = 0.05
            if not worker.warmed.wait(timeout=600):
                raise AssertionError("interruption (d): the worker's warm-up never finished")
            warm = worker.scheduler.last_stage_profile()
            rounds = []
            record_rounds(worker, rounds)
            with PlanProbe(ctl) as probe:
                t0 = time.perf_counter()
                ctl.reconcile("default")
                plan_prof = probe.scheds[-1].last_stage_profile()
                (entry,) = journal.unresolved()
                victims = list(entry.victims)
                deadline = time.time() + 120
                while time.time() < deadline and not ctl.wave_settled("default"):
                    time.sleep(0.005)
                settle_ms = (time.perf_counter() - t0) * 1e3
            if not ctl.wave_settled("default") or journal.unresolved():
                raise AssertionError("interruption (d): the wave never settled or its entry "
                                     "is open")
        finally:
            manager.stop()
            provisioning.stop()
            termination.stop()
        worker._thread.join(timeout=120)
        if worker._thread.is_alive():
            raise AssertionError("interruption (d): the provisioning worker did not stop")
        moved_pods = sorted(k for v in victims for k in by_node[v])
        submitted = [t[1] for t in trail if t[0] == "submit"]
        tainted = [t for t in trail if t[0] == "taint"]
        evicted = [t[1] for t in trail if t[0] == "evict"]
        if trail[0] != ("intent", 0) or [t[1] for t in tainted] != victims or any(
                t[2] != "consolidation" or not t[3] for t in tainted):
            raise AssertionError(f"interruption (d): journal and cordon order {trail[:3]}")
        if sorted(submitted) != moved_pods or not all(t[2] for t in trail if t[0] == "submit") \
                or set(evicted) & set(moved_pods):
            raise AssertionError(f"interruption (d): {len(moved_pods)} pods on the victims, "
                                 f"{len(submitted)} submitted to a card worker, "
                                 f"{len(set(evicted) & set(moved_pods))} evicted")
        if any(cluster.try_get("nodes", v, namespace="") is not None for v in victims) or \
                not all(p.spec.node_name for p in cluster.pods()):
            raise AssertionError("interruption (d): a victim stands or a pod is unbound")
        provisioned = check_rounds(rounds, {V1}, "interruption (d)")
        want = {V1: warm["pack_dispatches"] + plan_prof["pack_dispatches"]
                + provisioned.get(V1, 0)}
        # the crashed wave: the orchestrator dies after cordoning its first
        # victim, a BaseException like a killed process
        real = ctl.orchestrator

        class CrashAfterCordon:
            def __init__(self):
                self.crash_node = ""

            def consolidate(self, node, decision_id="", on_release=None):
                real._taint_and_cordon(node, DisruptionNotice(
                    kind="consolidation", node_name=node.metadata.name, grace_period_seconds=0.0))
                self.crash_node = node.metadata.name
                raise LaunchCrash(f"simulated crash mid-wave ({node.metadata.name})")

        crasher = ctl.orchestrator = CrashAfterCordon()
        journal.record_intent = record_intent
        with PlanProbe(ctl) as probe:
            try:
                ctl.reconcile("default")
            except LaunchCrash:
                pass
            crash_prof = probe.scheds[-1].last_stage_profile()
        want[V1] += crash_prof["pack_dispatches"]
        stuck = cluster.get("nodes", crasher.crash_node, namespace="")
        if not stuck.spec.unschedulable or len(journal.unresolved()) != 1:
            raise AssertionError("interruption (d): the crashed wave left no breadcrumb")
        collector = GarbageCollectionController(cluster, metered, journal=journal,
                                                termination=termination, replay_after=0.0)
        before = replays()
        t0 = time.perf_counter()
        collector.reconcile(GC_POLL_KEY)
        replay_ms = (time.perf_counter() - t0) * 1e3
        moved = {o: n - before[o] for o, n in replays().items() if n != before[o]}
        stuck = cluster.get("nodes", crasher.crash_node, namespace="")
        if moved != {"consolidation_replayed": 1.0} or stuck.spec.unschedulable or any(
                t.key == lbl.INTERRUPTION_TAINT_KEY for t in stuck.spec.taints) \
                or journal.unresolved():
            raise AssertionError(f"interruption (d): crashed wave replay {moved}")
        d_launches = delta(start)
        expect_launches("interruption d", d_launches, want)
        for i, r in enumerate(rounds):
            log(round_line("d", i, r))
        log(f"[interruption] (d) evict wave through the orchestrator: journaled with 0 nodes "
            f"cordoned, {len(victims)} victims tainted karpenter.sh/interruption=consolidation "
            f"and cordoned, {len(submitted)} pods submitted to the card worker and none "
            f"evicted, seated by {len(rounds)} card round(s), reconcile -> wave_settled "
            f"{settle_ms:.3f} ms, the entry resolved; a wave crashed after its first cordon "
            f"replayed by a GC sweep in {replay_ms:.3f} ms ({moved}), the victim un-cordoned; "
            f"launches {d_launches} (the worker's warm-up, 2 plans, {len(rounds)} rounds); "
            f"card {card}")
        out[V1]["launches_d"] = d_launches[V1]
        out["summary"]["d"] = {"victims": len(victims), "moved": len(submitted),
                               "rounds": len(rounds), "settle_ms": settle_ms,
                               "replay_ms": replay_ms}
        part_done("d")
        out["summary"]["part_s"] = part_s
        log(f"[interruption] walls by part {({k: round(v, 3) for k, v in part_s.items()})} s, "
            f"phase 17 {sum(part_s.values()):.3f} s; card {card}")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return out


FORECAST_S = 30.0  # bench_forecast_storm's parameters (bench.py:1956-2068)
FORECAST_SEED = 20260807
FORECAST_TTL_S = 8.0
FORECAST_MAX_WARM = 12
FORECAST_PROVISIONERS = 2
FORECAST_LAUNCH_S = 0.5  # the simulated cloud's create_fleet latency
FORECAST_WAVE_S = 0.5


def nearest_rank_p99(values) -> float:
    """bench.py's ``_p99``: the exact nearest-rank p99."""
    vs = sorted(values)
    return vs[min(len(vs) - 1, max(math.ceil(0.99 * len(vs)) - 1, 0))]


def forecast_pass(card: str, label: str, schedule, in_flash, warm_pool: bool,
                  device: str) -> dict:
    """One pass of the forecast storm (the reference's ``_forecast_phase``,
    bench.py:1735-1955): ``build_runtime`` with the leg's options over a
    SimulatedCloudProvider whose create_fleet sleeps 0.5 s — every
    controller main.py builds, a memory launch journal, the steal with
    ``warm_pool``, garbage collection every 1 s (replay_after 3 s, the
    warm-pool TTL), and with ``warm_pool`` the forecaster (bucket 1 s,
    alpha 0.35, horizon 8 s) and the WarmPoolController (a wave every 0.5
    s, at most 12 warm nodes). Two solver: tpu provisioners
    ``fc-<i>`` each admit pods with ``fc: fc-<i>``; the compiled schedule
    drives pods of cpu 0.25 in real time, alternating selectors; then every
    pod bound, and in the warm pass the epilogue: speculation paused until
    no warm node stands and no journal entry is open. Returns what the
    kernels line and the checks read; raises on a pod unbound or bound
    twice, a leaked instance, an open entry, no warm hit in the warm pass,
    or a round that names no kernel or raised."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
    from karpenter_tpu_torch.cloudprovider.simulated import SimCloudAPI, SimulatedCloudProvider
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.main import build_runtime
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import make_pod, make_provisioner

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    names = [f"fc-{i}" for i in range(FORECAST_PROVISIONERS)]
    families = ("karpenter_warmpool_hits_total", "karpenter_warmpool_misses_total",
                "karpenter_warmpool_speculative_launches_total")

    def sample() -> dict:
        out = {f: sum(metric(f, {"provisioner": n}) for n in names) for f in families}
        out["karpenter_warmpool_expired_total"] = metric("karpenter_warmpool_expired_total")
        out["guard"] = sum(metric("karpenter_fleet_duplicate_launch_guard_total", {"reason": r})
                           for r in ("fenced", "lost_ownership"))
        return out

    counters = sample()
    cluster = Cluster()
    api = SimCloudAPI()
    api.launch_latency_s = FORECAST_LAUNCH_S
    provider = SimulatedCloudProvider(api=api)
    created, bound_at, last_node, rebinds, binds = {}, {}, {}, [], {}
    lock = threading.Lock()
    bind = cluster.bind

    def counting_bind(pod, node_name):
        with lock:
            binds[pod.key] = binds.get(pod.key, 0) + 1
        bind(pod, node_name)

    def on_pod(event, pod):
        if event == "DELETED" or not pod.spec.node_name:
            return
        now = time.perf_counter()
        with lock:
            prev = last_node.get(pod.metadata.name)
            if prev and prev != pod.spec.node_name:
                rebinds.append((pod.metadata.name, prev, pod.spec.node_name))
            last_node[pod.metadata.name] = pod.spec.node_name
            if pod.metadata.name in created and pod.metadata.name not in bound_at:
                bound_at[pod.metadata.name] = now - created[pod.metadata.name]

    cluster.bind = counting_bind
    cluster.watch("pods", on_pod)
    engine = obs.configure_forecast(bucket_s=1.0, alpha=0.35, default_horizon_s=8.0) \
        if warm_pool else None
    # the reference's leg (bench.py:1813-1830): build_runtime with these
    # options, then the compressed-time knobs on the built controllers
    rt = build_runtime(Options(device=device, warm_pool=warm_pool,
                               warm_pool_ttl=FORECAST_TTL_S,
                               warm_pool_max_nodes=FORECAST_MAX_WARM, gc_interval=1.0,
                               launch_journal="memory:"),
                       cluster=cluster, cloud_provider=provider)
    provisioning, collector, journal, wave = (rt.provisioning, rt.garbage_collection,
                                              rt.journal, rt.warmpool)
    collector.replay_after = 3.0
    if wave is not None:
        wave.interval = FORECAST_WAVE_S
    rounds, warmups = {}, {}
    start = {V1: pack_kernel.launches, V2: pack_kernel_v2.launches}
    rt.manager.start()
    try:
        for name in names:
            cluster.create("provisioners", make_provisioner(
                name=name, solver="tpu",
                requirements=[NodeSelectorRequirement(key="fc", operator="In", values=[name])]))
        deadline = time.time() + 60
        while time.time() < deadline and not all(n in provisioning.workers for n in names):
            time.sleep(0.01)
        for name in names:
            worker = provisioning.workers[name]
            worker.batcher.idle_duration = 0.1
            # the storm starts once the kernels are warm: a cold first
            # round would put the build in a pod's time-to-ready
            if not worker.warmed.wait(timeout=600):
                raise AssertionError(f"warmpool (a) {label}: {name}'s warm-up never finished")
            warmups[name] = worker.scheduler.torch.completed_profile()
            rounds[name] = []
            record_rounds(worker, rounds[name])
        t_start = time.perf_counter()
        n_created = 0
        for tick, (t_off, count) in enumerate(schedule):
            delay = t_off - (time.perf_counter() - t_start)
            if delay > 0:
                time.sleep(delay)
            prefix = "flash" if in_flash(t_off) else "base"
            for j in range(count):
                pod_name = f"{prefix}-{label}-{tick}-{j}"
                with lock:
                    created[pod_name] = time.perf_counter()
                cluster.create("pods", make_pod(name=pod_name, requests={"cpu": "0.25"},
                                                node_selector={"fc": names[n_created % len(names)]}))
                n_created += 1
        drive_s = time.perf_counter() - t_start
        deadline = time.time() + 120
        while time.time() < deadline:
            with lock:
                if len(bound_at) >= n_created:
                    break
            time.sleep(0.02)
        settle_s = time.perf_counter() - t_start - drive_s
        epilogue_s = 0.0
        if wave is not None:
            t0 = time.perf_counter()
            wave.set_paused(True)
            deadline = time.time() + FORECAST_TTL_S * 4 + 15
            while time.time() < deadline:
                standing = [n for n in cluster.nodes()
                            if lbl.WARM_POOL_ANNOTATION in n.metadata.annotations
                            and n.metadata.deletion_timestamp is None]
                if not standing and not journal.unresolved():
                    break
                time.sleep(0.2)
            epilogue_s = time.perf_counter() - t0
        else:
            # a cold launch's entry resolves right after its binds
            deadline = time.time() + 10
            while time.time() < deadline and journal.unresolved():
                time.sleep(0.02)
        node_names = {n.metadata.name for n in cluster.nodes()}
        provider_ids = {n.spec.provider_id for n in cluster.nodes()}
        live = [i for i in api.list_instances() if i.state != "terminated"]
        leaked = [i.id for i in live if i.id not in node_names
                  and f"sim:///{i.zone}/{i.id}" not in provider_ids]
        open_entries = journal.unresolved()
    finally:
        rt.stop()
        if engine is not None:
            obs.shutdown_forecast(engine)
    for name in names:
        worker = provisioning.workers.get(name)
        if worker is not None and worker._thread is not None:
            worker._thread.join(timeout=120)
    launches = {V1: pack_kernel.launches - start[V1], V2: pack_kernel_v2.launches - start[V2]}
    all_rounds = [r for name in names for r in rounds[name]]
    launched = check_rounds(all_rounds, {V1, V2}, f"warmpool (a) {label}")
    for prof in warmups.values():
        if prof.get("packer_backend") not in (V1, V2):
            raise AssertionError(f"warmpool (a) {label}: a warm-up served by "
                                 f"{prof.get('packer_backend')!r}")
        launched[prof["packer_backend"]] = (launched.get(prof["packer_backend"], 0)
                                            + prof.get("pack_dispatches", 0))
    expect_launches(f"warmpool a {label}", launches, launched)
    with lock:
        unbound = [k for k in created if k not in bound_at]
        twice = {k: n for k, n in binds.items() if n != 1}
        lat = sorted(bound_at.values())
        spike = sorted(v for k, v in bound_at.items() if k.startswith("flash-"))
    if unbound or twice or rebinds or len(binds) != n_created:
        raise AssertionError(f"warmpool (a) {label}: {len(unbound)} pods unbound, {len(twice)} "
                             f"bound other than once, {len(rebinds)} re-bound, {len(binds)} of "
                             f"{n_created} bound")
    if leaked:
        raise AssertionError(f"warmpool (a) {label}: leaked instances {leaked}")
    if open_entries:
        raise AssertionError(f"warmpool (a) {label}: {len(open_entries)} journal entries open")
    moved = {k: v - counters[k] for k, v in sample().items()}
    hits = moved["karpenter_warmpool_hits_total"]
    misses = moved["karpenter_warmpool_misses_total"]
    if warm_pool and hits <= 0:
        raise AssertionError(f"warmpool (a) {label}: no warm hit")

    out = {
        "phase": label, "pods": n_created, "bound": len(bound_at),
        "p50_s": lat[len(lat) // 2], "p99_s": nearest_rank_p99(lat),
        "spike_p99_s": nearest_rank_p99(spike),
        "warm_hits": int(hits), "warm_misses": int(misses),
        "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
        "speculative": int(moved["karpenter_warmpool_speculative_launches_total"]),
        "expired": int(moved["karpenter_warmpool_expired_total"]),
        "guard": moved["guard"], "waves": wave.waves if wave is not None else 0,
        "launches": launches, "rounds": len(all_rounds), "drive_s": drive_s,
        "settle_s": settle_s, "epilogue_s": epilogue_s, "creates": len(api.instances),
        "gc_sweeps": collector.sweeps,
        "scheduling_ms": [r["scheduling_ms"] for r in all_rounds],
    }
    for name in names:
        for i, r in enumerate(rounds[name]):
            log(f"[warmpool] (a) {label} {name} round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")
    log(f"[warmpool] (a) {label} pass ({'warm pool + forecaster' if warm_pool else 'reactive'}, "
        f"solver: tpu on the card where the reference's leg defaults to ffd): {n_created} pods "
        f"over {len(names)} provisioners, time-to-ready p50 {out['p50_s'] * 1e3:.1f} ms, p99 "
        f"{out['p99_s'] * 1e3:.1f} ms, spike p99 {out['spike_p99_s'] * 1e3:.1f} ms "
        f"({len(spike)} flash pods); warm hits {out['warm_hits']}, misses {out['warm_misses']}, "
        f"hit rate {out['hit_rate']:.4f}; speculative launches {out['speculative']}, expired "
        f"{out['expired']}, {out['waves']} waves; {out['creates']} instances launched, 0 leaked, "
        f"0 entries open, every pod bound once; {len(all_rounds)} card rounds, launches "
        f"{launches} (with {len(warmups)} warm-ups); drive {drive_s:.3f} s, settle "
        f"{settle_s:.3f} s, epilogue {epilogue_s:.3f} s, {collector.sweeps} GC sweeps; card "
        f"{card}")
    return out


def inline_warm(device: str, catalog, pods, requirements=None) -> dict:
    """One provisioner's ``warm_pool=True`` controller with
    start_workers=False (topology rng seeded) over a decorated
    FakeCloudProvider and a memory journal. First one wave of a
    WarmPoolController (its default ``max_nodes``, 10) on a forecaster with
    a fake clock, fed one ``provision.round`` span (2,000 pods on 200 nodes
    in a closed 1 s bucket: 50,000 pods wanted); then every pod created and
    queued and provision_once until the queue drains (batches of
    CONTROLLER_BATCH): the steal first, the remainder to the scheduler.
    Returns, by pod index, the bound state, the warm claims (pods on each
    warm node by the rank of its name, the order the steal walks), the
    warm-claim and wave decision records (warm nodes by rank), the hits and
    misses of each batch, the rounds."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.cloudprovider import metrics as cpmetrics
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.controllers.warmpool import WARM_POOL_KEY, WarmPoolController
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.launch import MemoryLaunchJournal
    from karpenter_tpu_torch.obs.trace import Span
    from karpenter_tpu_torch.testing import make_provisioner

    obs.configure_decisions("")
    clock = [0.0]
    eng = obs.configure_forecast(bucket_s=1.0, alpha=1.0, default_horizon_s=5.0,
                                 clock=lambda: clock[0])
    cluster = Cluster()
    provider = cpmetrics.decorate(FakeCloudProvider(catalog))
    journal = MemoryLaunchJournal()
    provisioning = ProvisioningController(cluster, provider, start_workers=False, device=device,
                                          journal=journal, warm_pool=True)
    prov = make_provisioner(solver="tpu", requirements=requirements)
    cluster.create("provisioners", prov)
    provisioning.reconcile(prov.name)
    worker = provisioning.workers[prov.name]
    worker.batcher.idle_duration = 0.01
    worker.scheduler.torch.topology.rng = random.Random(1)
    labels = {"provisioner": prov.name}
    try:
        eng(Span(name="provision.round", trace_id="t" * 32, span_id="s" * 16, parent_id=None,
                 parent=None, attrs={"provisioner": prov.name, "batch": 2000, "nodes": 200}))
        clock[0] = 1.0
        wave = WarmPoolController(cluster, provider, provisioning, journal=journal)
        t0 = time.perf_counter()
        wave.reconcile(WARM_POOL_KEY)
        wave_ms = (time.perf_counter() - t0) * 1e3
        warm = sorted(n.metadata.name for n in cluster.nodes()
                      if lbl.WARM_POOL_ANNOTATION in n.metadata.annotations)
        rank = {name: k for k, name in enumerate(warm)}
        rounds = []
        record_rounds(worker, rounds)
        for p in pods:
            cluster.create("pods", p)
            worker.add(p)
        batches, walls = [], []
        while worker.batcher.depth():
            hits = metric("karpenter_warmpool_hits_total", labels)
            misses = metric("karpenter_warmpool_misses_total", labels)
            t0 = time.perf_counter()
            worker.provision_once()
            walls.append((time.perf_counter() - t0) * 1e3)
            batches.append((metric("karpenter_warmpool_hits_total", labels) - hits,
                            metric("karpenter_warmpool_misses_total", labels) - misses))
        records = []
        for r in reversed(obs.decision_log().recent(limit=64)):
            state = dict(r.get("state") or {})
            if state.get("warm_claim") or state.get("warm_pool_wave"):
                if "warm_nodes" in state:
                    state["warm_nodes"] = [rank[n] for n in state["warm_nodes"]]
                records.append((state, r["pods_considered"], r["nodes"],
                                r["unschedulable_count"]))
    finally:
        provisioning.stop()
        obs.shutdown_forecast(eng)
    random_keys = {k for k, vs in worker.provisioner.spec.constraints.requirements._sets
                   if vs.op_type() == "Exists"}
    nodes, unbound = bound_state(cluster, pods, random_keys)
    claims = [[i for i, p in enumerate(pods) if p.spec.node_name == name] for name in warm]
    return {
        "rounds": rounds, "walls": walls, "nodes": nodes, "unbound": unbound, "claims": claims,
        "records": records, "batches": batches, "speculative": wave.speculative_launches,
        "standing": sum(1 for n in cluster.nodes()
                        if lbl.WARM_POOL_ANNOTATION in n.metadata.annotations),
        "open": len(journal.unresolved()), "wave_ms": wave_ms,
        "fits": fits_and_counts(cluster, prov.name, f"warmpool inline {device}"),
    }


def warmpool_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                   n_types: int = 400, duration_s: float = FORECAST_S) -> dict:
    """Phase 18: predictive provisioning on the card. Returns the kernels
    line's ``warmpool`` entries."""
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods
    from karpenter_tpu_torch.testing.chaos import ArrivalPattern

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}
    part_s, t_part = {}, time.perf_counter()

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    # -- (a) the forecast storm, cold then warm -----------------------------
    pattern = ArrivalPattern(base_pods_per_tick=3.0, amplitude=0.7, period_s=duration_s / 2.0,
                             tick_s=1.0, flash_at=(duration_s * 0.55, duration_s * 0.8),
                             flash_pods=24, flash_len_s=3.0, seed=FORECAST_SEED)
    schedule = pattern.schedule(duration_s)
    passes = {}
    for label, warm in (("cold", False), ("warm", True)):
        passes[label] = forecast_pass(card, label, schedule, pattern.in_flash, warm, device)
        for name in (V1, V2):
            if passes[label]["launches"][name]:
                out[name][f"launches_a_{label}"] = passes[label]["launches"][name]
    speedup = passes["cold"]["spike_p99_s"] / passes["warm"]["spike_p99_s"]
    log(f"[warmpool] (a) forecast storm {duration_s:g} s, seed {FORECAST_SEED}, "
        f"{sum(n for _, n in schedule)} pods a pass: spike p99 cold "
        f"{passes['cold']['spike_p99_s'] * 1e3:.1f} ms, warm "
        f"{passes['warm']['spike_p99_s'] * 1e3:.1f} ms, warm-over-cold speedup {speedup:.2f} "
        f"(the reference's bar 2.0, reported, not enforced); warm hit rate "
        f"{passes['warm']['hit_rate']:.4f}; card {card}")
    out["summary"]["a"] = {**passes, "spike_speedup": speedup, "spike_speedup_bar": 2.0,
                           "pods": sum(n for _, n in schedule)}
    part_s["a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # -- (b) inline determinism at headline width ----------------------------
    team = [NodeSelectorRequirement(key="team", operator="Exists")]
    parts = (
        ("b", "headline", instance_types(n_types),
         lambda: diverse_pods(n_pods, random.Random(42)), None, V1),
        ("b_teams", "team mix", instance_types_tradeoff(n_types),
         lambda: team_pods(n_pods, 9), team, V2),
    )
    for label, what, catalog, make, requirements, kernel in parts:
        ref = inline_warm("cpu", catalog, make(), requirements)
        start = counts()
        got = inline_warm(device, catalog, make(), requirements)
        b_launches = {name: n - start[name] for name, n in counts().items()}
        expect_launches(f"warmpool {label}", b_launches,
                        check_rounds(got["rounds"], {kernel}, f"warmpool ({label})"))
        for key in ("nodes", "unbound", "claims", "records", "batches", "speculative",
                    "standing", "open", "fits"):
            if got[key] != ref[key]:
                raise AssertionError(f"warmpool ({label}): {key} differs from the device='cpu' "
                                     f"controller")
        if got["speculative"] != 10:
            raise AssertionError(f"warmpool ({label}): the wave launched {got['speculative']}")
        for i, (r, w, (hits, misses)) in enumerate(zip(got["rounds"], got["walls"],
                                                       got["batches"])):
            log(f"[warmpool] ({label}) {what} round {i}: warm hits {hits:g}, misses {misses:g}; "
                f"remainder {r['pods']} pods, nodes {r['nodes']}, {r['backend']} ({r['route']}, "
                f"dispatches {r['dispatches']}), SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms, "
                f"provision_once {w:.3f} ms")
        log(f"[warmpool] ({label}) {what}: a wave of {got['speculative']} warm nodes "
            f"({got['wave_ms']:.3f} ms), {sum(len(c) for c in got['claims'])} pods claimed on "
            f"{sum(1 for c in got['claims'] if c)} of them, {got['standing']} left standing, "
            f"{got['open']} entries open; {len(got['rounds'])} card rounds, "
            f"{len(got['nodes'])} nodes, {len(got['unbound'])} pods unplaced, launches "
            f"{b_launches}; == the device='cpu' controller pod for pod (warm claims by rank, "
            f"partition, labels, taints, finalizers, unplaced pods, warm_claim and "
            f"warm_pool_wave records, hits and misses by batch); card {card}")
        if b_launches[kernel]:
            out[kernel][f"launches_{label}"] = b_launches[kernel]
        out["summary"][label] = {
            "claimed": sum(len(c) for c in got["claims"]), "batches": got["batches"],
            "rounds": len(got["rounds"]), "provision_once_ms": got["walls"],
            "scheduling_ms": [r["scheduling_ms"] for r in got["rounds"]],
            "unplaced": len(got["unbound"]), "wave_ms": got["wave_ms"],
        }
        del ref, got
    part_s["b"] = time.perf_counter() - t_part
    out["summary"]["part_s"] = part_s
    log(f"[warmpool] walls by part {({k: round(v, 3) for k, v in part_s.items()})} s, "
        f"phase 18 {sum(part_s.values()):.3f} s; card {card}")
    return out


TELEMETRY_SEED = 20260807  # bench_regression_storm's seed (bench.py:2794-2968)
STITCH_ROUNDS = 5
OVERHEAD_BASE_ROUNDS = 4
PROFILE_ROUNDS = 32
SENTINEL_ROUNDS = 16
STITCHED_STAGES = ("solver.wire", "solver.solve", "sidecar.pack", "solve.pack_fetch")


def served_delta(services, before) -> dict:
    """What the sidecars' ``served`` counts moved by since ``before``
    (one dict per service), summed by what served."""
    got = {}
    for svc, was in zip(services, before):
        for k, n in svc.served.items():
            if n - was.get(k, 0):
                got[k] = got.get(k, 0) + n - was.get(k, 0)
    return got


def stitched_pack(solve: dict, what: str) -> dict:
    """The sidecar's real sidecar.pack stitched under the solver.wire it
    rode: inside the wire's bounds, with admission_wait_s and real
    sidecar.solve / sidecar.fetch children. Returns the pack."""
    from karpenter_tpu_torch.obs import collector as tc

    wires = [s for s in tc._walk(solve) if s["name"] == "solver.wire"]
    packs = [(w, c) for w in wires for c in w["children"] if c["name"] == "sidecar.pack"]
    if len(packs) != 1:
        raise AssertionError(f"{what}: {len(packs)} sidecar.pack spans stitched under "
                             f"{len(wires)} solver.wire spans")
    wire, pack = packs[0]
    if not (pack.get("stitched") and pack["trace_id"] == solve["trace_id"]):
        raise AssertionError(f"{what}: sidecar.pack not stitched into its trace")
    if not wire["t0"] <= pack["t0"] <= pack["t1"] <= wire["t1"]:
        raise AssertionError(f"{what}: the stitched pack lies outside its wire")
    if "admission_wait_s" not in pack["attrs"]:
        raise AssertionError(f"{what}: sidecar.pack carries no admission_wait_s")
    kids = {c["name"] for c in pack["children"]}
    if not {"sidecar.solve", "sidecar.fetch"} <= kids:
        raise AssertionError(f"{what}: sidecar.pack children {sorted(kids)}")
    return pack


def telemetry_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                    n_types: int = 400, storm_pods: int = 160) -> dict:
    """Phase 19: the telemetry plane around the card sidecar. Returns the
    kernels line's ``telemetry`` entries."""
    import torch

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}
    part_s, t_part = {}, time.perf_counter()
    prov = make_provisioner(solver="tpu")

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    def note(label: str, launches: dict) -> None:
        for name, n in launches.items():
            if n:
                out[name][f"launches_{label}"] = n

    # the controllers here have no card: their solves go to a sidecar, and
    # fused (the reference's "device") keeps the cpu scheduler's router from
    # sending a round to native, which never reaches the sidecar
    os.environ["KARPENTER_PACKER"] = "fused"
    obs.reset_for_tests()
    try:
        # -- (a) the stitched leg through a live in-process card sidecar ----
        address = free_address()
        server = S.serve(address, max_workers=8, service=S.SolverService(device=device))
        svc = server.solver_service
        legs = (("headline", V1, instance_types(n_types),
                 diverse_pods(n_pods, random.Random(7))),
                ("team mix", V2, instance_types_tradeoff(n_types), team_pods(n_pods, 9)))
        out["summary"]["a"] = {}
        try:
            for label, kernel, catalog, pods in legs:
                sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                                  solver_service_address=address)
                start, was = counts(), dict(svc.served)
                try:
                    sched.solve(prov, catalog, pods)  # warm-up: the session opens
                    dispatches = served(sched, "sidecar", f"telemetry (a) {label} warm-up")[
                        "pack_dispatches"]
                    obs.exporter().clear()
                    times = []
                    for r in range(STITCH_ROUNDS):
                        t0 = time.perf_counter()
                        sched.solve(prov, catalog, pods)
                        times.append(time.perf_counter() - t0)
                        dispatches += served(sched, "sidecar", f"telemetry (a) {label} {r}")[
                            "pack_dispatches"]
                finally:
                    if sched.torch._remote is not None:
                        sched.torch._remote.close()
                launches = delta(start)
                got = served_delta([svc], [was])
                if set(got) != {kernel} or got[kernel] != dispatches:
                    raise AssertionError(f"telemetry (a) {label}: the sidecar served {got}, "
                                         f"the rounds dispatched {dispatches}")
                expect_launches(f"telemetry a, {label}", launches, {kernel: dispatches})
                roots, joins = obs.stitch(obs.exporter().trees())
                solves = [t for t in roots if t["name"] == "solver.solve"]
                if len(solves) != STITCH_ROUNDS:
                    raise AssertionError(f"telemetry (a) {label}: {len(solves)} solver.solve "
                                         f"trees after {STITCH_ROUNDS} rounds")
                waits = [stitched_pack(t, f"telemetry (a) {label}")["attrs"]["admission_wait_s"]
                         for t in solves]
                worst = max(solves, key=lambda t: t["duration_ms"])
                path = obs.critical_path(worst)
                attr = obs.wire_attribution(worst)
                row = {
                    "rounds": STITCH_ROUNDS, "p99_s": nearest_rank_p99(times),
                    "solve_s": times, "stitched_joins": joins,
                    "fleet_critical_path_ms": sum(leg["self_ms"] for leg in path),
                    "fleet_critical_path": [(leg["name"], leg["self_ms"]) for leg in path],
                    "wire_share_pct": attr["wire_share_pct"], "wire_attribution": attr,
                    "admission_wait_s": waits,
                }
                out["summary"]["a"][label] = row
                note(f"a_{label.replace(' ', '_')}", launches)
                log(f"[telemetry] (a) {label} ({len(pods)} pods x {n_types} types, "
                    f"{kernel} in the sidecar): {STITCH_ROUNDS} rounds, p99 "
                    f"{row['p99_s'] * 1e3:.3f} ms, joins {joins} (every solver.solve stitched "
                    f"its sidecar.pack inside its solver.wire), fleet_critical_path_ms "
                    f"{row['fleet_critical_path_ms']:.3f}, wire_share_pct "
                    f"{attr['wire_share_pct']}, wire {attr['wire_ms']:.3f} ms, sidecar queue "
                    f"{attr['sidecar_queue_ms']:.3f} ms, device {attr['device_ms']:.3f} ms of "
                    f"{attr['total_ms']:.3f} ms; critical path "
                    + ", ".join(f"{n} {ms:.3f}" for n, ms in row["fleet_critical_path"])
                    + f" ms; launches {launches}; card {card}")
        finally:
            server.stop(grace=None)
        part_s["a"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # -- (b) two processes: the port's sidecar entry point ---------------
        out["summary"]["b"] = telemetry_two_process(card, device, n_pods, n_types, delta, counts)
        part_s["b"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # -- (c) and (d): profiler and sentinel overhead on card rounds -----
        catalog, pods = instance_types(n_types), diverse_pods(n_pods, random.Random(42))
        sched = Scheduler(Cluster(), rng=random.Random(1), device=device)
        start = counts()
        sched.solve(prov, catalog, pods)
        dispatches = served(sched, V1, "telemetry (c) warm-up")["pack_dispatches"]

        def run_rounds(n: int, what: str) -> dict:
            nonlocal dispatches
            walls = []
            for r in range(n):
                t0 = time.perf_counter()
                sched.solve(prov, catalog, pods)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                dispatches += served(sched, V1, f"telemetry {what} round {r}")[
                    "pack_dispatches"]
            return {"rounds": n, "wall_s": walls, "pods_per_s": n * len(pods) / sum(walls)}

        base = run_rounds(OVERHEAD_BASE_ROUNDS, "(c) off")
        prof = obs.configure_profiler(hz=19.0)
        try:
            withp = run_rounds(PROFILE_ROUNDS, "(c) on")
            snap = prof.snapshot(top_n=5)
            panel = prof.flight_panel()
        finally:
            obs.shutdown_profiler(prof)
        overhead = prof.overhead_ratio() * 100
        spans = snap["span_samples"]
        in_span = sum(spans.values())
        shares = {name: {"samples": n, "pct_of_span_samples": n / in_span * 100,
                         "pct_of_ticks": n / snap["ticks"] * 100}
                  for name, n in sorted(spans.items(), key=lambda kv: -kv[1])}
        out["summary"]["c"] = {
            "hz": 19.0, "overhead_pct": overhead, "profile_samples": snap["samples"],
            "ticks": snap["ticks"], "top": snap["top"],
            "top_folds": [(f["stack"].split(";")[-3:], f["samples"])
                          for f in panel["top_folds"][:5]],
            "span_shares": shares, "off": base, "on": withp,
        }
        log(f"[telemetry] (c) profiler at 19 Hz over {PROFILE_ROUNDS} headline rounds: "
            f"overhead {overhead:.4f} % (self-accounted busy/wall, gate < 1 %), "
            f"{snap['samples']} samples in {snap['ticks']} ticks; pods/s off "
            f"{base['pods_per_s']:.1f} ({OVERHEAD_BASE_ROUNDS} rounds), on "
            f"{withp['pods_per_s']:.1f}; card {card}")
        log("[telemetry] (c) top frames by self samples: " + "; ".join(
            f"{t['frame']} {t['self_samples']} ({t['self_pct']} %)" for t in snap["top"]))
        log("[telemetry] (c) top folds (last 3 frames): " + "; ".join(
            f"{' < '.join(reversed(stack))} {n}" for stack, n in out["summary"]["c"]["top_folds"]))
        log("[telemetry] (c) samples by open span (share of span samples / of ticks, the "
            "solving thread's wall): " + ", ".join(
                f"{name} {v['samples']} ({v['pct_of_span_samples']:.1f} % / "
                f"{v['pct_of_ticks']:.1f} %)" for name, v in shares.items()))
        if overhead >= 1.0:
            raise AssertionError(f"telemetry (c): profiler overhead {overhead:.4f} % >= 1 %")
        if not snap["samples"]:
            raise AssertionError("telemetry (c): the profiler took no samples")

        base = run_rounds(OVERHEAD_BASE_ROUNDS, "(d) off")
        eng = obs.configure_sentinel(min_events=8)
        try:
            withs = run_rounds(SENTINEL_ROUNDS, "(d) on")
        finally:
            obs.shutdown_sentinel(eng)
        overhead = eng.overhead_ratio() * 100
        out["summary"]["d"] = {"overhead_pct": overhead, "baselines": eng.baseline_count(),
                               "incidents": eng.incidents.count(), "off": base, "on": withs}
        log(f"[telemetry] (d) sentinel (min_events 8) over {SENTINEL_ROUNDS} headline rounds: "
            f"overhead {overhead:.4f} % (gate < 1 %), {eng.baseline_count()} baselines, "
            f"{eng.incidents.count()} incidents; pods/s off {base['pods_per_s']:.1f}, on "
            f"{withs['pods_per_s']:.1f}; card {card}")
        if overhead >= 1.0:
            raise AssertionError(f"telemetry (d): sentinel overhead {overhead:.4f} % >= 1 %")
        launches = delta(start)
        expect_launches("telemetry c+d", launches, {V1: dispatches})
        note("c_d", launches)
        part_s["c_d"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # -- (e) the regression storm ----------------------------------------
        out["summary"]["e"] = regression_storm(card, device, storm_pods, delta, counts)
        note("e", out["summary"]["e"].pop("launches"))
        part_s["e"] = time.perf_counter() - t_part
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        obs.reset_for_tests()
    out["summary"]["part_s"] = part_s
    log(f"[telemetry] walls by part {({k: round(v, 3) for k, v in part_s.items()})} s, "
        f"phase 19 {sum(part_s.values()):.3f} s; card {card}")
    return out


def telemetry_two_process(card: str, device: str, n_pods: int, n_types: int, delta,
                          counts) -> dict:
    """Phase 19 (b): ``python -m karpenter_tpu_torch.solver.service
    --telemetry-dir D --telemetry-flush-interval 1 --profile-hz 7`` in a
    second process; one headline solve through it from a device="cpu"
    controller, then a TelemetryCollector over the file backend until the
    child's flushed sidecar.pack stitches under this process's solver.wire
    (30 s at most), then the child's /debug/profile, /debug/incidents and
    /debug/fleet. The child builds nothing: phase 1 built the kernels into
    the build directory, whose file lock makes a second build wait."""
    import urllib.error
    import urllib.request

    import grpc

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.obs import collector as tc
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    root = os.path.dirname(os.path.abspath(__file__))
    tdir = tempfile.mkdtemp(prefix="karpenter-telemetry-")
    address = free_address()
    health = int(free_address().rsplit(":", 1)[1])
    child_log = open(os.path.join(tdir, "sidecar.log"), "w")
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.solver.service", "--address", address,
         "--health-port", str(health), "--telemetry-dir", tdir,
         "--telemetry-flush-interval", "1", "--profile-hz", "7", "--device", device],
        cwd=root, env=env, stdout=child_log, stderr=subprocess.STDOUT)

    def get(path: str):
        with urllib.request.urlopen(f"http://127.0.0.1:{health}{path}", timeout=30) as r:
            return r.headers.get("Content-Type"), r.read()

    def ready() -> bool:
        # /readyz answers 503 until the child's warm-up solve, and urlopen
        # raises on a 503 instead of returning its body
        try:
            return get("/readyz")[1] == b"ok"
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
            return False

    sched = None
    start = counts()
    try:
        t0 = time.perf_counter()
        grpc.channel_ready_future(grpc.insecure_channel(address)).result(timeout=300)
        deadline = time.monotonic() + 300
        while not ready():
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError("telemetry (b): the child sidecar never turned ready")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        obs.exporter().clear()
        sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address)
        t0 = time.perf_counter()
        sched.solve(make_provisioner(solver="tpu"), instance_types(n_types),
                    diverse_pods(n_pods, random.Random(7)))
        solve_s = time.perf_counter() - t0
        served(sched, "sidecar", "telemetry (b)")
        coll = tc.TelemetryCollector(
            [tc.FileTelemetryBackend(tdir, identity="controller")], flush_interval=1.0,
            extra_trees=lambda: obs.exporter().snapshot(limit=None, newest_first=False))
        solve, t0 = None, time.perf_counter()
        while solve is None and time.perf_counter() - t0 < 30.0:
            coll.refresh()
            roots, _ = coll.stitched()
            solve = next((t for t in roots if t["name"] == "solver.solve" and any(
                s.get("stitched") for s in tc._walk(t))), None)
            if solve is None:
                time.sleep(0.25)
        stitch_s = time.perf_counter() - t0
        if solve is None:
            raise AssertionError("telemetry (b): the child's flush never stitched in 30 s")
        pack = stitched_pack(solve, "telemetry (b)")
        ctype, body = get("/debug/profile")
        profile = json.loads(body)["profile"]
        if ctype != "application/json" or not profile.get("samples"):
            raise AssertionError(f"telemetry (b): the child's profile holds no samples {profile}")
        incidents = json.loads(get("/debug/incidents")[1])
        fleet = json.loads(get("/debug/fleet")[1])["fleet"]
        members = [(m["identity"], m["role"]) for m in fleet.get("members", [])]
        if (f"sidecar-{address}", "sidecar") not in members:
            raise AssertionError(f"telemetry (b): /debug/fleet members {members}")
        if get("/debug/profile?format=collapsed")[0] != "text/plain":
            raise AssertionError("telemetry (b): the collapsed profile is not text/plain")
        launches = delta(start)
        if any(launches.values()):
            raise AssertionError(f"telemetry (b): this process launched {launches}; the child "
                                 f"sidecar serves the solve")
        attr = tc.wire_attribution(solve)
        row = {"ready_s": ready_s, "solve_s": solve_s, "stitch_s": stitch_s,
               "pack_ms": pack["duration_ms"], "wire_attribution": attr,
               "child_profile_samples": profile["samples"],
               "child_profile_overhead_ratio": profile["overhead_ratio"],
               "child_span_samples": profile["span_samples"],
               "child_sentinel_watch": incidents["sentinel"].get("watch"),
               "child_incidents": len(incidents["incidents"]), "fleet_members": members}
        log(f"[telemetry] (b) child sidecar ({device}) ready in {ready_s:.3f} s; one headline "
            f"solve {solve_s * 1e3:.3f} ms; its sidecar.pack ({pack['duration_ms']:.3f} ms, "
            f"a foreign perf_counter base) stitched under solver.wire {stitch_s:.3f} s after, "
            f"wire {attr['wire_ms']:.3f} / queue {attr['sidecar_queue_ms']:.3f} / device "
            f"{attr['device_ms']:.3f} ms; child /debug/profile {profile['samples']} samples, "
            f"overhead {profile['overhead_ratio']}, spans {profile['span_samples']}; "
            f"/debug/incidents watch {row['child_sentinel_watch']}, "
            f"{row['child_incidents']} incidents; /debug/fleet members {members}; the "
            f"kernel launched in the child (its /readyz needs a kernel's warm-up), this "
            f"process launched {launches}; card {card}")
        return row
    finally:
        if sched is not None and sched.torch._remote is not None:
            sched.torch._remote.close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        child_log.close()
        if proc.returncode not in (0, -15):
            with open(os.path.join(tdir, "sidecar.log")) as f:
                log("[telemetry] (b) child log tail: " + f.read()[-2000:])
        shutil.rmtree(tdir, ignore_errors=True)


def regression_storm(card: str, device: str, n_pods: int, delta, counts,
                     pool_size: int = 2, latency_step_s: float = 0.05) -> dict:
    """Phase 19 (e): the reference's regression storm with its parameters.
    ``build_runtime`` over a SimulatedCloudProvider (bench.py:2838-2842:
    a ``device="cpu"`` controller whose solves go to a SidecarChaos pool of
    ``pool_size`` card sidecars, ChaosPolicy(seed=TELEMETRY_SEED + i)), a
    flight recorder (budget 10 s), the profiler at 19 Hz; 3 warm waves of 4
    pods (cpu 0.25), freeze_after_warmup, then configure_sentinel(
    min_events=6, window=4, sustain=2, abs_floor_s=0.005, cooldown_s=300);
    at least 12 steady waves, which must open no incident; then a
    ``latency_step_s`` floor on every proxy for up to 15 step waves, which
    must open exactly one incident naming a wire/device stage with a
    pinned flight record, a decision id and a profile fold. Every pod is
    bound once; every round is one launch of the kernel the sidecars'
    ladder picks for its shape."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.cloudprovider.simulated import SimCloudAPI, SimulatedCloudProvider
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.main import build_runtime
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.testing import make_pod, make_provisioner
    from karpenter_tpu_torch.testing.chaos import ChaosPolicy, SidecarChaos
    from karpenter_tpu_torch.utils import gcpolicy

    t_start = time.perf_counter()
    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    sidecars = SidecarChaos(n=pool_size, device=device, policies={
        i: ChaosPolicy(seed=TELEMETRY_SEED + i) for i in range(pool_size)})
    flight_dir = tempfile.mkdtemp(prefix="karpenter-sentinel-flight-")
    obs.configure_flight(flight_dir, budget_s=10.0)
    prof = obs.configure_profiler(hz=19.0)
    eng = None
    cluster = Cluster()
    binds, lock = {}, threading.Lock()
    bind = cluster.bind

    def counting_bind(pod, node_name):
        with lock:
            binds[pod.key] = binds.get(pod.key, 0) + 1
        bind(pod, node_name)

    cluster.bind = counting_bind
    rt = build_runtime(Options(device="cpu", solver_service_address=sidecars.address_spec),
                       cluster=cluster, cloud_provider=SimulatedCloudProvider(api=SimCloudAPI()))
    provisioning = rt.provisioning
    services = [srv.solver_service for srv in sidecars.servers.values()]
    before_served = [dict(svc.served) for svc in services]
    start = counts()
    created = []
    froze = False

    def wave(prefix: str, n: int = 4, timeout: float = 120.0) -> None:
        names = [f"{prefix}-{i}" for i in range(n)]
        for name in names:
            cluster.create("pods", make_pod(name=name, requests={"cpu": "0.25"}))
        created.extend(names)
        want = set(names)
        deadline = time.time() + timeout
        while time.time() < deadline:
            live = {p.metadata.name: p for p in cluster.pods() if p.metadata.name in want}
            if len(live) == len(want) and all(p.spec.node_name for p in live.values()):
                return
            time.sleep(0.02)
        raise AssertionError(f"telemetry (e): wave {prefix} not bound in {timeout} s")

    rt.manager.start()
    try:
        cluster.create("provisioners", make_provisioner(solver="tpu"))
        deadline = time.time() + 60
        while time.time() < deadline and not provisioning.workers:
            time.sleep(0.02)
        worker = provisioning.workers["default"]
        worker.batcher.idle_duration = 0.1
        if not worker.warmed.wait(timeout=300):
            raise AssertionError("telemetry (e): the worker's warm-up never finished")
        warm = worker.scheduler.torch.completed_profile()
        if warm.get("packer_backend") != "sidecar":
            raise AssertionError(f"telemetry (e): warm-up served by {warm.get('packer_backend')!r}")
        rounds = []
        record_rounds(worker, rounds)
        for w in range(3):
            wave(f"warm-{w}")
        gcpolicy.freeze_after_warmup()
        froze = True
        eng = obs.configure_sentinel(min_events=6, window=4, sustain=2, abs_floor_s=0.005,
                                     cooldown_s=300.0)
        steady_waves = max((n_pods // 2) // 4, 12)
        steady_s = []
        for w in range(steady_waves):
            t_wave = time.perf_counter()
            wave(f"steady-{w}")
            steady_s.append(time.perf_counter() - t_wave)
        steady_fp = eng.incidents.count()
        baselines = eng.baseline_count()
        for proxy in sidecars.proxies.values():
            proxy.policy = ChaosPolicy(latency_floor=latency_step_s, seed=TELEMETRY_SEED)
        step_waves = 0
        for w in range(max((n_pods // 2) // 4, 15)):
            wave(f"step-{w}", timeout=180.0)
            step_waves += 1
            # a few waves past the first detection let the other deviating
            # stages attach to the same incident
            if eng.incidents.count() > 0 and step_waves >= 6:
                break
        overhead = eng.overhead_ratio() * 100
        incidents = eng.incidents.recent()
    finally:
        rt.stop()
        sidecars.stop_all()
        if eng is not None:
            obs.shutdown_sentinel(eng)
        obs.shutdown_profiler(prof)
        if froze:
            gcpolicy.restore()
        shutil.rmtree(flight_dir, ignore_errors=True)
    launches = delta(start)
    with lock:
        twice = {k: n for k, n in binds.items() if n != 1}
    bound = {p.metadata.name for p in cluster.pods() if p.spec.node_name}
    served_by = served_delta(services, before_served)
    for i, r in enumerate(rounds):
        if "error" in r or r["backend"] != "sidecar":
            raise AssertionError(f"telemetry (e) round {i}: {r}")
    dispatches = sum(r["dispatches"] for r in rounds) + warm.get("pack_dispatches", 0)
    stages, flights, decisions, folds = [], 0, 0, 0
    if incidents:
        rec = incidents[0]
        stages = sorted({s["stage"] for s in rec["stages"]})
        flights, decisions, folds = (len(rec["flights"]), len(rec["decisions"]),
                                     len(rec["profile_top"]))
    row = {
        "pods": len(created), "pool_size": pool_size, "latency_step_s": latency_step_s,
        "seed": TELEMETRY_SEED, "steady_waves": steady_waves, "step_waves": step_waves,
        "baselines_learned": baselines, "steady_false_positives": steady_fp,
        "incidents_opened": len(incidents), "incident_stages": stages,
        "incident_flight_records": flights, "incident_decision_ids": decisions,
        "incident_profile_folds": folds, "sentinel_overhead_pct": overhead,
        "gc_frozen_after_warmup": froze, "rounds": len(rounds), "served": served_by,
        "wall_s": time.perf_counter() - t_start, "launches": launches,
    }
    log(f"[telemetry] (e) regression storm: {len(created)} pods in waves of 4 over "
        f"{pool_size} sidecars (seed {TELEMETRY_SEED}), gc frozen after the 3 warm waves: "
        f"{froze}; steady {steady_waves} waves ({min(steady_s) * 1e3:.1f}–"
        f"{max(steady_s) * 1e3:.1f} ms a wave, median "
        f"{sorted(steady_s)[len(steady_s) // 2] * 1e3:.1f}), {steady_fp} false positives, {baselines} "
        f"baselines; step {latency_step_s * 1e3:g} ms on every proxy, {step_waves} waves, "
        f"{len(incidents)} incident(s) on {stages}, evidence: {flights} pinned flight "
        f"records, {decisions} decision ids, {folds} profile folds; sentinel overhead "
        f"{overhead:.4f} %; {len(rounds)} rounds served {served_by}, launches {launches}; "
        f"{row['wall_s']:.3f} s; card {card}")
    if steady_fp:
        trips = [{k: v for k, v in st.items() if k in ("stage", "observed_s", "baseline_s",
                                                        "threshold_s", "observations")}
                 for st in incidents[0]["stages"]] if incidents else []
        raise AssertionError(f"telemetry (e): {steady_fp} incidents in the steady phase: "
                             f"{trips}; steady waves (ms) "
                             f"{[round(t * 1e3, 1) for t in steady_s]}")
    if len(incidents) != 1:
        raise AssertionError(f"telemetry (e): {len(incidents)} incidents in the step phase")
    if not set(stages) & set(STITCHED_STAGES):
        raise AssertionError(f"telemetry (e): the incident names {stages}")
    if not (flights >= 1 and decisions >= 1 and folds >= 1):
        raise AssertionError(f"telemetry (e): incomplete evidence {flights}, {decisions}, "
                             f"{folds}")
    if overhead >= 1.0:
        raise AssertionError(f"telemetry (e): sentinel overhead {overhead:.4f} % >= 1 %")
    if twice or bound != set(created):
        raise AssertionError(f"telemetry (e): {len(set(created) - bound)} pods unbound, "
                             f"{len(twice)} bound other than once")
    # the sidecars' kernel ladder picks the kernel by shape: a 4-pod wave's
    # table is no multiple of 128 rows, so pack_first_fit_v2 serves it
    if not set(served_by) <= {V1, V2} or sum(served_by.values()) != dispatches:
        raise AssertionError(f"telemetry (e): the sidecars served {served_by}, the rounds "
                             f"and the warm-up dispatched {dispatches}")
    expect_launches("telemetry e", launches, served_by)
    return row


GKE_SEED = 11  # this phase's mixed serving-and-training batch
GKE_PODS = 2000
GKE_TPU_PODS = 400
GKE_SLICE_PODS = 64  # of the TPU pods: 4 chips each, pinned to the 4x4 podslice
GKE_CPU_ONLY = 1600
LEASE_DURATION_S = 2.0


def gke_batch(n_pods: int = GKE_PODS, seed: int = GKE_SEED, tolerate: bool = False) -> list:
    """The mixed GKE batch (at 2,000 pods): 1,600 CPU-only pods of cpu
    0.25, 0.5, 1 or 2; 400 pods asking ``google.com/tpu`` 1, 4 or 8 with
    cpu 8, the first 64 of them 4 chips pinned by
    ``cloud.google.com/gke-tpu-topology: 4x4`` to the multi-host shape;
    shuffled by ``Random(seed)``. A smaller ``n_pods`` keeps the shares.
    ``tolerate`` gives the TPU pods a toleration of the ``google.com/tpu``
    taint (``tpu_provisioners``)."""
    from karpenter_tpu_torch.api.objects import Toleration
    from karpenter_tpu_torch.cloudprovider.gke import GKE_TPU_TOPOLOGY_LABEL, TPU_RESOURCE
    from karpenter_tpu_torch.testing import make_pod

    tol = [Toleration(key=TPU_RESOURCE, operator="Exists")] if tolerate else None

    n_tpu = n_pods * GKE_TPU_PODS // GKE_PODS
    n_slice = n_pods * GKE_SLICE_PODS // GKE_PODS // 4 * 4
    rng = random.Random(seed)
    pods = [make_pod(name=f"web-{i}", requests={"cpu": f"{rng.choice([0.25, 0.5, 1, 2])}"})
            for i in range(n_pods - n_tpu)]
    for i in range(n_tpu):
        if i < n_slice:
            pods.append(make_pod(name=f"slice-{i}", requests={"cpu": "8", TPU_RESOURCE: "4"},
                                 node_selector={GKE_TPU_TOPOLOGY_LABEL: "4x4"},
                                 tolerations=tol))
        else:
            pods.append(make_pod(name=f"tpu-{i}", requests={
                "cpu": "8", TPU_RESOURCE: f"{rng.choice([1, 4, 8])}"}, tolerations=tol))
    rng.shuffle(pods)
    return pods


def gke_provisioner():
    """A solver: tpu provisioner with the GKE vendor default and the
    catalog's requirements, as ``tests/test_gke_provider.py:24-30`` builds
    it; returns (provisioner, catalog)."""
    from karpenter_tpu_torch.cloudprovider.gke import GkeCloudProvider, gke_catalog
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.testing import make_provisioner

    catalog = gke_catalog()
    prov = make_provisioner(solver="tpu")
    c = prov.spec.constraints
    GkeCloudProvider().default(c)
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    return prov, catalog


def tpu_provisioners() -> list:
    """The runtime's provisioners for the GKE batch: ``tpu`` declares the
    ``cloud.google.com/gke-tpu-topology`` values of the catalog (selection
    admits a pod's selector on a label only when its provisioner declares
    it, in both packages) and taints its nodes ``google.com/tpu``;
    ``default`` takes the CPU-only pods."""
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Taint
    from karpenter_tpu_torch.cloudprovider.gke import (
        GKE_TPU_TOPOLOGY_LABEL, TPU_RESOURCE, gke_catalog)
    from karpenter_tpu_torch.testing import make_provisioner

    topologies = sorted({it.labels[GKE_TPU_TOPOLOGY_LABEL] for it in gke_catalog()
                         if GKE_TPU_TOPOLOGY_LABEL in it.labels})
    return [
        make_provisioner(name="tpu", solver="tpu", taints=[
            Taint(key=TPU_RESOURCE, value="present", effect="NoSchedule")], requirements=[
            NodeSelectorRequirement(key=GKE_TPU_TOPOLOGY_LABEL, operator="In",
                                    values=topologies)]),
        make_provisioner(name="default", solver="tpu"),
    ]


def http_get(url: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def process_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                  gke_pods: int = GKE_PODS, cpu_only: int = GKE_CPU_ONLY) -> dict:
    """Phase 20: the controller process on the card. (a) the entry point
    over the HTTP cloud wire, (b) GKE TPU podslices, (c) leader election.
    Returns the kernels line's ``process`` entries."""
    import torch

    from karpenter_tpu_torch.cloudprovider import simulated
    from karpenter_tpu_torch.cloudprovider.gke import (
        GKE_NODEPOOL_LABEL, GKE_TPU_TOPOLOGY_LABEL, TPU_RESOURCE, GkeCloudProvider, SimGkeAPI,
        slice_hosts)
    from karpenter_tpu_torch.cloudprovider.httpapi import CloudAPIServer
    from karpenter_tpu_torch.cloudprovider.simulated import SimCloudAPI
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.launch import FileLaunchJournal
    from karpenter_tpu_torch.main import build_runtime, run_controller_process
    from karpenter_tpu_torch.options import Options, parse_args
    from karpenter_tpu_torch.scheduling import oracle
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver.backend import N_MAX_FIRST
    from karpenter_tpu_torch.testing import make_pod, make_provisioner
    from karpenter_tpu_torch.utils.lease import FileLease, LeaderElector
    from karpenter_tpu_torch.utils.resources import requests_for_pods

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}
    t_phase = time.perf_counter()

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    def note(label: str, launches: dict) -> None:
        for name, n in launches.items():
            if n:
                out[name][f"launches_{label}"] = out[name].get(f"launches_{label}", 0) + n

    scratch = tempfile.mkdtemp(prefix="chip-smoke-process-")
    try:
        # -- (a) run_controller_process over the HTTP cloud wire ----------
        api = SimCloudAPI()
        server = CloudAPIServer(api, page_size=1000).start()
        env_before = os.environ.get("KARPENTER_CLOUD_API_URL")
        os.environ["KARPENTER_CLOUD_API_URL"] = server.url
        # the simulated cloud paces create_fleet at 2 QPS past a burst of
        # 100; the storm's ~180 creates would wait ~40 s for that budget,
        # which the reference's leg (a fake cloud) never meets: the burst
        # is raised for this runtime and restored after its build
        burst = simulated.CREATE_FLEET_BURST
        simulated.CREATE_FLEET_BURST = 10 * n_pods
        lease_path = os.path.join(scratch, "leader.lease")
        journal_path = os.path.join(scratch, "journal.json")
        metrics_port, health_port = (int(free_address().rsplit(":", 1)[1]) for _ in range(2))
        while health_port == metrics_port:
            health_port = int(free_address().rsplit(":", 1)[1])
        opts = parse_args([
            "--cloud-provider", "simulated-http", "--leader-election-lease", lease_path,
            "--launch-journal", journal_path, "--metrics-port", str(metrics_port),
            "--health-probe-port", str(health_port), "--device", device,
            "--telemetry-dir", os.path.join(scratch, "telemetry"),
            "--telemetry-flush-interval", "1",
        ])
        t0 = time.perf_counter()
        try:
            rt = run_controller_process(opts, serve=True)
        finally:
            simulated.CREATE_FLEET_BURST = burst
        started_s = time.perf_counter() - t0
        cluster = rt.cluster
        binds, created, bound_at = {}, {}, {}
        lock = threading.Lock()
        bind = cluster.bind

        def counting_bind(pod, node_name):
            with lock:
                binds[pod.key] = binds.get(pod.key, 0) + 1
            bind(pod, node_name)

        def on_pod(event, pod):
            if event == "MODIFIED" and pod.spec.node_name:
                now = time.perf_counter()
                with lock:
                    if pod.metadata.name in created and pod.metadata.name not in bound_at:
                        bound_at[pod.metadata.name] = now

        cluster.bind = counting_bind
        cluster.watch("pods", on_pod)
        start = counts()
        stopped = False
        try:
            if not (rt.elector is not None and rt.elector.is_leader
                    and FileLease(lease_path, identity="probe").holder() is not None):
                raise AssertionError("process (a): the runtime does not hold its lease")
            cluster.create("provisioners", make_provisioner(solver="tpu"))
            deadline = time.time() + 60
            while time.time() < deadline and not rt.provisioning.workers:
                time.sleep(0.01)
            worker = rt.provisioning.workers["default"]
            worker.batcher.idle_duration = 0.2
            if not worker.warmed.wait(timeout=600):
                raise AssertionError("process (a): the warm-up never finished")
            warm = worker.scheduler.torch.completed_profile()
            if warm.get("packer_backend") not in (V1, V2):
                raise AssertionError(f"process (a): warm-up served by "
                                     f"{warm.get('packer_backend')!r}")
            warm_launches = delta(start)
            expect_launches("process a, warm-up", warm_launches,
                            {warm["packer_backend"]: warm.get("pack_dispatches", 0)})
            rounds = []
            record_rounds(worker, rounds)
            rng = random.Random(5)
            storm_start = counts()
            t0 = time.perf_counter()
            for i in range(n_pods):
                name = f"storm-{i}"
                p = make_pod(name=name, requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"})
                with lock:
                    created[name] = time.perf_counter()
                cluster.create("pods", p)
            enqueue_s = time.perf_counter() - t0
            deadline = time.time() + 600
            while time.time() < deadline:
                with lock:
                    if len(bound_at) >= n_pods:
                        break
                time.sleep(0.02)
            wall = time.perf_counter() - t0
            storm_launches = delta(storm_start)
            with lock:
                lat = sorted(bound_at[k] - created[k] for k in bound_at)
                twice = {k: n for k, n in binds.items() if n != 1}
            if len(lat) != n_pods or len(binds) != n_pods:
                raise AssertionError(f"process (a): {len(lat)} of {n_pods} pods bound in "
                                     f"{wall:.1f} s")
            if twice:
                raise AssertionError(f"process (a): pods bound more than once: {list(twice)[:5]}")
            launched = check_rounds(rounds, {V1, V2}, "process (a)")
            expect_launches("process a, storm", storm_launches, launched)
            for i, r in enumerate(rounds):
                if r["dispatches"] != 1:
                    raise AssertionError(f"process (a) round {i}: {r['dispatches']} dispatches")
            planned = sum(r["nodes"] for r in rounds)
            nodes = cluster.nodes()
            running = [i for i in api.instances.values() if i.state == "running"]
            fleet_calls = api.calls.get("create_fleet", 0)
            if not (planned == len(nodes) == len(running) == fleet_calls):
                raise AssertionError(f"process (a): {planned} virtual nodes, {len(nodes)} Nodes, "
                                     f"{len(running)} running instances on the server, "
                                     f"{fleet_calls} create_fleet calls over the wire")
            if {n.metadata.name for n in nodes} != {i.id for i in running}:
                raise AssertionError("process (a): the Nodes are not the server's instances")
            capacity = fits_and_counts(cluster, "default", "process (a)")
            deadline = time.time() + 60
            while time.time() < deadline and counted(cluster, "default") != capacity:
                time.sleep(0.05)
            if counted(cluster, "default") != capacity:
                raise AssertionError(f"process (a): counter {counted(cluster, 'default')} != "
                                     f"capacity {capacity}")
            # the served ports: health and debug on one, the registry on the other
            base = f"http://127.0.0.1:{health_port}"
            answers = {}
            for path in ("/healthz", "/readyz", "/debug/profile", "/debug/fleet",
                         "/debug/incidents"):
                status, ctype, body = http_get(base + path)
                answers[path] = (status, len(body))
                if status != 200:
                    raise AssertionError(f"process (a): {path} answered {status}")
            status, _, body = http_get(f"http://127.0.0.1:{metrics_port}/metrics")
            if status != 200 or b"karpenter_" not in body:
                raise AssertionError(f"process (a): /metrics answered {status}")
            answers["/metrics"] = (status, len(body))
            profile = json.loads(http_get(base + "/debug/profile")[2])["profile"]
            incidents = json.loads(http_get(base + "/debug/incidents")[2])
            fleet = json.loads(http_get(base + "/debug/fleet")[2])["fleet"]
            p50 = lat[len(lat) // 2]
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            journal_entries = len(FileLaunchJournal(journal_path).unresolved())
            t0 = time.perf_counter()
            rt.stop()
            stopped = True
            stop_s = time.perf_counter() - t0
        finally:
            if not stopped:
                rt.stop()
            server.stop()
            if env_before is None:
                os.environ.pop("KARPENTER_CLOUD_API_URL", None)
            else:
                os.environ["KARPENTER_CLOUD_API_URL"] = env_before
        holder = FileLease(lease_path, identity="probe").holder()
        still_open = FileLaunchJournal(journal_path).unresolved()
        if holder is not None:
            raise AssertionError(f"process (a): the lease is still held by {holder} after stop")
        if still_open:
            raise AssertionError(f"process (a): {len(still_open)} journal entries open")
        for i, r in enumerate(rounds):
            log(f"[process] (a) round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")
        log(f"[process] (a) run_controller_process(--cloud-provider simulated-http, "
            f"--leader-election-lease, --launch-journal, --device {device}) up and leading in "
            f"{started_s:.3f} s; warm-up {warm['packer_backend']} ({warm_launches}); storm of "
            f"{n_pods} pods (Random(5)): create->bind p50 {p50 * 1e3:.1f} ms, p99 "
            f"{p99 * 1e3:.1f} ms, {n_pods / wall:.1f} bound pods/s, wall {wall:.3f} s (creates "
            f"{enqueue_s:.3f} s), {len(rounds)} rounds, each one launch; {len(nodes)} Nodes = "
            f"{planned} virtual nodes = {fleet_calls} create_fleet calls over the wire = "
            f"{len(running)} running instances on the server; every pod bound once; counter == "
            f"capacity {capacity}; served {answers}; profiler {profile.get('samples')} samples, "
            f"sentinel {len(incidents.get('sentinel', {}).get('baselines', []))} baselines, "
            f"{len(fleet.get('members') or [])} fleet members; {journal_entries} journal "
            f"entries open before stop, stop {stop_s:.3f} s released the lease (holder None) "
            f"and left 0 open; card {card}")
        note("a", {k: warm_launches[k] + storm_launches[k] for k in warm_launches})
        out["summary"]["a"] = {
            "pods": n_pods, "rounds": len(rounds), "batches": [r["pods"] for r in rounds],
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "pods_per_s": n_pods / wall,
            "wall_s": wall, "nodes": len(nodes), "create_fleet_calls": fleet_calls,
            "started_s": started_s, "stop_s": stop_s,
        }
        del rt, cluster

        # -- (b) GKE TPU podslices on the card ----------------------------
        prov, catalog = gke_provisioner()
        parts = {}
        # the reference's CPU-only case (tests/test_gke_provider.py:57-64,
        # 6 pods of cpu 2) must buy no TPU host; at 1,600 pods first fit
        # keeps filling a node while any type still fits its total, so its
        # nodes outgrow the largest CPU machine (48 cpu) and take the
        # 224-cpu ct5lp-hightpu-8t, in both packages (the gate there is the
        # device="cpu" plan)
        for label, pods in (("mixed", gke_batch(gke_pods)),
                            ("cpu_only_6", [make_pod(name=f"web-{i}", requests={"cpu": "2"})
                                            for i in range(6)]),
                            ("cpu_only", [make_pod(name=f"web-{i}", requests={"cpu": "2"})
                                          for i in range(cpu_only)])):
            batch = encode_batch(catalog, pods)
            axes = list(batch.axis_names)
            start = counts()
            sched = Scheduler(Cluster(), rng=random.Random(1), device=device)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalog, pods)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof = sched.last_stage_profile()
            got = delta(start)
            kernel = prof.get("packer_backend")
            if kernel not in (V1, V2) or prof.get("pack_dispatches") != 1 or sum(got.values()) != 1:
                raise AssertionError(f"process (b) {label}: served by {kernel!r}, "
                                     f"{prof.get('pack_dispatches')} dispatches, launches {got}")
            cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
            cpu_nodes = cpu_sched.solve(prov, catalog, pods)
            not_degraded(cpu_sched, f"process (b) {label} cpu plan")
            if plan_of(nodes, pods) != plan_of(cpu_nodes, pods):
                raise AssertionError(f"process (b) {label}: the card's plan differs from the "
                                     f"device='cpu' plan")
            placed = sum(len(n.pods) for n in nodes)
            for n in nodes:
                it = n.instance_type_options[0]
                for p in n.pods:
                    want = requests_for_pods(p).get(TPU_RESOURCE, 0.0)
                    if want and it.resources.get(TPU_RESOURCE, 0) < want:
                        raise AssertionError(f"process (b) {label}: {p.metadata.name} asks "
                                             f"{want} chips on {it.name}")
                if label == "cpu_only_6" and it.resources.get(TPU_RESOURCE):
                    raise AssertionError(f"process (b): the CPU-only batch bought {it.name}")
            if ("google.com/tpu" in axes) != (label == "mixed"):
                raise AssertionError(f"process (b): encoded axes {axes} lack the TPU axis")
            types = {}
            for n in nodes:
                types[n.instance_type_options[0].name] = types.get(
                    n.instance_type_options[0].name, 0) + 1
            F = int(batch.frontiers.shape[1])
            plan = pack_kernel.launch_plan(F, len(axes), N_MAX_FIRST)
            if not plan.node_state_in_smem:
                raise AssertionError(f"process (b) {label}: R={len(axes)} puts the node state "
                                     f"in device memory ({plan})")
            note(f"b_{label}", got)
            parts[label] = {"nodes": len(nodes), "placed": placed, "kernel": kernel,
                            "wall_ms": wall_ms, "axes": axes, "R": len(axes)}
            log(f"[process] (b) {label} batch of {len(pods)} pods: encoded R={len(axes)} "
                f"axes {axes} (P={len(batch.pod_valid)}, S={batch.join_table.shape[0]}, "
                f"F={batch.frontiers.shape[1]}, C={batch.join_table.shape[1]}), launch plan at "
                f"n_max {N_MAX_FIRST} {tuple(plan)} (node state in shared memory), {kernel} "
                f"({prof.get('pack_route')}), one launch; {len(nodes)} nodes, {placed} pods "
                f"placed, types {dict(sorted(types.items()))}; == the device='cpu' plan pod for "
                f"pod; round {wall_ms:.3f} ms: {stage_line(prof)}; card {card}")
        huge = [make_pod(name="huge", requests={TPU_RESOURCE: "16"})]
        cluster = Cluster()
        start = counts()
        sched = Scheduler(cluster, rng=random.Random(0), device=device)
        vnodes = sched.solve(prov, catalog, huge)
        verdict = oracle.classify_drops(cluster, prov.spec.constraints, catalog, huge,
                                        [p for v in vnodes for p in v.pods])
        got = delta(start)
        if vnodes or verdict["expected"] != {oracle.NO_CAPACITY: 1} or verdict["unexplained"]:
            raise AssertionError(f"process (b): the 16-chip pod: {len(vnodes)} nodes, {verdict}")
        note("b_oracle", got)
        log(f"[process] (b) a 16-chip pod: no node, oracle {verdict['expected']}, unexplained "
            f"{verdict['unexplained']}; launches {got}")

        # the mixed batch launched through build_runtime under a Manager: a
        # tainted tpu provisioner declaring the topology label, the TPU pods
        # tolerating it, and a default one for the rest
        api = SimGkeAPI()
        provider = GkeCloudProvider(api=api)
        cluster = Cluster()
        rt = build_runtime(Options(device=device), cluster=cluster, cloud_provider=provider)
        rt.manager.start()
        pods = gke_batch(gke_pods, tolerate=True)
        start = counts()
        rounds, warm = [], {}
        try:
            for p in tpu_provisioners():
                cluster.create("provisioners", p)
            deadline = time.time() + 60
            while time.time() < deadline and len(rt.provisioning.workers) < 2:
                time.sleep(0.01)
            for name in ("tpu", "default"):
                worker = rt.provisioning.workers[name]
                worker.batcher.idle_duration = 0.2
                if not worker.warmed.wait(timeout=600):
                    raise AssertionError(f"process (b): {name}'s warm-up never finished")
                warm[name] = worker.scheduler.torch.completed_profile()
                record_rounds(worker, rounds)
            t0 = time.perf_counter()
            for p in pods:
                cluster.create("pods", p)
            deadline = time.time() + 300
            while time.time() < deadline and any(
                    not cluster.get("pods", p.metadata.name).spec.node_name for p in pods):
                time.sleep(0.05)
            launch_s = time.perf_counter() - t0
            unbound = [p.metadata.name for p in pods
                       if not cluster.get("pods", p.metadata.name).spec.node_name]
            slices = [pool for pool in api.create_calls if pool.tpu_topology == "4x4"]
            partial = [pool.name for pool in slices
                       if pool.count != slice_hosts("ct5lp-hightpu-4t-4x4")
                       or len(pool.instances) != pool.count]
            hosts = {n.metadata.name: n for n in cluster.nodes()
                     if n.metadata.labels.get(GKE_TPU_TOPOLOGY_LABEL) == "4x4"}
            pinned = [cluster.get("pods", p.metadata.name) for p in pods
                      if p.spec.node_selector.get(GKE_TPU_TOPOLOGY_LABEL) == "4x4"]
            off_slice = [p.metadata.name for p in pinned if p.spec.node_name not in hosts]
            pools = {n.metadata.labels[GKE_NODEPOOL_LABEL] for n in hosts.values()}
        finally:
            rt.stop()
        got = delta(start)
        launched = check_rounds(rounds, {V1, V2}, "process (b) runtime")
        for prof in warm.values():
            launched[prof["packer_backend"]] = (launched.get(prof["packer_backend"], 0)
                                                + prof.get("pack_dispatches", 0))
        expect_launches("process b runtime", got, launched)
        if unbound or partial or off_slice or not slices:
            raise AssertionError(f"process (b) runtime: {len(unbound)} unbound, partial pools "
                                 f"{partial}, {len(off_slice)} slice pods off a 4x4 host, "
                                 f"{len(slices)} 4x4 pools")
        note("b_runtime", got)
        for i, r in enumerate(rounds):
            log(f"[process] (b) runtime round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")
        log(f"[process] (b) build_runtime(cloud_provider=GkeCloudProvider) bound {len(pods)} "
            f"pods in {launch_s:.3f} s: {len(api.create_calls)} node-pool creates, "
            f"{len(slices)} 4x4 podslices each one atomic create of 4 hosts, {len(hosts)} "
            f"4x4 hosts in {len(pools)} pools, every 4x4-pinned pod on one; launches {got}; "
            f"card {card}")
        out["summary"]["b"] = {**parts, "runtime": {
            "pods": len(pods), "rounds": len(rounds), "pool_creates": len(api.create_calls),
            "slices": len(slices), "launch_s": launch_s}}
        del rt, cluster, provider, api

        # -- (c) leader election on one file lease ------------------------
        path = os.path.join(scratch, "pair.lease")
        electors = [LeaderElector(FileLease(path, identity=name, duration=LEASE_DURATION_S),
                                  renew_interval=0.1) for name in ("a", "b")]
        for e in electors:
            e.start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline and not any(e.is_leader for e in electors):
                time.sleep(0.01)
            time.sleep(0.5)
            leaders = [e.is_leader for e in electors]
            if sum(leaders) != 1:
                raise AssertionError(f"process (c): leaders {leaders}")
            leader, other = electors[leaders.index(True)], electors[1 - leaders.index(True)]
            t0 = time.perf_counter()
            leader.stop()
            took = other.wait_for_leadership(timeout=LEASE_DURATION_S + 1.0)
            takeover_s = time.perf_counter() - t0
        finally:
            for e in electors:
                e.stop()
        if not took or takeover_s > LEASE_DURATION_S:
            raise AssertionError(f"process (c): takeover {took} after {takeover_s:.3f} s")
        log(f"[process] (c) two LeaderElectors on one file lease (duration "
            f"{LEASE_DURATION_S:g} s, renew 0.1 s): exactly one led; it stopped and the other "
            f"led {takeover_s * 1e3:.1f} ms later")
        out["summary"]["c"] = {"takeover_s": takeover_s}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    out["summary"]["phase_s"] = phase_s
    log(f"[process] phase 20 wall {phase_s:.3f} s; card {card}")
    return out


APISERVER_LEASE = "kube:kube-system/karpenter-leader-election"
APISERVER_JOURNAL = "kube:kube-system/launch"
# the client's QPS knobs (--kube-client-qps / --kube-client-burst), raised
# so that the client's token bucket is not what paces the storm
APISERVER_QPS = 5000.0
APISERVER_BURST = 10000
CHAOS_PODS = 2000
CHAOS_SEED = 20260803  # bench_partition_storm's (bench.py:2105)
CHAOS_THROTTLE = 0.05  # share of requests answered 429 during (c)'s storm
CHAOS_BLACKOUT_S = 3.0  # under KubeLease's 15 s duration less its 3 s margin
STANDING_NODES = 200  # (b)'s fleet, read through the informers
KUBE_LEASE_S = 2.0  # (d)'s Lease duration
CONSOLIDATION_NODES = 5  # (e): one evict wave (EVICT_WAVE_SIZE)


class RestCounter:
    """A ``chaos=`` hook on the in-repo API server: counts every request
    that reaches the REST surface by verb and subresource, and the binding
    POSTs per pod. ``inner`` (an ``ApiServerChaos``) decides first: a
    request it fails or drops is not counted."""

    def __init__(self):
        self.inner = None
        self._mu = threading.Lock()
        self.requests = {}
        self.bindings = {}

    def intercept(self, handler, method, path) -> bool:
        inner = self.inner
        if inner is not None and inner.intercept(handler, method, path):
            return True
        parts = path.split("?")[0].rstrip("/").split("/")
        sub = parts[-1] if parts[-1] in ("binding", "eviction", "status") else ""
        watch = "watch=true" in path
        key = f"{method} {sub or ('watch' if watch else 'rest')}"
        with self._mu:
            self.requests[key] = self.requests.get(key, 0) + 1
            if sub == "binding":
                self.bindings[parts[-2]] = self.bindings.get(parts[-2], 0) + 1
        return False

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self.requests)


def kube_counters() -> dict:
    """The transport's retries by verb class and its throttles by source,
    from the port's registry."""
    out = {}
    for cls in ("read", "mutate", "create", "watch", "events", "lease"):
        out[f"retries_{cls}"] = metric("karpenter_kube_request_retries_total", {"verb_class": cls})
    for source in ("server", "client"):
        out[f"throttled_{source}"] = metric("karpenter_kube_throttled_total", {"source": source})
    out["events_dropped"] = metric("karpenter_kube_events_dropped_total")
    return out


def counters_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


class BindWatch:
    """Watches a server's backing store: when each pod was created (by the
    caller) and first bound, how many times its nodeName went from empty to
    set, and every flip between two nodes (a pod provisioned twice)."""

    def __init__(self, cluster):
        self._mu = threading.Lock()
        self.created, self.bound_at, self.binds, self.flips, self.last = {}, {}, {}, [], {}
        cluster.watch("pods", self._on_pod)

    def _on_pod(self, event, pod) -> None:
        if event == "DELETED":
            return
        name, node = pod.metadata.name, pod.spec.node_name
        now = time.perf_counter()
        with self._mu:
            prev = self.last.get(name, "")
            if node and not prev:
                self.binds[name] = self.binds.get(name, 0) + 1
                self.bound_at.setdefault(name, now)
            elif node and prev and node != prev:
                self.flips.append((name, prev, node))
            self.last[name] = node

    def create(self, cluster, pod) -> None:
        with self._mu:
            self.created[pod.metadata.name] = time.perf_counter()
        cluster.create("pods", pod)

    def wait(self, names, timeout: float, stuck) -> list:
        """Wait until every pod in ``names`` was bound, or is in
        ``stuck()`` (the pods the controller declared unschedulable);
        raises after ``timeout``. Returns the pods left unbound."""
        deadline = time.time() + timeout
        while True:
            given_up = stuck()
            with self._mu:
                missing = [n for n in names if n not in self.bound_at]
            if all(n in given_up for n in missing):
                return missing
            if time.time() > deadline:
                raise AssertionError(f"{len(missing)} of {len(names)} pods unbound after "
                                     f"{timeout} s: {missing[:5]}")
            time.sleep(0.2)

    def latencies(self, names) -> list:
        with self._mu:
            return sorted(self.bound_at[n] - self.created[n] for n in names
                          if n in self.bound_at)


def unschedulable(cluster) -> set:
    """The pods with a ``PodUnschedulable`` Warning on ``cluster``: the
    controller's verdict that no launch can seat them."""
    return {e.involved_name for e in cluster.list("events") if e.reason == "PodUnschedulable"}


def unschedulable_reasons(cluster, names) -> dict:
    """How many of ``names`` were given a ``PodUnschedulable`` event,
    by the event's message less the pod's name."""
    names = set(names)
    out = {}
    for e in cluster.list("events"):
        if e.reason == "PodUnschedulable" and e.involved_name in names:
            why = e.message.replace(e.involved_name, "<pod>")[:160]
            out[why] = out.get(why, 0) + 1
    return out


def pod_report(cluster, names) -> dict:
    """The store's view of ``names``: each pod's node (empty when
    unbound or "gone" when absent) and the reasons and messages of the
    events about it."""
    events = {}
    for e in cluster.list("events"):
        if e.involved_name in names:
            events.setdefault(e.involved_name, []).append(f"{e.reason}: {e.message[:200]}")
    out = {}
    for name in names:
        pod = cluster.try_get("pods", name)
        out[name] = {"node": "gone" if pod is None else pod.spec.node_name,
                     "events": events.get(name, [])}
    return out


def apiserver_child(conn) -> None:
    """The in-repo API server in a process of its own, as a real API server
    is: its HTTP threads and watch fan-out do not share the controller's
    interpreter. Serves the parent's requests over ``conn``, one dict in
    and one dict out (``{"ok": value}`` or ``{"error": text}``), until
    ``{"op": "stop"}``. Pods are created in the server's own store, so they
    reach the controller through its watch; creation and bind times are
    taken here."""
    from karpenter_tpu_torch.kube import serde
    from karpenter_tpu_torch.kube.testserver import TestApiServer
    from karpenter_tpu_torch.launch.journal import KubeLaunchJournal
    from karpenter_tpu_torch.testing import diverse_pods, make_pod
    from karpenter_tpu_torch.testing.chaos import ApiServerChaos

    server = TestApiServer()
    rest = RestCounter()
    server.chaos = rest
    server.start()
    watch = BindWatch(server.cluster)
    store = server.cluster

    def storm(which: str, n: int, seed: int = 0, blackout_at: int = -1,
              blackout_s: float = 0.0) -> dict:
        if which == "diverse":
            pods = diverse_pods(n)
        else:
            sizes = random.Random(seed).choices([0.25, 0.5, 1], k=n)
            pods = [make_pod(name=f"{which}-{i}", requests={"cpu": f"{c}"})
                    for i, c in enumerate(sizes)]
        t0 = time.perf_counter()
        for i, p in enumerate(pods):
            watch.create(store, p)
            if i == blackout_at:
                rest.inner.blackout(blackout_s)
        return {"names": [p.metadata.name for p in pods], "enqueue_s": time.perf_counter() - t0}

    def state(names) -> dict:
        with watch._mu:
            binds = {n: watch.binds.get(n, 0) for n in names}
            flips = [f for f in watch.flips if f[0] in set(names)]
        with rest._mu:
            posts = {n: rest.bindings.get(n, 0) for n in names}
        return {"latencies": watch.latencies(names), "binds": binds, "flips": flips,
                "posts": posts}

    def chaos(fail_next=None, **kw) -> dict:
        if kw:
            rest.inner = ApiServerChaos(**kw)
            for verb, n in (fail_next or {}).items():
                rest.inner.fail_next(verb, n)
            return {}
        armed, rest.inner = rest.inner, None
        return {"throttled": armed.counts(armed.throttled), "dropped": armed.counts(armed.dropped),
                "injected": armed.counts(armed.injected)}

    ops = {
        "create": lambda kind, doc: store.create(kind, serde.from_wire(kind, doc)) and None,
        "storm": storm,
        "wait": lambda names, limit: watch.wait(names, limit, lambda: unschedulable(store)),
        "state": state,
        "requests": rest.snapshot,
        "chaos": chaos,
        "nodes": lambda: sorted(n.metadata.name for n in store.nodes()),
        "lease_holder": lambda name, namespace: store.get(
            "leases", name, namespace=namespace).holder_identity,
        "journal_open": lambda prefix: len(KubeLaunchJournal(store, prefix=prefix).unresolved()),
        "delete_pods": lambda names: [store.delete("pods", n) for n in names] and None,
        "pod_report": lambda names: pod_report(store, names),
        "unschedulable_reasons": lambda names: unschedulable_reasons(store, names),
    }
    conn.send({"ok": server.url})
    try:
        while True:
            msg = conn.recv()
            op = msg.pop("op")
            if op == "stop":
                break
            try:
                conn.send({"ok": ops[op](**msg)})
            except Exception as e:  # answered to the parent, which raises it
                conn.send({"error": f"{op}: {e!r}"})
    finally:
        server.stop()
        conn.close()


class ApiServerProcess:
    """The parent's handle on ``apiserver_child``: a spawned process (it
    imports the package anew and never touches the card), ``call(op,
    **kw)`` for its answers, ``stop()`` to end it."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.process = ctx.Process(target=apiserver_child, args=(child,), daemon=True,
                                   name="apiserver")
        self.process.start()
        child.close()
        self.url = self._answer("start", 120)

    def _answer(self, op: str, timeout: float):
        if not self._conn.poll(timeout):
            raise AssertionError(f"apiserver process: no answer to {op} in {timeout} s")
        msg = self._conn.recv()
        if "error" in msg:
            raise AssertionError(f"apiserver process: {msg['error']}")
        return msg["ok"]

    def call(self, op: str, timeout: float = 120.0, **kw):
        self._conn.send({"op": op, **kw})
        return self._answer(op, timeout)

    def stop(self) -> None:
        try:
            self._conn.send({"op": "stop"})
        except (OSError, BrokenPipeError):
            pass
        self.process.join(10)
        if self.process.is_alive():
            self.process.kill()
            self.process.join(5)


def stuck_report(rt, server, names, n: int = 6) -> dict:
    """Why the first ``n`` of ``names`` are unbound: the server's view
    (node, events) beside the controller's (its cached pod's node and
    whether it is provisionable, whether the worker holds it pending, the
    selection queue's failure count for it)."""
    from karpenter_tpu_torch.utils.pod import is_provisionable

    names = list(names)[:n]
    report = server.call("pod_report", names=names)
    selection = rt.manager._controllers["selection"].queue
    workers = rt.provisioning.list_workers()
    for name in names:
        pod = rt.cluster.try_get("pods", name)
        report[name]["cache"] = (
            "gone" if pod is None else
            {"node": pod.spec.node_name, "provisionable": is_provisionable(pod),
             "pending": any(w.is_pending(pod.key) for w in workers),
             "selection_failures": selection.backoff.retries((name, pod.metadata.namespace))})
    return report


def chaos_soak(device: str = "cpu", n_pre: int = 2000, n_chaos: int = CHAOS_PODS,
               iterations: int = 12, n_types: int = 100, stall_s: float = 60.0) -> list:
    """Phase 21 (c)'s chaos storm, repeated on one runtime: a process over
    the in-repo API server (a process of its own) takes ``n_pre`` diverse
    pods, then ``iterations`` storms of ``n_chaos`` pods, each under
    ``ApiServerChaos`` 429s, two 503 PATCHes and a 3 s blackout (the
    ``i``-th seeded ``CHAOS_SEED + i``). Returns each storm's seconds to
    bind every pod and its chaos counts; raises with ``stuck_report`` when
    no pod binds for ``stall_s`` seconds. Runs on the CPU:
    ``python3 -c "import chip_smoke; print(chip_smoke.chaos_soak())"``."""
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.kube import serde
    from karpenter_tpu_torch.main import run_controller_process
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.testing import make_provisioner

    server = ApiServerProcess()
    provider = FakeCloudProvider(instance_types(n_types))
    registry.register("fake", lambda: provider)
    rt = None
    try:
        rt = run_controller_process(Options(
            kube_api_server=server.url, leader_election_lease=APISERVER_LEASE,
            launch_journal=APISERVER_JOURNAL, device=device, cloud_provider="fake",
            kube_client_qps=APISERVER_QPS, kube_client_burst=APISERVER_BURST,
            unschedulable_event_rounds=1), serve=False)
        server.call("create", kind="provisioners",
                    doc=serde.to_wire("provisioners", make_provisioner(solver="tpu")))
        deadline = time.time() + 60
        while time.time() < deadline and "default" not in rt.provisioning.workers:
            time.sleep(0.01)
        worker = rt.provisioning.workers["default"]
        worker.batcher.idle_duration = 0.2
        worker.warmed.wait(timeout=600)
        if n_pre:
            names = server.call("storm", which="diverse", n=n_pre)["names"]
            server.call("delete_pods", names=server.call(
                "wait", timeout=960, names=names, limit=900))
        out = []
        for i in range(iterations):
            server.call("chaos", throttle_rate=CHAOS_THROTTLE, retry_after=0.05,
                        seed=CHAOS_SEED + i, fail_next={"PATCH": 2})
            t0 = time.perf_counter()
            names = server.call("storm", which=f"soak{i}", n=n_chaos, seed=CHAOS_SEED + i,
                                blackout_at=n_chaos // 4, blackout_s=CHAOS_BLACKOUT_S)["names"]
            left, moved = len(names), time.perf_counter()
            while left:
                binds = server.call("state", names=names)["binds"]
                missing = [n for n, k in binds.items() if not k]
                if len(missing) < left:
                    left, moved = len(missing), time.perf_counter()
                elif time.perf_counter() - moved > stall_s:
                    raise AssertionError(
                        f"chaos soak storm {i}: {left} of {n_chaos} pods unbound for "
                        f"{stall_s:g} s; leading {rt.elector.is_leader}, controllers running "
                        f"{rt.manager.healthz()}; {stuck_report(rt, server, missing)}")
                else:
                    time.sleep(0.5)
            out.append({"storm": i, "bound_s": time.perf_counter() - t0,
                        **server.call("chaos"), "fenced": rt.elector.lease.status.fenced})
            log(f"[soak] {out[-1]}")
        return out
    finally:
        registry.register("fake", FakeCloudProvider)
        if rt is not None:
            rt.stop()
        server.stop()


RELAXED_TOLERATION = {"effect": "PreferNoSchedule", "operator": "Exists"}


def same_view(client, kind: str, timeout: float = 30.0) -> tuple:
    """Wait until ``client``'s informer cache holds what ``list_live(kind)``
    answers: every object's wire form but its resourceVersion, and but the
    PreferNoSchedule toleration that selection's relaxation adds to a
    cached pod it could not seat (in place, never written, as in the
    reference). A bind caches the caller's pod (the Binding answer carries
    no object), so a watch echo that landed first leaves the cached
    resourceVersion behind the server's, as in the reference. Returns
    (objects, cached resourceVersions behind, relaxed pods)."""
    from karpenter_tpu_torch.kube import serde

    def view(objs):
        docs = {}
        for o in objs:
            doc = serde.to_wire(kind, o)
            rv = doc["metadata"].pop("resourceVersion", None)
            exact = json.dumps(doc, sort_keys=True)
            spec = doc.get("spec") or {}
            if RELAXED_TOLERATION in (spec.get("tolerations") or []):
                spec["tolerations"] = [t for t in spec["tolerations"] if t != RELAXED_TOLERATION]
                if not spec["tolerations"]:
                    del spec["tolerations"]
            docs[(o.metadata.namespace, o.metadata.name)] = (
                json.dumps(doc, sort_keys=True), rv, exact)
        return docs

    deadline = time.time() + timeout
    while True:
        live, cached = view(client.list_live(kind)), view(client.list(kind))
        differ = sorted(k for k in set(live) | set(cached)
                        if live.get(k, (None,))[0] != cached.get(k, (None,))[0])
        if not differ:
            return (len(live), sum(live[k][1] != cached[k][1] for k in live),
                    sum(live[k][2] != cached[k][2] for k in live))
        if time.time() > deadline:
            raise AssertionError(f"apiserver: the informer cache of {kind} differs from "
                                 f"list_live ({len(cached)} cached, {len(live)} live, "
                                 f"{len(differ)} differ: {differ[:6]})")
        time.sleep(0.1)


def apiserver_phase(card: str, device: str = "cuda", n_pods: int = STORM_PODS,
                    n_types: int = 400, chaos_pods: int = CHAOS_PODS,
                    standing: int = STANDING_NODES, solve_pods: int = 10000) -> dict:
    """Phase 21: the process over the in-repo API server. (a) the headline
    storm through run_controller_process over an ApiCluster, (b) one solve
    per kernel through an ApiCluster at full width, (c) chaos during a
    storm, (d) two electors on one Lease, (e) consolidation over the API
    server. Returns the kernels line's ``apiserver`` entries."""
    import torch

    from karpenter_tpu_torch.api.objects import OwnerReference, PodCondition
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.fake import (FakeCloudProvider, instance_types,
                                                         instance_types_tradeoff)
    from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
    from karpenter_tpu_torch.kube import serde
    from karpenter_tpu_torch.kube.apiserver import ApiCluster
    from karpenter_tpu_torch.kube.leader import KubeLease
    from karpenter_tpu_torch.kube.testserver import TestApiServer
    from karpenter_tpu_torch.main import build_runtime, run_controller_process
    from karpenter_tpu_torch.options import Options
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods, make_daemonset, make_pod, make_provisioner
    from karpenter_tpu_torch.testing.chaos import ApiServerChaos
    from karpenter_tpu_torch.testing.factories import make_node
    from karpenter_tpu_torch.utils.lease import LeaderElector
    from karpenter_tpu_torch.api import labels as lbl

    V1, V2 = "pack_first_fit", "pack_first_fit_v2"
    modules = {V1: pack_kernel, V2: pack_kernel_v2}
    out = {V1: {}, V2: {}, "summary": {}}
    t_phase = time.perf_counter()

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    def delta(start: dict) -> dict:
        return {name: n - start[name] for name, n in counts().items()}

    def note(label: str, launches: dict) -> None:
        for name, n in launches.items():
            if n:
                out[name][f"launches_{label}"] = out[name].get(f"launches_{label}", 0) + n

    def stop_clients(*clients) -> None:
        for c in clients:
            c.stop()

    # -- (a) run_controller_process over the API server -------------------
    server = ApiServerProcess()
    provider = FakeCloudProvider(instance_types(n_types))
    registry.register("fake", lambda: provider)
    # a pod no launch can seat (the headline's hostname-affinity pods whose
    # peers an earlier batch bound) gets its PodUnschedulable event after
    # one round
    opts = Options(kube_api_server=server.url, leader_election_lease=APISERVER_LEASE,
                   launch_journal=APISERVER_JOURNAL, device=device, cloud_provider="fake",
                   kube_client_qps=APISERVER_QPS, kube_client_burst=APISERVER_BURST,
                   unschedulable_event_rounds=1)
    rt, stopped = None, False
    try:
        t0 = time.perf_counter()
        try:
            rt = run_controller_process(opts, serve=False)
        finally:
            registry.register("fake", FakeCloudProvider)
        started_s = time.perf_counter() - t0
        cluster = rt.cluster
        if not isinstance(cluster, ApiCluster) or not isinstance(rt.elector.lease, KubeLease):
            raise AssertionError(f"apiserver (a): runtime over {type(cluster).__name__}, "
                                 f"lease {type(rt.elector.lease).__name__}")
        holder = server.call("lease_holder", name="karpenter-leader-election",
                             namespace="kube-system")
        if not rt.elector.is_leader or holder != rt.elector.lease.identity:
            raise AssertionError(f"apiserver (a): the runtime does not hold the Lease ({holder!r})")
        start = counts()
        server.call("create", kind="provisioners",
                    doc=serde.to_wire("provisioners", make_provisioner(solver="tpu")))
        deadline = time.time() + 60
        while time.time() < deadline and "default" not in rt.provisioning.workers:
            time.sleep(0.01)
        worker = rt.provisioning.workers["default"]
        worker.batcher.idle_duration = 0.2
        if not worker.warmed.wait(timeout=600):
            raise AssertionError("apiserver (a): the warm-up never finished")
        warm = worker.scheduler.torch.completed_profile()
        if warm.get("packer_backend") not in (V1, V2):
            raise AssertionError(f"apiserver (a): warm-up served by {warm.get('packer_backend')!r}")
        warm_launches = delta(start)
        expect_launches("apiserver a, warm-up", warm_launches,
                        {warm["packer_backend"]: warm.get("pack_dispatches", 0)})
        rounds = []
        record_rounds(worker, rounds)
        requests_before, kube_before = server.call("requests"), kube_counters()
        storm_start = counts()
        t0 = time.perf_counter()
        created = server.call("storm", which="diverse", n=n_pods)
        names = created["names"]
        stuck = server.call("wait", timeout=660, names=names, limit=600)
        wall = time.perf_counter() - t0
        storm_launches = delta(storm_start)
        seated = [n for n in names if n not in set(stuck)]
        st = server.call("state", names=names)
        twice = {n: k for n, k in st["binds"].items() if k > 1 or (k == 0 and n in seated)}
        posts = {n: st["posts"][n] for n in seated if st["posts"][n] != 1}
        if twice or st["flips"] or posts:
            raise AssertionError(f"apiserver (a): binds {list(twice.items())[:5]}, flips "
                                 f"{st['flips'][:5]}, binding POSTs {list(posts.items())[:5]}")
        launched = check_rounds(rounds, {V1, V2}, "apiserver (a)")
        expect_launches("apiserver a, storm", storm_launches, launched)
        planned = sum(r["nodes"] for r in rounds)
        nodes = server.call("nodes")
        made = sorted(i.id for i in provider.list_instances())
        if not (planned == len(nodes) == len(provider.create_calls)) or nodes != made:
            raise AssertionError(f"apiserver (a): {planned} virtual nodes, {len(nodes)} Nodes on "
                                 f"the server, {len(provider.create_calls)} cloud creates")
        cached = {k: same_view(cluster, k) for k in ("pods", "nodes")}
        requests = counters_delta(requests_before, server.call("requests"))
        kube = counters_delta(kube_before, kube_counters())
        lat = st["latencies"]
        p50 = lat[len(lat) // 2]
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        for i, r in enumerate(rounds):
            log(f"[apiserver] (a) round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"unplaced {r['unplaced']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']}), "
                f"SCHEDULING_DURATION {r['scheduling_ms']:.3f} ms")
        log(f"[apiserver] (a) run_controller_process(--kube-api-server {server.url} (the "
            f"in-repo API server, a process of its own), --leader-election-lease "
            f"{APISERVER_LEASE}, --launch-journal {APISERVER_JOURNAL}, --kube-client-qps "
            f"{APISERVER_QPS:g}, --kube-client-burst {APISERVER_BURST}, --device {device}): "
            f"informers synced and leading in {started_s:.3f} s; warm-up "
            f"{warm['packer_backend']} ({warm_launches}); storm of {n_pods} diverse pods created "
            f"in the server's store ({created['enqueue_s']:.3f} s) and seen through the watch: "
            f"{len(seated)} bound, {len(stuck)} with a PodUnschedulable event; create->bind "
            f"p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms, {len(seated) / wall:.1f} bound "
            f"pods/s, wall {wall:.3f} s; {len(rounds)} rounds, launches {storm_launches}; every "
            f"bound pod bound once through one binding POST; {len(nodes)} Nodes on the server "
            f"= {planned} virtual nodes = {len(provider.create_calls)} cloud creates; informer "
            f"cache == list_live but for resourceVersions and relaxed pods' tolerations "
            f"(objects, resourceVersions behind, relaxed) {cached}; REST requests {dict(sorted(requests.items()))}; transport {kube}; card "
            f"{card}")
        note("a", {k: warm_launches[k] + storm_launches[k] for k in warm_launches})
        out["summary"]["a"] = {
            "pods": n_pods, "bound": len(seated), "unschedulable": len(stuck),
            "rounds": len(rounds), "batches": [r["pods"] for r in rounds],
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "pods_per_s": len(seated) / wall,
            "wall_s": wall, "nodes": len(nodes), "started_s": started_s,
            "requests": requests, "transport": kube, "cache_vs_live": cached,
            "qps": APISERVER_QPS, "burst": APISERVER_BURST}
        # the pods no launch can seat leave the cluster: every later round
        # would re-solve them and re-post their events
        server.call("delete_pods", names=stuck)

        # -- (c) chaos during a storm through the same runtime --------------
        fenced = []
        stop_probe = threading.Event()

        def probe_fence():
            while not stop_probe.is_set():
                if rt.elector.lease.status.fenced or not rt.elector.is_leader:
                    fenced.append(time.perf_counter())
                stop_probe.wait(0.02)

        probe = threading.Thread(target=probe_fence, daemon=True)
        probe.start()
        rounds.clear()
        creates_before = len(provider.create_calls)
        requests_before, kube_before = server.call("requests"), kube_counters()
        start = counts()
        # the two next PATCHes answer 503 (the round's lastScaleTime and the
        # counter's status patches are PATCHes): the mutate class retries
        server.call("chaos", throttle_rate=CHAOS_THROTTLE, retry_after=0.05, seed=CHAOS_SEED,
                    fail_next={"PATCH": 2})
        t0 = time.perf_counter()
        try:
            created = server.call("storm", which="chaos", n=chaos_pods, seed=CHAOS_SEED,
                                  blackout_at=chaos_pods // 4, blackout_s=CHAOS_BLACKOUT_S)
            names = created["names"]
            try:
                left = server.call("wait", timeout=360, names=names, limit=300)
            except AssertionError as e:
                missing = [n for n, k in server.call("state", names=names)["binds"].items()
                           if not k]
                raise AssertionError(
                    f"{e}; leading {rt.elector.is_leader}, fenced "
                    f"{rt.elector.lease.status.fenced}, controllers running "
                    f"{rt.manager.healthz()}, fenced or not leading at {len(fenced)} probes; "
                    f"{len(missing)} unbound, the first: "
                    f"{stuck_report(rt, server, missing)}; rounds (batch, nodes, unplaced) "
                    f"{[(r['pods'], r.get('nodes'), r.get('unplaced')) for r in rounds]}; "
                    f"PodUnschedulable events "
                    f"{server.call('unschedulable_reasons', names=names)}") from None
        finally:
            injected = server.call("chaos")
            stop_probe.set()
            probe.join(5)
        wall_c = time.perf_counter() - t0
        chaos_launches = delta(start)
        launched = check_rounds(rounds, {V1, V2}, "apiserver (c)")
        expect_launches("apiserver c", chaos_launches, launched)
        st = server.call("state", names=names)
        twice = {n: k for n, k in st["binds"].items() if k != 1}
        requests = counters_delta(requests_before, server.call("requests"))
        kube = counters_delta(kube_before, kube_counters())
        creates = provider.create_calls[creates_before:]
        tokens = [r.launch_token for r in creates]
        retries = sum(v for k, v in kube.items() if k.startswith("retries_"))
        throttled = kube.get("throttled_server", 0)
        if left or twice or st["flips"] or len(set(tokens)) != len(tokens) or fenced:
            raise AssertionError(f"apiserver (c): unbound {left[:5]}, binds "
                                 f"{list(twice.items())[:5]}, flips {st['flips'][:5]}, "
                                 f"{len(tokens) - len(set(tokens))} repeated launch tokens, "
                                 f"fenced or not leading at {len(fenced)} probes")
        if retries <= 0 or throttled <= 0 or not injected["dropped"]:
            raise AssertionError(f"apiserver (c): retries {retries}, throttles {throttled}, "
                                 f"chaos {injected}")
        for i, r in enumerate(rounds):
            log(f"[apiserver] (c) round {i}: batch {r['pods']}, nodes {r['nodes']}, "
                f"unplaced {r['unplaced']}, "
                f"{r['backend']} ({r['route']}, dispatches {r['dispatches']})")
        lat = st["latencies"]
        log(f"[apiserver] (c) ApiServerChaos(throttle_rate={CHAOS_THROTTLE}, retry_after=0.05, "
            f"seed={CHAOS_SEED}), fail_next('PATCH', 2) and a {CHAOS_BLACKOUT_S:g} s blackout "
            f"during a storm of "
            f"{chaos_pods} pods: all bound in {wall_c:.3f} s (p50 {lat[len(lat) // 2] * 1e3:.1f} "
            f"ms, p99 {lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.1f} ms), every pod "
            f"bound once, no pod on two nodes, {len(creates)} cloud creates with "
            f"{len(set(tokens))} distinct launch tokens, the leader never fenced nor lost the "
            f"Lease; chaos {injected}; transport {kube}; REST requests "
            f"{dict(sorted(requests.items()))}; launches {chaos_launches}; card {card}")
        note("c", chaos_launches)
        out["summary"]["c"] = {"pods": chaos_pods, "wall_s": wall_c, "rounds": len(rounds),
                               "chaos": injected, "transport": kube, "creates": len(creates)}

        # the launches that chaos failed after their cloud create left
        # journal entries: the process's own garbage collector settles them
        # (adopt or confirm never launched), swept at once here instead of
        # after its 120 s replay floor
        from karpenter_tpu_torch.controllers.garbage_collection import GC_POLL_KEY

        open_after_c = server.call("journal_open", prefix="launch")
        gc_before = (rt.garbage_collection.adopted, rt.garbage_collection.replays,
                     rt.garbage_collection.leaks_terminated)
        if open_after_c:
            rt.garbage_collection.replay_after = 0.0
            rt.garbage_collection.reconcile(GC_POLL_KEY)
        gc_after = (rt.garbage_collection.adopted, rt.garbage_collection.replays,
                    rt.garbage_collection.leaks_terminated)
        leaked = sorted({i.id for i in provider.list_instances()} - set(server.call("nodes")))
        if leaked:
            raise AssertionError(f"apiserver (c): instances without a Node after the GC sweep: "
                                 f"{leaked[:5]}")
        log(f"[apiserver] (c) {open_after_c} journal entries open after the chaos storm (launches "
            f"that chaos failed after their cloud create); one GC sweep: adopted/replays/leaks "
            f"{gc_before} -> {gc_after}, {server.call('journal_open', prefix='launch')} open, "
            f"every cloud instance has its Node")
        out["summary"]["c"]["journal_open"] = open_after_c
        out["summary"]["c"]["adopted"] = gc_after[0] - gc_before[0]

        # -- rt.stop(): the Lease released, no journal entry open ----------
        t0 = time.perf_counter()
        rt.stop()
        stopped = True
        stop_s = time.perf_counter() - t0
        holder = server.call("lease_holder", name="karpenter-leader-election",
                             namespace="kube-system")
        open_entries = server.call("journal_open", prefix="launch")
        if holder or open_entries:
            raise AssertionError(f"apiserver (a): after stop the Lease is held by {holder!r}, "
                                 f"{open_entries} journal entries open")
        log(f"[apiserver] (a) rt.stop() in {stop_s:.3f} s released the Lease (holder '') and "
            f"left 0 journal entries open on the server")
        out["summary"]["a"]["stop_s"] = stop_s
    finally:
        if rt is not None and not stopped:
            rt.stop()
        server.stop()
    del rt, cluster, provider

    # -- (b) one solve per kernel through an ApiCluster at full width ------
    server = TestApiServer()
    server.start()
    client = ApiCluster(server.url, qps=APISERVER_QPS, burst=APISERVER_BURST)
    try:
        rng = random.Random(7)
        # cpu only: a memory request would add a resource axis and take the
        # team mix's v2 tables past V2_TABLE_BUDGET (the shape rule's v1)
        server.cluster.create("daemonsets", make_daemonset(name="node-agent",
                                                           requests={"cpu": "0.1"}))
        for i in range(standing):
            node = make_node(name=f"standing-{i}", provisioner_name="default",
                             capacity={"cpu": "16", "memory": "32Gi", "pods": "100"},
                             labels={lbl.INSTANCE_TYPE: f"fake-it-{rng.randrange(300, 400)}",
                                     lbl.TOPOLOGY_ZONE: f"test-zone-{1 + i % 3}",
                                     lbl.CAPACITY_TYPE: "on-demand"})
            server.cluster.create("nodes", node)
            for j in range(rng.randrange(1, 4)):
                server.cluster.create("pods", make_pod(
                    name=f"bound-{i}-{j}", labels={"app": f"a{j}"},
                    requests={"cpu": f"{rng.choice([0.5, 1, 2])}"},
                    node_name=node.metadata.name, unschedulable=False))
        t0 = time.perf_counter()
        client.start()
        if not client.wait_for_sync(60):
            raise AssertionError("apiserver (b): the informers never synced")
        sync_s = time.perf_counter() - t0
        cases = (("headline", V1, make_provisioner(solver="tpu"), instance_types(n_types),
                  diverse_pods(solve_pods)),
                 ("team mix", V2, make_provisioner(solver="tpu"),
                  instance_types_tradeoff(n_types), team_pods(solve_pods, 9)))
        parts = {}
        for label, kernel, prov, catalog, batch in cases:
            start = counts()
            sched = Scheduler(client, rng=random.Random(1), device=device)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalog, batch)
            if device != "cpu":
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof = sched.last_stage_profile()
            got = delta(start)
            if prof.get("packer_backend") != kernel or prof.get("pack_dispatches") != 1 \
                    or got[kernel] != 1:
                raise AssertionError(f"apiserver (b) {label}: served by "
                                     f"{prof.get('packer_backend')!r}, launches {got}")
            cpu_sched = Scheduler(client, rng=random.Random(1), device="cpu")
            cpu_nodes = cpu_sched.solve(prov, catalog, batch)
            not_degraded(cpu_sched, f"apiserver (b) {label} cpu plan")
            if plan_of(nodes, batch) != plan_of(cpu_nodes, batch):
                raise AssertionError(f"apiserver (b) {label}: the card's plan differs from the "
                                     f"device='cpu' plan over the same ApiCluster")
            note(f"b_{label.replace(' ', '_')}", got)
            parts[label] = {"nodes": len(nodes), "wall_ms": wall_ms, "kernel": kernel}
            log(f"[apiserver] (b) {label}: {len(batch)} pods over an ApiCluster holding "
                f"{len(client.nodes())} nodes, {len(client.pods())} bound pods and a daemonset "
                f"(informers synced in {sync_s:.3f} s): {kernel} ({prof.get('pack_route')}), one "
                f"launch; {len(nodes)} nodes == the device='cpu' plan pod for pod; round "
                f"{wall_ms:.3f} ms: {stage_line(prof)}; card {card}")
        out["summary"]["b"] = parts
    finally:
        client.stop()
        server.stop()

    # -- (d) two electors on one Lease, then a blackout past expiry --------
    chaos = ApiServerChaos(seed=CHAOS_SEED)
    server = TestApiServer()
    server.start()
    clients = [ApiCluster(server.url, kinds=()) for _ in range(2)]
    electors = [LeaderElector(KubeLease(c, name="phase21-lead", identity=name,
                                        duration=KUBE_LEASE_S), renew_interval=0.1)
                for c, name in zip(clients, ("a", "b"))]
    try:
        for e in electors:
            e.start()
        deadline = time.time() + 10
        while time.time() < deadline and not any(e.is_leader for e in electors):
            time.sleep(0.01)
        time.sleep(0.5)
        leaders = [e.is_leader for e in electors]
        if sum(leaders) != 1:
            raise AssertionError(f"apiserver (d): leaders {leaders}")
        leader, other = electors[leaders.index(True)], electors[1 - leaders.index(True)]
        t0 = time.perf_counter()
        leader.stop()
        took = other.wait_for_leadership(timeout=KUBE_LEASE_S + 1.0)
        takeover_s = time.perf_counter() - t0
        if not took or takeover_s > KUBE_LEASE_S:
            raise AssertionError(f"apiserver (d): takeover {took} after {takeover_s:.3f} s")
        server.chaos = chaos
        t0 = time.perf_counter()
        chaos.blackout(KUBE_LEASE_S * 2)
        deadline = time.time() + KUBE_LEASE_S * 2
        while time.time() < deadline and not other.lease.status.fenced:
            time.sleep(0.01)
        fenced_s = time.perf_counter() - t0
        if not other.lease.status.fenced:
            raise AssertionError("apiserver (d): a blackout past expiry never fenced the holder")
        while chaos.in_blackout():
            time.sleep(0.01)
        t1 = time.perf_counter()
        deadline = time.time() + 10
        while time.time() < deadline and (other.lease.status.fenced or not other.is_leader):
            time.sleep(0.01)
        lifted_s = time.perf_counter() - t1
        if other.lease.status.fenced or not other.is_leader:
            raise AssertionError("apiserver (d): recovery did not lift the fence")
    finally:
        for e in electors:
            e.stop()
        stop_clients(*clients)
        server.stop()
    log(f"[apiserver] (d) two LeaderElectors over KubeLeases on one Lease (duration "
        f"{KUBE_LEASE_S:g} s, renew 0.1 s), each its own ApiCluster: exactly one led; it stopped "
        f"and the other led {takeover_s * 1e3:.1f} ms later; a {KUBE_LEASE_S * 2:g} s blackout "
        f"fenced the holder after {fenced_s:.3f} s (chaos dropped {chaos.counts(chaos.dropped)} "
        f"requests) and the first answer after it lifted the fence and the lead in "
        f"{lifted_s * 1e3:.1f} ms")
    out["summary"]["d"] = {"takeover_s": takeover_s, "fenced_after_s": fenced_s,
                           "lifted_s": lifted_s}

    # -- (e) consolidation over the API server ------------------------------
    server = TestApiServer()
    rest = RestCounter()
    server.chaos = rest
    server.start()
    provider = FakeCloudProvider(instance_types(n_types))
    kubectl = ApiCluster(server.url, kinds=("pods",))
    controller = ApiCluster(server.url)
    rt = None
    try:
        kubectl.start()
        controller.start()
        if not (kubectl.wait_for_sync(30) and controller.wait_for_sync(30)):
            raise AssertionError("apiserver (e): the informers never synced")
        rt = build_runtime(Options(device=device), cluster=controller, cloud_provider=provider)
        rt.manager.start()
        recreated = []

        def recreate(event, pod):
            if event != "DELETED" or not pod.metadata.labels.get("workload"):
                return
            if pod.metadata.name in recreated:
                return
            recreated.append(pod.metadata.name)
            kubectl.create("pods", make_pod(name=f"{pod.metadata.name}-r",
                                            labels=dict(pod.metadata.labels),
                                            requests={"cpu": "1"}))

        kubectl.watch("pods", recreate)
        server.cluster.create("provisioners", make_provisioner(solver="tpu"))
        deadline = time.time() + 60
        while time.time() < deadline and "default" not in rt.provisioning.workers:
            time.sleep(0.01)
        worker = rt.provisioning.workers["default"]
        if not worker.warmed.wait(timeout=600):
            raise AssertionError("apiserver (e): the warm-up never finished")
        worker.batcher.idle_duration = 0.1
        rounds = []
        record_rounds(worker, rounds)
        owner = OwnerReference(api_version="apps/v1", kind="ReplicaSet", name="w")
        victims = []
        for i in range(CONSOLIDATION_NODES):
            node = make_node(name=f"old-{i}", provisioner_name="default",
                             capacity={"cpu": "64", "memory": "256Gi", "pods": "100"},
                             labels={lbl.INSTANCE_TYPE: f"fake-it-{n_types - 1}",
                                     lbl.TOPOLOGY_ZONE: "test-zone-1",
                                     lbl.CAPACITY_TYPE: "on-demand"},
                             finalizers=[lbl.TERMINATION_FINALIZER])
            node.status.conditions = [PodCondition(type="Ready", status="True")]
            server.cluster.create("nodes", node)
            for j in range(2):
                p = make_pod(name=f"w-{i}-{j}", labels={"workload": "a"}, requests={"cpu": "1"},
                             node_name=node.metadata.name, unschedulable=False, owner=owner)
                server.cluster.create("pods", p)
                victims.append(p.metadata.name)
        deadline = time.time() + 30
        while time.time() < deadline and (
                sum(n.metadata.name.startswith("old-") for n in controller.nodes())
                < CONSOLIDATION_NODES
                or sum(p.metadata.name.startswith("w-") for p in controller.pods())
                < len(victims)):
            time.sleep(0.02)
        consolidation = ConsolidationController(controller, provider, device=device)
        if consolidation.migration != "evict":
            raise AssertionError(f"apiserver (e): migration {consolidation.migration!r} on an "
                                 f"ApiCluster")
        start = counts()
        requests_before = rest.snapshot()
        t0 = time.perf_counter()
        plan = consolidation.plan(controller.get("provisioners", "default", namespace=""))
        plan_ms = (time.perf_counter() - t0) * 1e3
        plan_launches = delta(start)
        if not plan.worthwhile or sum(plan_launches.values()) < 1:
            raise AssertionError(f"apiserver (e): plan worthwhile {plan.worthwhile}, launches "
                                 f"{plan_launches}")
        launched_nodes = consolidation.execute(plan)
        replaced = [f"{n}-r" for n in victims]
        deadline = time.time() + 120
        while time.time() < deadline and (
                any(n.metadata.name.startswith("old-") for n in server.cluster.nodes())
                or not all((p := server.cluster.try_get("pods", n)) is not None
                           and p.spec.node_name for n in replaced)):
            time.sleep(0.05)
        settle_s = time.perf_counter() - t0
        left = [n.metadata.name for n in server.cluster.nodes() if n.metadata.name.startswith("old-")]
        unbound = [p.metadata.name for p in server.cluster.pods() if not p.spec.node_name]
        if left or unbound or len(recreated) != len(victims):
            raise AssertionError(f"apiserver (e): old nodes {left}, unbound {unbound[:5]}, "
                                 f"{len(recreated)} of {len(victims)} recreated")
        got = delta(start)
        launched = check_rounds(rounds, {V1, V2}, "apiserver (e)")
        replacement = {k: got[k] - plan_launches[k] for k in got}
        expect_launches("apiserver e, replacement", replacement, launched)
        if not sum(replacement.values()):
            raise AssertionError("apiserver (e): the replacement plan never ran on the card")
        requests = counters_delta(requests_before, rest.snapshot())
        if requests.get("POST eviction", 0) < len(victims):
            raise AssertionError(f"apiserver (e): {requests.get('POST eviction', 0)} evictions "
                                 f"for {len(victims)} pods")
        log(f"[apiserver] (e) ConsolidationController(migration=None) over an ApiCluster picked "
            f"{consolidation.migration!r}; plan of {len(plan.nodes)} under-used nodes in "
            f"{plan_ms:.3f} ms ({plan_launches}, worthwhile, {plan.current_price:.4f} -> "
            f"{plan.proposed_price:.4f} $/h), execute pre-launched {len(launched_nodes)}; "
            f"{requests.get('POST eviction', 0)} evictions through the eviction subresource, "
            f"{len(recreated)} pods recreated and bound by {len(rounds)} card rounds "
            f"({replacement}); every pod bound, old nodes gone in {settle_s:.3f} s; card {card}")
        note("e_plan", plan_launches)
        note("e_replacement", replacement)
        out["summary"]["e"] = {"plan_ms": plan_ms, "settle_s": settle_s,
                               "evictions": requests.get("POST eviction", 0),
                               "rounds": len(rounds)}
    finally:
        if rt is not None:
            rt.stop()
        stop_clients(kubectl, controller)
        server.stop()

    phase_s = time.perf_counter() - t_phase
    out["summary"]["phase_s"] = phase_s
    log(f"[apiserver] phase 21 wall {phase_s:.3f} s; card {card}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gc_hook = log_gc_pauses()

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner
    from karpenter_tpu_torch.testing.factories import make_pod
    from karpenter_tpu_torch.api.objects import LabelSelector, PodAffinityTerm
    from karpenter_tpu_torch.api import labels as lbl

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # every phase runs the default packer unless it says otherwise: on the
    # card that is the device path, routed by shape
    os.environ.pop("KARPENTER_PACKER", None)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = pack_kernel.build()
    log(f"[build] {', '.join(sorted(libs))} built in {time.perf_counter() - t0:.2f}s")
    for name in sorted(libs):
        for line in pack_kernel.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2. kernel against its plain version ------------------------------
    t0 = time.perf_counter()
    batch = headline_batch(10000, 400, 42)
    P = len(batch.pod_valid)
    S, C = batch.join_table.shape
    F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
    log(f"[parity] headline batch P={P} S={S} F={F} R={R} C={C} "
        f"T={batch.usable.shape[0]} U={batch.uniq_req.shape[0]} "
        f"hostnames={len(batch.hostnames)} (encoded in {time.perf_counter() - t0:.2f}s)")
    gpu = kernel_inputs(batch, dev)
    cpu = tuple(a.cpu() for a in gpu)
    worst = 0.0
    results = {}
    for n_max in (512, P, 64):
        out = pack_kernel.pack_first_fit(*gpu, n_max=n_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pack_reference(*cpu, n_max=n_max)
        cpu_s = time.perf_counter() - t0
        worst = max(worst, compare(ref, out))
        results[n_max] = out
        log(f"[parity] headline n_max={n_max}: bit-exact, nodes={int(out.n_nodes)} "
            f"unscheduled={int((out.assignment[: batch.n_pods] < 0).sum())} "
            f"(plain version on CPU {cpu_s:.2f}s)")
    if int(results[64].n_nodes) != 64:
        raise AssertionError("n_max=64 did not saturate the node table")

    rng = np.random.default_rng(7)
    Ps, Ss, Fs, Rs, Cs, H = 4096, 200, 8, 4, 16, 120
    host = np.where(rng.random(Ps) < 0.5, rng.integers(0, H, Ps), -1)
    hib = rng.random(Ps) < 0.7
    frontiers = rng.uniform(2.0, 8.0, (Ss, Fs, Rs))
    frontiers[:, Fs // 2:, :] = -1.0
    open_sig_by_core = rng.integers(0, Ss, Cs)
    core = rng.integers(0, Cs, Ps)
    synth = (
        torch.tensor(rng.random(Ps) < 0.95),
        torch.tensor(open_sig_by_core[core], dtype=torch.int32),
        torch.tensor(core, dtype=torch.int32),
        torch.tensor(host, dtype=torch.int32),
        torch.tensor(hib),
        torch.tensor(np.where(host >= 0, np.where(hib, host, -2), -1), dtype=torch.int32),
        torch.tensor(rng.uniform(0.1, 1.5, (Ps, Rs)), dtype=torch.float32),
        torch.tensor(rng.integers(-1, Ss, (Ss, Cs)), dtype=torch.int32),
        torch.tensor(frontiers, dtype=torch.float32),
        torch.tensor(rng.uniform(0.0, 0.5, Rs), dtype=torch.float32),
    )
    for n_max in (1024, Ps):
        out = pack_kernel.pack_first_fit(*(a.to(dev) for a in synth), n_max=n_max)
        torch.cuda.synchronize()
        worst = max(worst, compare(pack_reference(*synth, n_max=n_max), out))
        hosts = set(out.node_host[: int(out.n_nodes)].tolist())
        log(f"[parity] synthetic P={Ps} S={Ss} F={Fs} R={Rs} C={Cs} n_max={n_max}: "
            f"bit-exact, nodes={int(out.n_nodes)} host states -2:{-2 in hosts} "
            f"-1:{-1 in hosts} h:{max(hosts) >= 0}")

    ms_512 = kernel_ms(gpu, 512, 20)
    ms_p = kernel_ms(gpu, P, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pack_reference(*gpu, n_max=512)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare(plain, results[512]))
    n_bytes, n_ops = v1_work(gpu, results[512])
    bound_ms, bound_by = bound(n_bytes, n_ops)
    bound_p, _ = bound(*v1_work(gpu, results[P]))
    log(f"[parity] kernel {ms_512:.4f} ms at n_max=512 ({ms_512 * 1e6 / P:.1f} ns per pod "
        f"step), {ms_p:.4f} ms at n_max={P} (CUDA events, mean of 20); plain version on "
        f"the card {plain_ms:.1f} ms; "
        f"bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, {n_ops} ops), "
        f"{bound_p:.6f} ms at n_max={P}; card {card}")
    sweep("pack_first_fit headline", gpu, 512, (F, R), results[512], 20, card)

    # -- 3. main path -----------------------------------------------------
    catalog = instance_types(400)
    pods = diverse_pods(10000)
    prov = make_provisioner(solver="tpu")
    sched = Scheduler(Cluster(), rng=random.Random(1))
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit", "main warm-up")
    log(f"[main] warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    cpu_nodes = cpu_sched.solve(prov, catalog, pods)
    not_degraded(cpu_sched, "main cpu plan")
    if plan_of(warm, pods) != plan_of(cpu_nodes, pods):
        raise AssertionError("cuda plan differs from the device='cpu' plan")
    if len(warm) != HEADLINE_NODES:
        raise AssertionError(f"main path opened {len(warm)} nodes, expected {HEADLINE_NODES}")
    log(f"[main] cuda plan == cpu plan ({len(cpu_nodes)} nodes, "
        f"{sum(len(n.pods) for n in cpu_nodes)} pods placed)")

    pack_kernel.launches = 0
    rounds = []
    for r in range(5):
        before = pack_kernel.launches
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit", f"main round {r}")
        if pack_kernel.launches <= before:
            raise AssertionError(f"round {r} did not launch pack_first_fit")
        rounds.append(wall)
        stages = " ".join(
            f"{k}={prof[k] * 1e3:.3f}ms"
            for k in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s")
        )
        log(f"[main] round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, dispatches={prof['pack_dispatches']}, "
            f"{stages}")
    main_launches = pack_kernel.launches
    mean = sum(rounds) / len(rounds)
    log(f"[main] 5 rounds: mean {mean * 1e3:.3f} ms, {len(pods) / mean:.1f} pods/s, "
        f"kernel launches {main_launches}; kernel alone {ms_512:.4f} ms (CUDA events); "
        f"card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    # -- 4. retry path ----------------------------------------------------
    sel = {"app": "solo"}
    term = PodAffinityTerm(label_selector=LabelSelector(match_labels=sel),
                           topology_key=lbl.HOSTNAME)
    solo = [make_pod(labels=sel, requests={"cpu": "0.25"}, pod_anti_requirements=[term])
            for _ in range(600)]
    small = instance_types(50)
    before = pack_kernel.launches
    retry_sched = Scheduler(Cluster(), rng=random.Random(1))
    retry_nodes = retry_sched.solve(prov, small, solo)
    torch.cuda.synchronize()
    prof = served(retry_sched, "pack_first_fit", "retry")
    if prof["pack_dispatches"] != 2 or pack_kernel.launches - before != 2:
        raise AssertionError(f"retry path: {prof['pack_dispatches']} dispatches, "
                             f"{pack_kernel.launches - before} launches")
    retry_cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    retry_cpu = retry_cpu_sched.solve(prov, small, solo)
    not_degraded(retry_cpu_sched, "retry cpu plan")
    if plan_of(retry_nodes, solo) != plan_of(retry_cpu, solo):
        raise AssertionError("retry path: cuda plan differs from the cpu plan")
    log(f"[retry] 600 one-per-node pods: {len(retry_nodes)} nodes, dispatches=2, "
        f"cuda == cpu")

    v2, team = diverse_phases(dev, card)
    resident = resident_phase(dev, card)
    classes = {
        "headline": {"pods": pods, "cpu_plan": plan_of(cpu_nodes, pods)},
        "team mix": team,
        "retry": {"pods": solo, "cpu_plan": plan_of(retry_cpu, solo)},
    }
    route = route_phase(dev, card, classes)

    # -- 11. degrade ------------------------------------------------------
    # every earlier phase ran healthy: nothing quarantined, screened out or
    # contradicted by a canary
    from karpenter_tpu_torch.solver import integrity

    totals = integrity.totals()
    bad = {k: totals[k] for k in ("quarantines", "screen_failures", "canary_mismatches")
           if totals[k]}
    if bad:
        raise AssertionError(f"integrity counters before phase 11: {bad}")
    log(f"[degrade] before phase 11: integrity {totals}")
    degrade = degrade_phase(card, classes)

    # -- 12. sidecar ------------------------------------------------------
    catalogs, batches = sidecar_inputs()
    sidecar = sidecar_phase(dev, card, classes, catalogs, batches)

    # -- 13. stream -------------------------------------------------------
    stream = stream_phase(dev, card, classes, catalogs, batches, sidecar["wire_ser_ms"])

    # -- 14. obs ----------------------------------------------------------
    observed = obs_phase(dev, card, classes, catalogs, batches)

    # -- 15. controller ---------------------------------------------------
    controller = controller_phase(card, gc_hook=gc_hook)

    # -- 16. deprovision --------------------------------------------------
    deprovision = deprovision_phase(card)

    # -- 17. interruption -------------------------------------------------
    interruption = interruption_phase(card)

    # -- 18. warmpool -----------------------------------------------------
    warmpool = warmpool_phase(card)

    # -- 19. telemetry ----------------------------------------------------
    telemetry = telemetry_phase(card)

    # -- 20. process ------------------------------------------------------
    process = process_phase(card)

    # -- 21. apiserver ----------------------------------------------------
    apiserver = apiserver_phase(card)

    # -- 10. kernels ------------------------------------------------------
    def sidecar_launches(name):
        return {k.replace("launches_", ""): v
                for part in (sidecar[name], stream[name]) for k, v in part.items()
                if k.startswith("launches_")}

    kernels = [{
        "name": "pack_first_fit",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + resident["pack_first_fit"],
        "launches_by_path": {"main": main_launches, "resident": resident["pack_first_fit"],
                             "route": route["pack_first_fit"]["launches_route"],
                             "obs": observed["pack_first_fit"]["launches_obs"],
                             **sidecar_launches("pack_first_fit")},
        **{k: v for k, v in route["pack_first_fit"].items() if k != "launches_route"},
        "degrade": degrade["pack_first_fit"],
        "stream": stream["pack_first_fit"],
        "obs": {**observed["pack_first_fit"], **observed["summary"]},
        "controller": {**controller["pack_first_fit"], **controller["summary"]},
        "deprovision": {**deprovision["pack_first_fit"], **deprovision["summary"]},
        "interruption": {**interruption["pack_first_fit"], **interruption["summary"]},
        "warmpool": {**warmpool["pack_first_fit"], **warmpool["summary"]},
        "telemetry": {**telemetry["pack_first_fit"], **telemetry["summary"]},
        "process": {**process["pack_first_fit"], **process["summary"]},
        "apiserver": {**apiserver["pack_first_fit"], **apiserver["summary"]},
        "max_abs_err": worst,
        "ms": ms_512,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "parity": "bit-exact",
        "ns_per_pod": ms_512 * 1e6 / P,
    }, {
        "name": "pack_first_fit_v2",
        "route": "cuda",
        "source": V2_SOURCE,
        "replaces": V2_REPLACES,
        **v2,
        "launches": v2["launches"] + resident["pack_first_fit_v2"],
        "launches_by_path": {"diverse": v2["launches"], "resident": resident["pack_first_fit_v2"],
                             "route": route["pack_first_fit_v2"]["launches_route"],
                             "obs": observed["pack_first_fit_v2"]["launches_obs"],
                             **sidecar_launches("pack_first_fit_v2")},
        **{k: v for k, v in route["pack_first_fit_v2"].items() if k != "launches_route"},
        "degrade": degrade["pack_first_fit_v2"],
        "stream": stream["pack_first_fit_v2"],
        "obs": {**observed["pack_first_fit_v2"], **observed["summary"]},
        "controller": {**controller["pack_first_fit_v2"], **controller["summary"]},
        "deprovision": {**deprovision["pack_first_fit_v2"], **deprovision["summary"]},
        "interruption": {**interruption["pack_first_fit_v2"], **interruption["summary"]},
        "warmpool": {**warmpool["pack_first_fit_v2"], **warmpool["summary"]},
        "telemetry": {**telemetry["pack_first_fit_v2"], **telemetry["summary"]},
        "process": {**process["pack_first_fit_v2"], **process["summary"]},
        "apiserver": {**apiserver["pack_first_fit_v2"], **apiserver["summary"]},
        "library_ms": None,
        "parity": "bit-exact",
    }]
    if main_launches < 5:
        raise AssertionError(f"main path launched pack_first_fit {main_launches} times")
    if v2["launches"] < 5:
        raise AssertionError(f"diverse path launched pack_first_fit_v2 {v2['launches']} times")
    if resident["pack_first_fit"] < 5 or resident["pack_first_fit_v2"] < 6:
        raise AssertionError(f"resident path launches {resident}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    gc.callbacks.remove(gc_hook)  # nothing may print after the last line
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
