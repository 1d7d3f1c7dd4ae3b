"""Provisioning: per-Provisioner workers that batch, solve, launch, and bind.

Mirrors ``pkg/controllers/provisioning``: the controller reconciles
Provisioner objects — hot-swapping an in-memory worker when the spec hash
changes, layering the live catalog's requirements in at apply — and each
worker runs batch → re-verify → get catalog → solve → parallel launch,
creating the Node object itself (pre-registration with the not-ready taint)
and binding pods directly (provisioner.go:81-181).

``device`` is where a ``solver: tpu`` provisioner's solve runs (``cuda``,
the default, or ``cpu`` for the plain PyTorch version); each worker's
``Scheduler`` builds its accelerated backend on the first such solve, so a
``solver: ffd`` provisioner needs no card. With a launch ``journal`` (the
write-ahead record of ``karpenter_tpu_torch/launch``) each launch records
its intent before the cloud create, marks the Node written, and resolves
after the bind. ``ProvisioningController.submit`` is the interruption
subsystem's hook: a released pod goes straight to the first admitting
worker. With ``warm_pool`` a worker first-fits each batch onto its
provisioner's standing speculative nodes (``controllers/warmpool.py``
launches them) and binds the hits before the solve: only the remainder
goes to ``Scheduler.solve``, and so to the card.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import (
    SOLVER_FFD,
    SOLVER_TPU,
    Provisioner,
    default_provisioner,
    validate_provisioner,
)
from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeRequest
from karpenter_tpu_torch.kube.client import Cluster, Conflict
from karpenter_tpu_torch.scheduling.ffd import VirtualNode
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.batcher import Batcher

logger = logging.getLogger("karpenter.provisioning")

# Catalog refresh period — the reference requeues every 5 minutes to pick up
# catalog drift (provisioning/controller.go:82).
REQUEUE_INTERVAL = 300.0

# How often a replica re-checks a provisioner it does NOT own: ownership can
# arrive within one lease duration of the owner's death, so the recheck must
# be of the same order (docs/fleet.md).
OWNERSHIP_RECHECK_INTERVAL = 5.0

# Wall-clock allowance for one provision round (catalog → solve → launches):
# the resilience layer's retry deadlines are capped by what remains of this,
# so a flaky control plane degrades the round as a whole instead of every
# call independently stacking its own worst case (resilience/policy.py).
PROVISION_ROUND_BUDGET = 60.0


# Re-verification between enqueue and solve (reference: provisioner.go:121-134
# and selection/controller.go:117-123 share this predicate).
is_provisionable = podutil.is_provisionable


class ProvisionerWorker:
    """One worker goroutine-equivalent per Provisioner
    (reference: provisioner.go:40-77)."""

    def __init__(
        self,
        provisioner: Provisioner,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        scheduler: Optional[Scheduler] = None,
        batcher: Optional[Batcher] = None,
        solver_service_address: Optional[str] = None,
        owned: Optional[callable] = None,
        fenced: Optional[callable] = None,
        pack_checksum: Optional[bool] = None,
        canary_rate: Optional[float] = None,
        solver_stream: Optional[bool] = None,
        solver_shm_dir: Optional[str] = None,
        solver_delta: Optional[bool] = None,
        unschedulable_event_rounds: int = 3,
        journal=None,
        device="cuda",
        warm_pool: bool = False,
    ):
        self.provisioner = provisioner
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        # decision observability (docs/decisions.md): every round lands in
        # the decision audit log; a pod failing this many CONSECUTIVE
        # rounds gets its PodUnschedulable Warning event
        self.unschedulable_event_rounds = unschedulable_event_rounds
        # the current round's decision id — Warning events emitted from
        # this worker's decision path annotate it; "" until the first
        # record lands
        self.last_decision_id = ""
        # write-ahead launch journal (launch/journal.py): intent recorded
        # BEFORE the cloud create, resolved only after the bind — the
        # breadcrumb crash recovery replays. None = journaling off.
        self.journal = journal
        # warm-pool claiming (controllers/warmpool.py): when on, each
        # round first-fits its batch onto standing speculative nodes
        # BEFORE the solver — a warm hit binds immediately instead of
        # paying the launch-to-ready latency
        self.warm_pool = warm_pool
        self.scheduler = scheduler or Scheduler(
            cluster, device=device, solver_service_address=solver_service_address,
            pack_checksum=pack_checksum, canary_rate=canary_rate,
            solver_stream=solver_stream, solver_shm_dir=solver_shm_dir,
            solver_delta=solver_delta,
        )
        # bounded, priority-aware admission (docs/overload.md): a full
        # queue sheds the oldest lowest-priority pod instead of growing
        # without limit, and the brownout ladder scales the window/sheds
        # queued low-priority work through the same hooks
        self.batcher = batcher or Batcher(
            priority_fn=podutil.priority_of, on_shed=self._on_shed
        )
        # fleet split-brain guard: does this replica still hold the shard
        # lease for this provisioner? Re-checked at solve time and again
        # immediately before every cloud create — a replica that lost its
        # lease mid-round must not launch (docs/fleet.md). Single-replica
        # deployments run with the constant-True default.
        self.owned = owned or (lambda: True)
        # partition-tolerance fence (docs/partition.md): True while the
        # apiserver has been unreachable past the shard leases' expiry
        # margin — a peer with a working control plane may own this shard
        # already, so cloud creates are refused until contact resumes
        self.fenced = fenced or (lambda: False)
        self._pending_lock = threading.Lock()
        self._pending_keys: set = set()
        # keys a failed launch re-queued THIS round: provision_once's
        # cleanup must not strip their pending state while they sit in the
        # batcher, or selection's verify requeue would re-relax preferences
        # the pods never needed to give up
        self._requeued_keys: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # set once the solver: tpu warm-up finished (success or failure) —
        # observable so tests can assert the warmup path actually runs
        self.warmed = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if self.provisioner.spec.solver == SOLVER_TPU:
            # build the solver for this catalog's dimensions (kernel build,
            # catalog tables on the card) so the first real batch doesn't
            # pay for it
            threading.Thread(target=self._warmup, daemon=True).start()

    def _warmup(self) -> None:
        try:
            # one background retry: a transient first-build failure
            # (catalog call flake) must not make the first real batch pay
            # for the build
            for attempt in (1, 2):
                try:
                    self._warmup_once()
                    return
                except Exception:
                    metrics.SOLVER_WARMUP_FAILURES.inc()
                    if attempt == 2 or self._stop.is_set():
                        logger.exception(
                            "solver warmup failed (first batch will build)"
                        )
                        return
                    logger.exception(
                        "solver warmup failed; retrying once in background"
                    )
                    self._stop.wait(1.0)
                    if self._stop.is_set():  # shutdown mustn't pay a build
                        return
        finally:
            self.warmed.set()

    def _warmup_once(self) -> None:
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller
        from karpenter_tpu_torch.testing.factories import make_pod

        reconciling_controller.set("provisioning")

        instance_types = self.cloud_provider.get_instance_types(
            self.provisioner.spec.constraints.provider
        )
        # on the card, warm the FULL batch bucket (the batcher caps batches
        # at max_items, so the first event storm solves in that shape
        # bucket); a device="cpu" scheduler keeps the small bucket, its
        # plain version at 2048 pods is too slow
        n_warm = self.batcher.max_items if self.scheduler.device.type == "cuda" else 4
        pods = [make_pod(requests={"cpu": "0.1"}) for _ in range(n_warm)]
        self.scheduler.solve(self.provisioner, instance_types, pods)
        logger.debug(
            "solver warmed for provisioner %s (%d-pod bucket)",
            self.provisioner.name, n_warm,
        )

    def stop(self) -> None:
        self._stop.set()
        self.batcher.stop()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller

        reconciling_controller.set("provisioning")
        while not self._stop.is_set():
            try:
                self.provision_once()
            except Exception:
                logger.exception("provisioning loop error")

    # -- API ---------------------------------------------------------------
    def add(self, pod: Pod) -> threading.Event:
        """Enqueue a pod; returns the gate the selection reconciler MAY block
        on (reference: provisioner.go:77-79). The pod's key is tracked as
        pending until its batch has been solved, so a non-blocking selection
        can tell "awaiting its batch" from "needs another round"."""
        with self._pending_lock:
            self._pending_keys.add(pod.key)
        return self.batcher.add(pod)

    def is_pending(self, key) -> bool:
        """Is this pod enqueued or in the batch currently being solved?"""
        with self._pending_lock:
            return key in self._pending_keys

    def _on_shed(self, pod: Pod, reason: str) -> None:
        """Batcher shed hook: clear the pod's pending state — selection's
        periodic requeue re-submits it once capacity recovers — and
        surface the drop as a Warning event so every shed is auditable."""
        key = getattr(pod, "key", None)
        if key is None:
            return
        with self._pending_lock:
            self._pending_keys.discard(key)
            self._requeued_keys.discard(key)
        from karpenter_tpu_torch.kube.events import recorder_for

        recorder_for(self.cluster).event(
            "Provisioner", self.provisioner.name, "PodShed",
            f"pod {key} shed from the admission queue ({reason}); it "
            "re-enters selection when capacity recovers", type="Warning",
            decision_id=self.last_decision_id,
        )

    # -- the provision loop ------------------------------------------------
    def provision_once(self) -> List[VirtualNode]:
        # flush unconditionally so gate waiters never stall on a failed solve
        # (reference: provisioner.go:84 `defer p.batcher.Flush()`)
        batch_keys = ()
        try:
            pods, _window = self.batcher.wait()
            batch_keys = {p.key for p in pods}
            return self._provision_batch(pods, _window)
        finally:
            with self._pending_lock:
                # fast-requeued pods are back in the batcher: keep them
                # pending so is_pending() holds through the next round
                self._pending_keys -= set(batch_keys) - self._requeued_keys
                self._requeued_keys.clear()
            self.batcher.flush()

    def _provision_batch(self, pods: List[Pod], window: float) -> List[VirtualNode]:
        from karpenter_tpu_torch import obs

        # the round's root span starts AFTER the batcher hands over its
        # window (the idle wait is not latency anyone is owed); the
        # admission window happened BEFORE this span existed, so it rides
        # along as an attribute — a backdated child record would put an
        # interval outside the parent and corrupt self-time attribution
        with obs.tracer().span(
            "provision.round",
            attrs={
                "provisioner": self.provisioner.name,
                "batch": len(pods),
                "admission_window_s": round(max(window, 0.0), 6),
            },
        ) as round_sp:
            # dedupe by key: watch-event storms and verify requeues can
            # enqueue the same (or a replaced) pod object twice; double
            # inclusion would double its requests in the solve. Keep the
            # LATEST object per key (a replaced watch object carries the
            # freshest spec, e.g. after preference relaxation) at the
            # FIRST occurrence's position (stable FFD input order).
            latest = {}
            key_order = []
            for p in pods:
                if not is_provisionable(p):
                    continue
                if p.key not in latest:
                    key_order.append(p.key)
                latest[p.key] = p
            pods = [latest[k] for k in key_order]
            if not pods:
                return []
            if self.fenced():
                # apiserver unreachable past lease expiry: a peer may own
                # this shard already — launching now is the split-brain the
                # fence exists to prevent (docs/partition.md)
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="fenced"
                ).inc()
                round_sp.set_attribute("skipped", "fenced")
                return []
            if not self.owned():
                # shard lease gone: the new owner's selection loop re-routes
                # these pods to ITS worker — solving here would race its
                # launches (pending state clears in provision_once's finally)
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="lost_ownership"
                ).inc()
                round_sp.set_attribute("skipped", "lost_ownership")
                return []
            if self.warm_pool:
                # warm-hit steal BEFORE the solver: pods that fit standing
                # speculative capacity bind now; only the remainder pays
                # for a solve + cold launch
                pods = self._steal_warm(pods, round_sp)
                if not pods:
                    return []
            metrics.SOLVER_BATCH_SIZE.labels(backend=self.provisioner.spec.solver).observe(len(pods))
            # one time budget for the whole round: catalog, solve, and every
            # launch's retries all draw down the same allowance
            from karpenter_tpu_torch.resilience import Budget

            budget = Budget(PROVISION_ROUND_BUDGET)
            with budget.activate():
                instance_types = self.cloud_provider.get_instance_types(
                    self.provisioner.spec.constraints.provider
                )
                nodes = self.scheduler.solve(self.provisioner, instance_types, pods)
                self._observe_stages()
                # the decision audit record lands BEFORE any launch: even
                # a round whose launches crash leaves its decision (and
                # any per-pod elimination verdicts) replayable
                self._record_decision(pods, nodes, round_sp)
                # parallel launch per virtual node (reference: provisioner.go:113)
                with ThreadPoolExecutor(max_workers=min(8, max(len(nodes), 1))) as pool:
                    # executor threads don't inherit contextvars: each launch
                    # re-activates the SHARED round budget in its own thread
                    # and parents its span on the round explicitly
                    launched = list(
                        pool.map(lambda v: self._launch(v, budget, round_sp), nodes)
                    )
            round_sp.set_attribute("nodes", len(nodes))
            round_sp.set_attribute("launched", sum(map(bool, launched)))
            if any(launched):  # only actual creations count as a scale event
                from karpenter_tpu_torch.kube import serde

                try:
                    # status subresource: a main-resource write would have
                    # its status silently dropped by a real apiserver
                    self.cluster.patch_status(
                        "provisioners", self.provisioner.name,
                        {"lastScaleTime": serde.wire_ts(self.cluster.clock())},
                        namespace="",
                    )
                except Exception:
                    logger.debug("lastScaleTime write failed", exc_info=True)
            return nodes

    def _record_decision(self, pods: List[Pod], nodes: List[VirtualNode], round_sp) -> None:
        """Append this round to the decision audit log (obs/decisions.py):
        considered pods, the chosen packing, per-pod elimination
        attribution for whatever stayed unplaced, route/session
        provenance, and the brownout/fence state at decision time — then
        close the Kubernetes loop (PodUnschedulable Warning events for
        pods past the consecutive-failure threshold). Best-effort: the
        audit plane must never fail a reconcile round."""
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs import decisions as dec

        if not dec.enabled():
            return
        try:
            log = obs.decision_log()
            state = {
                "fenced": bool(self.fenced()),
                **obs.state_snapshot(only=("brownout",)),
            }
            rec = log.record_round(
                provisioner=self.provisioner.name,
                pods=pods,
                nodes=nodes,
                context=self.scheduler.last_decision_context(),
                trace_id=round_sp.trace_id,
                state=state,
            )
            if rec is not None:
                self.last_decision_id = rec["id"]
                round_sp.set_attribute("decision_id", rec["id"])
                if rec["unschedulable_count"]:
                    round_sp.set_attribute(
                        "unschedulable", rec["unschedulable_count"]
                    )
            log.emit_unschedulable_events(
                self.cluster, threshold=self.unschedulable_event_rounds
            )
        except Exception:
            logger.debug("decision record failed", exc_info=True)

    def _observe_stages(self) -> None:
        """Plumb the solve's per-stage timings onto the scrape: the <100ms
        p99 is judged on scheduling_duration_seconds, but only the stage
        histogram says WHERE a regression landed (host encode vs wire
        serialization vs the in-flight pack_fetch vs decode)."""
        prof = self.scheduler.last_stage_profile()
        for stage, seconds in prof.items():
            if stage.endswith("_s") and isinstance(seconds, float):
                metrics.SOLVER_STAGE_DURATION.labels(stage=stage[:-2]).observe(seconds)

    # -- warm-pool claiming --------------------------------------------------
    def _steal_warm(self, pods: List[Pod], round_sp) -> List[Pod]:
        """First-fit the batch onto this provisioner's standing warm-pool
        nodes (controllers/warmpool.py) and bind the hits immediately —
        the speculative capacity is already launched (often already
        ready), so a hit skips the whole solve → create → ready pipeline.
        Returns the pods the solver still owes capacity. Hit/miss counts
        are per POD: the measured warm-hit rate is
        hits / (hits + misses)."""
        name = self.provisioner.name
        warm = [
            n for n in self.cluster.nodes()
            if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == name
            and lbl.WARM_POOL_ANNOTATION in n.metadata.annotations
            and n.metadata.deletion_timestamp is None
        ]
        if not warm:
            metrics.WARMPOOL_MISSES.labels(provisioner=name).inc(len(pods))
            return pods
        # name order: the wave controller and every replica agree, so a
        # retried round re-claims the same nodes first
        warm.sort(key=lambda n: n.metadata.name)
        # plan first, record second, claim last: a stolen batch is still
        # a decision — the audit record (with the warm nodes as packing)
        # must land before any bind, same as the solver path, and the ring
        # must carry EVERY arrival or a replayed window under-counts demand
        # by exactly the hit rate
        remaining = list(pods)
        plan = []
        for node in warm:
            if not remaining:
                break
            chosen = self._fit_on_warm(remaining, node)
            if not chosen:
                continue
            plan.append((node, chosen))
            taken = {id(p) for p in chosen}
            remaining = [p for p in remaining if id(p) not in taken]
        if not plan:
            metrics.WARMPOOL_MISSES.labels(provisioner=name).inc(len(pods))
            return pods
        decision_id = self._record_warm_claims(plan, round_sp)
        hits = 0
        claimed = 0
        lost = set()
        for node, chosen in plan:
            if not self._claim_warm(node, chosen, decision_id):
                # claim lost (node raced away): its pods fall back to the
                # solver
                lost.update(id(p) for p in chosen)
                continue
            hits += len(chosen)
            claimed += 1
        if lost:
            # restore original batch positions for the fallen-back pods
            keep = {id(p) for p in remaining} | lost
            remaining = [p for p in pods if id(p) in keep]
        if hits:
            metrics.WARMPOOL_HITS.labels(provisioner=name).inc(hits)
            round_sp.set_attribute("warm_hits", hits)
            round_sp.set_attribute("warm_nodes", claimed)
        if remaining:
            metrics.WARMPOOL_MISSES.labels(provisioner=name).inc(
                len(remaining)
            )
        return remaining

    def _fit_on_warm(self, pods: List[Pod], node) -> List[Pod]:
        """The pods (first-fit, batch order) this warm node can hold:
        node-selector entries must match the node's labels, the template
        constraints must admit the pod (cheap re-check — the batch already
        passed selection), and the accumulated requests must fit the
        node's allocatable (exact milli-unit arithmetic)."""
        chosen: List[Pod] = []
        alloc = node.status.allocatable
        for pod in pods:
            sel = pod.spec.node_selector or {}
            if any(
                node.metadata.labels.get(k) != v for k, v in sel.items()
            ):
                continue
            if self.provisioner.spec.constraints.validate_pod(pod):
                continue
            if not res.fits(res.requests_for_pods(*(chosen + [pod])), alloc):
                continue
            chosen.append(pod)
        return chosen

    def _record_warm_claims(self, plan, round_sp) -> str:
        """Append the warm-claim plan to the decision audit ring. A round
        the steal absorbs never reaches ``_record_decision``, and a ring
        missing those rounds would replay as if the demand they served
        never arrived. The stand-in packing entries
        carry the claimed pods so the record shows zero unschedulable."""
        from types import SimpleNamespace

        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs import decisions as dec

        if not dec.enabled():
            return ""
        try:
            rec = obs.decision_log().record_round(
                provisioner=self.provisioner.name,
                pods=[p for _, chosen in plan for p in chosen],
                nodes=[
                    SimpleNamespace(
                        instance_type_options=[], pods=list(chosen)
                    )
                    for _, chosen in plan
                ],
                trace_id=round_sp.trace_id,
                state={
                    "warm_claim": True,
                    "warm_nodes": [n.metadata.name for n, _ in plan],
                },
            )
            if rec is not None:
                self.last_decision_id = rec["id"]
                round_sp.set_attribute("decision_id", rec["id"])
                return rec["id"]
        except Exception:
            logger.debug("warm claim record failed", exc_info=True)
        return ""

    def _claim_warm(self, node, pods: List[Pod], decision_id: str = "") -> bool:
        """Claim the node (remove the warm marker — what tells the GC
        ladder this speculation landed), bind the pods, and resolve the
        speculative journal entry by the node's launch token. The claim
        patch goes FIRST: a crash after it leaves a claimed node whose
        open entry resolves as NODE_EXISTS on the next sweep, never a
        double-claim."""
        try:
            self.cluster.merge_patch(
                "nodes", node.metadata.name,
                {"metadata": {"annotations": {lbl.WARM_POOL_ANNOTATION: None}}},
                namespace="",
            )
        except Exception:
            # claim lost (node deleted/raced): the pods stay in the batch
            # and the solver provides for them normally
            logger.debug(
                "warm-pool claim failed for %s", node.metadata.name,
                exc_info=True,
            )
            return False
        self._bind(pods, node.metadata.name)
        token = node.metadata.annotations.get(lbl.LAUNCH_TOKEN_ANNOTATION, "")
        if token and self.journal is not None:
            self.journal.resolve(token)
        from karpenter_tpu_torch.kube.events import recorder_for

        recorder_for(self.cluster).event(
            "Node", node.metadata.name, "WarmPoolHit",
            f"bound {len(pods)} pod(s) to standing warm-pool capacity for "
            f"provisioner {self.provisioner.name} (no launch paid)",
            decision_id=decision_id or self.last_decision_id,
        )
        return True

    def _launch(self, vnode: VirtualNode, budget=None, parent_span=None) -> bool:
        """Returns whether a node was actually created."""
        from contextlib import nullcontext

        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller

        # executor threads don't inherit the worker's context: the budget
        # re-activates and the launch span parents on the round explicitly
        reconciling_controller.set("provisioning")
        with budget.activate() if budget is not None else nullcontext():
            with obs.tracer().span(
                "provision.launch",
                parent=parent_span,
                attrs={"pods": len(vnode.pods)},
            ) as sp:
                created = self._launch_one(vnode)
                sp.set_attribute("created", created)
                return created

    def _launch_one(self, vnode: VirtualNode) -> bool:
        try:
            # the launch-side split-brain guard: re-checked as late as
            # possible before the cloud create. Launches are tokened (the
            # wire fleet POST dedupes), but a lost lease means another
            # replica may ALREADY be solving these pods — creating here
            # would double capacity and race its binds.
            if self.fenced():
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="fenced"
                ).inc()
                logger.warning(
                    "skipping launch for %s: replica fenced (apiserver "
                    "unreachable past lease expiry)",
                    self.provisioner.name,
                )
                return False
            if not self.owned():
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="lost_ownership"
                ).inc()
                logger.warning(
                    "skipping launch for %s: shard lease lost",
                    self.provisioner.name,
                )
                return False
            # fresh limits check against live status (reference:
            # provisioner.go:138-144 re-reads the provisioner)
            live = self.cluster.try_get("provisioners", self.provisioner.name, namespace="")
            prov = live if live is not None else self.provisioner
            if prov.spec.limits is not None:
                err = prov.spec.limits.exceeded_by(prov.status.resources)
                if err:
                    logger.info("skipping launch: %s", err)
                    return False
            from karpenter_tpu_torch import obs

            launch_span = obs.tracer().current()
            trace = (
                obs.to_traceparent(launch_span) if launch_span is not None else ""
            )
            # the launch token IS the launch's identity: stamped on the
            # cloud instance (providers replay a committed token, so the
            # metered retry policy can cover create), journaled BEFORE the
            # cloud call (crash recovery re-describes by it), annotated on
            # the Node (the GC cross-check pairs instance and Node by it)
            import uuid as _uuid

            token = _uuid.uuid4().hex
            if launch_span is not None:
                launch_span.set_attribute("launch_token", token[:12])
            if self.journal is not None:
                self.journal.record_intent(token, self.provisioner.name, trace)
            node = self.cloud_provider.create(
                NodeRequest(
                    template=vnode.constraints,
                    instance_type_options=vnode.instance_type_options,
                    launch_token=token,
                )
            )
            # merge the constraint template into the returned node: labels,
            # taints (incl. not-ready), finalizer (reference:
            # provisioner.go:152-160 + constraints.go:69-105)
            template = vnode.constraints.to_node()
            node.metadata.labels = {**template.metadata.labels, **node.metadata.labels}
            node.metadata.labels[lbl.PROVISIONER_NAME_LABEL] = self.provisioner.name
            # stamp the launch trace onto the Node: the ready transition
            # happens minutes later in another reconcile, and this
            # annotation is how node.ready joins the launch trace
            if trace:
                node.metadata.annotations[obs.TRACE_ANNOTATION] = trace
            node.metadata.annotations.setdefault(
                lbl.LAUNCH_TOKEN_ANNOTATION, token
            )
            node.metadata.finalizers = list(
                set(node.metadata.finalizers) | set(template.metadata.finalizers)
            )
            node.spec.taints = node.spec.taints + [
                t for t in template.spec.taints if t.key not in {x.key for x in node.spec.taints}
            ]
            try:
                self.cluster.create("nodes", node)
            except Conflict:
                # node self-registered first — idempotent create
                # (reference: provisioner.go:155-164)
                pass
            if self.journal is not None:
                self.journal.mark_created(token, node.metadata.name)
            self._bind(vnode.pods, node.metadata.name)
            if self.journal is not None:
                # bind done: the launch is fully committed across all three
                # stores — the journal entry has nothing left to protect
                self.journal.resolve(token)
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Node", node.metadata.name, "Launched",
                f"launched {node.metadata.labels.get(lbl.INSTANCE_TYPE, '?')} "
                f"for provisioner {self.provisioner.name}; bound {len(vnode.pods)} pod(s)",
            )
            return True
        except Exception:
            logger.exception("launching node")
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Provisioner", self.provisioner.name, "LaunchFailed",
                "node launch failed; see controller logs", type="Warning",
                decision_id=self.last_decision_id,
            )
            # fast retry: the pods are still provisionable — re-enter the
            # batcher for the NEXT round (paced by the batch idle window)
            # instead of stalling a full selection requeue period per
            # transient launch failure; provision_once's key dedupe absorbs
            # any concurrent selection re-submit of the same pods
            for pod in vnode.pods:
                if is_provisionable(pod):
                    self.add(pod)
                    with self._pending_lock:
                        self._requeued_keys.add(pod.key)
            return False

    def _bind(self, pods: List[Pod], node_name: str) -> None:
        from karpenter_tpu_torch import obs

        start = time.perf_counter()
        ok = True
        with obs.tracer().span(
            "provision.bind", attrs={"node": node_name, "pods": len(pods)}
        ) as sp:
            for pod in pods:
                try:
                    # re-check against the LIVE pod: a rebalance can hand
                    # the shard to another replica between this replica's
                    # solve and its bind, and that replica may have bound
                    # the pod already — binds are re-checked, never
                    # duplicated (docs/fleet.md). A pod the cluster does
                    # not know (test harnesses inject those) binds as-is.
                    live = self.cluster.try_get(
                        "pods", pod.metadata.name, namespace=pod.metadata.namespace
                    )
                    if live is not None and live.spec.node_name:
                        if live.spec.node_name != node_name:
                            metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                                reason="already_bound"
                            ).inc()
                        continue
                    self.cluster.bind(live if live is not None else pod, node_name)
                except Exception:
                    ok = False
                    logger.exception("binding pod %s", pod.key)
            sp.set_attribute("ok", ok)
        metrics.BIND_DURATION.labels(result="success" if ok else "error").observe(
            time.perf_counter() - start
        )


def spec_hash(provisioner: Provisioner) -> int:
    """Change detection for worker hot-swap
    (reference: controller.go:119 hashstructure of spec)."""
    c = provisioner.spec.constraints
    return hash(
        (
            tuple(sorted(c.labels.items())),
            tuple((t.key, t.value, t.effect) for t in c.taints),
            tuple(
                (r.key, r.operator, tuple(r.values)) for r in c.requirements.requirements
            ),
            str(c.provider),
            provisioner.spec.ttl_seconds_after_empty,
            provisioner.spec.ttl_seconds_until_expired,
            provisioner.spec.solver,
            tuple(sorted((provisioner.spec.limits.resources if provisioner.spec.limits else {}).items())),
        )
    )


class ProvisioningController:
    """Reconciles Provisioner objects into running workers
    (reference: provisioning/controller.go:43-154)."""

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        start_workers: bool = True,
        default_solver: str = SOLVER_FFD,
        solver_service_address: Optional[str] = None,
        ownership=None,
        pack_checksum: Optional[bool] = None,
        canary_rate: Optional[float] = None,
        solver_stream: Optional[bool] = None,
        solver_shm_dir: Optional[str] = None,
        solver_delta: Optional[bool] = None,
        unschedulable_event_rounds: int = 3,
        journal=None,
        device="cuda",
        warm_pool: bool = False,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.start_workers = start_workers  # False: tests drive provision_once inline
        # where every worker's solver: tpu solves run (cuda or cpu)
        self.device = device
        # warm-pool claiming: workers steal onto standing speculative
        # nodes before solving (controllers/warmpool.py launches them)
        self.warm_pool = warm_pool
        # decision observability: consecutive failed rounds before a pod's
        # PodUnschedulable Warning event (docs/decisions.md)
        self.unschedulable_event_rounds = unschedulable_event_rounds
        self.default_solver = default_solver
        self.solver_service_address = solver_service_address
        # pack-integrity knobs (docs/integrity.md), threaded to every
        # worker's scheduler; None = the KARPENTER_PACK_CHECKSUM /
        # KARPENTER_CANARY_RATE env twins
        self.pack_checksum = pack_checksum
        self.canary_rate = canary_rate
        # streaming solver transport + zero-copy shm arena (None = the
        # KARPENTER_SOLVER_STREAM / KARPENTER_SOLVER_SHM_DIR env twins)
        self.solver_stream = solver_stream
        self.solver_shm_dir = solver_shm_dir
        # resident delta encoding (None = the KARPENTER_SOLVER_DELTA twin)
        self.solver_delta = solver_delta
        self.journal = journal  # write-ahead launch journal, shared by workers
        # fleet.ShardManager (or None = this replica owns everything):
        # reconcile only runs workers for owned shards, and each worker's
        # launch path re-checks through the same manager
        self.ownership = ownership
        self.workers: Dict[str, ProvisionerWorker] = {}  # guarded-by: self._lock
        self._hashes: Dict[str, int] = {}  # guarded-by: self._lock
        # provisioners with a live gauge series — a failed Apply never
        # creates a worker, so stop()/teardown can't rely on self.workers
        # to know which series to drop. Mutated from per-provisioner
        # reconcile threads and iterated by stop(): same lock as the
        # worker table.
        self._gauged: set = set()  # guarded-by: self._lock
        self._lock = threading.Lock()

    def reconcile(self, name: str) -> Optional[float]:
        provisioner = self.cluster.try_get("provisioners", name, namespace="")
        if provisioner is None or provisioner.metadata.deletion_timestamp is not None:
            self._teardown(name)
            return None
        if self.ownership is not None and not self.ownership.owns(name):
            # another replica's shard: never run a worker for it here (the
            # split-brain P0 — two workers would double-launch its pods).
            # Re-check on a lease-scale cadence so a rebalance lands fast.
            self._teardown(name)
            return OWNERSHIP_RECHECK_INTERVAL
        # Active condition lifecycle (reference: provisioner_status.go:38-41,
        # the knative living ``Active`` set): every Apply outcome lands in
        # status.conditions, and the status write happens only on change so
        # steady-state requeues don't churn the apiserver.
        try:
            self.apply(provisioner)
        except Exception as e:
            reason = (
                "ValidationFailed" if isinstance(e, ValueError) else "ApplyFailed"
            )
            self._set_active(provisioner, "False", reason, str(e))
            raise
        self._set_active(provisioner, "True")
        # requeue to pick up instance-type catalog drift
        # (reference: provisioning/controller.go:82, 5 minutes)
        return REQUEUE_INTERVAL

    def _set_active(
        self, provisioner: Provisioner, value: str, reason: str = "", message: str = ""
    ) -> None:
        """Persist the Active condition through the status subresource.
        The live (cached) object is never mutated here: on a failed write
        the cache still holds the old condition, so the next reconcile's
        comparison re-detects the drift and retries. lastTransitionTime
        moves only when the status value flips (knative semantics)."""
        from karpenter_tpu_torch.api.provisioner import ACTIVE, Condition
        from karpenter_tpu_torch.kube import serde

        metrics.PROVISIONER_ACTIVE.labels(provisioner=provisioner.name).set(
            1 if value == "True" else 0
        )
        # reconcile threads race stop()'s iteration over this set
        with self._lock:
            self._gauged.add(provisioner.name)
        cond = provisioner.status.condition(ACTIVE)
        if cond is not None and (cond.status, cond.reason, cond.message) == (
            value, reason, message,
        ):
            return
        ltt = (
            self.cluster.clock()
            if cond is None or cond.status != value
            else cond.last_transition_time
        )
        wire = serde.prov_condition_to_wire(
            Condition(
                type=ACTIVE, status=value, reason=reason, message=message,
                last_transition_time=ltt,
            )
        )
        # arrays replace wholesale under RFC 7386: the patch must carry the
        # FULL conditions list, not just Active, or conditions owned by
        # other writers get erased. Read-modify-write against the freshest
        # cache copy (a raced write loses benignly — the next reconcile's
        # comparison re-detects the drift and retries).
        from karpenter_tpu_torch.kube.patch import upsert_condition

        live = self.cluster.try_get("provisioners", provisioner.name, namespace="")
        base = (live or provisioner).status.conditions
        wire_conditions = upsert_condition(
            [serde.prov_condition_to_wire(c) for c in base], wire
        )
        try:
            self.cluster.patch_status(
                "provisioners", provisioner.name,
                {"conditions": wire_conditions}, namespace="",
            )
        except Exception:
            # a lost condition write surfaces again on the next reconcile;
            # it must never mask the Apply outcome itself
            logger.debug("provisioner Active condition write failed", exc_info=True)

    def apply(self, provisioner: Provisioner) -> None:
        """Validate, default, layer live catalog requirements, and (re)start
        the worker when the spec changed (reference: controller.go:93-116).
        Defaulting re-runs here so the control loop is safe without the
        webhook (reference: provisioning/controller.go:94-95)."""
        default_provisioner(provisioner, self.default_solver)
        self.cloud_provider.default(provisioner.spec.constraints)
        errs = validate_provisioner(provisioner)
        errs += self.cloud_provider.validate(provisioner.spec.constraints)
        if errs:
            raise ValueError(f"invalid provisioner {provisioner.name}: {errs}")
        h = spec_hash(provisioner)
        enriched = self._with_catalog(provisioner)
        # check + swap is one critical section so concurrent applies cannot
        # both pass the hash check and leak a started worker
        with self._lock:
            if self._hashes.get(provisioner.name) == h:
                # still refresh catalog requirements (requeue path)
                self.workers[provisioner.name].provisioner = enriched
                return
            old = self.workers.pop(provisioner.name, None)
            name = provisioner.name
            worker = ProvisionerWorker(
                enriched, self.cluster, self.cloud_provider,
                solver_service_address=self.solver_service_address,
                owned=(
                    (lambda: self.ownership.owns(name))
                    if self.ownership is not None else None
                ),
                fenced=(
                    self.ownership.fenced
                    if self.ownership is not None
                    and hasattr(self.ownership, "fenced") else None
                ),
                pack_checksum=self.pack_checksum,
                canary_rate=self.canary_rate,
                solver_stream=self.solver_stream,
                solver_shm_dir=self.solver_shm_dir,
                solver_delta=self.solver_delta,
                unschedulable_event_rounds=self.unschedulable_event_rounds,
                journal=self.journal,
                device=self.device,
                warm_pool=self.warm_pool,
            )
            self.workers[provisioner.name] = worker
            self._hashes[provisioner.name] = h
            if self.start_workers:
                worker.start()
        if old:
            old.stop()

    def _with_catalog(self, provisioner: Provisioner) -> Provisioner:
        instance_types = self.cloud_provider.get_instance_types(
            provisioner.spec.constraints.provider
        )
        c = provisioner.spec.constraints.clone()
        c.requirements = c.requirements.merge(catalog_requirements(instance_types))
        out = Provisioner(metadata=provisioner.metadata, spec=provisioner.spec, status=provisioner.status)
        out.spec = type(provisioner.spec)(
            constraints=c,
            ttl_seconds_after_empty=provisioner.spec.ttl_seconds_after_empty,
            ttl_seconds_until_expired=provisioner.spec.ttl_seconds_until_expired,
            limits=provisioner.spec.limits,
            solver=provisioner.spec.solver,
        )
        return out

    def _teardown(self, name: str) -> None:
        with self._lock:
            worker = self.workers.pop(name, None)
            self._hashes.pop(name, None)
            self._gauged.discard(name)
        if worker:
            worker.stop()
        # drop the gauge series: a deleted provisioner must not linger on
        # the scrape as managed-and-failing. Several prometheus_client
        # releases raise KeyError from remove() for a never-gauged label
        # set (e.g. a reconcile of a name whose Apply never ran), and that
        # must not escape reconcile().
        try:
            metrics.PROVISIONER_ACTIVE.remove(name)
        except KeyError:
            pass

    def release_shard(self, name: str) -> None:
        """``ShardManager.on_lost`` hook: stop this provisioner's worker
        SYNCHRONOUSLY — by the time the lease duration elapses and a
        survivor claims the shard, this replica must no longer be solving,
        launching, or binding for it."""
        with self._lock:
            worker = self.workers.pop(name, None)
            self._hashes.pop(name, None)
        if worker:
            worker.stop()

    def list_workers(self) -> List[ProvisionerWorker]:
        """Active workers sorted by provisioner name — selection priority
        order (reference: controller.go:136-145)."""
        with self._lock:
            return [self.workers[k] for k in sorted(self.workers)]

    def submit(self, pod: Pod) -> Optional[ProvisionerWorker]:
        """Inject a pod straight into the first admitting worker's batcher,
        bypassing the selection controller — the interruption subsystem's
        proactive-replacement hook: pods released from a disrupted node
        enter the provisioning pipeline BEFORE the node drains, so
        replacement capacity is launching while the old node still runs.
        Returns the worker, or None when no provisioner admits the pod
        (the caller leaves it pending for selection to retry)."""
        # volume topology must ride along even though selection is bypassed:
        # a replacement pod with a zone-bound PV packed into another zone
        # would bind where its volume cannot attach — and selection cannot
        # repair it later (is_pending short-circuits its reconcile)
        from karpenter_tpu_torch.controllers.selection import VolumeTopology

        VolumeTopology(self.cluster).inject(pod)
        for worker in self.list_workers():
            if not worker.provisioner.spec.constraints.validate_pod(pod):
                worker.add(pod)
                return worker
        return None

    def stop(self) -> None:
        # snapshot under the lock: reconcile threads may still be mutating
        # both tables while shutdown walks them
        with self._lock:
            names = set(self.workers)
            # provisioners whose Apply only ever failed have a gauge series
            # but no worker — clear those too
            names |= self._gauged
        for name in names:
            self._teardown(name)
