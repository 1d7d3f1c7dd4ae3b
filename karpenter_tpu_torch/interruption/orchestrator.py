"""The end-to-end response to one disruption notice (the port's copy of
``karpenter_tpu/interruption/orchestrator.py``).

Ordering guarantee (the subsystem's contract, asserted by
tests/test_torch_interruption.py against the reference): on a notice the
orchestrator

1. taints (``karpenter.sh/interruption=<kind>:NoSchedule``) and cordons the
   node in ONE merge patch, so no new pod lands on doomed capacity;
2. emits a Kubernetes Warning event (``kubectl describe node`` shows why
   the node went away);
3. **injects the node's reschedulable pods into the provisioning batcher
   BEFORE any eviction happens** — each pod is released from the node
   (nodeName cleared, marked Unschedulable) and handed straight to the
   first admitting provisioner worker, so replacement capacity is already
   launching while the old node still runs. There is no kubelet or
   ReplicaSet controller in this substrate: the pod OBJECT is the workload,
   and re-binding it to the replacement node IS the replacement;
4. hands the node to the existing termination controller (delete → the
   finalizer-driven cordon/drain/terminate path) with the deadline derived
   from the notice's grace period tracked by the interruption controller.

Because step 3 removes every reschedulable pod from the node before step 4
runs, the termination drain finds only pods that could never move
(do-not-evict, daemonset, static) — a clean preemption evicts nothing, and
``interruption_evicted_unready`` stays 0.

``force_terminate`` is the deadline path: the cloud is taking the capacity
regardless, so do-not-evict stops applying — remaining pods are counted as
evicted-without-replacement, force-drained, and the instance is deleted.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, Pod, Taint
from karpenter_tpu_torch.interruption.types import DisruptionNotice
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import pod as podutil

logger = logging.getLogger("karpenter.interruption")


@dataclass
class Response:
    """What one ``handle()`` did — the controller tracks the deadline and
    the migrated pods' replacement lead times from this."""

    node_name: str
    deadline: float
    migrated: List[Pod] = field(default_factory=list)
    blocked: List[Pod] = field(default_factory=list)  # do-not-evict holdouts


class Orchestrator:
    def __init__(self, cluster: Cluster, cloud_provider, provisioning, termination):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioning = provisioning  # ProvisioningController (submit hook)
        self.termination = termination  # TerminationController (terminator + force drain)
        # bench/test observability beside the prometheus counters
        self.evicted_unready = 0
        self.notices_handled = 0

    # -- the notice path ---------------------------------------------------
    def handle(self, notice: DisruptionNotice, on_release=None) -> Optional[Response]:
        """Run steps 1–4 for one notice; returns None when there is nothing
        to do (node unknown or already terminating — the dedup for a cloud
        that re-announces). ``on_release(pod)`` fires after each pod is
        released and BEFORE it enters the batcher, so the caller's
        replacement-lead-time tracking can never miss a fast re-bind."""
        node = self.cluster.try_get("nodes", notice.node_name, namespace="")
        if node is None or node.metadata.deletion_timestamp is not None:
            return None
        self.notices_handled += 1
        now = self.cluster.clock()
        deadline = now + max(float(notice.grace_period_seconds), 0.0)
        from karpenter_tpu_torch import obs

        # the taint→replace→drain response as one trace: each step is a
        # child span, and the replacement solves the migrated pods trigger
        # nest under interruption.replace via the contextvar
        with obs.tracer().span(
            "interruption.notice",
            attrs={
                "kind": notice.kind,
                "node": node.metadata.name,
                "grace_s": float(notice.grace_period_seconds),
            },
        ) as sp:
            with obs.tracer().span("interruption.taint_cordon"):
                self._taint_and_cordon(node, notice)
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Node", node.metadata.name, "InterruptionNotice",
                f"{notice.kind} notice ({notice.reason or 'cloud-initiated'}): "
                f"grace {notice.grace_period_seconds:g}s; replacing pods proactively",
                type="Warning",
            )
            with obs.tracer().span("interruption.replace") as rep_sp:
                migrated, blocked = self._migrate(node, on_release)
                rep_sp.set_attribute("migrated", len(migrated))
                rep_sp.set_attribute("blocked", len(blocked))
            # only AFTER the replacement injection does the node enter the
            # termination path — this delete is the ordering guarantee's fence
            with obs.tracer().span("interruption.drain_handoff"):
                self.cluster.delete("nodes", node.metadata.name, namespace="")
            metrics.INTERRUPTION_DRAINS_STARTED.inc()
            sp.set_attribute("migrated", len(migrated))
        logger.info(
            "interruption: %s on %s (grace %gs) — %d pod(s) injected for "
            "replacement, %d blocked",
            notice.kind, node.metadata.name, notice.grace_period_seconds,
            len(migrated), len(blocked),
        )
        return Response(
            node_name=node.metadata.name, deadline=deadline,
            migrated=migrated, blocked=blocked,
        )

    # -- the consolidation path --------------------------------------------
    def consolidate(
        self, node: Node, decision_id: str = "", on_release=None
    ) -> Optional[Response]:
        """Retire one node VOLUNTARILY with the same ordering guarantee as
        a notice: taint+cordon (taint value ``consolidation``, so a
        mid-wave crash leaves a recognizable breadcrumb the journal replay
        un-cordons) → event → replacement injection BEFORE any eviction →
        drain handoff. The consolidation controller journals the whole
        wave before calling this per victim; ``decision_id`` rejoins the
        audit record that proposed the wave. Unlike ``handle`` there is no
        cloud deadline — the only clock on a voluntary wave is the
        controller's settle timeout — and do-not-evict pods cannot appear
        (plan-time screening excludes their nodes), but if one slips in it
        still blocks exactly as on the notice path."""
        node = self.cluster.try_get("nodes", node.metadata.name, namespace="")
        if node is None or node.metadata.deletion_timestamp is not None:
            return None
        from karpenter_tpu_torch import obs

        notice = DisruptionNotice(
            kind="consolidation", node_name=node.metadata.name,
            grace_period_seconds=0.0, reason="consolidation re-pack",
        )
        with obs.tracer().span(
            "consolidation.move",
            attrs={"node": node.metadata.name, "decision_id": decision_id},
        ) as sp:
            with obs.tracer().span("interruption.taint_cordon"):
                self._taint_and_cordon(node, notice)
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Node", node.metadata.name, "ConsolidationDrain",
                "consolidation re-pack is retiring this node; "
                "replacing pods proactively",
                type="Warning", decision_id=decision_id,
            )
            with obs.tracer().span("interruption.replace") as rep_sp:
                migrated, blocked = self._migrate(node, on_release)
                rep_sp.set_attribute("migrated", len(migrated))
                rep_sp.set_attribute("blocked", len(blocked))
            with obs.tracer().span("interruption.drain_handoff"):
                self.cluster.delete("nodes", node.metadata.name, namespace="")
            sp.set_attribute("migrated", len(migrated))
        logger.info(
            "consolidation: retiring %s — %d pod(s) injected for "
            "replacement, %d blocked",
            node.metadata.name, len(migrated), len(blocked),
        )
        return Response(
            node_name=node.metadata.name, deadline=0.0,
            migrated=migrated, blocked=blocked,
        )

    def _taint_and_cordon(self, node: Node, notice: DisruptionNotice) -> None:
        """One merge patch: interruption taint + cordon + ensure the
        termination finalizer (a self-registered node may not carry it yet,
        and without it the delete below would skip the drain path).

        RFC 7386 replaces the taints array wholesale, so the patch carries
        the FULL list — the node's current taints with the interruption
        taint upserted (kube.patch's RMW idiom; re-tainting an already
        noticed node is a no-op replace of the same entry)."""
        from karpenter_tpu_torch.kube.patch import upsert_taint
        from karpenter_tpu_torch.kube.serde import taint_to_wire

        taints_wire = upsert_taint(
            [taint_to_wire(t) for t in node.spec.taints],
            taint_to_wire(
                Taint(
                    key=lbl.INTERRUPTION_TAINT_KEY,
                    value=notice.kind,
                    effect="NoSchedule",
                )
            ),
        )
        finalizers = list(node.metadata.finalizers)
        if lbl.TERMINATION_FINALIZER not in finalizers:
            finalizers.append(lbl.TERMINATION_FINALIZER)
        self.cluster.merge_patch(
            "nodes", node.metadata.name,
            {
                "spec": {
                    "unschedulable": True,
                    "taints": taints_wire,
                },
                "metadata": {"finalizers": finalizers},
            },
            namespace=node.metadata.namespace,
        )

    def _migrate(self, node: Node, on_release=None):
        """Release every reschedulable pod from the node and inject it into
        the provisioning batcher. Pods are released even when no worker
        admits them right now — a pending pod survives the node's death and
        the selection controller keeps retrying it, whereas a pod left
        bound is destroyed with the node."""
        migrated: List[Pod] = []
        blocked: List[Pod] = []
        for pod in self.cluster.pods_on_node(node.metadata.name):
            if pod.metadata.deletion_timestamp is not None:
                continue
            if podutil.is_owned_by_daemonset(pod) or podutil.is_owned_by_node(pod):
                continue  # per-node workloads don't migrate
            if pod.metadata.annotations.get(lbl.DO_NOT_EVICT_ANNOTATION) == "true":
                blocked.append(pod)  # honored until the grace deadline
                continue
            released = self._release(pod)
            if on_release is not None:
                on_release(released)
            worker = self.provisioning.submit(released) if self.provisioning else None
            if worker is None:
                logger.warning(
                    "no provisioner admits replacement pod %s; left pending "
                    "for selection to retry", released.key,
                )
            migrated.append(released)
        return migrated, blocked

    def _release(self, pod: Pod) -> Pod:
        """Unbind the pod and mark it Unschedulable so the provisioning
        re-verify (``is_provisionable``) accepts it — the same wire shape
        the kube-scheduler would leave on a pending pod. Returns the
        PATCHED object: the in-memory store mutates in place, but a store
        whose ``merge_patch`` returns a fresh object leaves the caller's
        copy untouched — injecting the stale one would fail the
        is_provisionable re-verify and silently skip the replacement."""
        conditions = [
            {"type": c.type, "status": c.status, "reason": c.reason or None}
            for c in pod.status.conditions
            if c.type != "PodScheduled"
        ]
        conditions.append(
            {"type": "PodScheduled", "status": "False", "reason": "Unschedulable"}
        )
        return self.cluster.merge_patch(
            "pods", pod.metadata.name,
            {"spec": {"nodeName": None}, "status": {"conditions": conditions}},
            namespace=pod.metadata.namespace,
        )

    # -- the deadline path -------------------------------------------------
    def force_terminate(self, node: Node) -> int:
        """The grace period is over: whatever still sits on the node is
        lost capacity-side, so count it, force-drain (do-not-evict no
        longer applies), and delete the instance + finalizer. Returns the
        number of pods that had no replacement ready."""
        left = [
            p for p in self.cluster.pods_on_node(node.metadata.name)
            if p.metadata.deletion_timestamp is None
            and not podutil.is_owned_by_daemonset(p)
            and not podutil.is_owned_by_node(p)
        ]
        if left:
            metrics.INTERRUPTION_EVICTED_UNREADY.inc(len(left))
            self.evicted_unready += len(left)
        from karpenter_tpu_torch.kube.events import recorder_for

        recorder_for(self.cluster).event(
            "Node", node.metadata.name, "InterruptionDeadlineReached",
            f"grace period expired with {len(left)} pod(s) still aboard; "
            "forcing termination",
            type="Warning",
        )
        from karpenter_tpu_torch import obs

        with obs.tracer().span(
            "interruption.force_terminate",
            attrs={"node": node.metadata.name, "pods_left": len(left)},
        ):
            terminator = self.termination.terminator
            terminator.cordon(node)
            terminator.drain(node, force=True)
            # The provider already announced this capacity is being
            # reclaimed, so an ownership/fence check proves nothing here
            # (fencing is for leader-driven mutations)
            terminator.terminate(node)
        logger.warning(
            "interruption deadline: force-terminated %s (%d pod(s) without "
            "replacement)", node.metadata.name, len(left),
        )
        return len(left)
