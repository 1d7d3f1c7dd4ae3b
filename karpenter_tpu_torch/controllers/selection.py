"""Selection: route provisionable pods to a Provisioner worker.

Mirrors ``pkg/controllers/selection``: filter provisionable pods, validate
supportability, relax preferences on retry (5-min TTL cache), inject volume
topology from PVCs, pick the first Provisioner whose ``validate_pod`` passes,
and enqueue into its batcher (controller.go:61-115).

Divergence from the reference: required pod affinity/anti-affinity is rejected
there (controller.go:145-150); this framework schedules it (BASELINE config 3)
via topology pre-assignment (scheduling/topology.py), so the routing
controller accepts it by default, validating only that the affinity topology
keys are supported. Pass ``allow_pod_affinity=False`` for reference-parity
rejection.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    Toleration,
)
from karpenter_tpu_torch.api.requirements import SUPPORTED_NODE_SELECTOR_OPS
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.pod import is_provisionable
from karpenter_tpu_torch.utils.ttlcache import TTLCache

logger = logging.getLogger("karpenter.selection")

PREFERENCE_TTL = 300.0  # reference: preferences.go:32 ExpirationTTL
REQUEUE_AFTER = 5.0  # reference: controller.go:83 verify-scheduled requeue

SUPPORTED_TOPOLOGY_KEYS = {lbl.HOSTNAME, lbl.TOPOLOGY_ZONE}


class Preferences:
    """Iterative constraint relaxation keyed by pod UID
    (reference: preferences.go:36-163).

    Each failed scheduling round removes, in order: one preferred podAffinity
    term, one preferred podAntiAffinity term, the heaviest preferred
    nodeAffinity term, one required nodeAffinity OR-term (only when more than
    one remains), then adds a toleration for PreferNoSchedule taints.
    """

    def __init__(self, clock=None):
        self.cache = TTLCache(PREFERENCE_TTL, clock=clock)

    def relax(self, pod: Pod) -> None:
        cached = self.cache.get(pod.metadata.uid)
        if cached is None:
            # first sighting: remember the original affinity/tolerations
            self.cache.set(
                pod.metadata.uid,
                (copy.deepcopy(pod.spec.affinity), copy.deepcopy(pod.spec.tolerations)),
            )
            return
        affinity, tolerations = cached
        # hand out copies: downstream injection (volume topology) mutates the
        # pod's affinity, and an aliased cache entry would accumulate those
        # injected requirements across retries
        pod.spec.affinity = copy.deepcopy(affinity)
        pod.spec.tolerations = copy.deepcopy(tolerations)
        if self._relax(pod):
            self.cache.set(
                pod.metadata.uid,
                (copy.deepcopy(pod.spec.affinity), copy.deepcopy(pod.spec.tolerations)),
            )

    def _relax(self, pod: Pod) -> bool:
        for fn in (
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_required_node_affinity_term,
            self._tolerate_prefer_no_schedule_taints,
        ):
            reason = fn(pod)
            if reason is not None:
                logger.debug("Relaxing soft constraints for pod %s: %s", pod.key, reason)
                return True
        return False

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_affinity is None or not aff.pod_affinity.preferred:
            return None
        terms = sorted(aff.pod_affinity.preferred, key=lambda t: -t.weight)
        aff.pod_affinity.preferred = terms[1:]
        return "removed preferred pod affinity term"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None or not aff.pod_anti_affinity.preferred:
            return None
        terms = sorted(aff.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        aff.pod_anti_affinity.preferred = terms[1:]
        return "removed preferred pod anti-affinity term"

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or not aff.node_affinity.preferred:
            return None
        terms = sorted(aff.node_affinity.preferred, key=lambda t: -t.weight)
        aff.node_affinity.preferred = terms[1:]
        return "removed heaviest preferred node affinity term"

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or len(aff.node_affinity.required) <= 1:
            # unlike preferred terms, the last required OR-term cannot go
            return None
        aff.node_affinity.required = aff.node_affinity.required[1:]
        return "removed required node affinity OR-term"

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        for t in pod.spec.tolerations:
            if t.operator == "Exists" and t.effect == "PreferNoSchedule" and not t.key:
                return None
        pod.spec.tolerations = pod.spec.tolerations + [
            Toleration(operator="Exists", effect="PreferNoSchedule")
        ]
        return "added toleration for PreferNoSchedule taints"


class VolumeTopology:
    """Translate pod PVCs into node-affinity requirements
    (reference: volumetopology.go:36-125): bound PV → the PV's required
    nodeAffinity terms; unbound PVC → StorageClass allowedTopologies."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def inject(self, pod: Pod) -> None:
        requirements = self._get_requirements(pod)
        if not requirements:
            return
        from karpenter_tpu_torch.api.objects import Affinity, NodeAffinity

        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        na = pod.spec.affinity.node_affinity
        if not na.required:
            na.required = [NodeSelectorTerm()]
        # appended to every required OR-term so the volume constraint holds
        # whichever branch the scheduler picks (reference appends to the terms
        # of the first required selector, volumetopology.go:52-60)
        for term in na.required:
            term.match_expressions = term.match_expressions + requirements

    def _get_requirements(self, pod: Pod) -> List[NodeSelectorRequirement]:
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            if not volume.persistent_volume_claim:
                continue
            pvc = self.cluster.try_get(
                "pvcs", volume.persistent_volume_claim, pod.metadata.namespace
            )
            if pvc is None:
                continue
            if pvc.volume_name:
                requirements.extend(self._pv_requirements(pvc.volume_name))
            elif pvc.storage_class_name:
                requirements.extend(self._storage_class_requirements(pvc.storage_class_name))
        return requirements

    def _storage_class_requirements(self, name: str) -> List[NodeSelectorRequirement]:
        sc = self.cluster.try_get("storageclasses", name, namespace="")
        if sc is None:
            return []
        out: List[NodeSelectorRequirement] = []
        for term in sc.allowed_topologies:
            out.extend(term.match_expressions)
        return out

    def _pv_requirements(self, name: str) -> List[NodeSelectorRequirement]:
        pv = self.cluster.try_get("pvs", name, namespace="")
        if pv is None:
            return []
        out: List[NodeSelectorRequirement] = []
        for term in pv.node_affinity_required:
            out.extend(term.match_expressions)
        return out


def validate(pod: Pod, allow_pod_affinity: bool = False) -> List[str]:
    """Supportability gate (reference: controller.go:125-176)."""
    errs: List[str] = []
    for constraint in pod.spec.topology_spread_constraints:
        if constraint.topology_key not in SUPPORTED_TOPOLOGY_KEYS:
            errs.append(
                f"unsupported topology key {constraint.topology_key} not in {sorted(SUPPORTED_TOPOLOGY_KEYS)}"
            )
    aff = pod.spec.affinity
    if aff is not None:
        if allow_pod_affinity:
            # this framework schedules required pod (anti-)affinity; only the
            # topology key needs to be one the solver can reason about
            for term in _pod_affinity_terms(pod):
                if term.topology_key not in SUPPORTED_TOPOLOGY_KEYS:
                    errs.append(
                        f"unsupported pod affinity topology key {term.topology_key}"
                    )
        else:
            if podutil.has_required_pod_affinity(pod):
                errs.append("pod affinity 'required' is not supported")
            if podutil.has_required_pod_anti_affinity(pod):
                errs.append("pod anti-affinity 'required' is not supported")
        if aff.node_affinity is not None:
            for pref in aff.node_affinity.preferred:
                errs.extend(_validate_term_ops(pref.preference))
            for term in aff.node_affinity.required:
                errs.extend(_validate_term_ops(term))
    return errs


def _pod_affinity_terms(pod: Pod):
    aff = pod.spec.affinity
    terms = []
    if aff.pod_affinity is not None:
        terms.extend(aff.pod_affinity.required)
    if aff.pod_anti_affinity is not None:
        terms.extend(aff.pod_anti_affinity.required)
    return terms


def _validate_term_ops(term: NodeSelectorTerm) -> List[str]:
    return [
        f"node selector term has unsupported operator {r.operator}"
        for r in term.match_expressions
        if r.operator not in SUPPORTED_NODE_SELECTOR_OPS
    ]


class SelectionController:
    """Routes pods to provisioner workers (reference: controller.go:43-115).

    ``reconcile`` returns the requeue-after seconds (None = done), matching
    the reference's Result{RequeueAfter: 5s} verify-loop contract.
    """

    def __init__(
        self,
        cluster: Cluster,
        provisioning_controller,
        allow_pod_affinity: bool = True,
        clock=None,
        wait: bool = True,
    ):
        self.cluster = cluster
        self.provisioners = provisioning_controller
        self.preferences = Preferences(clock=clock)
        self.volume_topology = VolumeTopology(cluster)
        self.allow_pod_affinity = allow_pod_affinity
        # wait=True blocks each reconcile on the batch gate, the reference's
        # goroutine idiom (controller.go:86-115: 10k goroutines are free).
        # wait=False is the thread-pool idiom the controller process runs
        # with: enqueue and return — a pod sitting in an unresolved batch is
        # recognized via worker.is_pending and NOT re-relaxed/re-enqueued,
        # and the 5s verify requeue provides the completion check. Without
        # this, a 32-thread pool caps batch formation at ~32 pods/solve
        # under a 10k-pod event storm.
        self.wait = wait

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        pod = self.cluster.try_get("pods", name, namespace)
        if pod is None:
            return None
        if not is_provisionable(pod):
            return None
        # prewarm the pod's solve statics HERE, in the wide reconcile pool,
        # so the worker's solve (one thread, latency-critical) finds every
        # canonical core/request vector memoized instead of building 10k of
        # them inside its latency budget
        from karpenter_tpu_torch.scheduling.statics import statics

        statics(pod)
        errs = validate(pod, self.allow_pod_affinity)
        if errs:
            logger.error("Ignoring pod %s, %s", pod.key, "; ".join(errs))
            return None
        self.select_provisioner(pod)
        return REQUEUE_AFTER

    def select_provisioner(self, pod: Pod) -> bool:
        """Relax → inject volume topology → first matching provisioner →
        enqueue + block on the batch gate (reference: controller.go:86-115).
        Raises ``NoProvisionerMatched`` when every provisioner rejects the pod
        so the manager retries with backoff — each retry relaxes another
        preference (the reference returns an error for the same reason,
        controller.go:107-108)."""
        workers = self.provisioners.list_workers()
        # already enqueued and awaiting its batch: this reconcile is the
        # verify requeue firing early — don't relax another preference or
        # double-enqueue, just keep the requeue clock running
        if any(
            w.is_pending(pod.key) for w in workers if hasattr(w, "is_pending")
        ):
            return True
        if self._defer_to_foreign_owner(pod):
            # fleet mode (docs/fleet.md): the FIRST provisioner (in the
            # same sorted-name priority order single-replica selection
            # uses) that admits this pod belongs to another replica's
            # shard — that replica's selection loop serves it. Requeue
            # quietly; proceeding here would double-provision pods two
            # shards both admit, and raising would RELAX a preference per
            # retry on a pod this replica must not touch (pods are shared
            # objects).
            return False
        self.preferences.relax(pod)
        self.volume_topology.inject(pod)
        if not workers:
            return False
        errs = []
        for worker in workers:
            perrs = worker.provisioner.spec.constraints.validate_pod(pod)
            if perrs:
                errs.append(f"tried provisioner/{worker.provisioner.name}: {'; '.join(perrs)}")
            else:
                gate = worker.add(pod)
                if self.wait:
                    gate.wait(timeout=30)
                return True
        # the decision plane's admission feed (docs/decisions.md): an
        # every-provisioner rejection is a decision too — classify the
        # dimension (taint intolerance vs requirement mismatch), extend
        # the pod's consecutive-failure streak, and close the loop with
        # the PodUnschedulable Warning event once the streak crosses the
        # threshold. Best-effort: audit trouble never changes routing.
        self._note_admission_failure(pod, errs)
        raise NoProvisionerMatched(
            f"pod {pod.key} matched 0/{len(workers)} provisioners: {'; '.join(errs)}"
        )

    def _note_admission_failure(self, pod: Pod, errs: List[str]) -> None:
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs import decisions as dec

        if not dec.enabled():
            return
        try:
            log = obs.decision_log()
            log.note_admission_failure(pod, errs)
            # per-pod emission: this feed runs once per rejected pod, so
            # only THIS pod's streak is checked (a whole-table sweep here
            # would be O(rejected x failing) event writes per pass)
            log.maybe_emit_for(
                self.cluster, pod.key,
                threshold=getattr(
                    self.provisioners, "unschedulable_event_rounds", 3
                ),
            )
        except Exception:
            logger.debug("admission-failure audit failed", exc_info=True)

    def _defer_to_foreign_owner(self, pod: Pod) -> bool:
        """True when the FIRST cluster-wide provisioner (sorted by name —
        the same priority order ``list_workers`` serves single-replica
        selection in) that admits this pod belongs to another replica's
        shard. Exactly ONE replica answers False per pod, so overlapping
        provisioners split across shards never double-provision it. The
        ownership check short-circuits first: non-fleet deployments pay
        nothing here. The admission check runs against the raw spec — more
        permissive than the owner's catalog-enriched view; on the rare
        divergence the owner's own retry/relax loop still serves the pod."""
        ownership = getattr(self.provisioners, "ownership", None)
        if ownership is None:
            return False
        for prov in sorted(
            self.cluster.provisioners(), key=lambda p: p.metadata.name
        ):
            if prov.metadata.deletion_timestamp is not None:
                continue
            if prov.spec.constraints.validate_pod(pod):
                continue  # does not admit; next priority
            return not ownership.owns(prov.metadata.name)
        return False


class NoProvisionerMatched(Exception):
    """Every active provisioner rejected the pod this round."""
