"""Consolidation: cost-optimal re-pack of the live cluster (the port's copy
of ``karpenter_tpu/controllers/consolidation.py``).

Feed the provisioner's live pods through the same batched solver that
serves pending pods and compare the proposed packing's price against what
is running now (BASELINE.json config 5, "Consolidation re-pack of 1k live
nodes"). On a ``solver: tpu`` provisioner the re-pack is one
``Scheduler.solve`` on ``device``: on the card one fused launch of
``pack_first_fit`` or ``pack_first_fit_v2`` (two when the node table
saturates and the ``n_max = P`` retry runs).

Plan: collect the provisioner's consolidatable nodes (ready, not deleting,
no do-not-evict pods, no PDB-frozen pods) and their reschedulable pods,
re-solve them in one batch on a new ``Scheduler`` over a shadow cluster,
then reduce the proposal to a MINIMAL-MOVE wave (``solver/repack.py``):
nodes already holding their proposed packing are kept untouched, the rest
retire cheapest-disruption-first — price discounted by the interruption
risk, plus a per-pod move charge.

Execute has two migration modes:

- ``bind`` (the default on the in-memory ``Cluster``, which permits
  rebinding): launch replacements through the cloud provider and rebind
  pods directly; a real apiserver rejects Binding a pod that already has a
  nodeName, so an ``ApiCluster`` refuses this mode; every retired node is
  deleted at once and the termination controller drains it;
- ``evict`` (the default on an ``ApiCluster``): retire at most
  ``wave_size`` victims a reconcile, admitted by the disruption budget.
  With an ``orchestrator`` wired, each victim runs the interruption
  subsystem's taint→replace→drain sequence (its pods are released and
  submitted to provisioning BEFORE any eviction); without one, each is
  deleted and the termination controller drains it. Workload recreations
  flow through the normal provisioning path. The next wave
  waits until the victims are gone and the pods displaced since the wave
  began are seated (``wave_settled``).

The robustness envelope around an evict wave: the disruption budget
(``controllers/disruption.py``), enforced per wave AND across concurrently
settling waves through a shared ledger; the ``journal``
(``launch/journal.py``, ``consolidation`` marker): the wave's victims are
journaled BEFORE the first cordon, so a mid-wave crash is replayed by the
recovery ladder — survivors un-cordoned, entry resolved; a decision record
per wave whose id the journal entry and every wave event carry; brownout
rung 1 pauses new waves; a fenced or non-owning replica never executes
one. With neither ``orchestrator`` nor ``journal`` an evict wave takes the
plain delete path and leaves no breadcrumb.
"""

from __future__ import annotations

import copy
import logging
import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, Pod
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, InstanceType, NodeRequest
from karpenter_tpu_torch.controllers.disruption import (
    BudgetLedger,
    pdb_frozen_pod_keys,
    resolve_budget,
    risk_tracker,
)
from karpenter_tpu_torch.controllers.provisioning import REQUEUE_INTERVAL
from karpenter_tpu_torch.kube.client import Cluster, Conflict
from karpenter_tpu_torch.scheduling.ffd import VirtualNode
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.solver.repack import minimal_move_match, order_retirement
from karpenter_tpu_torch.utils import node as nodeutil
from karpenter_tpu_torch.utils import pod as podutil

logger = logging.getLogger("karpenter.consolidation")

# Savings below this fraction of current cost are not worth the churn.
MIN_SAVINGS_FRACTION = 0.05

# Evict-mode retirement pacing: at most this many nodes are handed to the
# termination controller per reconcile wave, and the next wave waits until
# the prior wave's nodes are gone AND
# the recreated pods have re-seated. The reference consolidates one command
# at a time and paces evictions through a rate-limited queue
# (termination/eviction.go:45-56); an unpaced 1k-node plan is a
# cluster-wide availability dip with only per-pod PDB retries as a brake.
EVICT_WAVE_SIZE = 5
WAVE_CHECK_INTERVAL = 10.0
# safety valve: a wave that has not settled after this long (e.g. an
# unrelated permanently-unschedulable pod appeared, or a replacement
# launch failed terminally) stops blocking further consolidation — and is
# FINISHED cleanly (survivors un-cordoned, journal resolved, budget
# released), because bounded disruption must not become unbounded deadlock
WAVE_SETTLE_TIMEOUT = 300.0


@dataclass
class ConsolidationPlan:
    provisioner: Provisioner
    nodes: List[Node] = field(default_factory=list)  # candidates, old world
    pods: List[Pod] = field(default_factory=list)  # reschedulable pods
    proposed: List[VirtualNode] = field(default_factory=list)  # new world
    current_price: float = 0.0
    proposed_price: float = 0.0
    # the minimal-move reduction (solver/repack.py): candidates whose
    # proposed packing is what they already run stay untouched; only the
    # rest retire (cheapest-disruption-first) / launch
    keep: List[Node] = field(default_factory=list)
    retire: List[Node] = field(default_factory=list)
    launch: List[VirtualNode] = field(default_factory=list)
    moves: List[Pod] = field(default_factory=list)
    node_pods: Dict[str, List[Pod]] = field(default_factory=dict)

    @property
    def savings(self) -> float:
        return self.current_price - self.proposed_price

    @property
    def worthwhile(self) -> bool:
        if not self.nodes or self.current_price <= 0:
            return False
        # every reschedulable pod must have a seat in the new world
        placed = sum(len(v.pods) for v in self.proposed)
        if placed < len(self.pods):
            return False
        if not self.retire:
            # minimal-move says the cluster already IS the proposal
            return False
        return self.savings / self.current_price >= MIN_SAVINGS_FRACTION


class ConsolidationController:
    """Batched re-pack + deprovision. Registered per provisioner; requeues on
    the provisioning cadence. ``device`` is where a ``solver: tpu``
    provisioner's re-pack runs (``cuda``, the default, needs a card;
    ``cpu`` runs the plain PyTorch version); each plan builds a new
    ``Scheduler`` on it, as the reference builds one per plan.
    ``migration`` None means ``evict`` on an ``ApiCluster`` and ``bind``
    on any other store."""

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        enabled: bool = True,
        solver_service_address: Optional[str] = None,
        migration: Optional[str] = None,  # "bind" | "evict" | None = auto
        wave_size: int = EVICT_WAVE_SIZE,
        ownership=None,
        decisions=None,  # obs.decisions.DecisionLog override (tests)
        ledger: Optional[BudgetLedger] = None,
        risk=None,  # disruption.InterruptionRiskTracker override (tests)
        default_budget: Optional[str] = None,
        orchestrator=None,  # interruption.Orchestrator (taint→replace→drain)
        journal=None,  # launch.journal.LaunchJournal (wave crash safety)
        device="cuda",
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.enabled = enabled
        self.solver_service_address = solver_service_address
        self.device = device
        # the shard owner (or None): consolidation disrupts a
        # provisioner's nodes, so only the shard owner may plan/execute a
        # wave — N un-sharded replicas would each retire wave_size nodes
        # concurrently (N× the configured disruption pacing)
        self.ownership = ownership
        self._decisions = decisions
        # the disruption-safety envelope — each piece optional: no
        # orchestrator → plain delete path, no journal → no crash
        # breadcrumb, no budget → wave-size pacing only
        self.orchestrator = orchestrator
        self.journal = journal
        self.ledger = ledger if ledger is not None else BudgetLedger()
        self.risk = risk if risk is not None else risk_tracker()
        self.default_budget = default_budget
        # observability beside the prometheus counters
        self.waves_executed = 0
        self.moves_executed = 0
        self.nodes_reclaimed = 0
        self.budget_blocked = 0
        self.cost_delta_usd = 0.0
        from karpenter_tpu_torch.kube.apiserver import ApiCluster

        if migration is None:
            # a real apiserver rejects rebinding a running pod
            migration = "evict" if isinstance(cluster, ApiCluster) else "bind"
        if migration not in ("bind", "evict"):
            raise ValueError(f"migration must be bind|evict, got {migration}")
        self.wave_size = max(1, wave_size)
        # in-flight evict wave PER PROVISIONER (reconciles of different
        # provisioners run concurrently): name -> (node names, pod keys
        # already pending when the wave launched, settle deadline, journal
        # token, decision id)
        self._wave_lock = threading.Lock()
        self._pending_waves: Dict[str, tuple] = {}
        # brownout ladder rung 1 (resilience/brownout.py): consolidation is
        # VOLUNTARY disruption — evicting pods creates the exact pending
        # work an overloaded provisioner is already drowning in, so it is
        # the first wave the ladder pauses. In-flight waves still settle;
        # only NEW plans are deferred.
        self._paused = False  # guarded-by: self._wave_lock
        if migration == "bind" and isinstance(cluster, ApiCluster):
            # would fail mid-execute on the first rebind (409), leaking the
            # already-launched replacements next to the old capacity
            raise ValueError(
                "bind migration cannot work against a real apiserver "
                "(Binding an assigned pod is rejected); use evict"
            )
        self.migration = migration

    def _decision_log(self):
        if self._decisions is not None:
            return self._decisions
        from karpenter_tpu_torch import obs

        return obs.decision_log()

    # -- planning ----------------------------------------------------------
    def plan(self, provisioner: Provisioner) -> ConsolidationPlan:
        catalog = self.cloud_provider.get_instance_types(
            provisioner.spec.constraints.provider
        )
        price_by_type: Dict[str, float] = {it.name: it.effective_price() for it in catalog}
        nodes, pods, node_pods = self._candidates(provisioner)
        plan = ConsolidationPlan(
            provisioner=provisioner, nodes=nodes, pods=pods, node_pods=node_pods
        )
        if not nodes:
            return plan
        plan.current_price = sum(
            price_by_type.get(n.metadata.labels.get(lbl.INSTANCE_TYPE, ""), 0.0)
            for n in nodes
        )
        # the batched re-pack: the whole cluster's pods in ONE solve. Solve on
        # clones — topology injection writes nodeSelectors — against a shadow
        # cluster with the candidates removed: the candidates' own live pods
        # must not count as existing topology/affinity occupants, or
        # anti-affinity workloads could never consolidate (their old seats
        # would block their new ones).
        clones = [copy.deepcopy(p) for p in pods]
        for clone in clones:
            clone.spec.node_name = ""
        shadow = self._shadow_cluster(nodes, pods)
        scheduler = Scheduler(
            shadow, device=self.device, solver_service_address=self.solver_service_address
        )
        plan.proposed = scheduler.solve(provisioner, catalog, clones) if pods else []
        plan.proposed_price = sum(
            v.instance_type_options[0].effective_price() for v in plan.proposed
        )
        # minimal-move reduction + disruption-cost retirement order
        match = minimal_move_match(nodes, node_pods, plan.proposed)
        plan.keep = match.keep
        plan.launch = match.launch
        plan.moves = match.moves
        plan.retire = order_retirement(
            match.retire, node_pods, price_by_type, self.risk.risk
        )
        return plan

    def _shadow_cluster(self, excluded_nodes: List[Node], excluded_pods: List[Pod]) -> Cluster:
        """The world as it will look once the candidates are gone: every
        other node/pod plus the daemonsets (for overhead computation). The
        shadow is read-only for the solve, so live objects are seeded as-is —
        no O(cluster) deepcopy per planning tick."""
        shadow = Cluster(clock=self.cluster.clock)
        gone_nodes = {n.metadata.name for n in excluded_nodes}
        gone_pods = {(p.metadata.namespace, p.metadata.name) for p in excluded_pods}
        for node in self.cluster.nodes():
            if node.metadata.name not in gone_nodes:
                shadow.seed("nodes", node)
        for pod in self.cluster.pods():
            if (pod.metadata.namespace, pod.metadata.name) not in gone_pods:
                shadow.seed("pods", pod)
        for ds in self.cluster.daemonsets():
            shadow.seed("daemonsets", ds)
        return shadow

    def _candidates(
        self, provisioner: Provisioner
    ) -> Tuple[List[Node], List[Pod], Dict[str, List[Pod]]]:
        """Nodes safe to consolidate and the pods that must be re-seated."""
        nodes: List[Node] = []
        pods: List[Pod] = []
        node_pods: Dict[str, List[Pod]] = {}
        # one pass over pods instead of a per-node scan (1k nodes × 10k pods
        # would otherwise be 10M predicate evaluations)
        by_node: Dict[str, List[Pod]] = {}
        for p in self.cluster.pods():
            if p.spec.node_name:
                by_node.setdefault(p.spec.node_name, []).append(p)
        # plan-time victim screening: a pod whose PDB allows zero
        # disruptions right now freezes its node out of candidacy HERE —
        # discovering it at drain time would strand a cordoned node
        # mid-wave with its replacement already paid for
        frozen = pdb_frozen_pod_keys(self.cluster) if self.migration == "evict" else set()
        for node in self.cluster.nodes():
            if node.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) != provisioner.name:
                continue
            if node.metadata.deletion_timestamp is not None:
                continue
            if not nodeutil.is_ready(node) or node.spec.unschedulable:
                continue
            its_pods = [
                p
                for p in by_node.get(node.metadata.name, [])
                if not podutil.is_terminal(p)
                and not podutil.is_owned_by_daemonset(p)
                and not podutil.is_owned_by_node(p)
            ]
            if any(
                p.metadata.annotations.get(lbl.DO_NOT_EVICT_ANNOTATION) == "true"
                for p in its_pods
            ):
                continue
            if frozen and any(p.key in frozen for p in its_pods):
                continue
            if self.migration == "evict" and any(
                not p.metadata.owner_references for p in its_pods
            ):
                # voluntary disruption must not destroy workloads: an
                # ownerless pod has no controller to recreate it after the
                # drain, so its node is not a candidate (bind mode migrates
                # the pod itself and has no such constraint)
                continue
            nodes.append(node)
            pods.extend(its_pods)
            node_pods[node.metadata.name] = its_pods
        return nodes, pods, node_pods

    # -- execution ---------------------------------------------------------
    def _budget_allowed(self, provisioner: Provisioner) -> Optional[int]:
        """Resolve the provisioner's disruption budget against its CURRENT
        node count (like PDB percentages resolve against matching pods).
        Provisioner spec wins over the controller-level default; None =
        no budget configured."""
        spec = getattr(provisioner.spec, "disruption_budget", None) or self.default_budget
        if spec is None or str(spec).strip() == "":
            return None
        total = sum(
            1 for n in self.cluster.nodes()
            if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL)
            == provisioner.name
        )
        return resolve_budget(spec, total)

    def execute(self, plan: ConsolidationPlan) -> List[Node]:
        """Retire the old world; build the new one per the migration mode
        (bind: launch + rebind here; evict: the provisioning path rebuilds
        from the recreated pending pods)."""
        launched: List[Node] = []
        prov_name = plan.provisioner.metadata.name
        if self.migration == "bind":
            for vnode in plan.launch:
                node = self.cloud_provider.create(
                    NodeRequest(
                        template=vnode.constraints,
                        instance_type_options=vnode.instance_type_options,
                    )
                )
                template = vnode.constraints.to_node()
                node.metadata.labels = {**template.metadata.labels, **node.metadata.labels}
                node.metadata.labels[lbl.PROVISIONER_NAME_LABEL] = plan.provisioner.name
                node.metadata.finalizers = list(
                    set(node.metadata.finalizers) | set(template.metadata.finalizers)
                )
                # replacement nodes are immediately schedulable:
                # consolidation binds directly, so the not-ready scheduler
                # fence is unnecessary
                node.spec.taints = [
                    t for t in template.spec.taints if t.key != lbl.NOT_READY_TAINT_KEY
                ]
                try:
                    self.cluster.create("nodes", node)
                except Conflict:
                    pass
                launched.append(node)
                for pod in vnode.pods:
                    live = self.cluster.try_get(
                        "pods", pod.metadata.name, pod.metadata.namespace
                    )
                    if live is not None:
                        self.cluster.bind(live, node.metadata.name)
        # retire the old world. In bind mode every pod was already rebound
        # above, so the drains are empty and all retired nodes go at once.
        # In evict mode the drain IS the migration (workload controllers
        # recreate, and the pending recreations drive the provisioner to
        # rebuild capacity) — so retirement is PACED (at most wave_size per
        # reconcile, cheapest disruption first) and BUDGETED (the ledger
        # admits only what the maxUnavailable-style budget allows across
        # every concurrently-settling wave).
        retire = plan.retire
        decision_id = ""
        if self.migration == "evict":
            wanted = [n.metadata.name for n in retire[: self.wave_size]]
            allowed = self._budget_allowed(plan.provisioner)
            if allowed is None:
                admitted_names = self.ledger.reserve(prov_name, wanted, 10**9)
            else:
                admitted_names = self.ledger.reserve(prov_name, wanted, allowed)
            admitted = set(admitted_names)
            retire = [n for n in retire[: self.wave_size] if n.metadata.name in admitted]
            blocked = len(wanted) - len(retire)
            log = self._decision_log()
            record = (
                log.record_consolidation(
                    prov_name,
                    victims=admitted_names,
                    keep=len(plan.keep),
                    moves=sum(
                        len(plan.node_pods.get(n, ())) for n in admitted_names
                    ),
                    savings=plan.savings,
                    context={
                        "budget": allowed,
                        "budget_blocked": blocked,
                        "candidates": len(plan.nodes),
                        "plan_retire": len(plan.retire),
                    },
                )
                if log is not None else None
            )
            decision_id = record["id"] if record else ""
            if blocked:
                metrics.CONSOLIDATION_BUDGET_BLOCKED.labels(prov_name).inc(blocked)
                self.budget_blocked += blocked
                from karpenter_tpu_torch.kube.events import recorder_for

                recorder_for(self.cluster).event(
                    "Provisioner", prov_name, "ConsolidationBudgetBlocked",
                    f"disruption budget admitted {len(retire)} of "
                    f"{len(wanted)} wave victim(s) "
                    f"({allowed if allowed is not None else 'unbounded'} "
                    "concurrent disruptions allowed)",
                    type="Warning", decision_id=decision_id,
                )
            if not retire:
                return launched
        # baseline BEFORE the retirement: pods already pending before this
        # wave must not gate settlement, but pods displaced BY the wave
        # (evicted and recreated while the loop runs) must — snapshotting
        # after would let them slip into the baseline
        baseline = (
            {p.key for p in self.cluster.pods() if podutil.is_provisionable(p)}
            if self.migration == "evict"
            else set()
        )
        from karpenter_tpu_torch import obs

        moves = 0
        token = ""
        with obs.tracer().span(
            "consolidation.wave",
            attrs={
                "provisioner": prov_name,
                "victims": len(retire),
                "decision_id": decision_id,
            },
        ) as wave_sp:
            if self.migration == "evict" and self.journal is not None:
                # journal the WHOLE wave before the first victim is
                # touched: the entry is what recovery replays after a
                # mid-wave crash (launch/recovery.py un-cordons survivors)
                token = f"consolidation-{uuid.uuid4().hex[:16]}"
                self.journal.record_intent(
                    token, prov_name, trace=obs.to_traceparent(wave_sp),
                    marker="consolidation",
                    victims=[n.metadata.name for n in retire],
                    decision_id=decision_id,
                )
            for old in retire:
                try:
                    if self.migration == "evict" and self.orchestrator is not None:
                        # taint→replace→drain per victim: replacement pods
                        # are injected into provisioning BEFORE any eviction
                        resp = self.orchestrator.consolidate(
                            old, decision_id=decision_id
                        )
                        if resp is not None:
                            moves += len(resp.migrated)
                            if resp.blocked:
                                # plan-time screening should make this
                                # impossible; a non-zero count is the hard
                                # bar's tripwire, not business as usual
                                metrics.CONSOLIDATION_EVICTED_UNREADY.inc(
                                    len(resp.blocked)
                                )
                    else:
                        moves += len(plan.node_pods.get(old.metadata.name, ()))
                        self.cluster.delete("nodes", old.metadata.name, namespace="")
                except Exception:
                    logger.exception("retiring node %s", old.metadata.name)
        if self.migration == "evict":
            with self._wave_lock:
                self._pending_waves[prov_name] = (
                    [n.metadata.name for n in retire],
                    baseline,
                    self.cluster.clock() + WAVE_SETTLE_TIMEOUT,
                    token,
                    decision_id,
                )
        # plan-time estimate of the wave's $-delta: the admitted victims'
        # prices leave, the launch side's share of the proposal arrives
        # with them (settled waves confirm node counts; prices are catalog
        # facts either way)
        wave_fraction = len(retire) / max(len(plan.retire), 1)
        wave_delta = -plan.savings * wave_fraction
        self.cost_delta_usd += wave_delta
        metrics.CONSOLIDATION_COST_DELTA.labels(prov_name).set(self.cost_delta_usd)
        metrics.CONSOLIDATION_WAVES.labels(prov_name).inc()
        metrics.CONSOLIDATION_MOVES.labels(prov_name).inc(moves or len(plan.moves))
        self.waves_executed += 1
        self.moves_executed += moves or len(plan.moves)
        logger.info(
            "consolidating %d of %d candidate nodes (kept %d in place) -> "
            "%d launched (%s migration), price %.3f -> %.3f (saving %.3f)",
            len(retire), len(plan.nodes), len(plan.keep), len(plan.launch),
            self.migration, plan.current_price, plan.proposed_price,
            plan.savings,
        )
        from karpenter_tpu_torch.kube.events import recorder_for

        recorder_for(self.cluster).event(
            "Provisioner", prov_name, "Consolidated",
            f"retiring {len(retire)} of {len(plan.nodes)} candidate node(s), "
            f"{len(plan.keep)} kept in place ({self.migration} migration), "
            f"hourly price {plan.current_price:.3f} -> {plan.proposed_price:.3f}",
            decision_id=decision_id,
        )
        return launched

    def _finish_wave(
        self, provisioner_name: str, wave: tuple, timed_out: bool
    ) -> None:
        """Close out one wave — on clean settlement AND on the settle
        timeout (a victim deleted out-of-band or a terminally-failed
        replacement launch must not wedge the loop): un-cordon any victim
        still standing (its drain never finished; a cordoned survivor is
        pure capacity loss), resolve the journal entry, release the
        budget, and count what was actually reclaimed."""
        node_names, _baseline, _deadline, token, _decision_id = wave
        reclaimed = 0
        for name in node_names:
            node = self.cluster.try_get("nodes", name, namespace="")
            if node is None:
                reclaimed += 1
                continue
            if node.metadata.deletion_timestamp is not None:
                continue  # drain in flight; termination finishes it
            if not node.spec.unschedulable:
                continue
            from karpenter_tpu_torch.kube.serde import taint_to_wire

            taints_wire = [
                taint_to_wire(t) for t in node.spec.taints
                if not (
                    t.key == lbl.INTERRUPTION_TAINT_KEY
                    and t.value == "consolidation"
                )
            ]
            try:
                self.cluster.merge_patch(
                    "nodes", name,
                    {"spec": {"unschedulable": False, "taints": taints_wire}},
                    namespace="",
                )
                logger.warning(
                    "consolidation wave for %s: un-cordoned surviving "
                    "victim %s (%s)",
                    provisioner_name, name,
                    "settle timeout" if timed_out else "settled without it",
                )
            except Exception:
                logger.exception("un-cordon of wave victim %s", name)
        if self.journal is not None and token:
            try:
                self.journal.resolve(token)
            except Exception:
                logger.exception("resolving wave journal entry %s", token)
        self.ledger.release(provisioner_name, node_names)
        if reclaimed:
            metrics.CONSOLIDATION_RECLAIMED_NODES.labels(provisioner_name).inc(
                reclaimed
            )
            self.nodes_reclaimed += reclaimed

    def wave_settled(self, provisioner_name: str) -> bool:
        """Has this provisioner's in-flight evict wave fully landed? True
        when every retired node is gone (termination finished its drain)
        and no pod that appeared SINCE the wave launched is still waiting
        for capacity (pods already pending before the wave don't gate it) —
        only then may the next wave disrupt more nodes. A wave past its
        settle deadline stops gating AND is finished cleanly (survivors
        un-cordoned, journal resolved, budget released): bounded
        disruption must not become unbounded deadlock on an out-of-band
        node delete, a dead replacement launch, or an unrelated stuck
        pod."""
        with self._wave_lock:
            wave = self._pending_waves.get(provisioner_name)
        if wave is None:
            return True
        node_names, baseline, deadline = wave[0], wave[1], wave[2]
        if self.cluster.clock() >= deadline:
            logger.warning(
                "consolidation wave for %s did not settle within %.0fs; "
                "finishing it and releasing the gate",
                provisioner_name, WAVE_SETTLE_TIMEOUT,
            )
            with self._wave_lock:
                wave = self._pending_waves.pop(provisioner_name, None)
            if wave is not None:
                self._finish_wave(provisioner_name, wave, timed_out=True)
            return True
        for name in node_names:
            if self.cluster.try_get("nodes", name, namespace="") is not None:
                return False
        if any(
            podutil.is_provisionable(p) and p.key not in baseline
            for p in self.cluster.pods()
        ):
            return False
        with self._wave_lock:
            wave = self._pending_waves.pop(provisioner_name, None)
        if wave is not None:
            self._finish_wave(provisioner_name, wave, timed_out=False)
        return True

    # -- brownout ----------------------------------------------------------
    def set_paused(self, paused: bool) -> None:
        with self._wave_lock:
            self._paused = bool(paused)

    def paused(self) -> bool:
        with self._wave_lock:
            return self._paused

    # -- reconcile ---------------------------------------------------------
    def reconcile(self, name: str) -> Optional[float]:
        if not self.enabled:
            return None
        provisioner = self.cluster.try_get("provisioners", name, namespace="")
        if provisioner is None:
            return None
        if self.ownership is not None and not self.ownership.owns(name):
            # another replica's shard: re-check on a
            # lease-scale cadence so a rebalance picks the work up here
            from karpenter_tpu_torch.controllers.provisioning import (
                OWNERSHIP_RECHECK_INTERVAL,
            )

            return OWNERSHIP_RECHECK_INTERVAL
        if self.ownership is not None and getattr(
            self.ownership, "fenced", lambda: False
        )():
            # a fenced replica (lease expired mid-partition) must not
            # mutate the cluster — same rule as the GC sweep
            from karpenter_tpu_torch.controllers.provisioning import (
                OWNERSHIP_RECHECK_INTERVAL,
            )

            return OWNERSHIP_RECHECK_INTERVAL
        if self.paused():
            # brownout: no new voluntary disruption while the ladder is
            # engaged — re-check on the wave cadence so recovery picks the
            # work back up quickly
            return WAVE_CHECK_INTERVAL
        if not self.wave_settled(name):
            # the previous wave's pods have not all re-seated: no new
            # disruption yet, check back shortly
            return WAVE_CHECK_INTERVAL
        allowed = self._budget_allowed(provisioner)
        if allowed == 0:
            # budget "0": voluntary disruption disabled entirely — don't
            # even pay for planning
            return REQUEUE_INTERVAL
        plan = self.plan(provisioner)
        if plan.worthwhile:
            self.execute(plan)
            with self._wave_lock:
                in_flight = name in self._pending_waves
            if in_flight:
                return WAVE_CHECK_INTERVAL
        return REQUEUE_INTERVAL

    def register(self, manager) -> None:
        def on_provisioner(event: str, provisioner) -> None:
            manager.enqueue("consolidation", provisioner.metadata.name)

        self.cluster.watch("provisioners", on_provisioner)
