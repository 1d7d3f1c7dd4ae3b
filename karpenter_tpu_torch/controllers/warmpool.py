"""Speculative warm-pool provisioning: launch ahead of forecast demand.

The port's copy of ``karpenter_tpu/controllers/warmpool.py``. It builds no
``Scheduler``: a warm node is launched from the provisioner's constraint
template, and the pods the steal does not place reach the card through the
provisioning worker's ``device``.

The arrival forecaster (karpenter_tpu_torch/forecast/) predicts, per
provisioner, how many pods will arrive within the launch-to-ready
horizon. This controller turns the prediction's upper band into standing
capacity: every wave it compares predicted node demand against the
provisioner's current warm pool and launches the deficit *speculatively*
— through the same constraint-template path the provisioning worker
uses, under the same fence/ownership/limit guards, journaled with the
``speculative`` marker so crash recovery and the TTL reaper own every
outcome:

- a speculative launch writes its Node with the ``karpenter.sh/warm-pool``
  annotation and leaves its journal entry OPEN — the entry is the TTL
  breadcrumb, not an orphan;
- demand claims the node BEFORE the solver: the provisioning worker's
  warm-hit steal binds pods to a warm node, removes the annotation, and
  resolves the journal token;
- no demand within ``--warm-pool-ttl`` → the GC replay ladder
  (launch/recovery.py) reclaims the instance (``SPECULATION_EXPIRED``);
- a crash anywhere in between → the ordinary adopt/confirm ladder, with
  adopted speculative orphans re-entering the pool.

Brownout rung 1 pauses speculation (``set_paused`` — re-asserted every
brownout tick, checked again between launches so a rung change freezes a
wave mid-flight); fenced replicas never speculative-create. Waves land in
the decision audit ring beside the provisioning rounds, so a replay of
the ring sees the speculation as well as the demand.
"""

from __future__ import annotations

import logging
import math
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.cloudprovider.types import NodeRequest
from karpenter_tpu_torch.kube.client import Cluster, Conflict
from karpenter_tpu_torch.launch import recovery

logger = logging.getLogger("karpenter.warmpool")

# Wave cadence: fast enough that a flash crowd's forecast turns into
# standing capacity within one launch-to-ready horizon, slow enough that
# the node scan + forecast reads stay negligible.
WARM_POOL_INTERVAL = 10.0

# Per-provisioner standing-pool ceiling: the upper band is a prediction,
# and an unbounded predictor must never be able to buy unbounded capacity.
DEFAULT_MAX_WARM_NODES = 10

WARM_POOL_KEY = "__warmpool__"  # never a valid node name (not DNS-1123)


class WarmPoolController:
    """The standing speculation wave (same self-rescheduling-reconcile
    idiom as the GC sweep). ``provisioning`` is the
    ``ProvisioningController`` — the workers it runs carry the enriched
    constraint templates, the fence, and the ownership checks every
    speculative create re-uses."""

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider,
        provisioning,
        journal=None,
        ownership=None,
        interval: float = WARM_POOL_INTERVAL,
        warm_pool_ttl: float = recovery.DEFAULT_WARM_POOL_TTL,
        max_nodes: int = DEFAULT_MAX_WARM_NODES,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.provisioning = provisioning
        self.journal = journal
        self.ownership = ownership  # fleet.ShardManager, or None = own all
        self.interval = interval
        self.warm_pool_ttl = warm_pool_ttl
        self.max_nodes = max_nodes
        # brownout rung 1 (resilience/brownout.py): True stops NEW
        # speculation — checked at wave start AND between launches so a
        # rung arriving mid-wave freezes the remainder; existing warm
        # nodes stay claimable and age out through the TTL
        self._paused = False  # guarded-by: self._mu
        self._mu = threading.Lock()
        # bench/test observability beside the prometheus counters
        self.speculative_launches = 0
        self.waves = 0

    # -- brownout surface ----------------------------------------------------
    def set_paused(self, paused: bool) -> None:
        with self._mu:
            changed = self._paused != bool(paused)
            self._paused = bool(paused)
        metrics.WARMPOOL_PAUSED.set(1 if paused else 0)
        if changed:
            logger.warning(
                "warm-pool speculation %s",
                "paused (brownout)" if paused else "resumed",
            )

    def paused(self) -> bool:
        with self._mu:
            return self._paused

    # -- reconcile -----------------------------------------------------------
    def reconcile(self, key: str) -> Optional[float]:
        if key != WARM_POOL_KEY:
            return None
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller

        reconciling_controller.set("warmpool")
        try:
            with obs.tracer().span("warmpool.wave") as sp:
                self._wave(sp)
        except Exception:
            # one raised wave defers speculation a tick; demand still
            # provisions normally through the worker path
            logger.exception("warm-pool wave failed")
        self.waves += 1
        return self.interval

    def _wave(self, span) -> None:
        from karpenter_tpu_torch import obs

        eng = obs.forecaster()
        if eng is None:
            span.set_attribute("skipped", "no_forecaster")
            return
        if self.paused():
            span.set_attribute("skipped", "paused")
            return
        if self.ownership is not None and getattr(
            self.ownership, "fenced", lambda: False
        )():
            # apiserver unreachable past lease expiry: a peer may own
            # these shards already — speculating now is the split-brain
            # double-launch the fence exists to prevent
            metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(reason="fenced").inc()
            span.set_attribute("skipped", "fenced")
            return
        launched_total = 0
        for worker in self.provisioning.list_workers():
            name = worker.provisioner.name
            if self.ownership is not None and not self.ownership.owns(name):
                continue
            forecast = eng.predict(name)
            want = self._nodes_wanted(forecast, eng)
            standing = len(self._warm_nodes(name))
            metrics.WARMPOOL_SIZE.labels(provisioner=name).set(standing)
            deficit = min(want, self.max_nodes) - standing
            if deficit <= 0:
                continue
            launched_total += self._launch_wave(
                worker, deficit, forecast, standing, span
            )
        span.set_attribute("launched", launched_total)

    @staticmethod
    def _nodes_wanted(forecast: dict, eng) -> int:
        """Predicted pod arrivals (upper band) over the launch-to-ready
        horizon, converted to nodes through the observed pods-per-node
        packing density."""
        pods = float(forecast.get("predicted_pods_upper", 0.0))
        if pods <= 0:
            return 0
        return int(math.ceil(pods / max(eng.pods_per_node(), 1.0)))

    def _warm_nodes(self, provisioner: str) -> List[Node]:
        """This provisioner's standing (unclaimed, not terminating) warm
        nodes, name-sorted so the steal and the wave agree on order."""
        out = [
            n for n in self.cluster.nodes()
            if n.metadata.labels.get(lbl.PROVISIONER_NAME_LABEL) == provisioner
            and lbl.WARM_POOL_ANNOTATION in n.metadata.annotations
            and n.metadata.deletion_timestamp is None
        ]
        out.sort(key=lambda n: n.metadata.name)
        return out

    def _launch_wave(
        self, worker, deficit: int, forecast: dict, standing: int, span
    ) -> int:
        """Launch ``deficit`` speculative nodes for one provisioner and
        record the wave as a decision. The audit record lands BEFORE the
        launches (same discipline as the provisioning round): even a wave
        whose creates crash leaves its decision replayable."""
        name = worker.provisioner.name
        decision_id = self._record_wave(
            name, deficit, forecast, standing, span
        )
        def one(_i: int) -> bool:
            # brownout rung landed mid-wave: tasks not yet started freeze
            # here — the remainder of the wave never reaches the cloud
            if self.paused():
                span.set_attribute("froze", "paused")
                return False
            return self._launch_speculative(worker, decision_id, span)

        if deficit == 1:
            launched = 1 if one(0) else 0
        else:
            # concurrent creates, same shape as the worker's launch fan-out:
            # a deficit of N must not pay N serial launch latencies — the
            # whole point is standing capacity BEFORE the demand lands
            with ThreadPoolExecutor(max_workers=min(8, deficit)) as pool:
                launched = sum(bool(ok) for ok in pool.map(one, range(deficit)))
        if launched:
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder_for(self.cluster).event(
                "Provisioner", name, "SpeculativeLaunch",
                f"launched {launched} warm-pool node(s) ahead of demand "
                f"(forecast {forecast.get('predicted_pods_upper', 0.0):.1f} "
                f"pods over {forecast.get('horizon_s', 0.0):.0f}s, "
                f"{standing} standing)",
                decision_id=decision_id,
            )
        span.set_attribute(f"launched.{name}", launched)
        return launched

    def _record_wave(
        self, provisioner: str, deficit: int, forecast: dict, standing: int,
        span,
    ) -> str:
        """Warm-pool waves ride the same decision ring as provisioning
        rounds: zero pods considered, the speculative intent in
        ``state``."""
        from karpenter_tpu_torch import obs

        try:
            rec = obs.decision_log().record_round(
                provisioner=provisioner,
                pods=[],
                nodes=[],
                trace_id=span.trace_id,
                state={
                    "warm_pool_wave": True,
                    "deficit": deficit,
                    "standing": standing,
                    "forecast": {
                        k: v for k, v in forecast.items()
                        if isinstance(v, (int, float, str))
                    },
                },
            )
            return rec["id"] if rec is not None else ""
        except Exception:
            logger.debug("warm-pool wave record failed", exc_info=True)
            return ""

    def _launch_speculative(self, worker, decision_id: str, parent_span) -> bool:
        """One speculative create through the provisioning template path:
        same guards, same journal, same token discipline — differing only
        in the ``speculative`` journal marker, the warm annotation, and
        the entry deliberately staying OPEN (no pods to bind; resolution
        belongs to the claim or the TTL reaper)."""
        from karpenter_tpu_torch import obs

        name = worker.provisioner.name
        try:
            # late split-brain guards, re-checked per create like the
            # worker's _launch_one — a wave outlives a rebalance
            if worker.fenced():
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="fenced"
                ).inc()
                logger.warning(
                    "skipping speculative launch for %s: replica fenced", name
                )
                return False
            if not worker.owned():
                metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(
                    reason="lost_ownership"
                ).inc()
                logger.warning(
                    "skipping speculative launch for %s: shard lease lost",
                    name,
                )
                return False
            # fresh limits check against live status: speculation must
            # never spend capacity the provisioner's limits reserve for
            # real demand
            live = self.cluster.try_get("provisioners", name, namespace="")
            prov = live if live is not None else worker.provisioner
            if prov.spec.limits is not None:
                err = prov.spec.limits.exceeded_by(prov.status.resources)
                if err:
                    logger.info("skipping speculative launch: %s", err)
                    return False
            constraints = worker.provisioner.spec.constraints
            options = self.cloud_provider.get_instance_types(
                constraints.provider
            )
            with obs.tracer().span(
                "warmpool.launch",
                parent=parent_span,
                attrs={"provisioner": name, "decision_id": decision_id},
            ) as sp:
                trace = obs.to_traceparent(sp)
                token = uuid.uuid4().hex
                sp.set_attribute("launch_token", token[:12])
                if self.journal is not None:
                    self.journal.record_intent(
                        token, name, trace, speculative=True
                    )
                node = self.cloud_provider.create(
                    NodeRequest(
                        template=constraints,
                        instance_type_options=options,
                        launch_token=token,
                    )
                )
                template = constraints.to_node()
                node.metadata.labels = {
                    **template.metadata.labels, **node.metadata.labels,
                }
                node.metadata.labels[lbl.PROVISIONER_NAME_LABEL] = name
                node.metadata.annotations[lbl.WARM_POOL_ANNOTATION] = "true"
                if trace:
                    node.metadata.annotations[obs.TRACE_ANNOTATION] = trace
                node.metadata.annotations.setdefault(
                    lbl.LAUNCH_TOKEN_ANNOTATION, token
                )
                node.metadata.finalizers = list(
                    set(node.metadata.finalizers)
                    | set(template.metadata.finalizers)
                )
                node.spec.taints = node.spec.taints + [
                    t for t in template.spec.taints
                    if t.key not in {x.key for x in node.spec.taints}
                ]
                try:
                    self.cluster.create("nodes", node)
                except Conflict:
                    pass  # node self-registered first — idempotent create
                if self.journal is not None:
                    # entry stays OPEN past mark_created: a speculative
                    # launch has no bind to resolve it — the claim or the
                    # TTL reaper does
                    self.journal.mark_created(token, node.metadata.name)
            self.speculative_launches += 1
            metrics.WARMPOOL_SPECULATIVE_LAUNCHES.labels(
                provisioner=name
            ).inc()
            return True
        except Exception:
            # the journal entry (if written) stays: recovery confirms
            # NEVER_LAUNCHED or adopts, exactly like a crashed real launch
            logger.exception("speculative launch for %s", name)
            return False

    def register(self, manager) -> None:
        manager.enqueue("warmpool", WARM_POOL_KEY)
