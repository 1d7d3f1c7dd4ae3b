"""Garbage collection: the crash-consistency sweep over live instances.

The launch path is three writes against three stores (cloud create → Node
object → binds) and the write-ahead journal (launch/journal.py) brackets
them; this controller is the read side that makes the bracket mean
something. Each sweep, on the shards this replica owns (shard-owner
routing — two replicas must never adopt or reap the same
instance):

1. **Journal replay** — every unresolved entry old enough to have lost
   its process runs the adopt/confirm ladder (launch/recovery.py):
   re-describe the token against ``CloudProvider.list_instances()``,
   adopt the instance no Node tracks (write the Node, rejoin the launch
   trace), or confirm it never launched and drop the entry.
2. **Leak sweep** — live instances with no Node AND no journal entry
   (token-less out-of-band launches, pre-token builds, a journal lost
   with its host) older than the grace period are terminated through the
   termination controller's terminator: capacity nobody can account for must die,
   not bill forever. The grace period is what protects instances still
   mid-registration — including a multi-host TPU slice's pending
   siblings, which stay token-less until their claiming creates land.

Reference Karpenter ships the same loop as instance tagging + node
garbage collection; this one adds the journal so interrupted launches
are *adopted* instead of re-paid.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.cloudprovider.types import LiveInstance
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.launch import recovery
from karpenter_tpu_torch.launch.journal import LaunchJournal

logger = logging.getLogger("karpenter.gc")

# Sweep cadence: one GC period is the adoption-latency bar the chaos
# crash-storm holds recovery to, so it must stay well under the emptiness
# TTL that would reap an adopted-then-idle node.
GC_INTERVAL = 30.0

# How old an untracked, unjournaled instance must be before it is declared
# a leak: registration (create → Node write → ready) takes seconds, and a
# multi-host slice's pending siblings wait token-less for their claiming
# creates — reaping those would kill a healthy launch in flight.
LEAK_GRACE_PERIOD = 120.0

GC_POLL_KEY = "__gc__"  # never a valid node name (not DNS-1123)


class GarbageCollectionController:
    """The standing sweep (same self-rescheduling-reconcile idiom as the
    interruption poll). ``journal`` may be None — the leak sweep still
    runs; adoption needs the journal's breadcrumbs."""

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider,
        journal: Optional[LaunchJournal] = None,
        termination=None,
        ownership=None,
        gc_interval: float = GC_INTERVAL,
        grace_period: float = LEAK_GRACE_PERIOD,
        replay_after: Optional[float] = None,
        warm_pool_ttl: float = recovery.DEFAULT_WARM_POOL_TTL,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.journal = journal
        self.termination = termination  # TerminationController (terminator)
        self.ownership = ownership  # fleet.ShardManager, or None = own all
        self.gc_interval = gc_interval
        self.grace_period = grace_period
        # unclaimed speculative (warm-pool) launches older than this are
        # reclaimed by the replay ladder even though their instance is live
        self.warm_pool_ttl = warm_pool_ttl
        # entries younger than this may still have a live launching
        # process. The floor is recovery.DEFAULT_REPLAY_AFTER, sized past
        # the WORST-case intent-to-commit window (fleet-limiter stall +
        # metered retry deadline): resolving an entry NEVER_LAUNCHED while
        # its create is still in flight would destroy the very breadcrumb
        # a subsequent crash needs — the orphan would then age into the
        # leak sweep instead of being adopted. A sweep cadence slower than
        # the floor raises the age-in with it.
        self.replay_after = (
            replay_after if replay_after is not None
            else max(gc_interval, recovery.DEFAULT_REPLAY_AFTER)
        )
        # bench/test observability beside the prometheus counters
        self.adopted = 0
        self.leaks_terminated = 0
        self.replays = 0
        self.sweeps = 0
        self.speculation_reclaimed = 0
        self.consolidation_waves_replayed = 0

    # -- shard routing -----------------------------------------------------
    def _owns(self, shard: str) -> bool:
        from karpenter_tpu_torch.fleet import DEFAULT_SHARD

        if self.ownership is None:
            return True
        if shard and self.cluster.try_get(
            "provisioners", shard, namespace=""
        ) is not None:
            return self.ownership.owns(shard)
        # unattributed work (no provisioner, or a deleted one) belongs to
        # the default shard — same routing as interruption notices
        return self.ownership.owns(DEFAULT_SHARD)

    def _shard_for_instance(
        self,
        live: LiveInstance,
        entries_by_token: Dict[str, "recovery.LaunchRecord"],
    ) -> str:
        """A leaked instance has no Node to read the provisioner label
        from — only its journal entry (if any, from this sweep's snapshot)
        attributes it."""
        if live.launch_token:
            entry = entries_by_token.get(live.launch_token)
            if entry is not None:
                return entry.provisioner
        return ""

    # -- reconcile ---------------------------------------------------------
    def reconcile(self, key: str) -> Optional[float]:
        if key != GC_POLL_KEY:
            return None
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.cloudprovider.metrics import reconciling_controller

        reconciling_controller.set("garbage_collection")
        try:
            with obs.tracer().span("gc.sweep") as sp:
                self._sweep(sp)
        except Exception:
            # one raised sweep (a flaked list, a raced write) defers a GC
            # round; the next tick re-checks everything from scratch
            logger.exception("garbage-collection sweep failed")
        self.sweeps += 1
        return self.gc_interval

    def _sweep(self, span) -> None:
        if self.ownership is not None and getattr(
            self.ownership, "fenced", lambda: False
        )():
            # control plane unreachable past lease expiry:
            # this replica can neither trust its Node view nor its shard
            # claims — adopting or terminating now could reap a peer's
            # healthy in-flight launch. Skip the whole sweep until the
            # control plane answers again.
            metrics.FLEET_DUPLICATE_LAUNCH_GUARD.labels(reason="fenced").inc()
            span.set_attribute("skipped", "fenced")
            return
        instances = self.cloud_provider.list_instances()
        if instances is NotImplemented or instances is None:
            # this vendor has no inventory surface: recovery can still
            # resolve never-launched entries? No — without a list there is
            # no way to tell "never launched" from "invisible", so the
            # provider opts out of the sweep entirely (journal entries
            # keep accumulating as the operator's signal)
            span.set_attribute("skipped", "no_list_surface")
            return
        by_token: Dict[str, LiveInstance] = {
            inst.launch_token: inst
            for inst in instances
            if inst.launch_token
        }
        span.set_attribute("instances", len(instances))
        # ONE journal snapshot and ONE node index per sweep: the per-
        # instance journal.get (a flock'd file parse or a store GET)
        # and per-instance full-node scans made the sweep O(n×m) with I/O.
        # The pre-replay snapshot is also the CORRECT shield for the leak
        # sweep: an entry the replay ladder resolves this sweep (adopt /
        # confirm) keeps protecting its instance until next sweep re-reads.
        entries = (
            list(self.journal.unresolved()) if self.journal is not None else []
        )
        index = recovery.NodeIndex(self.cluster)
        self._replay_journal(by_token, entries, index)
        self._sweep_leaks(
            instances, {e.token: e for e in entries}, index,
        )

    def _replay_journal(
        self,
        by_token: Dict[str, LiveInstance],
        entries,
        index: "recovery.NodeIndex",
    ) -> None:
        if self.journal is None:
            return
        from karpenter_tpu_torch import obs

        now = self.cluster.clock()
        for entry in entries:
            if not self._owns(entry.provisioner):
                continue
            # the replay span rejoins the original launch trace: the
            # journal stored the launch span's traceparent at intent time
            parent = obs.from_traceparent(entry.trace)
            with obs.tracer().span(
                "gc.replay",
                parent=parent,
                attrs={
                    "token": entry.token[:12],
                    "provisioner": entry.provisioner,
                    "state": entry.state,
                },
            ) as sp:
                outcome = recovery.replay_entry(
                    self.journal, self.cluster, self.cloud_provider,
                    entry, by_token, now, replay_after=self.replay_after,
                    index=index, warm_pool_ttl=self.warm_pool_ttl,
                    reap=self._reap,
                )
                sp.set_attribute("outcome", outcome)
            if outcome == recovery.PENDING:
                continue
            self.replays += 1
            metrics.LAUNCH_JOURNAL_REPLAYS.labels(outcome=outcome).inc()
            if outcome == recovery.CONSOLIDATION_REPLAYED:
                self.consolidation_waves_replayed += 1
                from karpenter_tpu_torch.kube.events import recorder_for

                recorder_for(self.cluster).event(
                    "Provisioner", entry.provisioner,
                    "ConsolidationWaveReplayed",
                    f"replayed crashed consolidation wave "
                    f"{entry.token[:20]} (decision "
                    f"{entry.decision_id or 'unknown'}): surviving victims "
                    "un-cordoned, journal entry resolved",
                    type="Warning",
                )
            if outcome == recovery.SPECULATION_EXPIRED:
                self.speculation_reclaimed += 1
                metrics.WARMPOOL_EXPIRED.inc()
                from karpenter_tpu_torch.kube.events import recorder_for

                recorder_for(self.cluster).event(
                    "Node", by_token[entry.token].id, "SpeculationExpired",
                    f"reclaimed speculative warm-pool capacity for "
                    f"provisioner {entry.provisioner}: no demand landed "
                    f"within the {self.warm_pool_ttl:.0f}s TTL",
                    type="Warning",
                )
            if outcome == recovery.ADOPTED:
                self.adopted += 1
                metrics.LAUNCH_ORPHANS_ADOPTED.inc()
                from karpenter_tpu_torch.kube.events import recorder_for

                recorder_for(self.cluster).event(
                    "Node", by_token[entry.token].id, "Adopted",
                    f"adopted orphan instance for provisioner "
                    f"{entry.provisioner}: its launching process died "
                    "before the Node object was written",
                    type="Warning",
                )

    def _sweep_leaks(
        self,
        instances: List[LiveInstance],
        entries_by_token: Dict[str, "recovery.LaunchRecord"],
        index: "recovery.NodeIndex",
    ) -> None:
        from karpenter_tpu_torch import obs

        now = self.cluster.clock()
        for live in instances:
            if index.find(live) is not None:
                continue
            if live.launch_token and live.launch_token in entries_by_token:
                continue  # journaled: the replay ladder owns its fate
            age = now - live.created_at
            if age < self.grace_period:
                continue  # mid-registration or a pending multi-host sibling
            if not self._owns(
                self._shard_for_instance(live, entries_by_token)
            ):
                continue
            with obs.tracer().span(
                "gc.terminate_leak",
                attrs={"instance": live.id, "age_s": round(age, 3)},
            ):
                try:
                    self._reap(live)
                except Exception:
                    # the instance outlives one failed reap; next sweep
                    # re-finds it (delete is idempotent + retried)
                    logger.exception("terminating leaked instance %s", live.id)
                    continue
            self.leaks_terminated += 1
            metrics.LAUNCH_INSTANCES_LEAKED.inc()

    def _reap(self, live: LiveInstance) -> None:
        """Terminate an instance no Node tracks and no journal explains,
        through the terminator (cloud delete + event) so the reap
        shares the orchestrator's teardown machinery and audit trail."""
        node = recovery.node_for_instance(self.cluster, self.cloud_provider, live)
        # the fabricated node is ephemeral — never written to the cluster;
        # it exists to drive the terminator's provider delete + event
        node.metadata.finalizers = []
        logger.warning(
            "terminating leaked instance %s (age %.0fs, token %r): no Node "
            "tracks it and no journal entry explains it",
            live.id, self.cluster.clock() - live.created_at,
            live.launch_token[:12] if live.launch_token else "",
        )
        if self.termination is not None:
            self.termination.terminator.terminate(node)
        else:
            self.cloud_provider.delete(node)

    def register(self, manager) -> None:
        manager.enqueue("garbage_collection", GC_POLL_KEY)
