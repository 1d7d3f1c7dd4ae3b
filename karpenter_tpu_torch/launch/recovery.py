"""Replay of unresolved launch-journal entries — the adopt/confirm ladder.

An unresolved entry is a launch whose process may have died mid-flight.
Replay re-describes the entry's launch token against the provider's live
inventory and lands on exactly one of four outcomes:

- ``ADOPTED``        — the instance exists and no Node object tracks it:
  the crash hit between the cloud create and the Node write. Recovery
  writes the Node the dead process never got to (template from the
  entry's provisioner, capacity from the live instance's type), rejoining
  the original launch trace via the entry's stored traceparent, and
  resolves the entry.
- ``NODE_EXISTS``    — the instance exists and a Node already tracks it:
  the crash hit between the Node write and the bind. The capacity is
  tracked; any unbound pods re-enter selection on their own. Resolve.
- ``NEVER_LAUNCHED`` — no live instance carries the token: the create
  never committed (or the instance already died). Nothing leaked. Resolve.
- ``PENDING``        — the entry is younger than the replay grace: the
  launching process may still be alive and mid-create, so recovery must
  not race it. Leave the entry for the next sweep.

The grace window is what separates a *crashed* launch from a *slow* one:
journal entries carry their write time, and replay only touches entries
older than ``replay_after`` seconds. The garbage-collection controller
(controllers/garbage_collection.py) drives this on its sweep cadence.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Node, NodeSpec, NodeStatus, ObjectMeta
from karpenter_tpu_torch.cloudprovider.types import LiveInstance
from karpenter_tpu_torch.launch.journal import LaunchJournal, LaunchRecord

logger = logging.getLogger("karpenter.launch")

# Replay outcomes (returned so the controller can count and log them).
ADOPTED = "adopted"
NODE_EXISTS = "node_exists"
NEVER_LAUNCHED = "never_launched"
PENDING = "pending"
# a speculative (warm-pool) entry aged past --warm-pool-ttl with no
# demand claiming its node: the instance is reclaimed even though it is
# live — the one case where "journaled and running" is NOT protection
SPECULATION_EXPIRED = "speculation_expired"
# a consolidation-wave entry whose owning replica crashed mid-wave: the
# surviving cordoned victims are un-cordoned (schedulable again) and the
# entry resolved — the half-executed wave is rolled forward to a safe
# state, and the next consolidation pass re-plans from scratch
CONSOLIDATION_REPLAYED = "consolidation_replayed"

# LaunchRecord.marker value for journaled consolidation waves
# (controllers/consolidation.py writes it, replay matches on it).
CONSOLIDATION_MARKER = "consolidation"

# Default --warm-pool-ttl: how long an unclaimed speculative launch may
# stand before the GC ladder reclaims it.
DEFAULT_WARM_POOL_TTL = 600.0

# How old an unresolved entry must be before replay touches it: younger
# entries may belong to a live process still between its journal write and
# its bind. The bound must exceed the WORST-case intent-to-commit window,
# not the typical one: a create can sit a cloud fleet limiter's full
# 60s take() timeout AND the metered retry policy's 20s deadline before
# the instance exists — resolving such an entry NEVER_LAUNCHED while the
# create is still in flight destroys the breadcrumb, so a post-commit
# crash would then LEAK (grace-period termination, capacity double-paid)
# instead of adopting. 60 + 20 + slack:
DEFAULT_REPLAY_AFTER = 120.0


def node_for_instance(
    cluster,
    cloud_provider,
    live: LiveInstance,
    provisioner_name: str = "",
    trace: str = "",
    speculative: bool = False,
) -> Node:
    """Fabricate the Node object a crashed launch never wrote.

    Mirrors what ``ProvisionerWorker._launch_one`` builds: the cloud
    half (name/provider-id/capacity/zone labels) comes from the live
    instance + its catalog type; the template half (labels, taints incl.
    not-ready, the termination finalizer) from the provisioner's
    constraints — the finalizer matters most, it is what routes the
    adopted node's eventual deletion through the terminator so the
    INSTANCE dies with the Node."""
    provisioner = (
        cluster.try_get("provisioners", provisioner_name, namespace="")
        if provisioner_name else None
    )
    itype = None
    if live.instance_type:
        try:
            provider_cfg = (
                provisioner.spec.constraints.provider
                if provisioner is not None else None
            )
            for it in cloud_provider.get_instance_types(provider_cfg):
                if it.name == live.instance_type:
                    itype = it
                    break
        except Exception:
            logger.debug("catalog lookup failed during adoption", exc_info=True)

    labels: Dict[str, str] = {}
    taints = []
    finalizers = [lbl.TERMINATION_FINALIZER]
    if provisioner is not None:
        template = provisioner.spec.constraints.to_node()
        labels.update(template.metadata.labels)
        taints = list(template.spec.taints)
        finalizers = list(
            set(template.metadata.finalizers) | {lbl.TERMINATION_FINALIZER}
        )
        labels[lbl.PROVISIONER_NAME_LABEL] = provisioner_name
    if itype is not None:
        labels[lbl.ARCH] = itype.architecture
        labels[lbl.OS] = lbl.OS_LINUX
    if live.instance_type:
        labels[lbl.INSTANCE_TYPE] = live.instance_type
    if live.zone:
        labels[lbl.TOPOLOGY_ZONE] = live.zone
    if live.capacity_type:
        labels[lbl.CAPACITY_TYPE] = live.capacity_type
    labels.update(live.labels)

    annotations = {"karpenter.sh/adopted": "true"}
    if speculative:
        # an adopted speculative orphan re-enters the warm pool: claimable
        # by the worker's warm-hit steal, reclaimable past the TTL
        annotations[lbl.WARM_POOL_ANNOTATION] = "true"
    if live.launch_token:
        annotations[lbl.LAUNCH_TOKEN_ANNOTATION] = live.launch_token
    if trace:
        from karpenter_tpu_torch import obs

        annotations[obs.TRACE_ANNOTATION] = trace

    resources = dict(itype.resources) if itype is not None else {}
    return Node(
        metadata=ObjectMeta(
            name=live.id,
            namespace="",
            labels=labels,
            annotations=annotations,
            finalizers=finalizers,
        ),
        spec=NodeSpec(provider_id=live.provider_id, taints=taints),
        status=NodeStatus(capacity=dict(resources), allocatable=resources),
    )


class NodeIndex:
    """One sweep's snapshot of the cluster's Nodes, keyed three ways for
    the instance↔Node pairing: node name (the providers name Nodes after
    the instance id), provider-id (the authoritative pairing), and
    launch-token annotation (covers renamed/self-registered nodes). Built
    ONCE per GC sweep — the naive per-instance ``cluster.nodes()`` scan
    made each sweep O(instances × nodes) in full list copies under the
    cluster lock."""

    def __init__(self, cluster):
        self.by_name: Dict[str, Node] = {}
        self.by_provider_id: Dict[str, Node] = {}
        self.by_token: Dict[str, Node] = {}
        for node in cluster.nodes():
            self.by_name[node.metadata.name] = node
            if node.spec.provider_id:
                self.by_provider_id[node.spec.provider_id] = node
            token = node.metadata.annotations.get(lbl.LAUNCH_TOKEN_ANNOTATION)
            if token:
                self.by_token[token] = node

    def find(self, live: LiveInstance) -> Optional[Node]:
        node = self.by_name.get(live.id)
        if node is not None:
            return node
        if live.provider_id:
            node = self.by_provider_id.get(live.provider_id)
            if node is not None:
                return node
        if live.launch_token:
            return self.by_token.get(live.launch_token)
        return None


def node_tracking(cluster, live: LiveInstance, index: Optional[NodeIndex] = None) -> Optional[Node]:
    """The Node object already tracking ``live``, or None — matched through
    ``index`` when the caller (the GC sweep) already built one, else
    through a fresh snapshot."""
    if index is not None:
        return index.find(live)
    return NodeIndex(cluster).find(live)


def replay_entry(
    journal: LaunchJournal,
    cluster,
    cloud_provider,
    entry: LaunchRecord,
    instances_by_token: Dict[str, LiveInstance],
    now: float,
    replay_after: float = DEFAULT_REPLAY_AFTER,
    index: Optional[NodeIndex] = None,
    warm_pool_ttl: float = DEFAULT_WARM_POOL_TTL,
    reap=None,
) -> str:
    """Run the adopt/confirm ladder for ONE unresolved entry; returns the
    outcome constant. Safe against the live launch path: a racing resolve
    (the launching process finished after all) is a benign no-op, and the
    grace window keeps replay off entries young enough to have one.

    Speculative (warm-pool) entries get the extra rungs: a STANDING warm
    node keeps its entry open (the entry is the TTL breadcrumb, not an
    orphan), a CLAIMED one resolves, and one past ``warm_pool_ttl`` is
    reclaimed through ``reap`` even though the instance is live — without
    this rung an untracked-but-journaled instance is protected forever.
    ``reap`` terminates one live instance (the GC controller passes its
    terminator-backed reaper); None falls back to the provider delete."""
    if now - entry.created_at < replay_after:
        return PENDING
    if entry.marker == CONSOLIDATION_MARKER:
        # BEFORE the live-instance lookup: a wave entry carries no launch
        # token of its own (replacement launches journal separately), so
        # the ladder below would wrongly read it as NEVER_LAUNCHED
        return _replay_consolidation(journal, cluster, entry)
    live = instances_by_token.get(entry.token)
    if live is None:
        # the create never committed (or the instance already terminated):
        # confirmed never launched — nothing to adopt, nothing leaked
        journal.resolve(entry.token)
        return NEVER_LAUNCHED
    tracked = node_tracking(cluster, live, index=index)
    if entry.speculative:
        return _replay_speculative(
            journal, cluster, cloud_provider, entry, live, tracked,
            now, warm_pool_ttl, reap,
        )
    if tracked is not None:
        # crash landed between Node write and bind: the Node tracks the
        # instance, unbound pods re-enter selection on their own
        journal.resolve(entry.token)
        return NODE_EXISTS
    node = node_for_instance(
        cluster, cloud_provider, live,
        provisioner_name=entry.provisioner, trace=entry.trace,
    )
    from karpenter_tpu_torch.kube.client import Conflict

    try:
        cluster.create("nodes", node)
    except Conflict:
        pass  # a racer (another replica's sweep, or self-registration) won
    journal.resolve(entry.token)
    logger.warning(
        "adopted orphan instance %s (token %s, provisioner %s) — "
        "its launching process died before the Node write",
        live.id, entry.token[:12], entry.provisioner,
    )
    return ADOPTED


def _replay_consolidation(journal, cluster, entry: LaunchRecord) -> str:
    """Roll a crashed consolidation wave forward to safety. The entry was
    written BEFORE the first victim was touched, so the victims list is
    the complete blast radius; any subset may be cordoned, drained, or
    already deleted. Surviving victims are un-cordoned — the consolidation
    taint removed and scheduling re-enabled — because a dead wave's
    cordons are pure capacity loss (its replacements journaled and
    recovered separately through the ordinary ladder; displaced pods are
    pending and re-enter selection on their own). Deleted victims need
    nothing: their drains finished. Then the entry resolves — the next
    consolidation pass re-plans from the real, recovered world."""
    uncordoned = 0
    for name in entry.victims:
        node = cluster.try_get("nodes", name, namespace="")
        if node is None or node.metadata.deletion_timestamp is not None:
            continue
        from karpenter_tpu_torch.kube.serde import taint_to_wire

        taints_wire = [
            taint_to_wire(t) for t in node.spec.taints
            if not (
                t.key == lbl.INTERRUPTION_TAINT_KEY
                and t.value == CONSOLIDATION_MARKER
            )
        ]
        try:
            cluster.merge_patch(
                "nodes", name,
                {"spec": {"unschedulable": False, "taints": taints_wire}},
                namespace="",
            )
            uncordoned += 1
        except Exception:
            logger.warning(
                "un-cordon of crashed-wave victim %s failed; next sweep "
                "retries", name, exc_info=True,
            )
            return PENDING
    journal.resolve(entry.token)
    logger.warning(
        "replayed crashed consolidation wave %s (provisioner %s, decision "
        "%s): %d of %d victim(s) un-cordoned, entry resolved",
        entry.token[:20], entry.provisioner, entry.decision_id or "-",
        uncordoned, len(entry.victims),
    )
    return CONSOLIDATION_REPLAYED


def _replay_speculative(
    journal: LaunchJournal,
    cluster,
    cloud_provider,
    entry: LaunchRecord,
    live: LiveInstance,
    tracked: Optional[Node],
    now: float,
    warm_pool_ttl: float,
    reap,
) -> str:
    """The warm-pool rungs of the ladder (one live instance, speculative
    entry). Claimed → resolve; standing within TTL → leave open; past
    TTL → reclaim instance AND entry, zero leaks, zero double-launches
    (the instance dies under its own token, so a token replay can never
    resurrect it)."""
    expired = (now - entry.created_at) >= warm_pool_ttl
    if tracked is not None:
        claimed = (
            lbl.WARM_POOL_ANNOTATION not in tracked.metadata.annotations
        )
        if claimed:
            # demand landed: the worker's warm-hit steal removed the
            # marker (its resolve may have raced this sweep — benign)
            journal.resolve(entry.token)
            return NODE_EXISTS
        if not expired:
            # standing warm capacity awaiting demand: the open entry IS
            # the TTL breadcrumb — resolving it would protect the
            # instance forever (the bug this rung exists to fix)
            return PENDING
        _reap_speculative(cluster, cloud_provider, live, tracked, reap)
        journal.resolve(entry.token)
        logger.warning(
            "reclaimed expired speculative node %s (token %s, provisioner "
            "%s): no demand landed within the warm-pool TTL (%.0fs)",
            tracked.metadata.name, entry.token[:12], entry.provisioner,
            warm_pool_ttl,
        )
        return SPECULATION_EXPIRED
    if expired:
        # untracked AND stale: the crash ate the Node write and the TTL
        # already passed — reclaim straight from the cloud
        _reap_speculative(cluster, cloud_provider, live, None, reap)
        journal.resolve(entry.token)
        logger.warning(
            "reclaimed expired speculative instance %s (token %s, "
            "provisioner %s): untracked past the warm-pool TTL (%.0fs)",
            live.id, entry.token[:12], entry.provisioner, warm_pool_ttl,
        )
        return SPECULATION_EXPIRED
    # untracked, within TTL: adopt back INTO the warm pool (Node carries
    # the warm marker, entry stays open so the TTL still applies)
    node = node_for_instance(
        cluster, cloud_provider, live,
        provisioner_name=entry.provisioner, trace=entry.trace,
        speculative=True,
    )
    from karpenter_tpu_torch.kube.client import Conflict

    try:
        cluster.create("nodes", node)
    except Conflict:
        pass  # a racer won the write
    logger.warning(
        "adopted speculative orphan %s (token %s, provisioner %s) back "
        "into the warm pool — its launching process died before the Node "
        "write",
        live.id, entry.token[:12], entry.provisioner,
    )
    return ADOPTED


def _reap_speculative(
    cluster, cloud_provider, live: LiveInstance, tracked: Optional[Node],
    reap,
) -> None:
    """Terminate one expired speculative launch: instance first (under
    its own token, so the fleet ledger forgets it), then the Node object
    (unclaimed warm nodes carry no pods, so no drain is owed)."""
    if reap is not None:
        reap(live)
    else:
        node = tracked or node_for_instance(cluster, cloud_provider, live)
        node.metadata.finalizers = []
        cloud_provider.delete(node)
    if tracked is not None:
        try:
            if tracked.metadata.finalizers:
                tracked.metadata.finalizers = []
                cluster.update("nodes", tracked)
            cluster.delete("nodes", tracked.metadata.name, namespace="")
        except Exception:
            logger.debug(
                "warm node object delete raced for %s",
                tracked.metadata.name, exc_info=True,
            )
