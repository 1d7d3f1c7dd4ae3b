"""Cluster-scoped leader election over a coordination.k8s.io/v1 Lease.

Replaces the single-host flock lease for multi-host deployments
(reference: cmd/controller/main.go:84-85, lease id
``karpenter-leader-election``). Same contract as ``utils.lease.FileLease``
so ``LeaderElector`` drives either: ``try_acquire`` (non-blocking),
``renew`` on heartbeat, ``release`` on shutdown. Safety against split
brain comes from apiserver optimistic concurrency — a stale
resourceVersion update returns 409 Conflict, and the loser backs off.
"""

from __future__ import annotations

import logging
import os
import uuid
from typing import Optional

logger = logging.getLogger("karpenter.kube.leader")

from karpenter_tpu_torch.api.objects import Lease, ObjectMeta
from karpenter_tpu_torch.kube.client import Cluster, Conflict, NotFound
from karpenter_tpu_torch.kube.transport import is_unreachable

DEFAULT_LEASE_NAME = "karpenter-leader-election"
DEFAULT_LEASE_NAMESPACE = "kube-system"

# Fraction of the lease duration BEFORE nominal expiry at which an
# unreachable-apiserver hold gives up and fences: the margin is the window
# in which a peer (with a working apiserver — asymmetric partition) could
# claim the expired lease while this replica still believes it holds it.
FENCE_MARGIN_FRACTION = 0.2


class FenceStatus:
    """Shared REJECTED-vs-UNREACHABLE verdict for a family of leases.

    A failed renewal used to read as "a peer took the lease" no matter the
    cause, so a 10-second apiserver blip synchronously tore down every
    provisioner worker in the fleet. The split (docs/partition.md):

    - **REJECTED** — the apiserver ANSWERED and the answer was "not yours"
      (a peer holds it, it expired server-side, a racer's write won):
      lose the lease NOW, exactly as before.
    - **UNREACHABLE** — the apiserver did not answer: the hold is still
      plausibly ours, so keep serving until the lease's own expiry minus a
      safety margin... then **fence**: assume a peer may own the shard and
      refuse cloud mutations until the control plane answers again.

    One status object is shared by every lease of a ``KubeLeaseSet`` so a
    single successful round trip — even a rejected one — un-fences the
    whole replica (reachability is a property of the apiserver, not of one
    Lease object)."""

    def __init__(self):
        # plain bool: written by the lease-manager thread, read lock-free
        # by launch guards and the GC sweep (attribute reads are atomic)
        self._fenced = False

    def fence(self) -> None:
        if not self._fenced:
            logger.warning(
                "FENCED: apiserver unreachable past lease expiry margin — "
                "refusing cloud mutations until the control plane answers"
            )
        self._fenced = True

    def contact(self) -> None:
        """Any completed apiserver round trip proves reachability."""
        if self._fenced:
            logger.info("apiserver reachable again; fence lifted")
        self._fenced = False

    @property
    def fenced(self) -> bool:
        return self._fenced


class KubeLease:
    def __init__(
        self,
        cluster: Cluster,
        name: str = DEFAULT_LEASE_NAME,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        identity: Optional[str] = None,
        duration: float = 15.0,
        status: Optional[FenceStatus] = None,
    ):
        self.cluster = cluster
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        # leaseDurationSeconds is an integer ≥ 1 on the wire
        self.duration = max(1, int(round(duration)))
        # REJECTED-vs-UNREACHABLE verdict sink, shared across a lease set
        self.status = status if status is not None else FenceStatus()
        # client-clock expiry of OUR hold (set on successful acquire/renew):
        # the unreachable-apiserver grace window is judged against this,
        # never against anything a peer could have written
        self._held_until: Optional[float] = None
        self._unreachable_since: Optional[float] = None

    def _now(self) -> float:
        return self.cluster.clock()

    def _get(self) -> Optional[Lease]:
        getter = getattr(self.cluster, "get_live", None)
        if getter is not None:
            try:
                out = getter("leases", self.name, namespace=self.namespace)
            except NotFound:
                out = None
            # a completed round trip — even a 404 — proves reachability
            self.status.contact()
            return out
        out = self.cluster.try_get("leases", self.name, namespace=self.namespace)
        self.status.contact()  # the in-memory store always answers
        return out

    def _expired(self, lease: Lease) -> bool:
        renew = lease.renew_time or lease.acquire_time or 0.0
        return renew + lease.lease_duration_seconds <= self._now()

    def _mark_held(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self._now()
        self._held_until = now + self.duration
        self._unreachable_since = None
        self.status.contact()

    def try_acquire(self) -> bool:
        # timestamp BEFORE the round trip: the server-side expiry runs from
        # the renew/acquire time stamped at call entry, so marking the hold
        # with a post-RTT clock would inflate _held_until by the acquire
        # latency and eat into the fence safety margin
        now = self._now()
        try:
            ok = self._try_acquire()
        except Exception as e:
            # transport blips and unexpected apiserver errors must read as
            # "not acquired", never kill the elector thread (split brain)
            if is_unreachable(e):
                logger.debug(
                    "lease acquire unreachable; retrying on next tick",
                    exc_info=True,
                )
            else:
                logger.exception("lease acquire failed; retrying on next tick")
            return False
        if ok:
            self._mark_held(now)
        return ok

    def _try_acquire(self) -> bool:
        now = self._now()
        current = self._get()
        if current is None:
            lease = Lease(
                metadata=ObjectMeta(name=self.name, namespace=self.namespace),
                holder_identity=self.identity,
                lease_duration_seconds=self.duration,
                acquire_time=now,
                renew_time=now,
                lease_transitions=0,
            )
            try:
                self.cluster.create("leases", lease)
                return True
            except Conflict:
                return False  # racer created it first
        if (
            current.holder_identity == self.identity
            or not current.holder_identity  # released
            or self._expired(current)
        ):
            if current.holder_identity != self.identity:
                current.lease_transitions += 1
                current.acquire_time = now
            current.holder_identity = self.identity
            current.renew_time = now
            try:
                self.cluster.update("leases", current)
                return True
            except (Conflict, NotFound):
                return False  # a racer's update landed first
        return False

    def renew(self) -> bool:
        """Renew the hold. REJECTED (the apiserver answered "not yours" —
        a peer holds it, it expired server-side, a racer's write won) is a
        lost lease NOW, exactly as before fencing existed. UNREACHABLE (no
        answer at all) keeps the hold until OUR OWN copy of the expiry
        minus a safety margin, then fences — a 10s apiserver blip must not
        read as fleet-wide lease loss (docs/partition.md)."""
        now = self._now()
        try:
            current = self._get()
            if current is None or current.holder_identity != self.identity or self._expired(current):
                self._held_until = None
                return False  # REJECTED: positively not ours any more
            current.renew_time = now
            self.cluster.update("leases", current)
        except Exception as e:
            if is_unreachable(e):
                return self._renew_unreachable(now)
            # Conflict (a racer's write landed first), RBAC, programming
            # errors: the apiserver ANSWERED — lost is the safe direction
            logger.exception("lease renew rejected; treating as lost")
            self._held_until = None
            return False
        self._mark_held(now)
        return True

    def _renew_unreachable(self, now: float) -> bool:
        margin = FENCE_MARGIN_FRACTION * self.duration
        if self._held_until is not None and now < self._held_until - margin:
            # still inside our own hold: no peer can legitimately own this
            # lease yet, so keep serving — zero churn across a short blip
            if self._unreachable_since is None:
                self._unreachable_since = now
                logger.warning(
                    "apiserver unreachable; lease %s held optimistically "
                    "(%.1fs until fence)",
                    self.name, self._held_until - margin - now,
                )
            return True
        # past expiry-minus-margin with the apiserver still silent: a peer
        # whose apiserver works (asymmetric partition) may claim the
        # expired lease any moment — fence, and report the hold lost
        self.status.fence()
        self._held_until = None
        self._unreachable_since = None
        return False

    @property
    def unreachable(self) -> bool:
        """Is the hold optimistic: did the last renewal find the
        apiserver unreachable and keep the lease inside its own expiry? The
        elector retries such a renewal after its short retry interval."""
        return self._unreachable_since is not None

    def release(self) -> None:
        self._held_until = None
        self._unreachable_since = None
        try:
            current = self._get()
            if current is not None and current.holder_identity == self.identity:
                current.holder_identity = ""
                current.renew_time = None
                self.cluster.update("leases", current)
        except Exception:
            logger.exception("lease release failed (expires on its own)")

    def holder(self) -> Optional[str]:
        try:
            current = self._get()
        except Exception:
            return None
        if current is None or not current.holder_identity or self._expired(current):
            return None
        return current.holder_identity


class KubeLeaseSet:
    """Keyed lease set over coordination.k8s.io/v1 Leases — the cluster-
    scoped counterpart of ``utils.lease.FileLeaseSet`` (same contract, so
    the fleet's ``ShardManager`` drives either). Each
    shard key maps to one Lease object (``<prefix>-shard-<slug>``); replica
    membership is its own Lease per replica (``<prefix>-member-<identity>``)
    that the holder heartbeats. Split-brain safety is the apiserver's
    optimistic concurrency, exactly as in :class:`KubeLease`."""

    def __init__(
        self,
        cluster: Cluster,
        prefix: str = "karpenter-shard",
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        identity: Optional[str] = None,
        duration: float = 15.0,
    ):
        self.cluster = cluster
        self.prefix = prefix
        self.namespace = namespace
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.duration = duration
        # ONE fence status across every lease of the set: reachability is a
        # property of the apiserver, so a single successful round trip on
        # ANY lease (or the member LIST) un-fences the whole replica
        self.status = FenceStatus()
        self._leases: dict = {}  # key -> KubeLease (lazily built; single-thread ShardManager use)
        self._member_lease: Optional[KubeLease] = None
        # one LIVE namespace LIST serves a whole tick (heartbeat's member
        # scan AND snapshot's holder resolution): (listing, fetched_at)
        self._listing: tuple = ((), float("-inf"))

    def fenced(self) -> bool:
        """Is this replica FENCED (apiserver unreachable past a held
        lease's expiry margin)? ``fleet.ShardManager.fenced`` reads this;
        launch guards and the GC sweep refuse cloud mutations while True."""
        return self.status.fenced

    def _list_leases(self, max_age: Optional[float] = None) -> list:
        """List the namespace's leases UNCACHED — against a real apiserver
        the informer plane deliberately does not watch leases, so the
        cached ``list`` would only show this process's own writes; the
        in-memory Cluster has no ``list_live`` and its ``list`` is
        authoritative. ``max_age`` lets the second caller in one tick
        reuse the first's listing instead of re-LISTing."""
        now = self.cluster.clock()
        listing, fetched_at = self._listing
        if max_age is not None and now - fetched_at <= max_age:
            return list(listing)
        lister = getattr(self.cluster, "list_live", None)
        if lister is not None:
            leases = lister("leases", namespace=self.namespace)
        else:
            leases = self.cluster.list("leases", namespace=self.namespace)
        self.status.contact()  # a completed LIST proves reachability
        self._listing = (tuple(leases), now)
        return list(leases)

    def _name_for(self, key: str) -> str:
        # DNS-1123-safe and collision-free: slugified key + a short content
        # hash (two keys differing only in stripped characters stay distinct)
        import hashlib
        import re

        slug = re.sub(r"[^a-z0-9-]+", "-", key.lower()).strip("-")[:40] or "x"
        digest = hashlib.blake2b(key.encode(), digest_size=4).hexdigest()
        return f"{self.prefix}-shard-{slug}-{digest}"

    def _lease_for(self, key: str) -> KubeLease:
        lease = self._leases.get(key)
        if lease is None:
            lease = self._leases[key] = KubeLease(
                self.cluster,
                name=self._name_for(key),
                namespace=self.namespace,
                identity=self.identity,
                duration=self.duration,
                status=self.status,
            )
        return lease

    # -- membership ---------------------------------------------------------
    def heartbeat(self) -> set:
        if self._member_lease is None:
            self._member_lease = KubeLease(
                self.cluster,
                name=f"{self.prefix}-member-{self.identity}",
                namespace=self.namespace,
                identity=self.identity,
                duration=self.duration,
                status=self.status,
            )
        if not self._member_lease.renew():
            self._member_lease.try_acquire()
        return self.members()

    @staticmethod
    def _expiry(lease) -> float:
        renew = lease.renew_time or lease.acquire_time or 0.0
        return renew + lease.lease_duration_seconds

    def members(self) -> set:
        try:
            leases = self._list_leases()
        except Exception as e:
            if is_unreachable(e):
                logger.debug("member lease list unreachable", exc_info=True)
            else:
                logger.exception("listing member leases failed")
            return {self.identity}
        prefix = f"{self.prefix}-member-"
        now = self.cluster.clock()
        out = set()
        for lease in leases:
            if not lease.metadata.name.startswith(prefix):
                continue
            if lease.holder_identity and self._expiry(lease) > now:
                out.add(lease.holder_identity)
            elif self._expiry(lease) + 4 * self.duration <= now:
                # GC long-dead member Leases: identities are per-process
                # (pid+uuid in the NAME), so crashed replicas would leak
                # one object per restart forever — any live replica's
                # tick may collect them once they are unambiguously stale
                try:
                    self.cluster.delete(
                        "leases", lease.metadata.name, namespace=self.namespace
                    )
                except Exception:
                    logger.debug(
                        "stale member lease GC failed", exc_info=True
                    )
        out.add(self.identity)
        return out

    def resign(self) -> None:
        """Delete (not just blank) this replica's member Lease: the
        identity is baked into the object NAME, so a released-but-kept
        object is permanent garbage no future process reuses."""
        if self._member_lease is None:
            return
        try:
            self.cluster.delete(
                "leases", self._member_lease.name, namespace=self.namespace
            )
        except Exception:
            logger.exception("member lease delete failed (GC'd by a peer later)")

    # -- per-key leases -----------------------------------------------------
    def try_acquire(self, key: str) -> bool:
        return self._lease_for(key).try_acquire()

    def renew_many(self, keys) -> set:
        renewed = set()
        for key in keys:
            if self._lease_for(key).renew():
                renewed.add(key)
        return renewed

    def release(self, key: str) -> None:
        self._lease_for(key).release()

    def release_all(self) -> None:
        for key in list(self._leases):
            self._leases[key].release()

    def holder(self, key: str) -> Optional[str]:
        return self._lease_for(key).holder()

    def snapshot(self, keys=None) -> dict:
        """Live key → holder map from ONE namespace LIST: each desired
        key's slugged Lease name is matched against the listing, so a
        fresh replica resolves holders for keys it never touched without
        a GET per key per tick (at 200 provisioners × 3 replicas that
        would be 120 GETs/s against the apiserver)."""
        wanted = set(keys or ()) | set(self._leases)
        if not wanted:
            return {}
        try:
            # reuse heartbeat's listing when it ran within this tick — the
            # shard manager calls heartbeat then snapshot back to back, and
            # two full LISTs per tick per replica would double the
            # apiserver load for the same bytes
            leases = self._list_leases(max_age=min(1.0, self.duration / 3.0))
        except Exception as e:
            if is_unreachable(e):
                logger.debug("shard lease list unreachable", exc_info=True)
            else:
                logger.exception("listing shard leases failed")
            return {}
        by_name = {lease.metadata.name: lease for lease in leases}
        now = self.cluster.clock()
        out = {}
        for key in wanted:
            lease = by_name.get(self._name_for(key))
            if (
                lease is not None
                and lease.holder_identity
                and self._expiry(lease) > now
            ):
                out[key] = lease.holder_identity
        return out
