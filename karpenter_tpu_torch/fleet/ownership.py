"""Per-provisioner shard ownership across controller replicas.

``ShardManager`` generalizes ``LeaderElector``'s active/passive contract to
a KEYED lease set: instead of one leader owning everything, each replica
owns the subset of provisioner shards that rendezvous hashing assigns it
among the live members, and the lease set arbitrates races (flock CAS for
``FileLeaseSet``, apiserver optimistic concurrency for ``KubeLeaseSet``).

The safety property mirrors ``LeaderElector.on_lost`` per shard: a failed
renewal fires ``on_lost(key)`` exactly once per holding epoch and the
replica must stop mutating that provisioner's cloud state BEFORE the lease
duration elapses and a survivor claims the shard. The liveness property is
rebalance-on-death: a crashed replica's membership and shard holds expire
together, the rendezvous placement re-ranks every orphaned key over the
survivors, and each survivor claims its share on the next tick — so the
whole fleet re-converges within ~2 lease durations (the acceptance bar the
chaos replica-kill scenario holds it to).

A claim is taken immediately when this replica IS the rendezvous winner;
a key whose winner is some other live member is left alone for one full
tick (``_pending_claims``) so the winner gets first chance — only if it
stays unheld (a wedged-but-heartbeating winner) does a loser steal it.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Callable, Dict, Iterable, Optional, Set

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.utils.lease import DEFAULT_RENEW_INTERVAL

logger = logging.getLogger("karpenter.fleet")

# the shard for work with no provisioner attribution (nodes without a
# provisioner label, cluster-scoped chores): always part of the key
# universe so exactly one replica handles it
DEFAULT_SHARD = "__unassigned__"


def rendezvous_owner(key: str, members: Iterable[str]) -> Optional[str]:
    """Highest-random-weight (rendezvous) placement: the member whose
    ``blake2b(member ## key)`` scores highest owns the key. Deterministic
    for every observer sharing the member view, and minimally disruptive —
    a member's death re-homes ONLY its own keys."""
    best, best_score = None, b""
    for member in members:
        score = hashlib.blake2b(
            f"{member}##{key}".encode(), digest_size=8
        ).digest()
        if best is None or score > best_score:
            best, best_score = member, score
    return best


def build_lease_set(spec: str, cluster=None, identity: Optional[str] = None,
                    duration: Optional[float] = None):
    """``kube:<namespace>/<prefix>`` → :class:`KubeLeaseSet` (requires a
    cluster that actually coordinates replicas); anything else is a shared
    file path → :class:`FileLeaseSet`."""
    kwargs = {}
    if identity:
        kwargs["identity"] = identity
    if duration:
        kwargs["duration"] = duration
    if spec.startswith("kube:"):
        from karpenter_tpu_torch.kube.leader import KubeLeaseSet

        ns_prefix = spec[len("kube:"):]
        if "/" in ns_prefix:
            namespace, _, prefix = ns_prefix.partition("/")
        else:
            namespace, prefix = "kube-system", ns_prefix
        return KubeLeaseSet(
            cluster,
            prefix=prefix or "karpenter-shard",
            namespace=namespace or "kube-system",
            **kwargs,
        )
    from karpenter_tpu_torch.utils.lease import FileLeaseSet

    return FileLeaseSet(spec, **kwargs)


class WatchedShardKeys:
    """Informer-watch-driven shard-key discovery (ROADMAP item 3 headroom).

    The first fleet cut passed ``keys_fn=lambda: [...cluster.provisioners()]``
    — one provisioner LIST per replica per renew interval, paid forever at
    fleet scale. This source seeds once and then maintains the key set from
    the cluster's provisioner watch events; a membership change (a
    provisioner added or deleted) additionally fires ``on_change`` so the
    ShardManager ticks IMMEDIATELY — a new provisioner gets an owner within
    one watch delivery, not one renew interval."""

    def __init__(self, cluster):
        self._mu = threading.Lock()
        self._keys: Set[str] = set()  # guarded-by: self._mu
        # fired (outside the lock) when the key set actually changed;
        # wired to ShardManager.request_tick by build_runtime
        self.on_change: Optional[Callable[[], None]] = None
        # watch BEFORE the seed list: an event landing between the two is
        # applied on top of the union'd seed instead of being lost
        cluster.watch("provisioners", self._on_event)
        with self._mu:
            self._keys |= {p.metadata.name for p in cluster.provisioners()}

    def _on_event(self, event: str, obj) -> None:
        name = obj.metadata.name
        gone = event == "DELETED" or obj.metadata.deletion_timestamp is not None
        with self._mu:
            before = name in self._keys
            if gone:
                self._keys.discard(name)
            else:
                self._keys.add(name)
            changed = (name in self._keys) != before
        if changed and self.on_change is not None:
            try:
                self.on_change()
            except Exception:
                logger.exception("shard-key change notification failed")

    def keys(self) -> Set[str]:
        with self._mu:
            return set(self._keys)


class ShardManager:
    """One replica's view of the fleet: which shards it owns right now.

    ``tick()`` is the whole protocol — heartbeat membership, renew owned
    shards (lost renewals fire ``on_lost`` and drop ownership), release
    shards whose key left the universe, then claim desired keys this
    replica wins under rendezvous placement (or steals after the winner
    left them unheld for a full tick). The background thread just calls
    ``tick()`` on the renew cadence; tests drive it synchronously.

    ``owns(key)`` is the hot-path read every reconcile and launch guard
    makes — a set lookup under a mutex, no I/O."""

    def __init__(
        self,
        leases,
        keys_fn: Callable[[], Iterable[str]],
        renew_interval: Optional[float] = None,
        on_acquired: Optional[Callable[[str], None]] = None,
        on_lost: Optional[Callable[[str], None]] = None,
        include_default_shard: bool = True,
    ):
        self.leases = leases
        self.keys_fn = keys_fn
        # derive from the lease duration unless overridden: a renew cadence
        # slower than the duration would expire every hold between ticks
        # (continuous on_lost/on_acquired churn, the fleet never converges)
        if renew_interval is None:
            duration = getattr(leases, "duration", DEFAULT_RENEW_INTERVAL * 3)
            renew_interval = min(DEFAULT_RENEW_INTERVAL, duration / 3.0)
        self.renew_interval = renew_interval
        self.on_acquired = on_acquired
        self.on_lost = on_lost
        self.include_default_shard = include_default_shard
        self.identity = leases.identity
        self._mu = threading.Lock()
        self._owned: Set[str] = set()  # guarded-by: self._mu
        # keys observed unheld last tick whose rendezvous winner is another
        # live member — steal candidates if still unheld this tick
        self._pending_claims: Set[str] = set()  # guarded-by: self._mu
        self._stop = threading.Event()
        self._crashed = threading.Event()  # chaos: die without releasing
        # set by request_tick(): the run loop wakes early instead of
        # sleeping out the renew interval (a provisioner appearing should
        # find an owner within one watch delivery, docs/fleet.md)
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # key -> last live holder observed in any snapshot; a claim of a
        # key last seen held by a DIFFERENT replica is a takeover
        # (rebalance-on-death), counted separately from first claims
        self._last_seen_holder: Dict[str, str] = {}  # guarded-by: self._mu
        # key -> the rendezvous winner it was STOLEN from (the winner was
        # live but left the key unheld for a full tick — wedged). The
        # handback loop must not release such a key back to the SAME
        # winner, or steal and handback would oscillate every ~2 ticks
        # with the shard's worker bouncing; the entry clears when the
        # key's winner changes (membership change) or the key is lost.
        self._stolen_from: Dict[str, str] = {}  # guarded-by: self._mu
        # observability for tests/bench: monotonic tick counter and the
        # last tick's membership view
        self.ticks = 0  # guarded-by: self._mu
        self.last_members: Set[str] = set()  # guarded-by: self._mu

    # -- reads --------------------------------------------------------------
    def owns(self, key: str) -> bool:
        with self._mu:
            return key in self._owned

    def owned(self) -> Set[str]:
        with self._mu:
            return set(self._owned)

    def fenced(self) -> bool:
        """Is this replica FENCED — the lease backend unreachable past a
        held lease's expiry margin (docs/partition.md)? While True, the
        launch guards and the GC sweep refuse cloud creates/terminates:
        a peer with a working control plane may legitimately own our
        shards already. Backends without the concept (``FileLeaseSet``)
        never fence."""
        fn = getattr(self.leases, "fenced", None)
        if fn is None:
            return False
        try:
            return bool(fn())
        except Exception:
            logger.exception("fence status read failed")
            return False

    # -- the protocol -------------------------------------------------------
    def tick(self) -> None:
        """One claim/renew/release round. Exceptions from the lease backend
        surface to the caller (the run loop contains them; a raising
        backend mid-tick loses nothing — un-renewed holds simply expire).
        Re-checks ``_stop`` at each phase: a tick wedged in a slow backend
        can outlive ``stop()``'s join timeout, and its claim loop must not
        re-acquire the leases stop just released (a dead replica holding
        every shard for a full lease duration)."""
        if self._stop.is_set():
            return
        members = set(self.leases.heartbeat())
        desired = set(self.keys_fn())
        if self.include_default_shard:
            desired.add(DEFAULT_SHARD)

        with self._mu:
            owned = set(self._owned)

        # renew first: holding is useless if the lease lapses mid-tick
        renewed = self.leases.renew_many(owned) if owned else set()
        for key in owned - renewed:
            self._lose(key)
        owned = renewed

        # release shards whose key left the universe (provisioner deleted).
        # on_lost FIRST (stops the worker synchronously), release SECOND —
        # the same no-two-concurrent-owners ordering as handback/stop: a
        # deleted-then-recreated provisioner's key must not be claimable
        # by a peer while this replica's launch is still in flight.
        for key in owned - desired:
            self._lose(key, reason="deleted")
            self.leases.release(key)
        owned &= desired

        # graceful handback: a shard whose rendezvous winner among the LIVE
        # members is another replica migrates there (a new replica joining
        # an up fleet must drain its share off the incumbents, or the first
        # replica keeps everything forever). on_lost stops the worker FIRST,
        # then the lease releases — the winner claims it next tick, so a
        # handback costs one tick of that shard being idle, never two
        # concurrent owners. A key STOLEN from a wedged-but-heartbeating
        # winner is exempt while that same member stays the winner —
        # releasing it back would just re-orphan it (steal/handback
        # oscillation); a membership change re-enables normal placement.
        handed_back: Set[str] = set()
        for key in sorted(owned):
            winner = rendezvous_owner(key, members)
            if winner == self.identity:
                continue
            with self._mu:
                stolen_from = self._stolen_from.get(key)
                if stolen_from is not None and stolen_from != winner:
                    del self._stolen_from[key]  # winner changed: normal rules
                    stolen_from = None
            if stolen_from == winner:
                continue
            self._lose(key, reason="handback")
            self.leases.release(key)
            owned.discard(key)
            handed_back.add(key)

        # claim: winners immediately, losers only steal keys that stayed
        # unheld across a full tick (the winner had its chance). The
        # desired keys are passed so the kube backend can resolve holders
        # for keys THIS replica never touched (its lazy lease table only
        # knows touched keys; FileLeaseSet ignores the hint).
        snapshot = self.leases.snapshot(sorted(desired))
        with self._mu:
            self._last_seen_holder.update(snapshot)
            # forget holders of keys that left the universe
            for key in list(self._last_seen_holder):
                if key not in desired:
                    del self._last_seen_holder[key]
        next_pending: Set[str] = set()
        for key in sorted(desired - owned):
            if self._stop.is_set():
                return  # stop() released our leases; claiming now would re-take them
            if key in handed_back:
                # just released to its winner THIS tick: neither claim nor
                # mark pending — the winner gets two full ticks before the
                # loser-steal clock starts, or a merely-slow (not wedged)
                # winner would lose the key right back and _stolen_from
                # would pin the misplacement until membership changes
                continue
            holder = snapshot.get(key)
            if holder is not None and holder != self.identity:
                continue  # live hold by a peer
            winner = rendezvous_owner(key, members)
            with self._mu:
                may_steal = key in self._pending_claims
                previous = self._last_seen_holder.get(key)
            if winner != self.identity and not may_steal:
                next_pending.add(key)
                continue
            if self.leases.try_acquire(key):
                if winner != self.identity:
                    # stolen from a live-but-wedged winner: exempt from
                    # handback while that member stays the winner
                    with self._mu:
                        self._stolen_from[key] = winner
                self._gain(
                    key,
                    taken_over=previous is not None and previous != self.identity,
                )
        with self._mu:
            self._pending_claims = next_pending
            self.ticks += 1
            self.last_members = members
            metrics.FLEET_SHARDS_OWNED.set(len(self._owned))
        metrics.FLEET_FENCED.set(1 if self.fenced() else 0)

    def _gain(self, key: str, taken_over: bool = False) -> None:
        with self._mu:
            if key in self._owned:
                return
            self._owned.add(key)
        if taken_over:
            metrics.FLEET_REBALANCES.inc()
        logger.info(
            "shard %s acquired by %s%s", key, self.identity,
            " (takeover)" if taken_over else "",
        )
        if self.on_acquired is not None:
            try:
                self.on_acquired(key)
            except Exception:
                logger.exception("on_acquired(%s) failed", key)

    def _lose(self, key: str, reason: str = "lost") -> None:
        with self._mu:
            if key not in self._owned:
                return
            self._owned.discard(key)
            self._stolen_from.pop(key, None)
        if reason == "lost":
            metrics.FLEET_SHARD_LOSSES.inc()
            logger.warning("shard %s lease lost by %s", key, self.identity)
        else:
            logger.info("shard %s released by %s (%s)", key, self.identity, reason)
        if self.on_lost is not None:
            try:
                self.on_lost(key)
            except Exception:
                logger.exception("on_lost(%s) failed", key)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="shard-manager"
        )
        self._thread.start()

    def request_tick(self) -> None:
        """Wake the run loop for an immediate tick (key-universe change
        from the informer watch, a test nudging convergence). Safe from
        any thread; a no-op when the background loop isn't running."""
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # a raising lease backend must not kill the manager thread;
                # un-renewed holds expire on their own — the safe direction
                logger.exception("shard tick failed")
            self._wake.wait(self.renew_interval)
            self._wake.clear()

    def crash(self) -> None:
        """Chaos hook: die WITHOUT releasing — holds and membership expire
        on the lease duration, exactly like a SIGKILL'd replica."""
        self._crashed.set()
        self._stop.set()
        self._wake.set()  # a loop parked in its inter-tick wait dies now
        if self._thread:
            self._thread.join(timeout=2)
        with self._mu:
            self._owned.clear()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._crashed.is_set():
            return  # crashed: leave the leases to expire
        with self._mu:
            owned = set(self._owned)
            self._owned.clear()
        for key in owned:
            # on_lost FIRST (it stops the shard's worker synchronously),
            # release SECOND — the same ordering the handback path keeps:
            # a survivor claiming the released lease must never overlap a
            # launch this replica still has in flight
            if self.on_lost is not None:
                try:
                    self.on_lost(key)
                except Exception:
                    logger.exception("on_lost(%s) failed", key)
            try:
                self.leases.release(key)
            except Exception:
                logger.exception("releasing shard %s failed", key)
        try:
            self.leases.resign()
        except Exception:
            logger.exception("membership resign failed (expires on its own)")
