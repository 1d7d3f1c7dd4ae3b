"""Write-ahead launch journal: the breadcrumb a crashed launch leaves.

The provisioning worker writes ``record_intent`` (token, provisioner,
trace) BEFORE the cloud create, advances the entry to ``created`` after
the Node object is written, and ``resolve``s it only after the pods are
bound. Any entry still present is a launch that may have died mid-flight;
recovery (controllers/garbage_collection.py) re-describes its token
against ``CloudProvider.list_instances()``:

- instance found, no Node      → ADOPT (write the Node, rejoin the trace)
- instance found, Node exists  → the crash landed between Node write and
  bind; the Node already tracks the instance — resolve the entry (the
  unbound pods re-enter selection on their own)
- no instance with that token  → the create never committed — resolve
  (confirmed never launched)

Two durable backends share the contract: a flock'd shared file (the
``FileLeaseSet`` discipline — single host, multi-process) and a
kube-object twin (one coordination Lease per open entry, so recovery
works across hosts). ``MemoryLaunchJournal``
serves tests.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.utils.lease import FileLease

logger = logging.getLogger("karpenter.launch")

STATE_INTENT = "intent"    # recorded; the cloud create may or may not have run
STATE_CREATED = "created"  # Node object written; binds still pending


@dataclass
class LaunchRecord:
    """One open launch. ``token`` is the client launch token the create
    stamps on the instance; ``trace`` is the launch span's traceparent so
    an adoption rejoins the original provisioning trace."""

    token: str
    provisioner: str
    state: str = STATE_INTENT
    node_name: str = ""
    trace: str = ""
    created_at: float = 0.0
    # warm-pool marker (the warm-pool controller): this launch was created
    # ahead of demand. A speculative entry stays OPEN after the Node write
    # — it resolves when a warm-hit claims the node, and the GC ladder
    # reclaims it past --warm-pool-ttl if demand never lands. Defaults
    # keep old journal docs (no key) parsing as ordinary launches.
    speculative: bool = False
    # wave marker (controllers/consolidation.py): a "consolidation" entry
    # is not a launch at all but a whole disruption wave journaled BEFORE
    # the first victim is touched — ``victims`` names the nodes the wave
    # cordons, ``decision_id`` ties it to the audit record that proposed
    # it. A crash mid-wave leaves the entry open; recovery replays it by
    # un-cordoning surviving victims (launch/recovery.py) instead of the
    # adopt/reap ladder. Defaults keep old docs parsing unchanged.
    marker: str = ""
    victims: List[str] = field(default_factory=list)
    decision_id: str = ""

    def to_doc(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_doc(doc: Dict) -> "LaunchRecord":
        return LaunchRecord(
            token=str(doc.get("token", "")),
            provisioner=str(doc.get("provisioner", "")),
            state=str(doc.get("state", STATE_INTENT)),
            node_name=str(doc.get("node_name", "")),
            trace=str(doc.get("trace", "")),
            created_at=float(doc.get("created_at", 0.0)),
            speculative=bool(doc.get("speculative", False)),
            marker=str(doc.get("marker", "")),
            victims=[str(v) for v in doc.get("victims", []) or []],
            decision_id=str(doc.get("decision_id", "")),
        )


class LaunchJournal:
    """The contract all backends implement. Methods are best-effort safe to
    call with unknown tokens (a resolve of an already-resolved entry is a
    no-op) — recovery and the live launch path may race benignly."""

    def record_intent(
        self, token: str, provisioner: str, trace: str = "",
        speculative: bool = False, marker: str = "",
        victims: Optional[List[str]] = None, decision_id: str = "",
    ) -> None:
        raise NotImplementedError

    def mark_created(self, token: str, node_name: str) -> None:
        raise NotImplementedError

    def resolve(self, token: str) -> None:
        raise NotImplementedError

    def get(self, token: str) -> Optional[LaunchRecord]:
        raise NotImplementedError

    def unresolved(self) -> List[LaunchRecord]:
        raise NotImplementedError


class MemoryLaunchJournal(LaunchJournal):
    """In-process backend: exercises the contract without I/O (a crashed
    process loses it, so production deployments configure file or kube)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.time
        self._mu = threading.Lock()
        self._entries: Dict[str, LaunchRecord] = {}  # guarded-by: self._mu

    def record_intent(
        self, token: str, provisioner: str, trace: str = "",
        speculative: bool = False, marker: str = "",
        victims: Optional[List[str]] = None, decision_id: str = "",
    ) -> None:
        with self._mu:
            self._entries[token] = LaunchRecord(
                token=token, provisioner=provisioner, trace=trace,
                created_at=self.clock(), speculative=speculative,
                marker=marker, victims=list(victims or []),
                decision_id=decision_id,
            )

    def mark_created(self, token: str, node_name: str) -> None:
        with self._mu:
            entry = self._entries.get(token)
            if entry is not None:
                entry.state = STATE_CREATED
                entry.node_name = node_name

    def resolve(self, token: str) -> None:
        with self._mu:
            self._entries.pop(token, None)

    def get(self, token: str) -> Optional[LaunchRecord]:
        with self._mu:
            return self._entries.get(token)

    def unresolved(self) -> List[LaunchRecord]:
        with self._mu:
            return list(self._entries.values())


class FileLaunchJournal(LaunchJournal):
    """Shared-file backend: one JSON record ``{"entries": {token: doc}}``
    under the same flock-serialized RMW discipline as ``FileLeaseSet`` —
    the write-to-temp + rename is atomic, and the flock keeps two
    replicas' read-modify-writes from interleaving. Entries survive the
    writing process's death by construction; that persistence IS the
    journal's reason to exist."""

    def __init__(
        self,
        path: str,
        clock: Optional[Callable[[], float]] = None,
        identity: Optional[str] = None,
    ):
        self.path = path
        self.clock = clock or time.time
        # tmp-file suffix namespace (same crash-sweep story as FileLease)
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        # sweep horizon for crashed writers' temp files
        self.duration = 15.0

    _locked = FileLease._locked
    _sweep_stale_tmp = FileLease._sweep_stale_tmp

    def _read(self) -> Dict:
        try:
            with open(self.path) as f:
                record = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            record = {}
        record.setdefault("entries", {})
        return record

    def _write(self, record: Dict) -> None:
        tmp = f"{self.path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)

    def record_intent(
        self, token: str, provisioner: str, trace: str = "",
        speculative: bool = False, marker: str = "",
        victims: Optional[List[str]] = None, decision_id: str = "",
    ) -> None:
        entry = LaunchRecord(
            token=token, provisioner=provisioner, trace=trace,
            created_at=self.clock(), speculative=speculative,
            marker=marker, victims=list(victims or []),
            decision_id=decision_id,
        )
        with self._locked():
            self._sweep_stale_tmp()
            record = self._read()
            record["entries"][token] = entry.to_doc()
            self._write(record)

    def mark_created(self, token: str, node_name: str) -> None:
        with self._locked():
            record = self._read()
            doc = record["entries"].get(token)
            if doc is None:
                return
            doc["state"] = STATE_CREATED
            doc["node_name"] = node_name
            self._write(record)

    def resolve(self, token: str) -> None:
        with self._locked():
            record = self._read()
            if record["entries"].pop(token, None) is not None:
                self._write(record)

    def get(self, token: str) -> Optional[LaunchRecord]:
        with self._locked():
            record = self._read()
        doc = record["entries"].get(token)
        return LaunchRecord.from_doc(doc) if doc is not None else None

    def unresolved(self) -> List[LaunchRecord]:
        with self._locked():
            record = self._read()
        return [LaunchRecord.from_doc(d) for d in record["entries"].values()]


class KubeLaunchJournal(LaunchJournal):
    """Kube-object twin: one coordination Lease per open entry
    (``<prefix>-<token>``), the record JSON-encoded in ``holderIdentity``
    (a free-form string on the wire). Apiserver writes are durable across
    host loss, so any replica's GC sweep can replay a dead peer's
    entries. Resolution DELETES the Lease — like the shard-member leases,
    the token is baked into the object name, so a kept-but-blanked object
    would be permanent garbage."""

    def __init__(
        self,
        cluster,
        prefix: str = "karpenter-launch",
        namespace: str = "kube-system",
        clock: Optional[Callable[[], float]] = None,
    ):
        self.cluster = cluster
        self.prefix = prefix
        self.namespace = namespace
        self.clock = clock or cluster.clock

    def _name_for(self, token: str) -> str:
        return f"{self.prefix}-{token[:48].lower()}"

    def _put(self, entry: LaunchRecord) -> None:
        from karpenter_tpu_torch.api.objects import Lease, ObjectMeta
        from karpenter_tpu_torch.kube.client import Conflict, NotFound

        name = self._name_for(entry.token)
        payload = json.dumps(entry.to_doc())
        existing = self.cluster.try_get("leases", name, namespace=self.namespace)
        if existing is None:
            lease = Lease(
                metadata=ObjectMeta(name=name, namespace=self.namespace),
                holder_identity=payload,
                # journal entries do not expire on their own — the GC
                # ladder (adopt / confirm-never-launched) retires them;
                # the duration only signals "not a coordination lease"
                lease_duration_seconds=1,
                acquire_time=self.clock(),
                renew_time=self.clock(),
            )
            try:
                self.cluster.create("leases", lease)
            except Conflict:
                # a racer (the same token's retried write) landed first;
                # fall through to the update path below
                existing = self.cluster.try_get(
                    "leases", name, namespace=self.namespace
                )
        if existing is not None:
            existing.holder_identity = payload
            existing.renew_time = self.clock()
            try:
                self.cluster.update("leases", existing)
            except (Conflict, NotFound):
                logger.debug("journal lease update raced for %s", name)

    def record_intent(
        self, token: str, provisioner: str, trace: str = "",
        speculative: bool = False, marker: str = "",
        victims: Optional[List[str]] = None, decision_id: str = "",
    ) -> None:
        self._put(LaunchRecord(
            token=token, provisioner=provisioner, trace=trace,
            created_at=self.clock(), speculative=speculative,
            marker=marker, victims=list(victims or []),
            decision_id=decision_id,
        ))

    def mark_created(self, token: str, node_name: str) -> None:
        entry = self.get(token)
        if entry is None:
            return
        entry.state = STATE_CREATED
        entry.node_name = node_name
        self._put(entry)

    def resolve(self, token: str) -> None:
        from karpenter_tpu_torch.kube.client import NotFound

        try:
            self.cluster.delete(
                "leases", self._name_for(token), namespace=self.namespace
            )
        except NotFound:
            pass

    def _decode(self, lease) -> Optional[LaunchRecord]:
        try:
            return LaunchRecord.from_doc(json.loads(lease.holder_identity))
        except (json.JSONDecodeError, TypeError, ValueError):
            return None

    def get(self, token: str) -> Optional[LaunchRecord]:
        lease = self.cluster.try_get(
            "leases", self._name_for(token), namespace=self.namespace
        )
        if lease is None:
            return None
        return self._decode(lease)

    def unresolved(self) -> List[LaunchRecord]:
        # journal leases are deliberately not informer-watched (same story
        # as the shard leases): list LIVE when the backend can, so this
        # replica sees entries a dead PEER wrote
        lister = getattr(self.cluster, "list_live", None)
        if lister is not None:
            leases = lister("leases", namespace=self.namespace)
        else:
            leases = self.cluster.list("leases", namespace=self.namespace)
        out: List[LaunchRecord] = []
        prefix = f"{self.prefix}-"
        for lease in leases:
            if not lease.metadata.name.startswith(prefix):
                continue
            entry = self._decode(lease)
            if entry is not None:
                out.append(entry)
        return out


def build_journal(spec: str, cluster=None, clock=None) -> Optional[LaunchJournal]:
    """``""`` → no journal; ``kube:<namespace>/<prefix>`` →
    :class:`KubeLaunchJournal`; ``memory:`` → in-process; anything else is
    a shared file path — the same spec grammar as ``build_lease_set``."""
    if not spec:
        return None
    if spec == "memory:":
        return MemoryLaunchJournal(clock=clock)
    if spec.startswith("kube:"):
        ns_prefix = spec[len("kube:"):]
        if "/" in ns_prefix:
            namespace, _, prefix = ns_prefix.partition("/")
        else:
            namespace, prefix = "kube-system", ns_prefix
        return KubeLaunchJournal(
            cluster,
            prefix=prefix or "karpenter-launch",
            namespace=namespace or "kube-system",
            clock=clock,
        )
    return FileLaunchJournal(spec, clock=clock)
