"""In-memory cluster state store with watch events.

The controllers speak to this ``Cluster`` interface: typed stores of pods,
nodes, daemonsets, provisioners, PVCs, PVs, storage classes, PDBs, leases and
events; create / get / update / merge_patch / patch_status / delete with
finalizer semantics; the Bind and Evict subresources; and watches, which
are synchronous callbacks dispatched outside the store lock. It is the
test and benchmark substrate (the reference's envtest/fake-client analog).

Every mutation (``create``, ``update``, ``merge_patch``, ``patch_status``,
``delete``, ``remove_finalizer``, ``bind``, ``evict``, ``seed``) bumps one
store version; ``version()`` reads it, and the resident solve path keys its
topology-plan reuse on it. Creating an event is a mutation too, as in the
reference: the round after a quarantine re-injects. Unlike the reference,
a removal (a finalizer-free ``delete`` or ``evict``, the last finalizer
leaving a terminating object) bumps the version too: without it a plan
injected against the removed pod would be reused.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.api.objects import DaemonSet, LabelSelector, Node, Pod
from karpenter_tpu_torch.api.provisioner import Provisioner

WatchFn = Callable[[str, object], None]  # (event_type, object)


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


def resolve_pdb_threshold(value, total: int) -> Optional[int]:
    """PDB minAvailable/maxUnavailable accept ints or percentages
    ("50%"); percentages resolve against the matching-pod count, rounded
    up (intstr.GetScaledValueFromIntOrPercent with roundUp=true):
    maxUnavailable "50%" of 3 pods allows 2 evictions, not 1."""
    if value is None:
        return None
    if isinstance(value, int):
        return value
    s = str(value).strip()
    if s.endswith("%"):
        return math.ceil(total * float(s[:-1]) / 100.0)
    return int(s)


class _Store:
    def __init__(self):
        self.objects: Dict[Tuple[str, str], object] = {}  # (namespace, name) -> obj
        self.watchers: List[WatchFn] = []


class Cluster:
    """Typed object store: pods, nodes, daemonsets, provisioners, PVCs, PVs,
    storage classes, PDBs, leases (the launch journal's kube backend keeps
    one per open entry), the webhook registrations (the caBundle
    reconciler's targets), events."""

    KINDS = ("pods", "nodes", "daemonsets", "provisioners", "pvcs", "pvs",
             "storageclasses", "pdbs", "leases", "validatingwebhookconfigurations",
             "mutatingwebhookconfigurations", "events")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.RLock()
        self._stores: Dict[str, _Store] = {k: _Store() for k in self.KINDS}
        self._version = 0
        self.clock = clock or time.time
        # spec.nodeName index, maintained incrementally on every pod event
        # (every mutation path funnels through _notify; seed() indexes
        # directly), so per-node queries are O(pods on that node)
        self._pods_by_node: Dict[str, Dict[Tuple[str, str], Pod]] = {}
        self._pod_node_of: Dict[Tuple[str, str], str] = {}

    # -- generic helpers ---------------------------------------------------
    def version(self) -> int:
        """Monotonic store version: bumped by every mutation (and by
        ``seed``). A matching version proves NO object in any store moved
        between two reads — what the resident plan-reuse guard
        (solver/delta.py) keys topology-round reuse on. Reading the int is
        atomic under the GIL; no lock needed."""
        return self._version

    @staticmethod
    def _key(obj) -> Tuple[str, str]:
        return (obj.metadata.namespace, obj.metadata.name)

    def _index_pod(self, event: str, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        with self._lock:
            old = self._pod_node_of.get(key)
            if event == "DELETED":
                if old is not None:
                    self._pods_by_node.get(old, {}).pop(key, None)
                    self._pod_node_of.pop(key, None)
                return
            new = pod.spec.node_name or None
            if old is not None and old != new:
                self._pods_by_node.get(old, {}).pop(key, None)
                self._pod_node_of.pop(key, None)
            if new is not None:
                self._pod_node_of[key] = new
                self._pods_by_node.setdefault(new, {})[key] = pod

    def _notify(self, kind: str, event: str, obj) -> None:
        if kind == "pods":
            self._index_pod(event, obj)
        for w in list(self._stores[kind].watchers):
            w(event, obj)

    def watch(self, kind: str, fn: WatchFn) -> None:
        """Call ``fn(event, obj)`` after every ADDED / MODIFIED / DELETED
        of ``kind``, on the mutating thread, outside the store lock."""
        self._stores[kind].watchers.append(fn)

    def seed(self, kind: str, obj) -> object:
        """Insert an object WITHOUT mutating it or dispatching events — for
        read-only shadow stores built from live objects; the live cluster
        remains the owner of the object."""
        with self._lock:
            self._stores[kind].objects[self._key(obj)] = obj
            # the store's content moved even though the object is untouched:
            # version-keyed consumers (the resident plan-reuse guard in
            # solver/delta.py) must see seeded state as a new cluster state
            self._version += 1
        if kind == "pods":
            self._index_pod("ADDED", obj)  # no events, but the index must see it
        return obj

    def create(self, kind: str, obj) -> object:
        with self._lock:
            store = self._stores[kind]
            key = self._key(obj)
            if key in store.objects:
                raise Conflict(f"{kind} {key} already exists")
            self._version += 1
            obj.metadata.resource_version = self._version
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock()
            store.objects[key] = obj
        self._notify(kind, "ADDED", obj)
        return obj

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            obj = self._stores[kind].objects.get((namespace, name))
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        return obj

    def try_get(self, kind: str, name: str, namespace: str = "default"):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def update(self, kind: str, obj) -> object:
        with self._lock:
            store = self._stores[kind]
            key = self._key(obj)
            if key not in store.objects:
                raise NotFound(f"{kind} {key} not found")
            self._version += 1
            obj.metadata.resource_version = self._version
            store.objects[key] = obj
        self._notify(kind, "MODIFIED", obj)
        return obj

    def merge_patch(self, kind: str, name: str, patch: dict, namespace: str = "default"):
        """RFC 7386 merge patch in Kubernetes wire shape (the reference's
        single-patch-per-reconcile idiom). Identity-preserving: the stored
        object is updated in place (watchers and tests hold references to
        it)."""
        from karpenter_tpu_torch.kube import serde

        with self._lock:
            obj = self._stores[kind].objects.get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            merged_doc = serde.json_merge(serde.to_wire(kind, obj), patch)
            fresh = serde.from_wire(kind, merged_doc)
            fresh.metadata.namespace = obj.metadata.namespace
            fresh.metadata.uid = obj.metadata.uid
            fresh.metadata.creation_timestamp = obj.metadata.creation_timestamp
            fresh.metadata.deletion_timestamp = obj.metadata.deletion_timestamp
            for f in dataclasses.fields(obj):
                setattr(obj, f.name, getattr(fresh, f.name))
            self._version += 1
            obj.metadata.resource_version = self._version
        self._notify(kind, "MODIFIED", obj)
        return obj

    def patch_status(self, kind: str, name: str, status: dict, namespace: str = "default"):
        """Merge-patch the status subresource (``status`` is the wire-shape
        dict of status fields): the only route by which controllers persist
        status for kinds whose CRD enables ``subresources.status`` (a real
        apiserver drops status carried on main-resource writes)."""
        return self.merge_patch(kind, name, {"status": status}, namespace=namespace)

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        """Delete with finalizer semantics: objects carrying finalizers only
        get a deletion timestamp; removal happens when finalizers clear.
        Repeat deletes of an already-terminating object are no-ops, like the
        apiserver — finalizers must never be bypassed by a second delete."""
        with self._lock:
            store = self._stores[kind]
            obj = store.objects.get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is not None:
                    return  # already terminating
                obj.metadata.deletion_timestamp = self.clock()
                self._version += 1
                obj.metadata.resource_version = self._version
                event = "MODIFIED"
            else:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self.clock()
                del store.objects[(namespace, name)]
                # a removal moves the store too: without this bump a plan
                # injected against the deleted pod would be reused
                self._version += 1
                event = "DELETED"
        self._notify(kind, event, obj)

    def remove_finalizer(self, kind: str, obj, finalizer: str) -> None:
        with self._lock:
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                self._stores[kind].objects.pop(self._key(obj), None)
                deleted = True
            else:
                deleted = False
            self._version += 1
        self._notify(kind, "DELETED" if deleted else "MODIFIED", obj)

    def list(self, kind: str, namespace: Optional[str] = None) -> List:
        with self._lock:
            objs = list(self._stores[kind].objects.values())
        if namespace is not None:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        return objs

    # -- typed conveniences ------------------------------------------------
    def pods(self, namespace: Optional[str] = None) -> List[Pod]:
        return self.list("pods", namespace)

    def nodes(self) -> List[Node]:
        return self.list("nodes")

    def daemonsets(self) -> List[DaemonSet]:
        return self.list("daemonsets")

    def provisioners(self) -> List[Provisioner]:
        return self.list("provisioners")

    def list_pods_matching(
        self, namespace: Optional[str], selector: Optional[LabelSelector]
    ) -> List[Pod]:
        pods = self.pods(namespace)
        if selector is None:
            return pods
        return [p for p in pods if selector.matches(p.metadata.labels)]

    def pods_on_node(self, node_name: str) -> List[Pod]:
        """The ``spec.nodeName`` field-index equivalent: incrementally
        maintained, O(pods on that node)."""
        with self._lock:
            return list(self._pods_by_node.get(node_name, {}).values())

    # -- subresources ------------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        """The Bind subresource: assign pod to node."""
        with self._lock:
            pod.spec.node_name = node_name
            self._version += 1
            pod.metadata.resource_version = self._version
        self._notify("pods", "MODIFIED", pod)

    def evict_with_hint(self, pod: Pod):
        """``(evicted, retry_after_seconds)``: the Retry-After-aware evict
        surface. The in-memory store has no pacing opinion (None)."""
        return self.evict(pod), None

    def evict(self, pod: Pod) -> bool:
        """The Evict subresource. Returns False (HTTP 429 analog) if a PDB
        would be violated; otherwise deletes the pod with the same finalizer
        semantics as ``delete`` (there is no kubelet here, so eviction
        completes immediately, like envtest)."""
        with self._lock:
            # already-terminating pods evict without PDB enforcement, like
            # the apiserver — they no longer count against the budget
            if pod.metadata.deletion_timestamp is not None and pod.metadata.finalizers:
                return True
            for pdb in self.list("pdbs", pod.metadata.namespace):
                if pdb.selector is None or not pdb.selector.matches(pod.metadata.labels):
                    continue
                matching = [
                    p
                    for p in self.pods(pod.metadata.namespace)
                    if pdb.selector is None or pdb.selector.matches(p.metadata.labels)
                ]
                healthy = [p for p in matching if p.metadata.deletion_timestamp is None]
                min_avail = resolve_pdb_threshold(pdb.min_available, len(matching))
                max_unavail = resolve_pdb_threshold(pdb.max_unavailable, len(matching))
                if min_avail is not None and len(healthy) - 1 < min_avail:
                    return False
                if max_unavail is not None and (len(matching) - (len(healthy) - 1)) > max_unavail:
                    return False
            if pod.metadata.finalizers:
                # (terminating finalizer pods short-circuited above)
                pod.metadata.deletion_timestamp = self.clock()
                self._version += 1
                pod.metadata.resource_version = self._version
                event = "MODIFIED"
            else:
                self._stores["pods"].objects.pop(self._key(pod), None)
                pod.metadata.deletion_timestamp = pod.metadata.deletion_timestamp or self.clock()
                self._version += 1
                event = "DELETED"
        self._notify("pods", event, pod)
        return True
