"""In-memory cluster state store.

The solve path reads three things from the cluster: daemonsets (for the
per-node daemon overhead) and pods and nodes (for topology spread and pod
(anti-)affinity domain counts), and writes one: the Warning events of the
solver's integrity quarantines (``kube/events.py``). This is the in-memory
store that serves them — the test and benchmark substrate.

Every mutation (``create``, ``update``, ``delete``, ``bind``, ``seed``)
bumps one store version; ``version()`` reads it, and the resident solve
path keys its topology-plan reuse on it. Creating an event is a mutation
too, as in the reference: the round after a quarantine re-injects. There
are no watches.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.api.objects import DaemonSet, LabelSelector, Node, Pod


class Conflict(Exception):
    pass


class NotFound(Exception):
    pass


class Cluster:
    """Typed object store: pods, nodes, daemonsets, events."""

    KINDS = ("pods", "nodes", "daemonsets", "events")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.RLock()
        self._stores: Dict[str, Dict[Tuple[str, str], object]] = {k: {} for k in self.KINDS}
        self._version = 0
        self.clock = clock or time.time

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

    def seed(self, kind: str, obj) -> object:
        """Insert an object WITHOUT mutating it — for read-only shadow
        stores built from live objects; the live cluster remains the owner
        of the object."""
        with self._lock:
            self._stores[kind][self._key(obj)] = obj
            # the store's content moved even though the object is untouched:
            # version-keyed consumers (the resident plan-reuse guard in
            # solver/delta.py) must see seeded state as a new cluster state
            self._version += 1
        return obj

    def create(self, kind: str, obj) -> object:
        with self._lock:
            store = self._stores[kind]
            key = self._key(obj)
            if key in store:
                raise Conflict(f"{kind} {key} already exists")
            self._version += 1
            obj.metadata.resource_version = self._version
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock()
            store[key] = obj
        return obj

    def get(self, kind: str, name: str, namespace: str = "default"):
        with self._lock:
            obj = self._stores[kind].get((namespace, name))
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
            if key not in store:
                raise NotFound(f"{kind} {key} not found")
            self._version += 1
            obj.metadata.resource_version = self._version
            store[key] = obj
        return obj

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        """Delete with finalizer semantics: objects carrying finalizers only
        get a deletion timestamp; removal happens when finalizers clear.
        Repeat deletes of an already-terminating object are no-ops, like the
        apiserver — finalizers must never be bypassed by a second delete."""
        with self._lock:
            store = self._stores[kind]
            obj = store.get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is not None:
                    return  # already terminating
                obj.metadata.deletion_timestamp = self.clock()
                self._version += 1
                obj.metadata.resource_version = self._version
            else:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self.clock()
                del store[(namespace, name)]
                # a removal moves the store too: without this bump a plan
                # injected against the deleted pod would be reused
                self._version += 1

    def list(self, kind: str, namespace: Optional[str] = None) -> List:
        with self._lock:
            objs = list(self._stores[kind].values())
        if namespace is not None:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        return objs

    def pods(self, namespace: Optional[str] = None) -> List[Pod]:
        return self.list("pods", namespace)

    def nodes(self) -> List[Node]:
        return self.list("nodes")

    def daemonsets(self) -> List[DaemonSet]:
        return self.list("daemonsets")

    def list_pods_matching(
        self, namespace: Optional[str], selector: Optional[LabelSelector]
    ) -> List[Pod]:
        pods = self.pods(namespace)
        if selector is None:
            return pods
        return [p for p in pods if selector.matches(p.metadata.labels)]

    # -- subresources ------------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        """The Bind subresource: assign pod to node."""
        with self._lock:
            pod.spec.node_name = node_name
            self._version += 1
            pod.metadata.resource_version = self._version
