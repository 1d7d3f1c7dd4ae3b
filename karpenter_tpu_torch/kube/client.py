"""In-memory cluster state store.

The solve path reads three things from the cluster: daemonsets (for the
per-node daemon overhead) and pods and nodes (for topology spread and pod
(anti-)affinity domain counts). This is the in-memory store that serves
them — the test and benchmark substrate.
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
    """Typed object store: pods, nodes, daemonsets."""

    KINDS = ("pods", "nodes", "daemonsets")

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.RLock()
        self._stores: Dict[str, Dict[Tuple[str, str], object]] = {k: {} for k in self.KINDS}
        self._version = 0
        self.clock = clock or time.time

    @staticmethod
    def _key(obj) -> Tuple[str, str]:
        return (obj.metadata.namespace, obj.metadata.name)

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
