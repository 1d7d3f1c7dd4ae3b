"""Real-apiserver ``Cluster`` backend.

``ApiCluster`` speaks plain Kubernetes REST — list/watch with resync,
create/update/merge-patch/delete, the Bind and Eviction subresources — and
maintains informer-style local caches fed by watch streams, so reads served
to reconcilers are cache reads exactly like controller-runtime's
(reference: pkg/controllers/manager.go:34-46). Every request passes the
client-side QPS/burst token bucket (reference: cmd/controller/main.go:68-70,
options.go:42-43).

Transport is stdlib ``http.client`` (no kubernetes client dependency):
chunked watch streams are newline-delimited JSON events, exactly the
apiserver protocol. TLS + bearer-token auth cover in-cluster use;
``from_env()`` builds the in-cluster config from the standard service
account mount.

Writes go to the server; the local cache is updated from the server's
response immediately (not waiting for the watch echo) so a reconciler that
writes then reads sees its own write, matching the reference's
optimistic-concurrency flow.

Every change this client makes to its cache (a watch event or re-list it
applies, a write's answer it caches, a removal) bumps ``Cluster.version()``,
as every mutation of the in-memory ``Cluster`` does: the resident solve
path keys its topology-plan reuse on that version, so a watch that moved a
node must invalidate the plan. An event older than the cached view, which
the cache drops, moves nothing.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import ssl
import threading
import time
from http.client import HTTPConnection, HTTPSConnection
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.kube import serde
from karpenter_tpu_torch.kube.client import Cluster, Conflict, NotFound
from karpenter_tpu_torch.kube.transport import (
    VERB_CREATE,
    VERB_EVENTS,
    VERB_LEASE,
    VERB_MUTATE,
    VERB_READ,
    VERB_WATCH,
    ApiUnavailable,
    KubeThrottled,
    KubeTransport,
)

logger = logging.getLogger("karpenter.kube.apiserver")

# kind -> (api prefix, resource plural)
RESOURCES: Dict[str, Tuple[str, str]] = {
    "pods": ("/api/v1", "pods"),
    "nodes": ("/api/v1", "nodes"),
    "daemonsets": ("/apis/apps/v1", "daemonsets"),
    "provisioners": ("/apis/karpenter.sh/v1alpha5", "provisioners"),
    "pvcs": ("/api/v1", "persistentvolumeclaims"),
    "pvs": ("/api/v1", "persistentvolumes"),
    "storageclasses": ("/apis/storage.k8s.io/v1", "storageclasses"),
    "pdbs": ("/apis/policy/v1", "poddisruptionbudgets"),
    "leases": ("/apis/coordination.k8s.io/v1", "leases"),
    "validatingwebhookconfigurations": (
        "/apis/admissionregistration.k8s.io/v1", "validatingwebhookconfigurations",
    ),
    "mutatingwebhookconfigurations": (
        "/apis/admissionregistration.k8s.io/v1", "mutatingwebhookconfigurations",
    ),
    "events": ("/api/v1", "events"),
}

WATCH_RECONNECT_DELAY = 1.0
# the watch loop's failure backoff doubles per consecutive failure (with
# jitter) up to this cap, and resets on any successful list — a down
# apiserver costs each kind one paced probe, not a re-list hot loop
WATCH_BACKOFF_CAP = 30.0
# idle watch reads give up and reconnect after this long, so a stop() or a
# silently-dead connection never wedges a watch thread indefinitely
WATCH_READ_TIMEOUT = 60.0
# server-side watch timeout: below WATCH_READ_TIMEOUT so an idle stream ends
# with a clean EOF (resumable from the last RV) rather than a socket timeout
WATCH_TIMEOUT_SECONDS = 45

# Kinds the informer plane watches by default: everything EXCEPT leases and
# webhook registrations. Leader election reads its Lease with uncached
# get_live (kube/leader.py) and the caBundle reconciler reads its
# registration the same way, so informers there are dead weight — leases
# would churn on every node-heartbeat cluster-wide, and BOTH require
# list/watch RBAC the shipped manifests deliberately do not grant (watching
# without it 403s forever and fails wait_for_sync).
WATCH_KINDS = tuple(
    k for k in Cluster.KINDS
    if k not in (
        # write-mostly kinds the controllers never read back: informers on
        # them are churn + RBAC surface for nothing
        "leases", "validatingwebhookconfigurations", "mutatingwebhookconfigurations",
        "events",
    )
)


class ApiError(Exception):
    def __init__(self, status: int, body: str = ""):
        super().__init__(f"apiserver returned {status}: {body[:200]}")
        self.status = status
        self.body = body


def _raise_for(status: int, body: str):
    if status == 404:
        raise NotFound(body or "not found")
    if status == 409:
        raise Conflict(body or "conflict")
    raise ApiError(status, body)


class ApiCluster(Cluster):
    """Cluster interface against a real apiserver; see module docstring.

    The inherited in-memory stores act as the informer cache: reads
    (``get``/``list``/``pods_on_node``/…) and watch registration are served
    by the base class against cache contents; mutations override the base
    to issue REST calls and then apply the server's view to the cache.
    """

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure_skip_verify: bool = False,
        qps: float = 200.0,
        burst: int = 300,
        kinds: Optional[Tuple[str, ...]] = None,
        clock=None,
    ):
        super().__init__(clock=clock)
        u = urlparse(base_url)
        self._scheme = u.scheme or "http"
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if self._scheme == "https" else 80)
        self._token = token
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self._scheme == "https":
            self._ssl_ctx = ssl.create_default_context(cafile=ca_file)
            if insecure_skip_verify:
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE
        # the resilient transport choke point (kube/transport.py): per-verb
        # retries, 429/Retry-After handling, mutation-priority flow control
        # (the old bare TokenBucket generalized), circuit breaker, metrics
        self.transport = KubeTransport(qps=qps, burst=burst)
        # Event writes must never hold a reconcile hostage: short connect/
        # read timeout on the events verb class (tests shrink it)
        self.events_timeout = 2.0
        # lease ops get their own short timeout: a renew slower than the
        # renew cadence is useless, and a 30s connect hang into a real
        # packet-dropping partition would blow past the fencing margin
        self.lease_timeout = 5.0
        # watch-loop failure backoff knobs (tests shrink them to count
        # re-list attempts in CI time)
        self.watch_backoff_base = WATCH_RECONNECT_DELAY
        self.watch_backoff_cap = WATCH_BACKOFF_CAP
        # kind -> full re-LIST attempts (regression surface for the
        # blackout hot-loop fix; the prometheus twin is KUBE_RELISTS)
        self.relist_attempts: Dict[str, int] = {}
        self._watch_kinds = tuple(kinds) if kinds is not None else WATCH_KINDS
        self._stop = threading.Event()
        self._threads: list = []
        self._watch_conns: Dict[str, object] = {}
        self._synced: Dict[str, threading.Event] = {
            k: threading.Event() for k in self._watch_kinds
        }

    @classmethod
    def from_env(cls, qps: float = 200.0, burst: int = 300) -> "ApiCluster":
        """In-cluster config from the standard service-account mount."""
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        token = None
        token_path = os.path.join(sa, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        ca = os.path.join(sa, "ca.crt")
        return cls(
            f"https://{host}:{port}",
            token=token,
            ca_file=ca if os.path.exists(ca) else None,
            qps=qps,
            burst=burst,
        )

    # -- transport ---------------------------------------------------------
    def _connect(self, timeout: Optional[float] = 30.0):
        if self._scheme == "https":
            return HTTPSConnection(self._host, self._port, timeout=timeout, context=self._ssl_ctx)
        return HTTPConnection(self._host, self._port, timeout=timeout)

    def _headers(self, content_type: Optional[str] = None) -> Dict[str, str]:
        h = {"Accept": "application/json"}
        if content_type:
            h["Content-Type"] = content_type
        if self._token:
            h["Authorization"] = f"Bearer {self._token}"
        return h

    _VERB_CLASS = {"GET": VERB_READ, "POST": VERB_CREATE}

    def _request(
        self, method: str, path: str, body: Optional[dict] = None,
        content_type: str = "application/json",
        kind: str = "", verb_class: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[int, dict]:
        """One logical apiserver call through the transport choke point.
        ``verb_class`` defaults from the method (GET→read, POST→create,
        PUT/PATCH/DELETE→mutate); Event writes pass ``events`` explicitly
        (zero retries, short deadline, drop-counted)."""
        if verb_class is None:
            verb_class = self._VERB_CLASS.get(method, VERB_MUTATE)
        if kind == "leases" and verb_class != VERB_WATCH:
            # lease traffic IS the fencing signal (kube/leader.py): single
            # attempt, short deadline, never fast-failed by a breaker some
            # OTHER traffic opened (kube/transport.py VERB_LEASE)
            verb_class = VERB_LEASE
            if timeout is None:
                timeout = self.lease_timeout
        status, doc, _hint = self.transport.request(
            verb_class, method, kind,
            lambda: self._attempt(method, path, body, content_type, timeout),
        )
        return status, doc

    def _attempt(
        self, method: str, path: str, body: Optional[dict],
        content_type: str, timeout: Optional[float],
    ) -> Tuple[int, dict, Optional[float]]:
        """One HTTP round trip: (status, body, Retry-After seconds)."""
        conn = self._connect(timeout=timeout if timeout is not None else 30.0)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload, headers=self._headers(content_type))
            resp = conn.getresponse()
            raw = resp.read()
            doc = json.loads(raw) if raw else {}
            retry_after: Optional[float] = None
            header = resp.getheader("Retry-After")
            if header:
                try:
                    retry_after = float(header)
                except ValueError:
                    retry_after = None
            return resp.status, doc, retry_after
        finally:
            conn.close()

    def _path(self, kind: str, namespace: Optional[str], name: Optional[str] = None,
              subresource: Optional[str] = None, query: str = "") -> str:
        prefix, plural = RESOURCES[kind]
        _, _, namespaced = serde.KIND_INFO[kind]
        parts = [prefix]
        if namespaced and namespace is not None and namespace != "":
            parts += ["namespaces", namespace]
        parts.append(plural)
        if name is not None:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts) + (f"?{query}" if query else "")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the list+watch loop for every kind."""
        for kind in self._watch_kinds:
            t = threading.Thread(
                target=self._watch_loop, args=(kind,), daemon=True,
                name=f"watch-{kind}",
            )
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        self._stop.set()
        # unblock threads sitting in watch reads
        for conn in list(self._watch_conns.values()):
            try:
                conn.close()
            except Exception:
                pass
        for t in self._threads:
            t.join(timeout=2)

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        """Block until every kind's cache saw its initial list."""
        deadline = time.monotonic() + timeout
        for kind in self._watch_kinds:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._synced[kind].wait(timeout=remaining):
                return False
        return True

    # -- informer loop -----------------------------------------------------
    def _watch_loop(self, kind: str) -> None:
        """List once, then watch forever — resuming each reconnect from the
        last-seen event resourceVersion. Re-listing happens only when the
        server says the RV is too old (410 Gone / ERROR event) or on a
        transport error, never on routine idle stream ends: client-go resyncs
        on the order of hours, and a full re-LIST dispatches MODIFIED for
        every cached object, requeueing every controller key.

        Consecutive failures back off with jittered exponential delays (base
        doubled per failure up to ``watch_backoff_cap``, reset by any
        successful list) — a down apiserver costs one paced probe per kind,
        not a re-list hot loop multiplied by every replica in the fleet."""
        import random

        rv: Optional[str] = None
        failures = 0
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._relist(kind)
                    self._synced[kind].set()
                    failures = 0  # success resets the backoff ladder
                rv = self._stream(kind, rv)
            except Exception as e:
                if self._stop.is_set():
                    return
                failures += 1
                delay = min(
                    self.watch_backoff_cap,
                    self.watch_backoff_base * (2 ** min(failures - 1, 16)),
                )
                delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
                logger.debug(
                    "watch %s disconnected (%s); re-listing in %.2fs "
                    "(failure %d)", kind, e, delay, failures,
                )
                rv = None  # unknown delta state: resync with a full list
                self._stop.wait(delay)

    def _relist(self, kind: str) -> str:
        """Full list; reconcile the cache to it (resync), dispatching
        ADDED/MODIFIED/DELETED deltas to registered watchers.

        The list snapshot can be OLDER than local writes already applied to
        the cache (a create raced the reconnect), so the list's
        resourceVersion gates both overwrites and evictions — mirroring
        ``_apply_event``'s per-object guard."""
        from karpenter_tpu_torch import metrics

        self.relist_attempts[kind] = self.relist_attempts.get(kind, 0) + 1
        metrics.KUBE_RELISTS.labels(kind=kind).inc()
        # the `watch` verb class: flow-limited, breaker-recorded, but NOT
        # transport-retried — this loop owns the pacing, and stacking two
        # retry layers would multiply load on a struggling apiserver
        status, doc = self._request(
            "GET", self._path(kind, None), kind=kind, verb_class=VERB_WATCH
        )
        if status != 200:
            raise ApiError(status, str(doc))
        rv = str((doc.get("metadata") or {}).get("resourceVersion") or "0")
        try:
            list_rv = int(rv)
        except ValueError:
            list_rv = 0
        fresh = {}
        for item in doc.get("items") or []:
            obj = serde.from_wire(kind, item)
            fresh[(obj.metadata.namespace, obj.metadata.name)] = obj
        notify_fresh = []
        deleted = []
        with self._lock:
            store = self._stores[kind]
            for key, obj in fresh.items():
                current = store.objects.get(key)
                # rv 0 = unparseable/opaque RV: ordering is unknowable, so
                # last-write-wins (never silently freeze the cache)
                if (
                    current is not None
                    and obj.metadata.resource_version > 0
                    and current.metadata.resource_version > obj.metadata.resource_version
                ):
                    continue  # cache holds a newer (locally-written) view
                store.objects[key] = obj
                notify_fresh.append(obj)
            for key in set(store.objects) - set(fresh):
                current = store.objects[key]
                if current.metadata.resource_version > list_rv:
                    continue  # created after the list snapshot — not deleted
                del store.objects[key]
                deleted.append(current)
            if notify_fresh or deleted:
                self._version += 1
        for obj in notify_fresh:
            self._notify(kind, "MODIFIED", obj)
        for obj in deleted:
            self._notify(kind, "DELETED", obj)
        return rv

    def _stream(self, kind: str, rv: str) -> Optional[str]:
        """Consume one watch stream until disconnect. Returns the
        resourceVersion to resume the next watch from (each event — and
        BOOKMARK events, which exist for exactly this — advances it), or
        ``None`` when the server declared the RV too old (410 Gone / ERROR
        event) and the caller must re-list. A finite read timeout (idle
        watches reconnect) plus connection tracking keeps ``stop()`` from
        leaving threads blocked in reads forever."""
        conn = self._connect(timeout=WATCH_READ_TIMEOUT)
        self._watch_conns[kind] = conn
        try:
            path = self._path(
                kind, None,
                query=(
                    f"watch=true&resourceVersion={rv}&allowWatchBookmarks=true"
                    f"&timeoutSeconds={WATCH_TIMEOUT_SECONDS}"
                ),
            )
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status == 410:
                return None  # too-old resourceVersion: caller re-lists
            if resp.status != 200:
                raise ApiError(resp.status, resp.read().decode(errors="replace"))
            buf = b""
            while not self._stop.is_set():
                chunk = resp.read1(65536)
                if not chunk:
                    return rv  # clean EOF (server timeout): resume from rv
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    event = json.loads(line)
                    etype = event.get("type")
                    obj_rv = ((event.get("object") or {}).get("metadata") or {}).get(
                        "resourceVersion"
                    )
                    if obj_rv:
                        rv = str(obj_rv)
                    if etype == "BOOKMARK":
                        continue
                    if etype == "ERROR":
                        return None  # 410 Gone mid-stream: re-list
                    obj = serde.from_wire(kind, event.get("object") or {})
                    self._apply_event(kind, etype, obj)
            return rv
        except socket.timeout:
            return rv  # idle past the read timeout: resume from rv
        finally:
            self._watch_conns.pop(kind, None)
            conn.close()

    def _apply_event(self, kind: str, etype: str, obj) -> None:
        if self._stop.is_set():
            return  # a stopped cluster must not feed stopped watchers
        key = (obj.metadata.namespace, obj.metadata.name)
        with self._lock:
            store = self._stores[kind]
            if etype == "DELETED":
                store.objects.pop(key, None)
                self._version += 1
            else:
                current = store.objects.get(key)
                # rv 0 = opaque/unparseable RV: accept (last-write-wins) —
                # dropping on 0 >= 0 would freeze the cache permanently
                if (
                    current is not None
                    and obj.metadata.resource_version > 0
                    and current.metadata.resource_version >= obj.metadata.resource_version
                ):
                    return  # our own write already applied a newer view
                store.objects[key] = obj
                self._version += 1
        self._notify(kind, etype, obj)

    def _cache_put(self, kind: str, obj) -> None:
        with self._lock:
            self._stores[kind].objects[(obj.metadata.namespace, obj.metadata.name)] = obj
            self._version += 1

    def _cache_pop(self, kind: str, namespace: str, name: str):
        """Drop ``(namespace, name)`` from the cache; the dropped object
        (None when it was not cached)."""
        with self._lock:
            obj = self._stores[kind].objects.pop((namespace, name), None)
            self._version += 1
        return obj

    def degraded(self) -> bool:
        """Is the transport refusing apiserver calls (breaker open)?
        Controllers treat True as "serve the informer cache"; the lease
        layer treats it as UNREACHABLE and fences on its own clock."""
        return self.transport.degraded()

    def get_live(self, kind: str, name: str, namespace: str = "default"):
        """Uncached GET straight from the server — leader election must
        never trust a stale informer view. While the apiserver breaker is
        OPEN, watched kinds degrade to the informer cache (counted on
        ``karpenter_kube_degraded_reads_total``); un-watched kinds (leases)
        have no cache to fall back on, and the failure propagates so the
        lease layer can fence instead of trusting anything stale."""
        try:
            status, doc = self._request(
                "GET", self._path(kind, namespace, name), kind=kind
            )
        except ApiUnavailable:
            # only WATCHED kinds have an informer cache worth serving; an
            # un-watched kind's store holds nothing but this process's own
            # write echoes, and handing the lease layer its own stale
            # renewal back would corrupt the REJECTED/UNREACHABLE split
            if kind in self._watch_kinds:
                cached = self.try_get(kind, name, namespace=namespace)
                if cached is not None:
                    from karpenter_tpu_torch import metrics

                    metrics.KUBE_DEGRADED_READS.inc()
                    return cached
            raise
        if status != 200:
            _raise_for(status, str(doc))
        return serde.from_wire(kind, doc)

    def list_live(self, kind: str, namespace: Optional[str] = None):
        """Uncached collection GET straight from the server. The fleet
        shard-lease set (kube/leader.py ``KubeLeaseSet``) must see PEER
        replicas' lease objects, and leases are deliberately not
        informer-watched (WATCH_KINDS) — the cached ``list`` only ever
        shows this process's own writes for those kinds, so there is no
        cache worth degrading to here: failures propagate and the lease
        layer classifies them (REJECTED vs UNREACHABLE)."""
        status, doc = self._request("GET", self._path(kind, namespace), kind=kind)
        if status != 200:
            _raise_for(status, str(doc))
        return [serde.from_wire(kind, item) for item in doc.get("items") or []]

    # -- mutations (REST) --------------------------------------------------
    def _write_policy(self, kind: str) -> dict:
        """Extra ``_request`` kwargs for a write to ``kind``: Event writes
        ride the zero-retry/short-deadline ``events`` class — recording is
        fire-and-forget and must never block a reconcile on a slow
        apiserver (drops are counted, kube/transport.py)."""
        if kind == "events":
            return {"verb_class": VERB_EVENTS, "timeout": self.events_timeout}
        return {}

    def create(self, kind: str, obj):
        status, doc = self._request(
            "POST", self._path(kind, obj.metadata.namespace), serde.to_wire(kind, obj),
            kind=kind, **self._write_policy(kind),
        )
        if status not in (200, 201):
            _raise_for(status, str(doc))
        fresh = serde.from_wire(kind, doc)
        # propagate server-assigned identity onto the caller's object
        obj.metadata.resource_version = fresh.metadata.resource_version
        obj.metadata.uid = fresh.metadata.uid
        obj.metadata.creation_timestamp = fresh.metadata.creation_timestamp
        self._cache_put(kind, fresh)
        self._notify(kind, "ADDED", fresh)
        return obj

    def update(self, kind: str, obj):
        status, doc = self._request(
            "PUT",
            self._path(kind, obj.metadata.namespace, obj.metadata.name),
            serde.to_wire(kind, obj),
            kind=kind, **self._write_policy(kind),
        )
        if status != 200:
            _raise_for(status, str(doc))
        fresh = serde.from_wire(kind, doc)
        obj.metadata.resource_version = fresh.metadata.resource_version
        self._cache_put(kind, fresh)
        self._notify(kind, "MODIFIED", fresh)
        return obj

    def merge_patch(
        self,
        kind: str,
        name: str,
        patch: dict,
        namespace: str = "default",
        subresource: Optional[str] = None,
    ):
        """JSON merge-patch — the reference's single-patch-per-reconcile
        idiom (node/controller.go:106-115)."""
        status, doc = self._request(
            "PATCH",
            self._path(kind, namespace, name, subresource),
            patch,
            content_type="application/merge-patch+json",
            kind=kind,
        )
        if status != 200:
            _raise_for(status, str(doc))
        fresh = serde.from_wire(kind, doc)
        self._cache_put(kind, fresh)
        self._notify(kind, "MODIFIED", fresh)
        return fresh

    def patch_status(self, kind: str, name: str, status: dict, namespace: str = "default"):
        """Merge-patch against the ``/status`` subresource — the apiserver
        drops status changes on main-resource writes for kinds with
        ``subresources.status`` (deploy/crd.yaml), so controllers must come
        through here."""
        return self.merge_patch(
            kind, name, {"status": status}, namespace=namespace, subresource="status"
        )

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        status, doc = self._request(
            "DELETE", self._path(kind, namespace, name), kind=kind
        )
        if status not in (200, 202):
            _raise_for(status, str(doc))
        # finalizer semantics live on the server: a finalized object comes
        # back MODIFIED with deletionTimestamp; a free one is gone
        if doc.get("kind") == "Status" or not doc:
            obj = self._cache_pop(kind, namespace, name)
            if obj is not None:
                self._notify(kind, "DELETED", obj)
            return
        fresh = serde.from_wire(kind, doc)
        if fresh.metadata.deletion_timestamp is not None and fresh.metadata.finalizers:
            self._cache_put(kind, fresh)
            self._notify(kind, "MODIFIED", fresh)
        else:
            self._cache_pop(kind, namespace, name)
            self._notify(kind, "DELETED", fresh)

    def remove_finalizer(self, kind: str, obj, finalizer: str) -> None:
        from karpenter_tpu_torch.kube.patch import without_value

        # RFC 7386 replaces the array wholesale: carry the FULL remaining
        # list (RMW of the caller's copy), mirrored back into it so repeat
        # calls stay idempotent against the same object
        finalizers = without_value(obj.metadata.finalizers, finalizer)
        obj.metadata.finalizers[:] = finalizers
        fresh = self.merge_patch(
            kind,
            obj.metadata.name,
            {"metadata": {"finalizers": finalizers}},
            namespace=obj.metadata.namespace,
        )
        obj.metadata.resource_version = fresh.metadata.resource_version
        if fresh.metadata.deletion_timestamp is not None and not fresh.metadata.finalizers:
            # dropping the last finalizer of a terminating object frees it
            gone = self._cache_pop(kind, obj.metadata.namespace, obj.metadata.name)
            if gone is not None:
                self._notify(kind, "DELETED", fresh)

    # -- subresources ------------------------------------------------------
    def bind(self, pod: Pod, node_name: str) -> None:
        # VERB_CREATE: a Binding POST is not idempotent at the HTTP layer —
        # the transport never retries it, and the 409 arm below is the
        # idempotency ladder (a lost response followed by a re-bind to the
        # SAME node already achieved the goal)
        status, doc = self._request(
            "POST",
            self._path("pods", pod.metadata.namespace, pod.metadata.name, "binding"),
            {
                "apiVersion": "v1",
                "kind": "Binding",
                "metadata": {"name": pod.metadata.name},
                "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
            },
            kind="pods",
        )
        if status == 409:
            # idempotent retry: a lost response followed by a re-bind to the
            # SAME node already achieved the goal; anything else is a real
            # conflict
            try:
                live = self.get_live("pods", pod.metadata.name, pod.metadata.namespace)
            except NotFound:
                live = None
            if live is None or live.spec.node_name != node_name:
                _raise_for(status, str(doc))
            # cache the server's (fresher) view, not the caller's stale copy
            pod.spec.node_name = node_name
            pod.metadata.resource_version = live.metadata.resource_version
            self._cache_put("pods", live)
            self._notify("pods", "MODIFIED", live)
            return
        if status not in (200, 201):
            _raise_for(status, str(doc))
        pod.spec.node_name = node_name
        self._cache_put("pods", pod)
        self._notify("pods", "MODIFIED", pod)

    def evict(self, pod: Pod) -> bool:
        return self.evict_with_hint(pod)[0]

    def evict_with_hint(self, pod: Pod) -> Tuple[bool, Optional[float]]:
        """Eviction + the server's pacing opinion: a PDB-blocked eviction
        answers 429 WITH a ``Retry-After`` header, and discarding it made
        termination requeue on a blind interval — the hint rides back so
        the eviction queue can honor the server's own schedule."""
        try:
            status, doc, retry_after = self.transport.request(
                VERB_CREATE, "POST", "pods",
                lambda: self._attempt(
                    "POST",
                    self._path(
                        "pods", pod.metadata.namespace, pod.metadata.name, "eviction"
                    ),
                    {
                        "apiVersion": "policy/v1",
                        "kind": "Eviction",
                        "metadata": {
                            "name": pod.metadata.name,
                            "namespace": pod.metadata.namespace,
                        },
                    },
                    "application/json",
                    None,
                ),
            )
        except KubeThrottled as e:
            # PDB would be violated (or the apiserver itself throttled the
            # POST): not evicted, retry when the server said to
            return False, e.retry_after
        if status == 429:
            return False, retry_after  # unreachable: transport raises — kept for safety
        if status == 404:
            return True, None  # already gone
        if status not in (200, 201):
            _raise_for(status, str(doc))
        return True, None
