"""An in-process Kubernetes apiserver double speaking the real protocol.

The reference's integration substrate is envtest — a real kube-apiserver +
etcd booted per suite (``pkg/test/environment.go:53-98``). The equivalent
here: this server exposes the actual Kubernetes REST surface (list/get/
create/update/merge-patch/finalizer-aware delete, Binding and Eviction
subresources, chunked ``?watch=true`` streams of newline-delimited JSON
events) over a real TCP socket, backed by the in-memory ``Cluster``.
``ApiCluster`` connects to it exactly as it would to a production
apiserver, so the full controller stack is exercised across a genuine
HTTP/serialization boundary.

Usage::

    env = TestApiServer()
    env.start()
    cluster = ApiCluster(env.url)
    cluster.start(); cluster.wait_for_sync()
    ...
    env.stop()
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from karpenter_tpu_torch.kube import serde
from karpenter_tpu_torch.kube.client import Cluster, Conflict, NotFound

# plural -> kind (reverse of apiserver.RESOURCES)
PLURALS: Dict[str, str] = {
    "pods": "pods",
    "nodes": "nodes",
    "daemonsets": "daemonsets",
    "provisioners": "provisioners",
    "persistentvolumeclaims": "pvcs",
    "persistentvolumes": "pvs",
    "storageclasses": "storageclasses",
    "poddisruptionbudgets": "pdbs",
    "leases": "leases",
    "validatingwebhookconfigurations": "validatingwebhookconfigurations",
    "mutatingwebhookconfigurations": "mutatingwebhookconfigurations",
    "events": "events",
}


from karpenter_tpu_torch.kube.serde import json_merge as merge_patch  # shared RFC 7386 impl

# Kinds whose CRD declares ``subresources: {status: {}}`` (deploy/crd.yaml):
# like a real apiserver, main-resource writes to these kinds silently keep
# the CURRENT status, and status changes must come through the ``/status``
# subresource.
STATUS_SUBRESOURCE_KINDS = {"provisioners"}


def _status(code: int, reason: str, message: str) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Status",
        "status": "Failure" if code >= 400 else "Success",
        "code": code,
        "reason": reason,
        "message": message,
    }


class _Request:
    """Parsed REST path: /api/v1/namespaces/{ns}/pods/{name}/{sub}."""

    def __init__(self, path: str):
        u = urlparse(path)
        self.query = parse_qs(u.query)
        parts = [p for p in u.path.split("/") if p]
        # strip the group/version prefix: api/v1 or apis/<group>/<version>
        if parts and parts[0] == "api":
            parts = parts[2:]
        elif parts and parts[0] == "apis":
            parts = parts[3:]
        self.namespace: Optional[str] = None
        if parts and parts[0] == "namespaces" and len(parts) >= 2:
            self.namespace = parts[1]
            parts = parts[2:]
        self.plural = parts[0] if parts else ""
        self.name = parts[1] if len(parts) > 1 else None
        self.subresource = parts[2] if len(parts) > 2 else None
        self.kind = PLURALS.get(self.plural)

    @property
    def watch(self) -> bool:
        return self.query.get("watch", ["false"])[0] == "true"


class TestApiServer:
    __test__ = False  # not a pytest class, despite the name

    def __init__(
        self,
        cluster: Optional[Cluster] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        chaos=None,
    ):
        self.cluster = cluster or Cluster()
        # control-plane chaos (testing/chaos.py ApiServerChaos): when set,
        # every request consults it first — injected 5xx, 429-with-
        # Retry-After, latency, and blackout connection drops wrap the
        # whole REST surface, watch connects included. Settable live so a
        # storm leg can phase chaos on and off mid-run.
        self.chaos = chaos
        # the PDB pacing hint a blocked eviction advertises (Retry-After)
        self.eviction_retry_after = 1.0
        self._watch_queues: Dict[str, list] = {k: [] for k in Cluster.KINDS}
        self._watch_lock = threading.Lock()
        # recent events per kind, stamped with the store version, so a
        # watch starting at resourceVersion=N replays everything after N —
        # without this, objects created between a client's initial list and
        # its watch connection are silently lost (real apiserver semantics)
        import collections

        self._history: Dict[str, "collections.deque"] = {
            k: collections.deque(maxlen=4096) for k in Cluster.KINDS
        }
        for kind in Cluster.KINDS:
            self.cluster.watch(kind, self._fanout(kind))
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send_json(self, code: int, doc: dict, headers=None) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _chaos(self, method: str) -> bool:
                """True when the chaos layer handled (or dropped) the
                request; the real handler must return immediately."""
                chaos = server.chaos
                if chaos is None:
                    return False
                return chaos.intercept(self, method, self.path)

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                if self._chaos("GET"):
                    return
                req = _Request(self.path)
                if req.kind is None:
                    return self._send_json(404, _status(404, "NotFound", f"no resource {req.plural}"))
                if req.name is None:
                    if req.watch:
                        return server._serve_watch(self, req)
                    return server._serve_list(self, req)
                try:
                    obj = server._get(req)
                except NotFound as e:
                    return self._send_json(404, _status(404, "NotFound", str(e)))
                self._send_json(200, serde.to_wire(req.kind, obj))

            def do_POST(self):
                if self._chaos("POST"):
                    return
                req = _Request(self.path)
                if req.kind is None:
                    return self._send_json(404, _status(404, "NotFound", f"no resource {req.plural}"))
                doc = self._body()
                if req.subresource == "binding":
                    return server._serve_binding(self, req, doc)
                if req.subresource == "eviction":
                    return server._serve_eviction(self, req, doc)
                obj = serde.from_wire(req.kind, doc)
                if req.namespace is not None and serde.KIND_INFO[req.kind][2]:
                    obj.metadata.namespace = req.namespace
                try:
                    created = server.cluster.create(req.kind, obj)
                except Conflict as e:
                    return self._send_json(409, _status(409, "AlreadyExists", str(e)))
                self._send_json(201, serde.to_wire(req.kind, created))

            def do_PUT(self):
                if self._chaos("PUT"):
                    return
                req = _Request(self.path)
                if req.kind is None or req.name is None:
                    return self._send_json(404, _status(404, "NotFound", "bad path"))
                doc = self._body()
                obj = serde.from_wire(req.kind, doc)
                try:
                    current = server._get(req)
                except NotFound as e:
                    return self._send_json(404, _status(404, "NotFound", str(e)))
                sent_rv = obj.metadata.resource_version
                if sent_rv and sent_rv != current.metadata.resource_version:
                    return self._send_json(
                        409, _status(409, "Conflict", f"resourceVersion {sent_rv} is stale")
                    )
                obj.metadata.namespace = current.metadata.namespace
                obj.metadata.uid = current.metadata.uid
                obj.metadata.creation_timestamp = current.metadata.creation_timestamp
                if current.metadata.deletion_timestamp is not None:
                    obj.metadata.deletion_timestamp = current.metadata.deletion_timestamp
                if req.kind in STATUS_SUBRESOURCE_KINDS:
                    if req.subresource == "status":
                        # PUT to /status replaces status only
                        current.status = obj.status
                        obj = current
                    else:
                        # main-resource write: the apiserver keeps the
                        # current status when subresources.status is on
                        obj.status = current.status
                elif req.subresource:
                    return self._send_json(
                        404, _status(404, "NotFound", f"no subresource {req.subresource}")
                    )
                server.cluster.update(req.kind, obj)
                self._send_json(200, serde.to_wire(req.kind, obj))

            def do_PATCH(self):
                if self._chaos("PATCH"):
                    return
                req = _Request(self.path)
                if req.kind is None or req.name is None:
                    return self._send_json(404, _status(404, "NotFound", "bad path"))
                patch = self._body()
                try:
                    current = server._get(req)
                except NotFound as e:
                    return self._send_json(404, _status(404, "NotFound", str(e)))
                if req.kind in STATUS_SUBRESOURCE_KINDS:
                    if req.subresource == "status":
                        # only the status field of the patch applies
                        patch = (
                            {"status": patch["status"]}
                            if patch.get("status") is not None
                            else {}
                        )
                    elif "status" in patch:
                        # main-resource patch: status changes are dropped
                        patch = {k: v for k, v in patch.items() if k != "status"}
                elif req.subresource:
                    return self._send_json(
                        404, _status(404, "NotFound", f"no subresource {req.subresource}")
                    )
                merged_doc = merge_patch(serde.to_wire(req.kind, current), patch)
                obj = serde.from_wire(req.kind, merged_doc)
                obj.metadata.namespace = current.metadata.namespace
                obj.metadata.uid = current.metadata.uid
                obj.metadata.creation_timestamp = current.metadata.creation_timestamp
                obj.metadata.deletion_timestamp = current.metadata.deletion_timestamp
                if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                    # patching away the last finalizer frees a terminating
                    # object, like the apiserver's finalizer GC
                    server.cluster.update(req.kind, obj)
                    server.cluster.remove_finalizer(req.kind, obj, "")
                else:
                    server.cluster.update(req.kind, obj)
                self._send_json(200, serde.to_wire(req.kind, obj))

            def do_DELETE(self):
                if self._chaos("DELETE"):
                    return
                req = _Request(self.path)
                if req.kind is None or req.name is None:
                    return self._send_json(404, _status(404, "NotFound", "bad path"))
                namespace = req.namespace if req.namespace is not None else server._default_ns(req.kind)
                try:
                    obj = server.cluster.get(req.kind, req.name, namespace=namespace)
                    server.cluster.delete(req.kind, req.name, namespace=namespace)
                except NotFound as e:
                    return self._send_json(404, _status(404, "NotFound", str(e)))
                still = server.cluster.try_get(req.kind, req.name, namespace=namespace)
                if still is not None:
                    # finalizers pinned it: terminating, not gone
                    return self._send_json(200, serde.to_wire(req.kind, still))
                self._send_json(200, _status(200, "Success", "deleted"))

        class _Server(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                import sys

                exc = sys.exc_info()[1]
                # chaos blackout drops and impatient clients (short event
                # deadlines) tear connections mid-request routinely — that
                # is the scenario, not a server bug worth a traceback
                if isinstance(exc, OSError):
                    return
                super().handle_error(request, client_address)

        self._httpd = _Server((host, port), Handler)
        self._httpd.daemon_threads = True
        self.url = f"http://{host}:{self._httpd.server_address[1]}"

    # -- store helpers -----------------------------------------------------
    def _default_ns(self, kind: str) -> str:
        return "" if not serde.KIND_INFO[kind][2] else "default"

    def _get(self, req: _Request):
        namespace = req.namespace if req.namespace is not None else None
        if namespace is not None:
            return self.cluster.get(req.kind, req.name, namespace=namespace)
        # cluster-scoped or cross-namespace lookup by name
        for obj in self.cluster.list(req.kind):
            if obj.metadata.name == req.name:
                return obj
        raise NotFound(f"{req.kind} {req.name} not found")

    def _fanout(self, kind: str):
        def push(event: str, obj) -> None:
            doc = serde.to_wire(kind, obj)
            ev = {"type": event, "object": doc}
            with self._watch_lock:
                self._history[kind].append((self.cluster._version, ev))
                for q in self._watch_queues[kind]:
                    q.put(ev)

        return push

    # -- list / watch ------------------------------------------------------
    def _serve_list(self, handler, req: _Request) -> None:
        objs = self.cluster.list(req.kind, req.namespace)
        api_version, k8s_kind, _ = serde.KIND_INFO[req.kind]
        doc = {
            "apiVersion": api_version,
            "kind": f"{k8s_kind}List",
            "metadata": {"resourceVersion": str(self.cluster._version)},
            "items": [serde.to_wire(req.kind, o) for o in objs],
        }
        handler._send_json(200, doc)

    def _serve_watch(self, handler, req: _Request) -> None:
        q: "queue.Queue" = queue.Queue()
        try:
            since = int(req.query.get("resourceVersion", ["0"])[0] or 0)
        except ValueError:
            since = 0
        try:
            # real apiserver semantics: the stream ends with a clean EOF
            # after timeoutSeconds, and the client resumes from the last RV
            timeout_s = float(req.query.get("timeoutSeconds", ["0"])[0] or 0)
        except ValueError:
            timeout_s = 0.0
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        with self._watch_lock:
            # replay-then-register atomically: nothing between `since` and
            # "now" may be dropped, nothing live may jump the backlog
            for seq, ev in self._history[req.kind]:
                if seq > since:
                    q.put(ev)
            self._watch_queues[req.kind].append(q)
        last_rv = since  # highest RV delivered on THIS stream; bookmarks
        # must never advance the client past an undelivered event
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def send_chunk(data: bytes) -> None:
                handler.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                handler.wfile.flush()

            while True:
                if deadline is not None and time.monotonic() >= deadline:
                    # terminal chunk: clean EOF the client resumes from
                    handler.wfile.write(b"0\r\n\r\n")
                    handler.wfile.flush()
                    return
                try:
                    event = q.get(timeout=1.0)
                except queue.Empty:
                    # heartbeat bookmark keeps half-open connections honest
                    # and advances the client's resume RV like a real
                    # apiserver's allowWatchBookmarks
                    send_chunk(
                        json.dumps(
                            {
                                "type": "BOOKMARK",
                                "object": {"metadata": {"resourceVersion": str(last_rv)}},
                            }
                        ).encode()
                        + b"\n"
                    )
                    continue
                if req.namespace is not None:
                    meta = (event["object"].get("metadata") or {})
                    if meta.get("namespace", "default") != req.namespace:
                        continue
                try:
                    last_rv = int((event["object"].get("metadata") or {}).get("resourceVersion") or last_rv)
                except (TypeError, ValueError):
                    pass
                send_chunk(json.dumps(event).encode() + b"\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with self._watch_lock:
                try:
                    self._watch_queues[req.kind].remove(q)
                except ValueError:
                    pass

    # -- subresources ------------------------------------------------------
    def _serve_binding(self, handler, req: _Request, doc: dict) -> None:
        namespace = req.namespace if req.namespace is not None else "default"
        pod = self.cluster.try_get("pods", req.name, namespace=namespace)
        if pod is None:
            return handler._send_json(404, _status(404, "NotFound", f"pod {req.name}"))
        node_name = (doc.get("target") or {}).get("name", "")
        if pod.spec.node_name:
            # real apiserver semantics: Binding an already-assigned pod is
            # 409 even to the same node — migration must evict and let the
            # workload recreate
            return handler._send_json(
                409,
                _status(409, "Conflict", f"pod {req.name} is already assigned to {pod.spec.node_name}"),
            )
        self.cluster.bind(pod, node_name)
        handler._send_json(201, _status(201, "Created", "bound"))

    def _serve_eviction(self, handler, req: _Request, doc: dict) -> None:
        namespace = req.namespace if req.namespace is not None else "default"
        pod = self.cluster.try_get("pods", req.name, namespace=namespace)
        if pod is None:
            return handler._send_json(404, _status(404, "NotFound", f"pod {req.name}"))
        if not self.cluster.evict(pod):
            # real apiserver semantics: the PDB 429 carries Retry-After so
            # the evictor requeues on the server's schedule, not a blind one
            return handler._send_json(
                429, _status(429, "TooManyRequests", "disruption budget violated"),
                headers={"Retry-After": f"{self.eviction_retry_after:g}"},
            )
        handler._send_json(201, _status(201, "Created", "evicted"))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
