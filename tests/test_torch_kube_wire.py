"""The two packages' API server clients and servers across the wire: the
port's ``ApiCluster`` against the JAX package's ``TestApiServer``, and the
JAX package's ``ApiCluster`` against the port's. Each server records every
request it receives (method, path, body) through its ``chaos=`` hook; one
deterministic scenario (create, merge patch, status patch, bind, evict, a
Lease acquire and renew, a delete) must give the same transcript from
either package's client, and leave the same store behind.
"""

import io
import json
import re

from torch_parity import PACKAGES, fresh_router, kube, kube_env, wire_doc  # noqa: F401


class Recorder:
    """A ``chaos=`` hook that lets every request through after recording
    its method, path and JSON body (the body is read here and handed back
    to the handler)."""

    def __init__(self):
        self.requests = []

    def intercept(self, handler, method, path):
        length = int(handler.headers.get("Content-Length") or 0)
        raw = handler.rfile.read(length) if length else b""
        handler.rfile = io.BytesIO(raw)
        body = json.loads(raw) if raw else None
        self.requests.append((method, path, body))
        return False


def scrub(transcript):
    """The transcript with random uids replaced by their presence."""
    return json.loads(re.sub(r'"uid": "[^"]*"', '"uid": "<set>"', json.dumps(transcript)))


def scenario(server_pkg, client_pkg):
    """The scenario from a ``client_pkg`` client against a fresh
    ``server_pkg`` server (its store and both clocks pinned): the
    server's transcript and its store afterwards."""
    S, C = kube(server_pkg), kube(client_pkg)
    recorder = Recorder()
    with kube_env(S, cluster=S.client.Cluster(clock=lambda: 1000.0), chaos=recorder) as env:
        c = env.connect(M=C, start=False, kinds=(), clock=lambda: 1000.0)
        pod = C.f.make_pod(name="p", requests={"cpu": "1"}, labels={"app": "a"})
        c.create("pods", pod)
        c.merge_patch("pods", "p", {"metadata": {"labels": {"tier": "web"}}})
        c.create("provisioners", C.f.make_provisioner())
        c.patch_status("provisioners", "default", {"resources": {"cpu": "4"}}, namespace="")
        c.create("nodes", C.f.make_node(name="node-a", capacity={"cpu": "4"}))
        c.bind(pod, "node-a")
        evicted = c.evict(pod)
        lease = C.leader.KubeLease(c, name="lead", namespace="kube-system", identity="a",
                                   duration=30)
        acquired, renewed = lease.try_acquire(), lease.renew()
        c.delete("nodes", "node-a", namespace="")
        stored = {kind: sorted((wire_doc(S, kind, o) for o in env.cluster.list(kind)),
                               key=lambda d: d["metadata"]["name"])
                  for kind in ("pods", "nodes", "provisioners", "leases")}
        return scrub(recorder.requests), (evicted, acquired, renewed), scrub(stored)


def across(server_pkg):
    native, foreign = (scenario(server_pkg, client_pkg) for client_pkg in
                       (server_pkg, next(p for p in PACKAGES if p != server_pkg)))
    assert foreign == native
    return native


def test_port_client_against_reference_server():
    transcript, answers, stored = across("karpenter_tpu")
    assert answers == (True, True, True)
    assert [(m, p.split("?")[0]) for m, p, _ in transcript] == EXPECTED
    assert stored["pods"] == [] and [d["holderIdentity"] for d in
                                     (s["spec"] for s in stored["leases"])] == ["a"]


def test_reference_client_against_port_server():
    transcript, answers, _ = across("karpenter_tpu_torch")
    assert answers == (True, True, True)
    assert [(m, p.split("?")[0]) for m, p, _ in transcript] == EXPECTED


EXPECTED = [
    ("POST", "/api/v1/namespaces/default/pods"),
    ("PATCH", "/api/v1/namespaces/default/pods/p"),
    ("POST", "/apis/karpenter.sh/v1alpha5/provisioners"),
    ("PATCH", "/apis/karpenter.sh/v1alpha5/provisioners/default/status"),
    ("POST", "/api/v1/nodes"),
    ("POST", "/api/v1/namespaces/default/pods/p/binding"),
    ("POST", "/api/v1/namespaces/default/pods/p/eviction"),
    ("GET", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/lead"),
    ("POST", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases"),
    ("GET", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/lead"),
    ("PUT", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases/lead"),
    ("DELETE", "/api/v1/nodes/node-a"),
]
