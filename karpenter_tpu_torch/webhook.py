"""Admission webhook: Provisioner defaulting and validation.

Mirrors ``cmd/webhook`` + the knative admission plumbing: a ``defaulting``
pass (spec defaults, then the cloud provider's DefaultHook) and a
``validation`` pass (spec validation, then the ValidateHook)
(reference: cmd/webhook/main.go:46-94, apis/provisioning/v1alpha5/
provisioner_defaults.go:154-161, provisioner_validation.go:34-132,
register.go:225-227).

The provisioning controller re-runs both at Apply so the control loop is
safe without the webhook (reference: provisioning/controller.go:94-95) — the
webhook's job is fast feedback at ``kubectl apply`` time.
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.api.provisioner import (
    SOLVER_FFD,
    Provisioner,
    default_provisioner,
    validate_provisioner,
)
from karpenter_tpu_torch.cloudprovider.types import CloudProvider


class AdmissionError(Exception):
    def __init__(self, errors: List[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


class Webhook:
    def __init__(self, cloud_provider: CloudProvider, default_solver: str = SOLVER_FFD):
        self.cloud_provider = cloud_provider
        self.default_solver = default_solver

    def default(self, provisioner: Provisioner) -> Provisioner:
        """CRD defaulting: framework defaults then the vendor hook
        (the /default-resource endpoint)."""
        default_provisioner(provisioner, self.default_solver)
        self.cloud_provider.default(provisioner.spec.constraints)
        return provisioner

    def validate(self, provisioner: Provisioner) -> None:
        """CRD validation: framework rules then the vendor hook
        (the /validate-resource endpoint). Raises AdmissionError."""
        errs = validate_provisioner(provisioner)
        errs += self.cloud_provider.validate(provisioner.spec.constraints)
        if errs:
            raise AdmissionError(errs)

    def admit(self, provisioner: Provisioner) -> Provisioner:
        """Default + validate, the full admission pass."""
        self.default(provisioner)
        self.validate(provisioner)
        return provisioner


# ---------------------------------------------------------------------------
# The webhook as a process: HTTP admission endpoints — the second binary
# (reference: cmd/webhook/main.go:46-94 serves /default-resource,
# /validate-resource, /config-validation).
# ---------------------------------------------------------------------------


def serialize_provisioner(p: Provisioner) -> dict:
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement  # noqa: F401

    c = p.spec.constraints
    return {
        "metadata": {"name": p.metadata.name},
        "spec": {
            "labels": dict(c.labels),
            "taints": [
                {"key": t.key, "value": t.value, "effect": t.effect} for t in c.taints
            ],
            "requirements": [
                {"key": r.key, "operator": r.operator, "values": list(r.values)}
                for r in c.requirements.requirements
            ],
            "ttlSecondsAfterEmpty": p.spec.ttl_seconds_after_empty,
            "ttlSecondsUntilExpired": p.spec.ttl_seconds_until_expired,
            "limits": dict(p.spec.limits.resources) if p.spec.limits else None,
            "solver": p.spec.solver,
            "provider": c.provider,
        },
    }


def deserialize_provisioner(doc: dict) -> Provisioner:
    from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta, Taint
    from karpenter_tpu_torch.api.provisioner import (
        Constraints,
        Limits,
        ProvisionerSpec,
    )
    from karpenter_tpu_torch.api.requirements import Requirements
    from karpenter_tpu_torch.utils import resources as res

    spec = doc.get("spec", {})
    limits = spec.get("limits")
    return Provisioner(
        metadata=ObjectMeta(name=doc.get("metadata", {}).get("name", "default"), namespace=""),
        spec=ProvisionerSpec(
            constraints=Constraints(
                labels=dict(spec.get("labels", {})),
                taints=[
                    Taint(key=t.get("key", ""), value=t.get("value", ""),
                          effect=t.get("effect", "NoSchedule"))
                    for t in spec.get("taints", [])
                ],
                requirements=Requirements.new(
                    *(
                        NodeSelectorRequirement(
                            key=r["key"], operator=r["operator"],
                            values=list(r.get("values", [])),
                        )
                        for r in spec.get("requirements", [])
                    )
                ),
                provider=spec.get("provider"),
            ),
            ttl_seconds_after_empty=spec.get("ttlSecondsAfterEmpty"),
            ttl_seconds_until_expired=spec.get("ttlSecondsUntilExpired"),
            # kubectl-style quantity strings ("1Gi") become floats here
            limits=Limits(resources=res.parse_resource_list(limits)) if limits else None,
            solver=spec.get("solver", ""),
        ),
    )


def admission_review_response(webhook: Webhook, review: dict, path: str) -> dict:
    """Handle one admission.k8s.io/v1 AdmissionReview for ``path``
    (/default-resource mutates, /validate-resource validates).

    Mutating response: a JSONPatch ``add`` on /spec (add upserts — a
    metadata-only Provisioner has no /spec for ``replace`` to target).
    Validating response: allowed or denied with a Status message.
    (reference: the knative admission plumbing behind
    cmd/webhook/main.go:66-84.)
    """
    import base64
    import json

    from karpenter_tpu_torch.kube import serde

    request = review.get("request") or {}
    uid = request.get("uid", "")

    def deny(errors: List[str]) -> dict:
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": {
                "uid": uid,
                "allowed": False,
                "status": {"code": 400, "message": "; ".join(errors)},
            },
        }

    try:
        provisioner = serde.from_wire("provisioners", request.get("object") or {})
    except Exception as e:
        return deny([f"undecodable object: {e}"])
    if path == "/default-resource":
        try:
            webhook.default(provisioner)
        except Exception as e:
            return deny([f"defaulting failed: {e}"])
        patched = serde.to_wire("provisioners", provisioner)
        patch = [{"op": "add", "path": "/spec", "value": patched.get("spec", {})}]
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": {
                "uid": uid,
                "allowed": True,
                "patchType": "JSONPatch",
                "patch": base64.b64encode(json.dumps(patch).encode()).decode(),
            },
        }
    try:
        webhook.validate(provisioner)
    except AdmissionError as e:
        return deny(e.errors)
    except Exception as e:
        return deny([f"validation crashed: {e}"])
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": {"uid": uid, "allowed": True},
    }


def serve(
    webhook: Webhook,
    address: str = "0.0.0.0:8443",
    tls_cert: Optional[str] = None,
    tls_key: Optional[str] = None,
):
    """Start the admission server; returns the server object.

    With ``tls_cert``/``tls_key`` the server speaks HTTPS — what an
    apiserver requires of a webhook (reference: cmd/webhook/main.go:46
    self-managed cert via knative certificates).

    POST /default-resource  → AdmissionReview with a JSONPatch, or (plain
                              provisioner doc in) the defaulted document
    POST /validate-resource → AdmissionReview allow/deny, or
                              {"allowed": bool, "errors": [...]}
    GET  /healthz           → 200
    """
    import json
    import ssl
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # per-connection read deadline: a stalled client (short body vs its
        # Content-Length) must not wedge a handler thread forever
        timeout = 10

        def _respond(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._respond(200, {"ok": True})
            else:
                self._respond(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            try:
                doc = json.loads(self.rfile.read(length) or b"{}")
            except Exception as e:
                self._respond(400, {"error": f"bad request: {e}"})
                return
            if self.path not in ("/default-resource", "/validate-resource"):
                self._respond(404, {"error": "not found"})
                return
            if doc.get("kind") == "AdmissionReview":
                self._respond(200, admission_review_response(webhook, doc, self.path))
                return
            # bespoke (non-AdmissionReview) protocol for direct callers
            try:
                provisioner = deserialize_provisioner(doc)
            except Exception as e:
                self._respond(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/default-resource":
                try:
                    webhook.default(provisioner)
                except Exception as e:  # hook crash → clean admission failure
                    self._respond(422, {"error": f"defaulting failed: {e}"})
                    return
                self._respond(200, serialize_provisioner(provisioner))
            else:
                try:
                    webhook.validate(provisioner)
                    self._respond(200, {"allowed": True, "errors": []})
                except AdmissionError as e:
                    self._respond(200, {"allowed": False, "errors": e.errors})
                except Exception as e:  # hook crash → denial, not a dropped conn
                    self._respond(200, {"allowed": False, "errors": [f"validation crashed: {e}"]})

        def log_message(self, *args):
            return

    host, port = address.rsplit(":", 1)
    server = ThreadingHTTPServer((host, int(port)), Handler)
    server.daemon_threads = True
    if tls_cert and tls_key:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)
        # handshake deferred to the per-connection handler thread (with its
        # 10s timeout): with the default handshake-on-accept, one idle
        # client would block accept() — and with failurePolicy: Fail that
        # stalls every Provisioner write in the cluster
        server.socket = ctx.wrap_socket(
            server.socket, server_side=True, do_handshake_on_connect=False
        )
    threading.Thread(target=server.serve_forever, daemon=True, name="webhook").start()
    return server


def main(argv=None) -> None:
    """Webhook process entrypoint: ``python -m karpenter_tpu_torch.webhook``."""
    import argparse
    import time

    from karpenter_tpu_torch.cloudprovider import registry

    ap = argparse.ArgumentParser(prog="karpenter-tpu-webhook")
    ap.add_argument("--address", default="0.0.0.0:8443")
    ap.add_argument("--cloud-provider", default="fake")
    ap.add_argument("--default-solver", default=SOLVER_FFD)
    ap.add_argument("--cert-dir", default="/tmp/karpenter-webhook-certs",
                    help="serving cert dir; cert is self-generated when absent")
    ap.add_argument("--service-name", default="karpenter-tpu-webhook")
    ap.add_argument("--service-namespace", default="karpenter")
    ap.add_argument("--no-tls", action="store_true", help="plain HTTP (dev only)")
    ap.add_argument("--kube-api-server", default="",
                    help="'in-cluster' or an apiserver URL; enables runtime "
                         "caBundle self-reconciliation of the webhook "
                         "registrations (reference: cmd/webhook/main.go:46-63)")
    ap.add_argument("--webhook-config", action="append", default=[],
                    metavar="KIND:NAME",
                    help="webhook registration to keep current, e.g. "
                         "validating:validation.webhook.provisioners.karpenter.sh "
                         "(repeatable; defaults to the two shipped registrations)")
    args = ap.parse_args(argv)
    provider = registry.new_cloud_provider(args.cloud_provider)
    tls_cert = tls_key = ca_path = None
    if not args.no_tls:
        from karpenter_tpu_torch.kube.certs import ensure_serving_cert

        dns = [
            args.service_name,
            f"{args.service_name}.{args.service_namespace}",
            f"{args.service_name}.{args.service_namespace}.svc",
            f"{args.service_name}.{args.service_namespace}.svc.cluster.local",
        ]
        tls_cert, tls_key, ca_path = ensure_serving_cert(args.cert_dir, dns)
        print(f"serving cert ready; caBundle at {ca_path}")
    reconciler = None
    if args.kube_api_server and ca_path:
        from karpenter_tpu_torch.kube.apiserver import ApiCluster
        from karpenter_tpu_torch.kube.cabundle import CABundleReconciler

        _KIND_ALIASES = {
            "validating": "validatingwebhookconfigurations",
            "mutating": "mutatingwebhookconfigurations",
        }
        specs = args.webhook_config or [
            "mutating:defaulting.webhook.provisioners.karpenter.sh",
            "validating:validation.webhook.provisioners.karpenter.sh",
        ]
        configs = []
        for spec in specs:
            kind, _, name = spec.partition(":")
            configs.append((_KIND_ALIASES.get(kind, kind), name))
        if args.kube_api_server == "in-cluster":
            cluster = ApiCluster.from_env()
        else:
            cluster = ApiCluster(args.kube_api_server)
        # no informer start: the reconciler reads live and patches — the
        # webhook RBAC grants only get/update/patch on admissionregistration
        reconciler = CABundleReconciler(cluster, configs, ca_path).start()
        print(f"caBundle reconciler running for {configs}")
    server = serve(
        Webhook(provider, default_solver=args.default_solver),
        args.address,
        tls_cert=tls_cert,
        tls_key=tls_key,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        if reconciler is not None:
            reconciler.stop()


if __name__ == "__main__":
    main()
