"""The port's webhook certificates (``kube/certs.py``), caBundle
reconciler (``kube/cabundle.py``) and webhook process surface against the
JAX package's: stale bundles patched with every other field kept, a CA
rotation followed by an admission call verified with exactly the patched
bundle, the reconciler over an ``ApiCluster``, the serving cert reused and
rotated, admission over HTTPS with the self-made cert, the manifest's
caBundle placeholder, and ``webhook.main`` with ``--cert-dir``,
``--no-tls`` and ``--kube-api-server``.

Mirrors ``tests/test_cabundle.py`` and ``tests/test_webhook_server_lease.py``
(``TestWebhookTLS``). Keys and certificates are random, so each case
compares what they certify (names, issuers, reuse) and every answer, not
their bytes.
"""

import base64
import importlib
import json
import os
import ssl
import threading
import time
import urllib.request

import pytest

pytest.importorskip("cryptography", reason="the webhook's certificates need cryptography")

from cryptography import x509  # noqa: E402

from torch_parity import PACKAGES, both_canon, fresh_router, kube, kube_env  # noqa: E402,F401


def with_certs(pkg):
    """``kube(pkg)`` plus ``kube/certs.py``, which imports cryptography."""
    M = kube(pkg)
    M.certs = importlib.import_module(f"{pkg}.kube.certs")
    return M


def both(fn):
    return both_canon(fn, ns=with_certs)


def sans(path):
    with open(path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    names = cert.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    return names.get_values_for_type(x509.DNSName), cert.issuer.rfc4514_string()


def registration(M, name, suffix, bundle):
    return M.O.ValidatingWebhookConfiguration(
        metadata=M.O.ObjectMeta(name=name, namespace=""),
        webhooks=[{
            "name": name, "admissionReviewVersions": ["v1"], "sideEffects": "None",
            "failurePolicy": "Fail",
            "clientConfig": {"service": {"name": "karpenter-tpu-webhook", "namespace": "karpenter",
                                         "path": f"/{suffix}", "port": 443},
                             "caBundle": bundle},
            "rules": [{"apiGroups": ["karpenter.sh"], "apiVersions": ["v1alpha5"],
                       "operations": ["CREATE", "UPDATE"], "resources": ["provisioners"]}],
        }])


def bundle_of(path):
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


REVIEW = {"kind": "AdmissionReview", "apiVersion": "admission.k8s.io/v1",
          "request": {"uid": "u1", "object": {
              "apiVersion": "karpenter.sh/v1alpha5", "kind": "Provisioner",
              "metadata": {"name": "default"}, "spec": {"solver": "ffd"}}}}


def post(url, body, context):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, context=context, timeout=10) as resp:
        return json.loads(resp.read())


# -- TestCABundleReconciler ------------------------------------------------------------


def test_stale_bundles_patched_fields_preserved(tmp_path):
    def run(M):
        _, _, ca = M.certs.ensure_serving_cert(str(tmp_path / M.pkg), ["svc", "svc.ns"])
        cluster = M.client.Cluster()
        cluster.create("validatingwebhookconfigurations",
                       registration(M, "validation.webhook.karpenter.sh", "validate-resource",
                                    "c3RhbGU="))
        cluster.create("mutatingwebhookconfigurations",
                       registration(M, "defaulting.webhook.karpenter.sh", "default-resource",
                                    "c3RhbGU="))
        rec = M.cabundle.CABundleReconciler(cluster, [
            ("validatingwebhookconfigurations", "validation.webhook.karpenter.sh"),
            ("mutatingwebhookconfigurations", "defaulting.webhook.karpenter.sh")], ca)
        first = rec.reconcile_once()
        hooks = []
        for kind, name in rec.configs:
            w = json.loads(json.dumps(cluster.get(kind, name, namespace="").webhooks[0]))
            assert w["clientConfig"].pop("caBundle") == bundle_of(ca)
            hooks.append(w)
        return first, hooks, rec.reconcile_once()

    first, hooks, steady = both(run)
    assert first == 2 and steady == 0
    assert hooks[0]["rules"][0]["apiGroups"] == ["karpenter.sh"]
    assert hooks[0]["clientConfig"]["service"]["port"] == 443


def test_rotation_updates_registration_and_admission_verifies(tmp_path):
    def run(M):
        cert_dir = str(tmp_path / M.pkg)
        cert, key, ca = M.certs.ensure_serving_cert(cert_dir, ["localhost"])
        cluster = M.client.Cluster()
        name = "validation.webhook.karpenter.sh"
        cluster.create("validatingwebhookconfigurations",
                       registration(M, name, "validate-resource", bundle_of(ca)))
        rec = M.cabundle.CABundleReconciler(cluster, [("validatingwebhookconfigurations", name)],
                                            ca)
        current = rec.reconcile_once()
        for f in ("ca.key", "ca.crt", "tls.crt"):
            os.remove(os.path.join(cert_dir, f))
        cert, key, ca2 = M.certs.ensure_serving_cert(cert_dir, ["localhost"])
        rotated = rec.reconcile_once()
        cfg = cluster.get("validatingwebhookconfigurations", name, namespace="")
        patched = base64.b64decode(cfg.webhooks[0]["clientConfig"]["caBundle"])
        with open(ca2, "rb") as f:
            matches = patched == f.read()
        server = M.webhook.serve(M.webhook.Webhook(M.fake.FakeCloudProvider(
            M.fake.instance_types(4))), "127.0.0.1:0", tls_cert=cert, tls_key=key)
        try:
            context = ssl.create_default_context(cadata=patched.decode())
            body = post(f"https://localhost:{server.server_address[1]}/validate-resource",
                        REVIEW, context)
        finally:
            server.shutdown()
        return current, rotated, matches, body["response"]

    current, rotated, matches, response = both(run)
    assert (current, rotated, matches) == (0, 1, True)
    assert response["uid"] == "u1" and response["allowed"] is True


def test_reconciles_over_real_apiserver_boundary(tmp_path):
    """Each package's reconciler over an ``ApiCluster`` against the other
    package's server too (no informers: it reads live and patches)."""
    def run(M):
        _, _, ca = M.certs.ensure_serving_cert(str(tmp_path / M.pkg), ["svc"])
        out = []
        for server_pkg in PACKAGES:
            S = kube(server_pkg)
            with kube_env(S) as env:
                name = "validation.webhook.karpenter.sh"
                env.cluster.create("validatingwebhookconfigurations",
                                   registration(S, name, "validate-resource", "c3RhbGU="))
                client = env.connect(M=M, start=False)
                rec = M.cabundle.CABundleReconciler(
                    client, [("validatingwebhookconfigurations", name)], ca)
                updated = rec.reconcile_once()
                w = env.cluster.get("validatingwebhookconfigurations", name,
                                    namespace="").webhooks[0]
                out.append((updated, w["clientConfig"]["caBundle"] == bundle_of(ca),
                            w["rules"][0]["resources"]))
        return out

    assert both(run) == [(1, True, ["provisioners"])] * 2


# -- TestWebhookTLS --------------------------------------------------------------------


def test_cert_reused_and_rotated(tmp_path):
    def run(M):
        d = str(tmp_path / M.pkg)
        c1 = M.certs.ensure_serving_cert(d, ["localhost"])
        pem1 = open(c1[0], "rb").read()
        ca1 = open(c1[2], "rb").read()
        before = sans(c1[0])
        c2 = M.certs.ensure_serving_cert(d, ["localhost"])
        reused = open(c2[0], "rb").read() == pem1
        c3 = M.certs.ensure_serving_cert(d, ["other-name"])
        return ([os.path.basename(p) for p in c1], reused,
                open(c3[0], "rb").read() != pem1, open(c3[2], "rb").read() == ca1,
                before, sans(c3[0]), M.certs.ca_bundle_b64(c3[2]) == bundle_of(c3[2]))

    names, reused, rotated, ca_kept, before, after, b64 = both(run)
    assert names == ["tls.crt", "tls.key", "ca.crt"] and reused and rotated and ca_kept and b64
    assert before == (["localhost"], "CN=karpenter-tpu-webhook-ca")
    assert after[0] == ["other-name"]


def tls_run(tmp_path, body_of):
    """``body_of(post_to)`` against each package's webhook served over
    HTTPS with a cert from that package's ``ensure_serving_cert``
    (``default_solver="tpu"``)."""
    def run(M):
        cert, key, ca = M.certs.ensure_serving_cert(
            str(tmp_path / M.pkg), ["localhost", "karpenter-tpu-webhook.karpenter.svc"])
        webhook = M.webhook.Webhook(M.fake.FakeCloudProvider(M.fake.instance_types(4)),
                                    default_solver="tpu")
        server = M.webhook.serve(webhook, "127.0.0.1:0", tls_cert=cert, tls_key=key)
        context = ssl.create_default_context(cafile=ca)
        context.check_hostname = False
        try:
            return body_of(lambda path, obj: post(
                f"https://127.0.0.1:{server.server_address[1]}{path}",
                {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                 "request": {"uid": "test-uid-1", "object": obj}}, context))
        finally:
            server.shutdown()

    return both(run)


def provisioner(spec):
    return {"apiVersion": "karpenter.sh/v1alpha5", "kind": "Provisioner",
            "metadata": {"name": "default"}, "spec": spec}


def test_mutating_review_returns_defaulting_patch(tmp_path):
    resp = tls_run(tmp_path, lambda post_to: post_to("/default-resource", provisioner({})))
    response = resp["response"]
    assert response["uid"] == "test-uid-1" and response["allowed"] is True
    patch = json.loads(base64.b64decode(response["patch"]))
    assert patch[0]["path"] == "/spec" and patch[0]["value"]["solver"] == "tpu"


def test_validating_review_denies_bad_spec(tmp_path):
    out = tls_run(tmp_path, lambda post_to: post_to("/validate-resource",
                                                     provisioner({"solver": "bogus"})))
    assert out["response"]["allowed"] is False
    assert "solver" in out["response"]["status"]["message"]


def test_validating_review_allows_good_spec(tmp_path):
    out = tls_run(tmp_path, lambda post_to: post_to("/validate-resource",
                                                     provisioner({"solver": "tpu"})))
    assert out["response"]["allowed"] is True


def test_manifest_cabundle_placeholder_renders(tmp_path):
    def run(M):
        _, _, ca = M.certs.ensure_serving_cert(str(tmp_path / M.pkg), ["localhost"])
        with open("deploy/webhook.yaml") as f:
            rendered = f.read().replace("${CA_BUNDLE}", M.certs.ca_bundle_b64(ca))
        return "${CA_BUNDLE}" not in rendered, "caBundle: LS0t" in rendered

    assert both(run) == (True, True)


# -- webhook.main ------------------------------------------------------------------------


def run_main(M, argv, monkeypatch, during):
    """``webhook.main(argv)`` on a thread, ``during()`` once it serves, then
    a KeyboardInterrupt into its sleep; ``during``'s value."""
    started, stop, out = threading.Event(), threading.Event(), {}
    orig_serve, orig_start = M.webhook.serve, M.cabundle.CABundleReconciler.start

    def serve(*args, **kw):
        out["server"] = orig_serve(*args, **kw)
        started.set()
        return out["server"]

    def start(self):
        out["reconciler"] = self
        return orig_start(self)

    def sleep(seconds):
        if threading.current_thread() is thread:
            stop.wait(30)
            raise KeyboardInterrupt
        return real_sleep(seconds)

    real_sleep = time.sleep
    monkeypatch.setattr(M.webhook, "serve", serve)
    monkeypatch.setattr(M.cabundle.CABundleReconciler, "start", start)
    monkeypatch.setattr(time, "sleep", sleep)
    thread = threading.Thread(target=M.webhook.main, args=(argv,), daemon=True)
    thread.start()
    try:
        assert started.wait(30)
        return during(out)
    finally:
        stop.set()
        thread.join(30)
        monkeypatch.undo()


def test_main_serves_tls_and_reconciles_the_bundle(tmp_path, monkeypatch, capsys):
    """``--cert-dir`` makes the serving cert for the service's names,
    ``--kube-api-server`` starts the caBundle reconciler over an
    ``ApiCluster`` that patches the registration on the server."""
    def run(M):
        with kube_env(M) as env:
            name = "validation.webhook.provisioners.karpenter.sh"
            env.cluster.create("validatingwebhookconfigurations",
                               registration(M, name, "validate-resource", "c3RhbGU="))
            cert_dir = str(tmp_path / M.pkg)
            argv = ["--address", "127.0.0.1:0", "--cert-dir", cert_dir,
                    "--service-name", "hook", "--service-namespace", "ops",
                    "--kube-api-server", env.url, "--webhook-config", f"validating:{name}"]

            def during(out):
                deadline = time.time() + 10
                cfg = env.cluster.get("validatingwebhookconfigurations", name, namespace="")
                while time.time() < deadline and cfg.webhooks[0]["clientConfig"]["caBundle"] \
                        == "c3RhbGU=":
                    time.sleep(0.02)
                    cfg = env.cluster.get("validatingwebhookconfigurations", name, namespace="")
                context = ssl.create_default_context(cafile=os.path.join(cert_dir, "ca.crt"))
                context.check_hostname = False
                body = post(f"https://127.0.0.1:{out['server'].server_address[1]}"
                            "/validate-resource", REVIEW, context)
                return (cfg.webhooks[0]["clientConfig"]["caBundle"]
                        == bundle_of(os.path.join(cert_dir, "ca.crt")),
                        out["reconciler"].configs, body["response"]["allowed"],
                        sans(os.path.join(cert_dir, "tls.crt"))[0])

            return run_main(M, argv, monkeypatch, during)

    patched, configs, allowed, names = both(run)
    assert patched and allowed
    assert configs == [("validatingwebhookconfigurations",
                        "validation.webhook.provisioners.karpenter.sh")]
    assert names == ["hook", "hook.ops", "hook.ops.svc", "hook.ops.svc.cluster.local"]


def test_main_without_tls_serves_plain_http(tmp_path, monkeypatch):
    def run(M):
        def during(out):
            body = post(f"http://127.0.0.1:{out['server'].server_address[1]}/validate-resource",
                        REVIEW, None)
            return body["response"]["allowed"], "reconciler" in out

        return run_main(M, ["--address", "127.0.0.1:0", "--no-tls",
                            "--cert-dir", str(tmp_path / M.pkg)], monkeypatch, during) + (
            os.path.exists(tmp_path / M.pkg),)

    assert both(run) == (True, False, False)
