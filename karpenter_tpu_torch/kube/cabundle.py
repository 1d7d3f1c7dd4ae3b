"""Webhook-registration caBundle self-reconciliation.

The reference's webhook process doesn't just serve its cert — it keeps the
admission registration's ``clientConfig.caBundle`` current at runtime
(knative ``certificates.NewController``, reference: cmd/webhook/main.go:46-63).
Without this, a CA rotation on a live cluster (``kube/certs.py`` reissues a
near-expiry CA) leaves the registration pointing at the OLD CA: the
apiserver rejects every webhook call, and with ``failurePolicy: Fail`` that
blocks every Provisioner write until an operator re-runs
``make webhook-cabundle``.

``CABundleReconciler`` closes the loop: read the live registration, compare
every webhook entry's caBundle to the CA on disk, and write ONE update with
the bundles rewritten when they differ. Reads are uncached (``get_live``
against an apiserver backend) — a reconciler that trusts a stale informer
view of its own write target can flap.
"""

from __future__ import annotations

import base64
import logging
import threading
from typing import Callable, List, Optional

from karpenter_tpu_torch.kube.client import Cluster, NotFound

logger = logging.getLogger("karpenter.webhook.cabundle")

RESYNC_SECONDS = 300.0  # certs rotate on the order of days; minutes is ample

WEBHOOK_CONFIG_KINDS = (
    "validatingwebhookconfigurations",
    "mutatingwebhookconfigurations",
)


class CABundleReconciler:
    def __init__(
        self,
        cluster: Cluster,
        configs: List,  # (kind, name) pairs; kind in WEBHOOK_CONFIG_KINDS
        ca_path: str,
        resync_seconds: float = RESYNC_SECONDS,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.cluster = cluster
        self.configs = [tuple(c) for c in configs]
        self.ca_path = ca_path
        self.resync_seconds = resync_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _current_bundle(self) -> str:
        with open(self.ca_path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    def _get_live(self, kind: str, name: str):
        getter = getattr(self.cluster, "get_live", None)
        if getter is not None:
            return getter(kind, name, namespace="")
        return self.cluster.get(kind, name, namespace="")

    def reconcile_once(self) -> int:
        """Returns how many registrations were updated."""
        try:
            bundle = self._current_bundle()
        except OSError as e:
            logger.warning("cannot read CA at %s: %s", self.ca_path, e)
            return 0
        updated = 0
        for kind, name in self.configs:
            try:
                cfg = self._get_live(kind, name)
            except NotFound:
                logger.warning("webhook configuration %s not found", name)
                continue
            except Exception as e:
                logger.error("reading webhook configuration %s: %s", name, e)
                continue
            stale = [
                w.get("name", "?")
                for w in cfg.webhooks
                if (w.get("clientConfig") or {}).get("caBundle") != bundle
            ]
            if not stale:
                continue
            # JSON merge-patch replaces lists wholesale, so ship the FULL
            # webhooks array with only the bundles rewritten — every other
            # field (rules, sideEffects, ...) round-trips untouched
            webhooks = []
            for w in cfg.webhooks:
                w = dict(w)
                cc = dict(w.get("clientConfig") or {})
                cc["caBundle"] = bundle
                w["clientConfig"] = cc
                webhooks.append(w)
            try:
                self.cluster.merge_patch(kind, name, {"webhooks": webhooks}, namespace="")
                updated += 1
                logger.info(
                    "updated caBundle of %s (stale webhooks: %s)", name, ", ".join(stale)
                )
            except Exception as e:
                logger.error("patching webhook configuration %s: %s", name, e)
        return updated

    def start(self) -> "CABundleReconciler":
        def loop():
            while not self._stop.is_set():
                self.reconcile_once()
                self._stop.wait(self.resync_seconds)

        self._thread = threading.Thread(target=loop, daemon=True, name="cabundle")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
