"""Self-managed webhook serving certificates.

The reference webhook self-manages its TLS cert via knative's certificates
controller (``cmd/webhook/main.go:46``): generate a CA + leaf for the
webhook Service's DNS names, serve HTTPS with the leaf, and publish the CA
bundle for the ``ValidatingWebhookConfiguration.clientConfig.caBundle``.
``ensure_serving_cert`` reproduces that: idempotent per cert-dir, rotating
automatically when the cert is near expiry or the DNS names changed.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID

CERT_VALIDITY_DAYS = 365
ROTATE_BEFORE_DAYS = 30


def _new_key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
    os.chmod(path, 0o600)


def generate(cert_dir: str, dns_names: List[str]) -> Tuple[str, str, str]:
    """Generate (or re-sign under an existing CA) a serving cert for
    ``dns_names`` into ``cert_dir``. Returns (cert_path, key_path, ca_path).

    The CA (cert + key) persists in the cert dir and is REUSED on leaf
    rotation: the registered ``caBundle`` in the webhook configurations
    must stay valid across renewals — minting a fresh CA every rotation
    would break apiserver→webhook TLS until the bundle is re-injected."""
    os.makedirs(cert_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=CERT_VALIDITY_DAYS)

    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "karpenter-tpu-webhook-ca")])
    ca_key_path = os.path.join(cert_dir, "ca.key")
    ca_path = os.path.join(cert_dir, "ca.crt")
    ca_key = ca_cert = None
    if os.path.exists(ca_key_path) and os.path.exists(ca_path):
        try:
            with open(ca_key_path, "rb") as f:
                ca_key = serialization.load_pem_private_key(f.read(), password=None)
            with open(ca_path, "rb") as f:
                ca_cert = x509.load_pem_x509_certificate(f.read())
            if ca_cert.not_valid_after_utc - now < datetime.timedelta(days=ROTATE_BEFORE_DAYS):
                ca_key = ca_cert = None  # CA itself near expiry: reissue
        except (ValueError, TypeError):
            ca_key = ca_cert = None
    if ca_key is None:
        ca_key = _new_key()
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(not_after)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
            .sign(ca_key, hashes.SHA256())
        )

    leaf_key = _new_key()
    leaf = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])]))
        .issuer_name(ca_name)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(not_after)
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(n) for n in dns_names]),
            critical=False,
        )
        .add_extension(
            x509.ExtendedKeyUsage([x509.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False
        )
        .sign(ca_key, hashes.SHA256())
    )

    cert_path = os.path.join(cert_dir, "tls.crt")
    key_path = os.path.join(cert_dir, "tls.key")
    _write(cert_path, leaf.public_bytes(serialization.Encoding.PEM))
    _write(
        key_path,
        leaf_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ),
    )
    _write(ca_path, ca_cert.public_bytes(serialization.Encoding.PEM))
    _write(
        ca_key_path,
        ca_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ),
    )
    return cert_path, key_path, ca_path


def _expiring(pem_path: str) -> bool:
    try:
        with open(pem_path, "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
    except (OSError, ValueError):
        return True
    now = datetime.datetime.now(datetime.timezone.utc)
    return cert.not_valid_after_utc - now < datetime.timedelta(days=ROTATE_BEFORE_DAYS)


def _needs_rotation(cert_path: str, ca_path: str, dns_names: List[str]) -> bool:
    # the CA's own expiry matters as much as the leaf's: a re-signed leaf
    # can outlive a reused CA, and an expired CA in the registered caBundle
    # fails every apiserver handshake with nothing else prompting rotation
    if _expiring(cert_path) or _expiring(ca_path):
        return True
    try:
        with open(cert_path, "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
        sans = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName
        ).value.get_values_for_type(x509.DNSName)
    except (OSError, ValueError, x509.ExtensionNotFound):
        return True
    return set(sans) != set(dns_names)


def ensure_serving_cert(cert_dir: str, dns_names: List[str]) -> Tuple[str, str, str]:
    """Idempotent: reuse a valid existing cert, else (re)generate.
    Returns (cert_path, key_path, ca_path).

    On a read-only cert dir (Secret volume) that needs rotation, the
    existing cert is served with a loud warning — a soon-to-expire cert
    beats a crash loop that (failurePolicy: Fail) blocks every
    Provisioner write; rotation there is `make webhook-certs` + Secret
    update, outside the pod."""
    cert_path = os.path.join(cert_dir, "tls.crt")
    key_path = os.path.join(cert_dir, "tls.key")
    ca_path = os.path.join(cert_dir, "ca.crt")
    have_all = all(os.path.exists(p) for p in (cert_path, key_path, ca_path))
    if have_all and not _needs_rotation(cert_path, ca_path, dns_names):
        return cert_path, key_path, ca_path
    try:
        return generate(cert_dir, dns_names)
    except OSError:
        if have_all:
            import logging

            logging.getLogger("karpenter.webhook").warning(
                "cert dir %s is not writable and the cert needs rotation; "
                "serving the existing cert — regenerate the Secret with "
                "`make webhook-certs`", cert_dir,
            )
            return cert_path, key_path, ca_path
        raise


def ca_bundle_b64(ca_path: str) -> str:
    """Base64 CA bundle for webhook clientConfig.caBundle."""
    import base64

    with open(ca_path, "rb") as f:
        return base64.b64encode(f.read()).decode()
