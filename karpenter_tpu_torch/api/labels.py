"""Well-known label registry, normalization, and restriction rules.

Mirrors ``pkg/apis/provisioning/v1alpha5/labels.go`` and the group constants in
``register.go:229-246``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set

# Kubernetes well-known labels.
TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
TOPOLOGY_REGION = "topology.kubernetes.io/region"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
HOSTNAME = "kubernetes.io/hostname"

# Group / domain constants (reference: register.go:229-246).
GROUP = "karpenter.sh"
LABEL_DOMAIN = GROUP
CAPACITY_TYPE = LABEL_DOMAIN + "/capacity-type"
PROVISIONER_NAME_LABEL = LABEL_DOMAIN + "/provisioner-name"
NOT_READY_TAINT_KEY = LABEL_DOMAIN + "/not-ready"
INTERRUPTION_TAINT_KEY = LABEL_DOMAIN + "/interruption"
DO_NOT_EVICT_ANNOTATION = LABEL_DOMAIN + "/do-not-evict"
# the client launch token stamped on both the cloud instance (tag/label)
# and the Node object at create — the idempotency key that pairs them for
# crash recovery (launch/journal.py) and the GC/adoption cross-check
LAUNCH_TOKEN_ANNOTATION = LABEL_DOMAIN + "/launch-token"
# present (value "true") on a node the warm-pool controller launched
# speculatively and no demand has claimed yet; removed at claim time by
# the worker's warm-hit steal — its absence is how the GC ladder tells a
# claimed warm node from stale speculation (controllers/warmpool.py)
WARM_POOL_ANNOTATION = LABEL_DOMAIN + "/warm-pool"
EMPTINESS_TIMESTAMP_ANNOTATION = LABEL_DOMAIN + "/emptiness-timestamp"
TERMINATION_FINALIZER = LABEL_DOMAIN + "/termination"

ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
OS_LINUX = "linux"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

RESTRICTED_LABEL_DOMAINS: Set[str] = {"kubernetes.io", "k8s.io", LABEL_DOMAIN}
LABEL_DOMAIN_EXCEPTIONS: Set[str] = {"kops.k8s.io"}

WELL_KNOWN_LABELS: Set[str] = {
    TOPOLOGY_ZONE,
    INSTANCE_TYPE,
    ARCH,
    OS,
    CAPACITY_TYPE,
}

RESTRICTED_LABELS: Set[str] = {
    EMPTINESS_TIMESTAMP_ANNOTATION,
    HOSTNAME,
}

# Aliased/beta labels → stable labels (reference: labels.go:66-73).
NORMALIZED_LABELS: Dict[str, str] = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE,
    "beta.kubernetes.io/arch": ARCH,
    "beta.kubernetes.io/os": OS,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION,
}

IGNORED_LABELS: Set[str] = {TOPOLOGY_REGION}


# Syntax rules (reference: provisioner_validation.go:75-100 via
# k8s.io/apimachinery validation.IsQualifiedName / IsValidLabelValue).
_NAME_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9\-_.]*[A-Za-z0-9])?$")
_DNS1123_SUBDOMAIN_RE = re.compile(
    r"^[a-z0-9]([a-z0-9\-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9\-]*[a-z0-9])?)*$"
)
_MAX_NAME_LEN = 63
_MAX_PREFIX_LEN = 253


def check_qualified_name(key: str) -> List[str]:
    """Syntax errors for a label/taint key: ``[prefix/]name`` where the
    optional prefix is a DNS-1123 subdomain (≤253 chars) and the name is ≤63
    alphanumeric-bounded chars allowing ``-_.`` inside."""
    errs: List[str] = []
    parts = key.split("/")
    if len(parts) == 1:
        name = parts[0]
    elif len(parts) == 2:
        prefix, name = parts
        if not prefix:
            errs.append(f"{key}: prefix part must be non-empty")
        elif len(prefix) > _MAX_PREFIX_LEN:
            errs.append(f"{key}: prefix part must be no more than {_MAX_PREFIX_LEN} characters")
        elif not _DNS1123_SUBDOMAIN_RE.fullmatch(prefix):
            errs.append(f"{key}: prefix part must be a lowercase RFC 1123 subdomain")
    else:
        return [f"{key}: a qualified name must consist of a name part and an optional prefix part separated by a single '/'"]
    if not name:
        errs.append(f"{key}: name part must be non-empty")
    elif len(name) > _MAX_NAME_LEN:
        errs.append(f"{key}: name part must be no more than {_MAX_NAME_LEN} characters")
    elif not _NAME_RE.fullmatch(name):
        errs.append(
            f"{key}: name part must consist of alphanumeric characters, '-', '_' or '.', "
            "and must start and end with an alphanumeric character"
        )
    return errs


def check_label_value(value: str) -> List[str]:
    """Syntax errors for a label or taint value: empty or ≤63
    alphanumeric-bounded chars allowing ``-_.`` inside."""
    if not value:
        return []
    if len(value) > _MAX_NAME_LEN:
        return [f"{value}: must be no more than {_MAX_NAME_LEN} characters"]
    if not _NAME_RE.fullmatch(value):
        return [
            f"{value}: a valid label value must consist of alphanumeric characters, "
            "'-', '_' or '.', and must start and end with an alphanumeric character"
        ]
    return []


def _label_domain(key: str) -> str:
    if "/" in key:
        return key.split("/", 1)[0]
    return ""


def check_restricted_label(key: str) -> Optional[str]:
    """Return an error string if the label may not be used on a provisioner
    (reference: labels.go:83-97)."""
    if key in WELL_KNOWN_LABELS:
        return None
    if key in RESTRICTED_LABELS:
        return f"label is restricted, {key}"
    domain = _label_domain(key)
    if domain in LABEL_DOMAIN_EXCEPTIONS:
        return None
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain.endswith(restricted):
            return f"label domain not allowed, {domain}"
    return None


def is_restricted_node_label(key: str) -> bool:
    """True if karpenter must not inject this label onto nodes it creates
    (reference: labels.go:100-109)."""
    domain = _label_domain(key)
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain.endswith(restricted):
            return True
    return key in RESTRICTED_LABELS
