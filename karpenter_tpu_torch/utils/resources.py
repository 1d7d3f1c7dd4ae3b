"""Resource-quantity parsing and ResourceList arithmetic.

Mirrors the semantics of ``pkg/utils/resources/resources.go`` (RequestsForPods
sums container requests and adds a ``pods`` count; ``fits`` is an elementwise
<=) but stores quantities as floats, and provides the fixed-order vector
encoding the TPU solver consumes: every ResourceList maps onto a float32
vector with one slot per supported resource dimension.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

# Canonical resource names (match kubernetes resource names).
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
NVIDIA_GPU = "nvidia.com/gpu"
AMD_GPU = "amd.com/gpu"
AWS_NEURON = "aws.amazon.com/neuron"
AWS_POD_ENI = "vpc.amazonaws.com/pod-eni"

# The fixed dimension order for the solver's dense encoding. Keep CPU and
# MEMORY first: the FFD sort key is (cpu desc, memory desc)
# (reference: scheduler.go:116-137).
RESOURCE_AXES: List[str] = [
    CPU,
    MEMORY,
    PODS,
    EPHEMERAL_STORAGE,
    NVIDIA_GPU,
    AMD_GPU,
    AWS_NEURON,
    AWS_POD_ENI,
]
AXIS_INDEX = {name: i for i, name in enumerate(RESOURCE_AXES)}
NUM_RESOURCE_AXES = len(RESOURCE_AXES)

ResourceList = Dict[str, float]

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?)(?P<suffix>(?:[KMGTPE]i?|[mkun])?)$"
)

_SUFFIX_MULTIPLIERS = {
    "": 1.0,
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "K": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
    "Ei": 2.0**60,
}


def parse_quantity(value) -> float:
    """Parse a kubernetes-style quantity ('100m', '2Gi', 1.5) into a float."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse quantity {value!r}")
    num = float(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    return num * _SUFFIX_MULTIPLIERS[m.group("suffix")]


def parse_resource_list(raw: Optional[Mapping[str, object]]) -> ResourceList:
    return {k: parse_quantity(v) for k, v in (raw or {}).items()}


def merge(*lists: Mapping[str, float]) -> ResourceList:
    """Sum resource lists key-wise (reference: resources.go:51-64)."""
    out: ResourceList = {}
    for rl in lists:
        for name, qty in rl.items():
            out[name] = out.get(name, 0.0) + qty
    return out


def fits(candidate: Mapping[str, float], total: Mapping[str, float]) -> bool:
    """Candidate fits iff every requested quantity <= total's (missing keys
    in total count as zero; reference: resources.go:83-90). Comparison is in
    integer milli-units, matching Go's resource.Quantity exact arithmetic —
    float drift from summing parsed quantities (e.g. 0.1+0.25 > 0.35 in
    binary) must not flip a fit decision."""
    return all(
        round(qty * 1000.0) <= round(total.get(name, 0.0) * 1000.0)
        for name, qty in candidate.items()
    )


def requests_for_pods(*pods) -> ResourceList:
    """Total requests of the pods plus a `pods` count
    (reference: resources.go:25-35).

    The single-pod case is memoized on the pod object (keyed by the identity
    of its containers list, which scheduling never mutates): a 10k-pod solve
    calls this twice per pod (FFD sort + encode) and the repeated merges were
    a top-3 profile entry."""
    if len(pods) == 1:
        pod = pods[0]
        containers = pod.spec.containers
        cached = getattr(pod, "_requests_memo", None)
        if cached is not None and cached[0] is containers:
            return dict(cached[1])
        out = merge(*(c.requests for c in containers))
        out[PODS] = out.get(PODS, 0.0) + 1.0
        try:
            pod._requests_memo = (containers, dict(out))
        except AttributeError:
            pass  # slotted/frozen pod types just skip the memo
        return out
    out = merge(*(p.resource_requests() for p in pods))
    out[PODS] = out.get(PODS, 0.0) + float(len(pods))
    return out


def to_string(rl: Mapping[str, float]) -> str:
    if not rl:
        return "{}"
    return "{" + ", ".join(f"{k}: {rl[k]:g}" for k in sorted(rl)) + "}"


# -- dense encoding for the solver ----------------------------------------

# Per-axis scale factors chosen so realistic quantities become integers that
# float32 represents exactly (mantissa 2^24): cpu in milli-cores, memory and
# ephemeral storage in Mi, counts as-is, extended resources in milli. The
# solver's granularity contract: quantities milli-cpu / Mi-memory granular
# compare exactly; sub-Mi memory differences are quantized on device.
AXIS_SCALES = {
    CPU: 1000.0,
    MEMORY: 1.0 / (2.0**20),
    PODS: 1.0,
    EPHEMERAL_STORAGE: 1.0 / (2.0**20),
}
_DEFAULT_SCALE = 1000.0


def axis_scales(extra_axes: Sequence[str] = ()) -> np.ndarray:
    scales = [AXIS_SCALES.get(name, _DEFAULT_SCALE) for name in RESOURCE_AXES]
    scales += [_DEFAULT_SCALE] * len(extra_axes)
    return np.array(scales, dtype=np.float64)


def to_scaled_vector(rl: Mapping[str, float], extra_axes: Sequence[str] = ()) -> np.ndarray:
    """Encode for device arithmetic: scaled per AXIS_SCALES and rounded to
    integers so float32 sums and compares stay exact."""
    vec = to_vector(rl, extra_axes).astype(np.float64) * axis_scales(extra_axes)
    return np.rint(vec).astype(np.float32)


def to_vector(rl: Mapping[str, float], extra_axes: Sequence[str] = ()) -> np.ndarray:
    """Encode a ResourceList as a float32 vector in RESOURCE_AXES order,
    optionally extended with per-solve extra resource names.

    Unknown resource names without a reserved or extra axis raise, so a solve
    can never silently drop a constraint dimension.
    """
    n = NUM_RESOURCE_AXES + len(extra_axes)
    vec = np.zeros((n,), dtype=np.float32)
    extra_index = {name: NUM_RESOURCE_AXES + i for i, name in enumerate(extra_axes)}
    for name, qty in rl.items():
        if name in AXIS_INDEX:
            vec[AXIS_INDEX[name]] = qty
        elif name in extra_index:
            vec[extra_index[name]] = qty
        else:
            raise KeyError(f"resource {name!r} has no encoding axis")
    return vec


def collect_extra_axes(lists: Iterable[Mapping[str, float]]) -> List[str]:
    """Discover resource names outside the reserved axes, in sorted order, so
    a solve's vector layout is deterministic."""
    extras = set()
    for rl in lists:
        for name in rl:
            if name not in AXIS_INDEX:
                extras.add(name)
    return sorted(extras)
