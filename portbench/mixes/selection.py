"""The pods of the upstream price-optimality suite
(``scheduling/instance_selection_test.go:37-70``, the cheapest-instance
cases): generic pods, each pinned by its own node requirements to an
architecture, an OS, a zone or a capacity type, in the pod-side forms the
suite's cases take, in equal shares drawn per pod. A pinned pod carries
its form as a ``nodeSelector`` or as one required node-affinity term of
``In`` expressions, with equal odds. Cpu and memory come from the
upstream benchmark's pools (``mixes/mix7.py``), and each pod has the
benchmark's ``my-label``.

Every form names values of the assorted catalog, so no pod is
unschedulable. The closure of the forms' cores under joining is at most
3 zones (unset, test-zone-1, test-zone-2) x 2 capacity types (unset,
spot) x 3 arches x 3 OSes (unset or one of two) = 54 signatures.
"""

from __future__ import annotations

import random
from typing import Dict, List

ZONE = "topology.kubernetes.io/zone"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"

# the upstream benchmark's pools, as mixes/mix7.py has them
LABEL_VALUES = ["a", "b", "c", "d", "e", "f", "g"]
MEM_MI = [100, 256, 512, 1024, 2048, 4096]
CPU_M = [100, 250, 500, 1000, 1500]

FORMS = (
    {},
    {ARCH: "amd64"},
    {ARCH: "arm64"},
    {OS: "windows"},
    {OS: "linux"},
    {ZONE: "test-zone-2"},
    {CAPACITY_TYPE: "spot"},
    {CAPACITY_TYPE: "spot", ZONE: "test-zone-1"},
    {CAPACITY_TYPE: "spot", ZONE: "test-zone-2", ARCH: "amd64", OS: "linux"},
)


def records(count: int, rng: random.Random) -> List[Dict]:
    """The draws per pod: own label, cpu, memory, the form, then (for a
    pinned pod) selector or affinity."""
    out: List[Dict] = []
    for _ in range(count):
        rec = {"kind": "generic", "labels": {"my-label": rng.choice(LABEL_VALUES)},
               "cpu_m": rng.choice(CPU_M), "mem_mi": rng.choice(MEM_MI), "sel": None}
        form = rng.choice(FORMS)
        if form:
            if rng.random() < 0.5:
                rec["node_selector"] = dict(form)
            else:
                rec["node_affinity"] = [[key, "In", [value]] for key, value in form.items()]
        out.append(rec)
    return out
