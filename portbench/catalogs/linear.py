"""The upstream fake catalog (``fake/instancetype.go:117-130``): type i has
i + 1 cpus, 2 (i + 1) GiB and 10 (i + 1) pods, with integer resources
(millicores, bytes, pods) and the upstream fake price: 0.1 a cpu plus 0.1 a
GB of memory.

Spec: ``{"kind": "linear", "types": <n>}``.
"""

from __future__ import annotations

from typing import Dict, List

MI = 2 ** 20
GI = 2 ** 30
# the fake catalog's defaults (fake/instancetype.go:32-76): 100m cpu and
# 10Mi memory reserved; spot in zones 1-2, on-demand in zones 1-3
OVERHEAD = (100, 10 * MI, 0)
OFFERINGS = (
    ("spot", "test-zone-1"), ("spot", "test-zone-2"),
    ("on-demand", "test-zone-1"), ("on-demand", "test-zone-2"), ("on-demand", "test-zone-3"),
)
OPERATING_SYSTEMS = ("darwin", "linux", "windows")


def records(spec: Dict) -> List[Dict]:
    out = []
    for i in range(spec["types"]):
        cpu, mem_gi, n_pods = i + 1, (i + 1) * 2, (i + 1) * 10
        out.append({
            "name": f"fake-it-{i}",
            "res": (cpu * 1000, mem_gi * GI, n_pods),
            "price": 0.1 * float(cpu) + 0.1 * float(mem_gi * GI) / 1e9,
            "overhead": OVERHEAD,
            "offerings": OFFERINGS,
            "arch": "amd64",
            "os": frozenset(OPERATING_SYSTEMS),
        })
    return out


def small(spec: Dict) -> Dict:
    """The spec the CPU tests run: 50 types."""
    return dict(spec, types=50)
