"""The upstream assorted catalog (``fake/instancetype.go:79-110``,
``fake.InstanceTypesAssorted()``): the full cross product of the spec's cpu
and memory sizes with 3 zones, 2 capacity types, 2 operating systems and 2
architectures, in the generator's own loop order (cpu, memory, zone,
capacity type, OS, arch), unshuffled. Each type has one offering, one OS
and one arch; the fake's defaults hold: 5 pods a type, 100m cpu and 10Mi
memory reserved, and the fake price, 0.1 a cpu plus 0.1 a GB of memory.
Resources are integers (millicores, bytes, pods).

Spec: ``{"kind": "assorted", "cpus": [...], "mem_gi": [...]}``; the
upstream catalog is cpus 1-64 and 1-128 GiB in powers of two, 1,344 types.
"""

from __future__ import annotations

from typing import Dict, List

MI = 2 ** 20
GI = 2 ** 30
ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")
CAPACITY_TYPES = ("spot", "on-demand")
OPERATING_SYSTEMS = ("linux", "windows")
ARCHITECTURES = ("amd64", "arm64")
PODS = 5
OVERHEAD = (100, 10 * MI, 0)


def records(spec: Dict) -> List[Dict]:
    out = []
    for cpu in spec["cpus"]:
        for mem_gi in spec["mem_gi"]:
            for zone in ZONES:
                for ct in CAPACITY_TYPES:
                    for os_ in OPERATING_SYSTEMS:
                        for arch in ARCHITECTURES:
                            out.append({
                                "name": f"{cpu}-cpu-{mem_gi}-mem-{arch}-{os_}-{zone}-{ct}",
                                "res": (cpu * 1000, mem_gi * GI, PODS),
                                "price": 0.1 * float(cpu) + 0.1 * float(mem_gi * GI) / 1e9,
                                "overhead": OVERHEAD,
                                "offerings": ((ct, zone),),
                                "arch": arch,
                                "os": frozenset({os_}),
                            })
    return out


def small(spec: Dict) -> Dict:
    """The spec the CPU tests run: 3 cpu sizes by 4 memory sizes, 288 types
    (the mix's largest pod, 1.5 cpus and 4 GiB, still fits the largest)."""
    return dict(spec, cpus=[1, 2, 4], mem_gi=[1, 2, 4, 8])
