"""The one traffic generator: plain pod records from a seed.

A configuration (``configs/<name>.json``) says which pods a round holds
(``pods.mix`` and ``pods.count``); a traffic mix (``traffic/<name>.json``)
says how rounds follow each other. Both are data; this module is the only
code that reads them. Records are plain dicts, so the reference
(``reference/``) and the adapter to the program (``adapter.py``) read the
same inputs.

A record: ``kind`` (one of ``MIX7_KINDS``), ``labels``, ``cpu_m``
(millicores), ``mem_mi`` (MiB) and ``sel`` (the label value a term or a
spread selects, or None).

Random streams are seeded with strings (``random.Random`` hashes a string
seed with SHA-512), so any whole number works as ``--seed`` and the draws do
not depend on the interpreter's hash seed.
"""

from __future__ import annotations

import random
from typing import Dict, List

# the upstream benchmark's pools (scheduling_benchmark_test.go:159-216)
LABEL_VALUES = ["a", "b", "c", "d", "e", "f", "g"]
MEM_MI = [100, 256, 512, 1024, 2048, 4096]
CPU_M = [100, 250, 500, 1000, 1500]

MIX7_KINDS = (
    "generic", "zone_spread", "host_spread",
    "aff_host", "aff_zone", "anti_host", "anti_zone",
)


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
# a fresh round draws each position from one of this many batches
POOL_BATCHES = 4


def stream(seed: int, name: str, index: int = 0) -> random.Random:
    return random.Random(f"portbench:{seed}:{name}:{index}")


def _record(kind):
    return {"kind": kind, "labels": {}, "cpu_m": None, "mem_mi": 0, "sel": None}


def mix7(count: int, rng: random.Random) -> List[Dict]:
    """The upstream benchmark's pod mix: a seventh each of generic, zone
    spread, hostname spread, hostname and zone pod affinity, hostname and
    zone anti-affinity; the remainder generic. The draws follow the
    upstream generator's order: own label, cpu, memory, then the term's
    selector (a spread selects the pod's own label)."""
    def labels():
        return {"my-label": rng.choice(LABEL_VALUES)}

    def sized(rec):
        rec["cpu_m"] = rng.choice(CPU_M)
        rec["mem_mi"] = rng.choice(MEM_MI)
        return rec

    out: List[Dict] = []
    seventh = count // 7
    for _ in range(seventh):
        rec = _record("generic")
        rec["labels"] = labels()
        out.append(sized(rec))
    for kind in ("zone_spread", "host_spread"):
        for _ in range(seventh):
            rec = _record(kind)
            rec["labels"] = labels()
            rec["sel"] = rec["labels"]["my-label"]
            out.append(sized(rec))
    for kind in ("aff_host", "aff_zone", "anti_host", "anti_zone"):
        for _ in range(seventh):
            rec = _record(kind)
            rec["labels"] = labels()
            sized(rec)
            rec["sel"] = rng.choice(LABEL_VALUES)
            out.append(rec)
    while len(out) < count:
        rec = _record("generic")
        rec["labels"] = labels()
        out.append(sized(rec))
    return out


def catalog(spec: Dict) -> List[Dict]:
    """The upstream fake catalog (``fake/instancetype.go:117-130``): type i
    has i + 1 cpus, 2 (i + 1) GiB and 10 (i + 1) pods, with integer
    resources (millicores, bytes, pods) and the upstream fake price: 0.1 a
    cpu plus 0.1 a GB of memory."""
    if spec["kind"] != "linear":
        raise ValueError(f"unknown catalog kind {spec['kind']!r}")
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


def pods(config: Dict, count: int, rng: random.Random) -> List[Dict]:
    spec = config["pods"]
    if spec["mix"] == "mix7":
        return mix7(count, rng)
    raise ValueError(f"unknown pod mix {spec['mix']!r}")


class Fresh:
    """Every round hands ``pods.count`` pods no earlier round held. Set-up
    draws a pool of ``POOL_BATCHES`` batches of the configuration's mix; round
    ``r`` takes position ``i`` of its batch from one of them, chosen by the
    seeded stream ``pick:r``, so every round holds the mix's kinds at the
    same positions and in the same numbers, and no two rounds hold the
    same set of records. Record ``b * count + i`` is position ``i`` of
    batch ``b``."""

    def __init__(self, config: Dict, seed: int):
        self.seed = seed
        self.count = config["pods"]["count"]
        self.records: List[Dict] = []
        for b in range(POOL_BATCHES):
            self.records.extend(pods(config, self.count, stream(seed, "fresh", b)))
        self.round = 0

    def next(self) -> List[int]:
        """The record numbers of the next round's batch, in the order the
        round hands them over."""
        rng = stream(self.seed, "pick", self.round)
        self.round += 1
        n = self.count
        return [rng.randrange(POOL_BATCHES) * n + i for i in range(n)]


def traffic(config: Dict, traffic_spec: Dict, seed: int) -> Fresh:
    if traffic_spec["kind"] == "fresh":
        return Fresh(config, seed)
    raise ValueError(f"unknown traffic kind {traffic_spec['kind']!r}")
