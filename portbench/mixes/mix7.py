"""The upstream benchmark's pod mix (``scheduling_benchmark_test.go:159-216``):
a seventh each of generic, zone spread, hostname spread, hostname and zone
pod affinity, hostname and zone anti-affinity; the remainder generic."""

from __future__ import annotations

import random
from typing import Dict, List

# the upstream benchmark's pools
LABEL_VALUES = ["a", "b", "c", "d", "e", "f", "g"]
MEM_MI = [100, 256, 512, 1024, 2048, 4096]
CPU_M = [100, 250, 500, 1000, 1500]

MIX7_KINDS = (
    "generic", "zone_spread", "host_spread",
    "aff_host", "aff_zone", "anti_host", "anti_zone",
)


def _record(kind):
    return {"kind": kind, "labels": {}, "cpu_m": None, "mem_mi": 0, "sel": None}


def records(count: int, rng: random.Random) -> List[Dict]:
    """The draws follow the upstream generator's order: own label, cpu,
    memory, then the term's selector (a spread selects the pod's own
    label)."""
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
