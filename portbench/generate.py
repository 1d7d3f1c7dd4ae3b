"""The one traffic generator: plain pod and catalog records from a seed.

A configuration (``configs/<name>.json``) names its catalog
(``catalog.kind``, with the rest of ``catalog`` as the catalog's spec) and
its pod mix (``pods.mix`` and ``pods.count``); a traffic mix
(``traffic/<name>.json``) says how rounds follow each other. Each catalog
kind is a file ``catalogs/<kind>.py`` with ``records(spec)`` and
``small(spec)`` (the spec the CPU tests run), each pod mix a file
``mixes/<mix>.py`` with ``records(count, rng)``, found by name on
``SEARCH`` as the harness finds a metric's reader. Each imports only
the standard library. Records are plain dicts, so the reference
(``reference/``) and the adapter to the program (``adapter.py``) read the
same inputs.

A pod record: ``kind`` (a topology kind of ``MIX7_KINDS`` other than
``generic``, or any other name for a pod without one), ``labels``,
``cpu_m`` (millicores), ``mem_mi`` (MiB) and ``sel`` (the label value a
term or a spread selects, or None); and, for a pod with node requirements,
either or both of ``node_selector`` (``{label: value}``) and
``node_affinity`` (``[[key, "In" | "NotIn", [values]], ...]``, one
required term), over the zone, capacity type, arch, OS and instance type.

A catalog record: ``name``, ``res`` and ``overhead`` (millicores, bytes,
pods), ``price``, ``offerings`` (``(capacity type, zone)`` pairs),
``arch`` and ``os`` (a set).

Random streams are seeded with strings (``random.Random`` hashes a string
seed with SHA-512), so any whole number works as ``--seed`` and the draws do
not depend on the interpreter's hash seed.
"""

from __future__ import annotations

import importlib.util
import random
import sys
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
# the directories searched, in order, for catalogs/<kind>.py and mixes/<mix>.py
SEARCH: List[Path] = [HERE]
# a fresh round draws each position from one of this many batches
POOL_BATCHES = 4

_loaded: Dict[Path, object] = {}


def module(kind: str, name: str):
    """``<kind>/<name>.py`` (``kind`` is ``catalogs`` or ``mixes``), the
    first found on ``SEARCH``, loaded once under a name of its own."""
    tried = [root / kind / f"{name}.py" for root in SEARCH]
    for path in tried:
        if path in _loaded:
            return _loaded[path]
        if path.is_file():
            key = f"portbench_{kind}_{name}"
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
            _loaded[path] = mod
            return mod
    raise ValueError(f"no {kind}/{name}.py: looked for {', '.join(map(str, tried))}")


def stream(seed: int, name: str, index: int = 0) -> random.Random:
    return random.Random(f"portbench:{seed}:{name}:{index}")


def catalog(spec: Dict) -> List[Dict]:
    """The catalog records of ``spec`` (a configuration's ``catalog``)."""
    return module("catalogs", spec["kind"]).records(spec)


def pods(config: Dict, count: int, rng: random.Random) -> List[Dict]:
    """``count`` pod records of the configuration's mix."""
    return module("mixes", config["pods"]["mix"]).records(count, rng)


# the names the built-in catalog and mix had here before they moved to
# files of their own
_linear, _mix7 = module("catalogs", "linear"), module("mixes", "mix7")
MI, GI = _linear.MI, _linear.GI
OVERHEAD, OFFERINGS, OPERATING_SYSTEMS = _linear.OVERHEAD, _linear.OFFERINGS, _linear.OPERATING_SYSTEMS
LABEL_VALUES, MEM_MI, CPU_M, MIX7_KINDS = _mix7.LABEL_VALUES, _mix7.MEM_MI, _mix7.CPU_M, _mix7.MIX7_KINDS
mix7 = _mix7.records


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
