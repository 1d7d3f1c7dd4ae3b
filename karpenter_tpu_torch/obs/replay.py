"""Replay a persisted decision record through the native packer, offline.

The port's copy of ``tools/replay_decision.py``. The canary re-solves a
SAMPLED live pack and quarantines on disagreement; this is its forensic
twin for the decision audit log: a record persisted into ``--decision-dir`` carries the
exact kernel tensors (``EncodedBatch.pack_args`` order) plus the served
assignment and node-table size, so any decision can be re-solved on the
native C++ packer long after the fact — on a laptop, from a support
bundle — and diffed bit-exact against what production actually did.

Usage::

    python -m tools.replay_decision <record.json>           # one file
    python -m tools.replay_decision --decision-dir DIR      # newest replayable
    python -m tools.replay_decision --decision-dir DIR --id d-abc123...

Exit codes: 0 = assignment reproduced bit-exact, 1 = divergence (prints
the first difference — the smoking gun), 2 = record unusable (no replay
blob: memory-only rounds and FFD-degraded rounds don't carry tensors).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np


def load_record(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find_record(
    directory: str, record_id: Optional[str] = None
) -> Optional[str]:
    """Newest replayable record in the ring (lexicographic filename IS
    recency order — the flight-recorder discipline), or the one matching
    ``record_id``."""
    try:
        names = sorted(
            (
                n for n in os.listdir(directory)
                if n.startswith("decision-") and n.endswith(".json")
            ),
            reverse=True,
        )
    except OSError:
        return None
    for name in names:
        path = os.path.join(directory, name)
        try:
            rec = load_record(path)
        except (OSError, json.JSONDecodeError):
            continue
        if record_id is not None and rec.get("id") != record_id:
            continue
        if record_id is not None or "replay_file" in rec:
            return path
    return None


def replay(record: Dict[str, Any], record_path: str = "") -> Dict[str, Any]:
    """Re-solve the record's tensors on the native packer and diff.

    Returns ``{"ok": bool, "diff": str|None, ...}``; raises ValueError
    when the record has no replay sidecar."""
    from karpenter_tpu_torch.obs.decisions import PACK_ARG_NAMES
    from karpenter_tpu_torch.solver import native

    replay_file = record.get("replay_file")
    if not replay_file:
        raise ValueError(
            "record has no replay sidecar (memory-only or FFD-degraded round)"
        )
    npz_path = os.path.join(os.path.dirname(record_path) or ".", replay_file)
    blob = np.load(npz_path, allow_pickle=False)
    if not native.native_available(wait=180.0):
        raise RuntimeError("native packer unavailable (g++ build failed?)")

    def arg(name: str) -> np.ndarray:
        if name == "pod_req" and "pod_req" not in blob:
            # compact transfer form: re-gather the dense request matrix
            # from the unique vectors + per-pod ids (bit-identical to the
            # encode-side gather)
            return blob["uniq_req"][blob["pod_req_id"]]
        return blob[name]

    args = [arg(n) for n in PACK_ARG_NAMES]
    n_max = int(blob["n_max"])
    n_pods = int(blob["n_pods"])
    result = native.pack_native(*args, n_max=n_max)
    fresh = np.asarray(result.assignment)[:n_pods]
    out: Dict[str, Any] = {
        "decision_id": record.get("id"),
        "route": record.get("route"),
        "n_pods": n_pods,
        "n_max": n_max,
        "replay_nodes": int(result.n_nodes),
        "replay_unschedulable": int((fresh < 0).sum()),
    }
    if "assignment" not in blob:
        out["ok"] = None
        out["diff"] = "record carries no served assignment to diff against"
        return out
    served = np.asarray(blob["assignment"]).reshape(-1)[:n_pods]
    if np.array_equal(served, fresh):
        out["ok"] = True
        out["diff"] = None
        return out
    idx = np.flatnonzero(served != fresh)
    pod_keys: List[str] = record.get("pod_keys") or []
    first = int(idx[0])
    out["ok"] = False
    out["diverged_pods"] = int(len(idx))
    out["diff"] = (
        f"assignment differs for {len(idx)} pod(s); first: "
        f"{pod_keys[first] if first < len(pod_keys) else f'index {first}'} "
        f"served node {int(served[first])} vs replay {int(fresh[first])}"
    )
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="replay_decision",
        description="re-solve a persisted decision record on the native "
        "packer and diff the assignment bit-exact",
    )
    ap.add_argument("record", nargs="?", help="path to a decision-*.json")
    ap.add_argument("--decision-dir", default="",
                    help="ring directory; picks the newest replayable "
                    "record (or --id)")
    ap.add_argument("--id", default=None, help="decision id to replay")
    args = ap.parse_args(argv)

    path = args.record
    if not path and args.decision_dir:
        path = find_record(args.decision_dir, record_id=args.id)
    if not path:
        print("replay_decision: no record found", file=sys.stderr)
        return 2
    try:
        record = load_record(path)
        verdict = replay(record, record_path=path)
    except (ValueError, RuntimeError, OSError, json.JSONDecodeError) as e:
        print(f"replay_decision: {path}: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"record": path, **verdict}))
    if verdict["ok"] is None:
        return 2  # nothing to diff against — not a pass, not a finding
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
