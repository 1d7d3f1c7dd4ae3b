"""Bounded in-memory trace storage + the trace analysis helpers.

The exporter is a ring: the newest ``capacity`` root span TREES are held,
older ones are dropped (counted — ``karpenter_trace_dropped_total`` —
because a silently-shrinking window reads as "nothing slow happened").
``GET /debug/traces`` on either health server serves :meth:`snapshot`;
:meth:`dump_jsonl` writes the same trees as JSON lines for offline tools.

The two pure functions at the bottom are the measurement surface:
``critical_path`` walks the slowest chain of a tree attributing SELF time
per leg, and ``overlapping_pairs`` counts cross-trace interval overlaps —
the "encode(i+1) overlaps solve(i)" pipeline claim as a checked invariant
instead of a smoke test.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.obs.trace import Span


def _count_spans(span: Span) -> int:
    return 1 + sum(_count_spans(c) for c in span.children)


class RingExporter:
    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._trees: "deque[Span]" = deque()  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.exported_spans = 0  # guarded-by: self._lock
        self.dropped_spans = 0  # guarded-by: self._lock
        self.held_spans = 0  # guarded-by: self._lock

    def export(self, root: Span) -> None:
        n = _count_spans(root)
        dropped = 0
        with self._lock:
            self.exported_spans += n
            while len(self._trees) >= self.capacity:
                dropped += _count_spans(self._trees.popleft())
            self.dropped_spans += dropped
            self._trees.append(root)
            self.held_spans += n - dropped
            held_trees, held_spans = len(self._trees), self.held_spans
        try:
            from karpenter_tpu_torch import metrics

            metrics.TRACE_SPANS.inc(n)
            if dropped:
                metrics.TRACE_DROPPED.inc(dropped)
            metrics.TRACE_RING_TREES.set(held_trees)
            metrics.TRACE_RING_SPANS.set(held_spans)
        except Exception:
            pass  # the sidecar's trimmed images may lack the registry

    def stats(self) -> Dict[str, Any]:
        """Per-process exporter residency — the /debug/traces sidebar and
        the source of the `karpenter_trace_ring_*` gauges."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "trees": len(self._trees),
                "spans": self.held_spans,
                "exported_spans": self.exported_spans,
                "dropped_spans": self.dropped_spans,
            }

    def snapshot(
        self,
        limit: Optional[int] = 50,
        newest_first: bool = True,
        name: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """JSON-ready trees; newest first by default (the /debug surface).
        ``name`` keeps only trees CONTAINING a span so named (the
        ``?name=`` query filter — one trace family, not the whole ring);
        ``trace_id`` is the exact lookup (every span in a tree shares its
        root's trace id, so this is a root-field test, not a walk);
        ``limit`` applies after the filters, so it bounds what the
        operator asked for."""
        with self._lock:
            trees = list(self._trees)
        if newest_first:
            trees.reverse()
        if trace_id is not None:
            trees = [t for t in trees if t.trace_id == trace_id]
        if name is None:
            # no filter: slice BEFORE serializing — a full 256-tree ring
            # must not pay 256 deep to_dict()s to answer a limit-50 request
            if limit is not None:
                trees = trees[:limit]
            return [t.to_dict() for t in trees]
        dicts: List[Dict[str, Any]] = []
        for t in trees:
            d = t.to_dict()
            if spans_named(d, name):
                dicts.append(d)
                if limit is not None and len(dicts) >= limit:
                    break
        return dicts

    def trees(self) -> List[Dict[str, Any]]:
        """All held trees, oldest first — a caller correlates tree index to
        iteration index (single-threaded legs export in call order)."""
        return self.snapshot(limit=None, newest_first=False)

    def clear(self) -> None:
        with self._lock:
            self._trees.clear()
            self.held_spans = 0
        try:
            from karpenter_tpu_torch import metrics

            metrics.TRACE_RING_TREES.set(0)
            metrics.TRACE_RING_SPANS.set(0)
        except Exception:
            pass

    def dump_jsonl(self, path: str) -> int:
        """Write every held tree as one JSON line each; returns the count."""
        trees = self.snapshot(limit=None, newest_first=False)
        with open(path, "w", encoding="utf-8") as f:
            for t in trees:
                f.write(json.dumps(t) + "\n")
        return len(trees)


# -- analysis ----------------------------------------------------------------


def critical_path(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Self-time attribution down the slowest-child chain of a span tree
    (already in dict form). Each step reports the leg's total duration and
    its SELF time (duration minus its children's) — where the milliseconds
    actually live, not just which subtree contains them."""
    out: List[Dict[str, Any]] = []
    node = tree
    while node is not None:
        children = node.get("children") or []
        child_total = sum(c.get("duration_ms", 0.0) for c in children)
        out.append({
            "name": node.get("name"),
            "duration_ms": round(node.get("duration_ms", 0.0), 3),
            "self_ms": round(max(node.get("duration_ms", 0.0) - child_total, 0.0), 3),
        })
        node = max(children, key=lambda c: c.get("duration_ms", 0.0)) if children else None
    return out


def spans_named(tree: Dict[str, Any], name: str) -> List[Dict[str, Any]]:
    """Every span dict named ``name`` anywhere under ``tree`` (inclusive) —
    the one tree walk, shared by the overlap counter and the
    fetch-duration checks."""
    out = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if node.get("name") == name:
            out.append(node)
        stack.extend(node.get("children") or [])
    return out


def overlapping_pairs(
    trees: List[Dict[str, Any]],
    a_name: str = "solve.encode",
    b_name: str = "solve.pack_fetch",
) -> int:
    """Count (a, b) span pairs from DIFFERENT traces whose perf_counter
    intervals overlap — only meaningful for trees captured in one process
    (t0/t1 share a clock). A pipelined run asserts this is nonzero:
    some batch's encode really did run while another solve's fetch was in
    flight."""
    a_spans = []
    b_spans = []
    for t in trees:
        tid = t.get("trace_id")
        a_spans.extend((tid, s["t0"], s["t1"]) for s in spans_named(t, a_name))
        b_spans.extend((tid, s["t0"], s["t1"]) for s in spans_named(t, b_name))
    pairs = 0
    for a_tid, a0, a1 in a_spans:
        for b_tid, b0, b1 in b_spans:
            if a_tid != b_tid and a0 < b1 and b0 < a1:
                pairs += 1
    return pairs
