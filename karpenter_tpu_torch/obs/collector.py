"""Fleet telemetry plane: cross-process collection, trace stitching, and
fleet-aggregated SLOs.

The ring exporter, the SLO engine and the flight recorder are each a
per-process island: the sidecar's real ``sidecar.pack``
spans live in the sidecar's OWN ring and reach the controller only as
grafted timing records, and no endpoint anywhere can answer "where did
this solve's 160ms go, fleet-wide". This module is the missing plane,
three pieces:

- **Flush**: every process (controller replicas AND sidecars) periodically
  publishes a member payload — completed span trees, the SLO engine's
  mergeable histogram snapshot (``SloEngine.histogram_snapshot``), and the
  profiler's fold summary — to a shared backend. The file backend is a
  flock'd per-member dir with atomic tmp+rename (the launch-journal
  discipline: each member owns ONE file, so a crashed writer can never
  corrupt a peer's); the HTTP backend instead PULLS members' existing
  ``/debug/traces`` + ``/debug/slo`` + ``/debug/profile`` endpoints, so a
  deployment with no shared volume still aggregates.

- **Stitch**: a sidecar's ``sidecar.pack`` tree is a local ROOT carrying
  the controller's trace id and the dispatch-time span id as its
  ``parent_id`` (the traceparent the v3 wire already carries).
  :func:`stitch` re-joins those roots into their controller trees —
  preferring the ``solver.wire`` transport span that wall-overlaps the
  sidecar's work, whose grafted ``sidecar.*`` stage RECORDS it replaces
  with the real subtree — and REBASES the foreign perf_counter timeline
  into the parent's (clocks never agree across processes; wall stamps on
  the same machine do). The result is ONE fleet-wide tree whose
  ``critical_path`` splits wire vs sidecar admission-queue vs device time.

- **Aggregate**: the SLO engine's log-linear histograms are mergeable by
  construction (fixed GROWTH bucket geometry), so member SLO windows merge
  bucket-by-bucket into fleet-wide quantiles and burn rates, judged by the
  same objective grammar. ``GET /debug/fleet`` serves the member inventory
  (with staleness), the fleet SLO verdicts, and the stitched-trace index.
"""

from __future__ import annotations

import contextlib
import copy
import fcntl
import glob
import json
import logging
import math
import os
import re
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.obs.slo import Histogram, Objective, MIN_WINDOW_EVENTS

logger = logging.getLogger("karpenter.obs")

PAYLOAD_VERSION = 1
# how many of the newest ring trees a flush ships; the collector keeps only
# each member's latest payload, so this bounds the fleet-wide working set
FLUSH_TREE_LIMIT = 64
DEFAULT_FLUSH_INTERVAL_S = 10.0
# a member is STALE once its last flush is older than this many intervals —
# crashed, partitioned, or wedged; its data still shows, flagged
STALE_INTERVALS = 3.0
# wall-clock slack when matching a sidecar tree to its wire span: same-host
# clocks agree to well under this; cross-host NTP skew gets the benefit of
# the doubt (a miss degrades to the anchor span, never a wrong trace)
WALL_SLACK_S = 0.25

# the transport spans a foreign sidecar.pack tree prefers as its parent,
# and the wire-trailer stage RECORDS the real subtree replaces
WIRE_PARENT_NAMES = ("solver.wire",)
GRAFT_RECORD_NAMES = ("sidecar.solve", "sidecar.fetch", "sidecar.serialize")

_SAFE_IDENT = re.compile(r"[^A-Za-z0-9_.-]")


def _walk(tree: Dict[str, Any]):
    stack = [tree]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.get("children") or [])


# ---------------------------------------------------------------------------
# stitching
# ---------------------------------------------------------------------------


def _wall_interval(span: Dict[str, Any]) -> Tuple[float, float]:
    w0 = float(span.get("wall_start") or 0.0)
    return w0, w0 + float(span.get("duration_ms") or 0.0) / 1e3


def _wall_overlaps(a: Dict[str, Any], b: Dict[str, Any], slack: float) -> bool:
    a0, a1 = _wall_interval(a)
    b0, b1 = _wall_interval(b)
    return a0 - slack < b1 and b0 - slack < a1


def _rebase(root: Dict[str, Any], parent: Dict[str, Any]) -> None:
    """Shift a foreign subtree's perf_counter stamps into the parent's
    timeline (positioned by the wall clocks both processes share), then
    clamp every span inside the parent's bounds — the stitched tree must
    stay monotonic-consistent for critical_path/overlap analysis even
    under wall skew. ``duration_ms`` keeps the MEASURED value."""
    p0 = float(parent.get("t0") or 0.0)
    p1 = float(parent.get("t1") or p0)
    dur = max(float(root.get("t1") or 0.0) - float(root.get("t0") or 0.0), 0.0)
    offset = (float(root.get("wall_start") or 0.0)
              - float(parent.get("wall_start") or 0.0))
    new_t0 = p0 + max(offset, 0.0)
    # keep the subtree inside the parent: a child reported longer than its
    # parent (clock skew) pins to the parent's bounds
    new_t0 = min(max(new_t0, p0), max(p1 - dur, p0))
    shift = new_t0 - float(root.get("t0") or 0.0)
    for node in _walk(root):
        node["t0"] = min(max(float(node.get("t0") or 0.0) + shift, p0), p1)
        node["t1"] = min(max(float(node.get("t1") or 0.0) + shift, p0), p1)


def stitch(
    trees: Sequence[Dict[str, Any]],
    wall_slack_s: float = WALL_SLACK_S,
) -> Tuple[List[Dict[str, Any]], int]:
    """Join foreign-rooted span trees into the trees holding their parent
    spans. Returns ``(roots, joins)``: the surviving root trees (joined
    subtrees removed from the top level) and how many joins happened.

    A foreign root is any tree whose root carries a ``parent_id`` (a
    remote-parented local root — the sidecar's ``sidecar.pack``, the cloud
    wire's ``cloudapi.request``). Its anchor is the span with that id in
    another tree of the SAME trace. ``sidecar.pack`` roots prefer a
    ``solver.wire`` span of the trace that wall-overlaps them — that is
    the RPC they rode — and replace its grafted ``sidecar.*`` stage
    records (childless, wire-trailer provenance) with the real subtree so
    nothing double-counts. Inputs are never mutated."""
    trees = [copy.deepcopy(t) for t in trees]
    index: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for t in trees:
        for s in _walk(t):
            sid = s.get("span_id")
            if sid:
                # first writer wins: a span id duplicated across payload
                # generations keeps ONE anchor
                index.setdefault((t.get("trace_id"), sid), s)
    joins = 0
    attached: List[int] = []
    pending = [t for t in trees if t.get("parent_id")]
    pending.sort(key=lambda t: float(t.get("wall_start") or 0.0))
    for root in pending:
        trace_id = root.get("trace_id")
        anchor = index.get((trace_id, root.get("parent_id")))
        if anchor is None or anchor is root:
            continue  # the other half never flushed (yet): stays a root
        if any(s is anchor for s in _walk(root)):
            continue  # cycle guard: never attach a tree into itself
        parent = anchor
        if root.get("name") == "sidecar.pack":
            candidates = [
                s for (tid, _), s in index.items()
                if tid == trace_id
                and s.get("name") in WIRE_PARENT_NAMES
                and not any(x is s for x in _walk(root))
                and _wall_overlaps(s, root, wall_slack_s)
            ]
            if candidates:
                parent = min(
                    candidates,
                    key=lambda s: abs(
                        float(s.get("wall_start") or 0.0)
                        - float(root.get("wall_start") or 0.0)
                    ),
                )
                parent["children"] = [
                    c for c in (parent.get("children") or [])
                    if not (
                        c.get("name") in GRAFT_RECORD_NAMES
                        and not c.get("children")
                    )
                ]
        _rebase(root, parent)
        root["stitched"] = True
        parent.setdefault("children", []).append(root)
        attached.append(id(root))
        joins += 1
    roots = [t for t in trees if id(t) not in attached]
    return roots, joins


def wire_attribution(tree: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Split the slowest ``solver.wire`` leg of a (stitched) tree into
    wire transport vs sidecar admission-queue vs device time — the
    attribution a transport change needs before anyone touches the hot
    path. ``None`` when the tree never crossed the wire."""
    wires = [s for s in _walk(tree) if s.get("name") in WIRE_PARENT_NAMES]
    if not wires:
        return None
    wire = max(wires, key=lambda s: float(s.get("duration_ms") or 0.0))
    total_ms = float(wire.get("duration_ms") or 0.0)
    pack = next(
        (c for c in (wire.get("children") or [])
         if c.get("name") == "sidecar.pack"),
        None,
    )
    if pack is not None:
        # the wire span measures the BLOCKING residual (the double-buffered
        # client dispatches at pack_begin and waits later), so the sidecar's
        # work can wall-precede and even exceed it; the honest RPC envelope
        # is the union of the two intervals
        w0, w1 = _wall_interval(wire)
        p0, p1 = _wall_interval(pack)
        total_ms = max(total_ms, (max(w1, p1) - min(w0, p0)) * 1e3)
    if pack is not None:
        device_ms = sum(
            float(c.get("duration_ms") or 0.0)
            for c in (pack.get("children") or [])
            if c.get("name") in ("sidecar.solve", "sidecar.fetch")
        )
        # the admission gate is entered BEFORE the pack span opens (a
        # backdated child would corrupt self-time), so queue time rides
        # the span as an attribute
        try:
            queue_ms = float(
                (pack.get("attrs") or {}).get("admission_wait_s") or 0.0
            ) * 1e3
        except (TypeError, ValueError):
            queue_ms = 0.0
        sidecar_ms = float(pack.get("duration_ms") or 0.0) + queue_ms
        stitched = bool(pack.get("stitched"))
    else:
        # unstitched: only the wire-trailer grafts to go by
        records = [
            c for c in (wire.get("children") or [])
            if c.get("name") in GRAFT_RECORD_NAMES
        ]
        device_ms = sum(
            float(c.get("duration_ms") or 0.0) for c in records
            if c.get("name") in ("sidecar.solve", "sidecar.fetch")
        )
        queue_ms = 0.0
        sidecar_ms = sum(float(c.get("duration_ms") or 0.0) for c in records)
        stitched = False
    wire_ms = max(total_ms - sidecar_ms, 0.0)
    return {
        "total_ms": round(total_ms, 3),
        "wire_ms": round(wire_ms, 3),
        "sidecar_queue_ms": round(queue_ms, 3),
        "device_ms": round(device_ms, 3),
        "stitched": stitched,
        "wire_share_pct": round(wire_ms / total_ms * 100, 1) if total_ms else None,
    }


# ---------------------------------------------------------------------------
# fleet SLO aggregation
# ---------------------------------------------------------------------------


def _burn_rate(h: Histogram, budget: float) -> float:
    """Merged-window burn rate, same volume guard as the per-process
    engine: a fleet window under MIN_WINDOW_EVENTS never burns."""
    if h.events() < MIN_WINDOW_EVENTS:
        return 0.0
    return (h.bad / h.events()) / budget


def merge_objective_snapshots(
    members: Dict[str, Dict[str, Any]],
) -> Dict[str, Any]:
    """Merge per-member ``SloEngine.histogram_snapshot`` payloads into
    fleet-wide verdicts: per objective name, bucket-add every member's
    fast/slow windows (fixed geometry makes this exact), then re-judge the
    merged sketch with the shared grammar. Objectives present on only some
    members (controller vs sidecar sets) merge over whoever reports them."""
    merged: Dict[str, Dict[str, Any]] = {}
    for identity, snap in members.items():
        for name, obj in (snap.get("objectives") or {}).items():
            slot = merged.setdefault(name, {
                "expr": obj.get("expr"),
                "fast": Histogram(),
                "slow": Histogram(),
                "members": [],
                "breach": None,
            })
            slot["fast"].merge(obj.get("fast") or {})
            slot["slow"].merge(obj.get("slow") or {})
            slot["members"].append(identity)
            if obj.get("breach"):
                slot["breach"] = obj["breach"]
    out: Dict[str, Any] = {}
    for name, slot in merged.items():
        try:
            obj = Objective(slot["expr"])
        except (ValueError, TypeError):
            continue  # a member shipped an expr this build can't parse
        fast: Histogram = slot["fast"]
        slow: Histogram = slot["slow"]
        if obj.kind == "latency":
            value = fast.quantile(obj.quantile) if obj.quantile is not None else fast.mean()
        else:
            value = (fast.good / fast.events()) if fast.events() else None
        burn_fast = _burn_rate(fast, obj.budget)
        burn_slow = _burn_rate(slow, obj.budget)
        out[name] = {
            "expr": obj.expr,
            "kind": obj.kind,
            "threshold": obj.threshold,
            "value": value,
            "ok": obj.evaluate(value),
            "burn_rate": {
                "fast": round(burn_fast, 4), "slow": round(burn_slow, 4),
            },
            "burning": burn_fast >= 1.0 and burn_slow >= 1.0,
            "events": {"fast": fast.events(), "slow": slow.events()},
            "members": sorted(slot["members"]),
            "breach": slot["breach"],
        }
    return out


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class FileTelemetryBackend:
    """Shared-directory backend: each member owns ``member-<identity>.json``
    and replaces it whole with atomic tmp+rename under a directory flock —
    the launch-journal discipline, minus the RMW (one writer per file means
    publish is replace, not read-modify-write; the flock serializes dir
    maintenance and keeps a poll from reading mid-sweep)."""

    def __init__(self, directory: str, identity: Optional[str] = None):
        self.directory = directory
        self.identity = identity or f"{os.uname().nodename}-{os.getpid()}"
        os.makedirs(directory, exist_ok=True)

    @contextlib.contextmanager
    def _locked(self):
        lock_path = os.path.join(self.directory, ".telemetry.flock")
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _member_path(self, identity: str) -> str:
        return os.path.join(
            self.directory, f"member-{_SAFE_IDENT.sub('_', identity)}.json"
        )

    def publish(self, payload: Dict[str, Any]) -> None:
        path = self._member_path(str(payload.get("identity") or self.identity))
        tmp = f"{path}.{os.getpid()}.tmp"
        body = json.dumps(payload)
        with self._locked():
            # sweep temp files a crashed writer left between write & rename
            horizon = time.time() - 60.0
            for stale in glob.glob(os.path.join(glob.escape(self.directory), "*.tmp")):
                try:
                    if os.path.getmtime(stale) < horizon:
                        os.remove(stale)
                except OSError:
                    pass
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(body)
            os.replace(tmp, path)

    def poll(self) -> List[Dict[str, Any]]:
        with self._locked():
            names = sorted(
                glob.glob(os.path.join(glob.escape(self.directory), "member-*.json"))
            )
            out = []
            for name in names:
                try:
                    with open(name, encoding="utf-8") as f:
                        doc = json.load(f)
                    if isinstance(doc, dict):
                        out.append(doc)
                except (OSError, json.JSONDecodeError):
                    continue  # a racer's half-state never poisons the poll
        return out


class HttpTelemetryBackend:
    """Pull mode: scrape members' EXISTING debug endpoints — no shared
    volume needed. Each peer is ``<base url>`` or ``<name>=<base url>``;
    one poll GETs ``/debug/traces`` (+ ``/debug/slo``, ``/debug/profile``,
    best-effort) and assembles the same member payload the file backend
    carries. An unreachable peer contributes nothing this round; the
    collector's staleness accounting surfaces it."""

    def __init__(self, peers: Sequence[str], timeout: float = 2.0):
        self.peers: List[Tuple[str, str]] = []
        for peer in peers:
            peer = peer.strip()
            if not peer:
                continue
            if "=" in peer.split("://", 1)[0]:
                name, _, url = peer.partition("=")
            else:
                name, url = peer, peer
            self.peers.append((name, url.rstrip("/")))
        self.timeout = timeout

    def _get_json(self, url: str) -> Optional[Dict[str, Any]]:
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None

    def poll(self) -> List[Dict[str, Any]]:
        out = []
        for name, url in self.peers:
            traces = self._get_json(f"{url}/debug/traces?limit={FLUSH_TREE_LIMIT}")
            if traces is None:
                continue  # unreachable: staleness accounting shows it
            slo = self._get_json(f"{url}/debug/slo") or {}
            profile = self._get_json(f"{url}/debug/profile") or {}
            decisions = self._get_json(f"{url}/debug/decisions?limit=16") or {}
            incidents = self._get_json(f"{url}/debug/incidents?limit=8") or {}
            out.append({
                "version": PAYLOAD_VERSION,
                "identity": name,
                "role": "scraped",
                "flushed_at": time.time(),
                "traces": traces.get("traces") or [],
                "slo": slo.get("histograms") or {},
                "profile": profile.get("profile") or {},
                "decisions": decisions.get("decisions") or [],
                "incidents": incidents.get("incidents") or [],
            })
        return out


# ---------------------------------------------------------------------------
# the plane: flusher + collector
# ---------------------------------------------------------------------------


def member_payload(identity: str, role: str) -> Dict[str, Any]:
    """This process's flush body: newest ring trees, the SLO engine's
    mergeable histogram snapshot, the profiler's fold summary, and the
    decision audit log's bounded summaries (a dead replica's decisions
    survive it in /debug/fleet through these)."""
    from karpenter_tpu_torch import obs

    eng = obs.slo_engine()
    prof = obs.profiler()
    exp = obs.exporter()
    sent = obs.sentinel()
    return {
        "version": PAYLOAD_VERSION,
        "identity": identity,
        "role": role,
        "flushed_at": time.time(),
        # NEWEST first: the limit slices from the head, so a full ring
        # ships the latest solves, not traffic from 192 solves ago
        "traces": exp.snapshot(limit=FLUSH_TREE_LIMIT, newest_first=True),
        "slo": eng.histogram_snapshot() if eng is not None else {},
        "profile": prof.snapshot(top_n=10) if prof is not None else {},
        "decisions": obs.decision_log().summaries(),
        # bounded sentinel incident summaries: a dead member's regressions
        # stay visible in /debug/fleet as long as its last payload does
        "incidents": (
            sent.incidents.summaries(limit=8) if sent is not None else []
        ),
    }


class TelemetryCollector:
    """Aggregates member payloads from any set of backends; owns the
    stitched-trace cache and the ``/debug/fleet`` body."""

    def __init__(
        self,
        backends: Sequence[Any],
        flush_interval: float = DEFAULT_FLUSH_INTERVAL_S,
        clock: Callable[[], float] = time.time,
        extra_trees: Optional[Callable[[], List[Dict[str, Any]]]] = None,
    ):
        self.backends = list(backends)
        self.flush_interval = flush_interval
        self._clock = clock
        # the collector's OWN process may not flush to any backend (pull
        # deployments): extra_trees contributes its local ring directly
        self._extra_trees = extra_trees
        self._lock = threading.Lock()
        self._members: Dict[str, Dict[str, Any]] = {}  # guarded-by: self._lock
        # stitched-span keys CURRENTLY visible in member payloads — the
        # idempotence set for the stitched-traces counter. Replaced (not
        # grown) every recompute: a key only re-appears while its flushed
        # tree is still in some member's window, so swapping to the
        # current set both stays bounded and never double-counts.
        self._stitched_seen: set = set()  # guarded-by: self._lock
        self._last_refresh = 0.0  # guarded-by: self._lock
        # stitch cache: /debug/fleet re-polled faster than the refresh
        # window must not deep-copy + re-stitch an identical working set
        # per request (the health-server thread pays it)
        self._stitch_roots: Optional[List[Dict[str, Any]]] = None  # guarded-by: self._lock
        self._stitch_at = -math.inf  # guarded-by: self._lock

    def refresh(self) -> None:
        payloads: List[Dict[str, Any]] = []
        for backend in self.backends:
            try:
                payloads.extend(backend.poll())
            except Exception:
                logger.debug("telemetry backend poll failed", exc_info=True)
        with self._lock:
            for p in payloads:
                identity = str(p.get("identity") or "")
                if not identity:
                    continue
                cur = self._members.get(identity)
                if cur is None or (
                    float(p.get("flushed_at") or 0.0)
                    >= float(cur.get("flushed_at") or 0.0)
                ):
                    self._members[identity] = p
            self._last_refresh = self._clock()

    def _refresh_if_stale(self) -> None:
        with self._lock:
            fresh = self._clock() - self._last_refresh < 1.0
        if not fresh:
            self.refresh()

    def members(self) -> List[Dict[str, Any]]:
        """Inventory with staleness: who has flushed, how long ago, and
        whether they have gone quiet past the stale horizon."""
        now = self._clock()
        horizon = self.flush_interval * STALE_INTERVALS
        with self._lock:
            payloads = list(self._members.values())
        out = []
        for p in payloads:
            age = max(now - float(p.get("flushed_at") or 0.0), 0.0)
            prof = p.get("profile") or {}
            out.append({
                "identity": p.get("identity"),
                "role": p.get("role"),
                "age_s": round(age, 1),
                "stale": age > horizon,
                "trees": len(p.get("traces") or []),
                "profile_samples": prof.get("samples", 0),
            })
        return sorted(out, key=lambda m: str(m["identity"]))

    def _all_trees(self) -> List[Dict[str, Any]]:
        with self._lock:
            payloads = list(self._members.items())
        trees: List[Dict[str, Any]] = []
        seen: set = set()
        for identity, p in payloads:
            for t in p.get("traces") or []:
                key = (t.get("trace_id"), t.get("span_id"))
                if key in seen:
                    continue
                seen.add(key)
                t = dict(t)
                t["member"] = identity
                trees.append(t)
        if self._extra_trees is not None:
            for t in self._extra_trees():
                key = (t.get("trace_id"), t.get("span_id"))
                if key in seen:
                    continue
                seen.add(key)
                trees.append(t)
        return trees

    def stitched(self) -> Tuple[List[Dict[str, Any]], int]:
        """Stitch everything currently collected; counts NEW joins on
        ``karpenter_telemetry_stitched_traces_total`` (re-stitching the
        same flushed tree on the next poll is not a new stitch). The
        result is cached for the refresh window (callers treat the trees
        as read-only) so a hot /debug/fleet poller pays one stitch per
        window, not per request."""
        with self._lock:
            if (
                self._stitch_roots is not None
                and self._clock() - self._stitch_at < 1.0
            ):
                return self._stitch_roots, 0
        roots, _ = stitch(self._all_trees())
        current = {
            (s.get("trace_id"), s.get("span_id"))
            for root in roots
            for s in _walk(root)
            if s.get("stitched")
        }
        with self._lock:
            new = len(current - self._stitched_seen)
            # swap, don't grow: keys vanish with their flushed trees and
            # never return, so the set stays bounded by the working set
            self._stitched_seen = current
            self._stitch_roots = roots
            self._stitch_at = self._clock()
        if new:
            try:
                from karpenter_tpu_torch import metrics

                metrics.TELEMETRY_STITCHED.inc(new)
            except Exception:
                pass
        return roots, new

    def fleet_slo(self) -> Dict[str, Any]:
        with self._lock:
            snaps = {
                identity: p.get("slo") or {}
                for identity, p in self._members.items()
                if p.get("slo")
            }
        return merge_objective_snapshots(snaps)

    def fleet_decisions(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Cross-member decision index, newest first: every member's
        flushed decision summaries tagged with who recorded them. A dead
        replica's rounds stay visible for as long as its last payload
        does — exactly the flight-recorder property the per-process
        /debug/decisions ring cannot give."""
        with self._lock:
            payloads = list(self._members.items())
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for identity, p in payloads:
            for d in p.get("decisions") or []:
                did = d.get("id")
                if not did or did in seen:
                    continue
                seen.add(did)
                out.append({**d, "member": identity})
        out.sort(key=lambda d: -float(d.get("recorded_at") or 0.0))
        return out[:limit]

    def fleet_incidents(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Cross-member regression-incident index, newest first — the
        fleet twin of :meth:`fleet_decisions`: every member's flushed
        sentinel incident summaries tagged with who opened them, deduped
        by incident id (a scraped member can also flush to the file
        backend)."""
        with self._lock:
            payloads = list(self._members.items())
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for identity, p in payloads:
            for inc in p.get("incidents") or []:
                iid = inc.get("id")
                if not iid or iid in seen:
                    continue
                seen.add(iid)
                out.append({**inc, "member": identity})
        out.sort(key=lambda i: -float(i.get("opened_at") or 0.0))
        return out[:limit]

    def fleet_payload(self) -> Dict[str, Any]:
        """The ``GET /debug/fleet`` body."""
        self._refresh_if_stale()
        roots, _ = self.stitched()
        index = []
        worst = None
        worst_ms = -1.0
        for root in roots:
            stitched_members = sorted({
                s.get("member") for s in _walk(root) if s.get("member")
            } - {None})
            has_join = any(s.get("stitched") for s in _walk(root))
            dur = float(root.get("duration_ms") or 0.0)
            index.append({
                "trace_id": root.get("trace_id"),
                "name": root.get("name"),
                "duration_ms": dur,
                "members": stitched_members,
                "stitched": has_join,
            })
            if has_join and dur > worst_ms:
                worst_ms = dur
                worst = root
        index.sort(key=lambda e: -e["duration_ms"])
        out: Dict[str, Any] = {
            "members": self.members(),
            "slo": self.fleet_slo(),
            "decisions": self.fleet_decisions(),
            "incidents": self.fleet_incidents(),
            "traces": {
                "roots": len(roots),
                "stitched": sum(1 for e in index if e["stitched"]),
                "index": index[:50],
            },
        }
        if worst is not None:
            from karpenter_tpu_torch.obs.export import critical_path

            out["worst_stitched"] = {
                "trace_id": worst.get("trace_id"),
                "duration_ms": worst_ms,
                "critical_path": critical_path(worst),
                "wire": wire_attribution(worst),
            }
        return out


class TelemetryPlane:
    """One process's telemetry wiring: the periodic flusher (when a
    publishing backend is configured) plus the collector. Installed via
    ``obs.configure_telemetry``; ``Runtime.stop`` / sidecar shutdown call
    :meth:`stop`."""

    def __init__(
        self,
        identity: str,
        role: str = "controller",
        directory: str = "",
        peers: Sequence[str] = (),
        flush_interval: float = DEFAULT_FLUSH_INTERVAL_S,
        clock: Callable[[], float] = time.time,
    ):
        if flush_interval <= 0:
            raise ValueError("telemetry flush interval must be positive seconds")
        self.identity = identity
        self.role = role
        self.flush_interval = flush_interval
        self._file_backend = (
            FileTelemetryBackend(directory, identity=identity) if directory else None
        )
        backends: List[Any] = []
        if self._file_backend is not None:
            backends.append(self._file_backend)
        if peers:
            backends.append(HttpTelemetryBackend(peers))
        self.collector = TelemetryCollector(
            backends,
            flush_interval=flush_interval,
            clock=clock,
            # the collector's own ring rides along even when this process
            # publishes nowhere (pure pull mode)
            extra_trees=self._local_trees,
        )
        self.flushes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _local_trees(self) -> List[Dict[str, Any]]:
        from karpenter_tpu_torch import obs

        trees = obs.exporter().snapshot(limit=FLUSH_TREE_LIMIT, newest_first=True)
        for t in trees:
            t["member"] = self.identity
        return trees

    def flush(self) -> None:
        """Publish this process's payload now (the loop's body; tests and
        shutdown call it directly)."""
        if self._file_backend is None:
            return
        try:
            self._file_backend.publish(member_payload(self.identity, self.role))
            self.flushes += 1
            try:
                from karpenter_tpu_torch import metrics

                metrics.TELEMETRY_FLUSHES.inc()
            except Exception:
                pass
        except Exception:
            logger.debug("telemetry flush failed", exc_info=True)

    def start(self) -> "TelemetryPlane":
        if self._thread is not None or self._file_backend is None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-telemetry-flush", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self.flush()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        # one final flush so a clean shutdown's last window isn't lost
        self.flush()

    def fleet_payload(self) -> Dict[str, Any]:
        return self.collector.fleet_payload()
