"""The decision audit log: every provisioning round, recorded and replayable.

Spans and metrics say how long things took, not WHAT was decided and why.
This module is the flight-recorder twin for decisions (the port's copy of
``karpenter_tpu/obs/decisions.py``):

- :meth:`DecisionLog.record_round` turns one provisioning round (pods
  considered, the chosen packing, the solver context the scheduler
  captured, brownout/fence state at decision time) into a bounded
  ``DecisionRecord``: per-pod elimination attribution for the pods the
  solve left unplaced (``solver/explain.py`` — cheap mask reductions, OFF
  the hot path), the route/transport/session provenance, and — when an
  on-disk ring is configured — a compressed replay blob carrying the exact
  kernel tensors so ``obs/replay.py`` (or the JAX package's
  ``tools/replay_decision.py``) can re-solve the decision offline on the
  native packer and diff it (the canary's forensic twin).

- the ring is flight-recorder-shaped (``--decision-dir``, capped,
  lexicographic filename = recency): record writes are BEST-EFFORT — a
  full or read-only directory never fails a reconcile round (drops count
  on ``karpenter_decisions_dropped_total{reason="write_failed"}``), and
  pruning counts evictions (``reason="evicted"``). An in-memory deque
  (bounded) always backs ``GET /debug/decisions`` and
  ``GET /debug/explain?pod=`` even with no directory configured.

- the unschedulable tracker closes the loop to Kubernetes: a pod that
  fails selection/admission or solver placement for N CONSECUTIVE rounds
  gets a ``PodUnschedulable`` Warning event carrying the top elimination
  reason, with the decision id in the ``karpenter.sh/decision-id``
  annotation. A round that places the pod
  resets its streak.

- :meth:`DecisionLog.record_consolidation` records one consolidation
  wave (victims, nodes kept in place, pod moves, hourly savings); its id
  is stamped on the wave's events.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("karpenter.obs")

DEFAULT_CAP = 64  # on-disk ring size (the flight-recorder default)
DEFAULT_MEMORY_CAP = 256  # in-memory records backing the debug endpoints
DEFAULT_EVENT_ROUNDS = 3  # consecutive failures before PodUnschedulable
# per-record bounds: counts stay complete, listings are capped
MAX_POD_KEYS = 200
MAX_PACKING_NODES = 100
MAX_NODE_POD_KEYS = 50
MAX_UNSCHEDULABLE = 50

# tracker cap: a pathological churn of never-again-seen pods must not grow
# the failure table without bound (oldest-updated evicts first)
MAX_TRACKED_PODS = 4096

# a pod mid-failure-streak reuses its cached verdict; every this-many
# records the round re-attributes everything fresh (catalog/constraint
# drift can change WHY a pod is stuck even while it stays stuck)
VERDICT_REFRESH_ROUNDS = 32

# failure-streak entries not bumped within this window expire: a stuck
# pod that gets DELETED never re-appears in a batch to reset its streak,
# and without expiry it would pin the unschedulable gauge (and its event
# emission) forever
STREAK_TTL_S = 600.0

# async write queue depth: disk persistence (incl. the replay-tensor
# serialization) runs on ONE daemon writer thread so the hot provisioning
# round pays only the record build + an enqueue — the <1% explain bar.
# A full queue DROPS the newest write (counted), never blocks the round.
MAX_WRITE_QUEUE = 8

# disk-persistence thinning: back-to-back rounds would churn the capped
# ring (64 records at 100 rounds/sec = a sub-second window) and keep the
# writer thread competing for the GIL against live solves, so at most one
# record per interval lands on disk. Every record ALWAYS lands in the
# in-memory ring; thinning trades disk history density, not audit truth.
DEFAULT_WRITE_INTERVAL_S = 1.0

_enabled_lock = threading.Lock()
_enabled: Optional[bool] = None  # guarded-by: _enabled_lock


def enabled() -> bool:
    """Is decision recording + attribution on? Defaults to the
    ``KARPENTER_EXPLAIN`` env twin (true unless explicitly disabled) —
    an overhead comparison flips it."""
    global _enabled
    with _enabled_lock:
        if _enabled is None:
            # the boolean env contract: only the literal ``true`` is on
            _enabled = (
                os.environ.get("KARPENTER_EXPLAIN", "true").strip().lower()
                == "true"
            )
        return _enabled


def set_enabled(value: Optional[bool]) -> None:
    """Override (``None`` = re-read the env twin on next check)."""
    global _enabled
    with _enabled_lock:
        _enabled = value if value is None else bool(value)


PACK_ARG_NAMES = (
    "pod_valid", "pod_open_sig", "pod_core", "pod_host",
    "pod_host_in_base", "pod_open_host", "pod_req", "join_table",
    "frontiers", "daemon",
)


def _replay_arrays(batch, assignment, n_max: int) -> Dict[str, np.ndarray]:
    """The exact kernel inputs (``EncodedBatch.pack_args`` order) plus the
    served assignment and node-table size — everything the native packer
    needs to re-solve this decision offline. Written as an ``.npz``
    sidecar (C-speed serialization — the writer thread shares the GIL
    with live solves). The dense ``pod_req`` matrix ships in its compact
    transfer form (unique request vectors + per-pod ids — a 10k batch has
    dozens of distinct shapes, not 10k rows); replay re-gathers the
    identical matrix."""
    arrays = {
        n: np.asarray(a) for n, a in zip(PACK_ARG_NAMES, batch.pack_args())
    }
    if batch.uniq_req is not None and batch.pod_req_id is not None:
        del arrays["pod_req"]
        arrays["uniq_req"] = np.asarray(batch.uniq_req)
        arrays["pod_req_id"] = np.asarray(batch.pod_req_id)
    arrays["n_pods"] = np.asarray(int(batch.n_pods))
    arrays["n_max"] = np.asarray(int(n_max))
    if assignment is not None:
        arrays["assignment"] = np.asarray(assignment)
    return arrays


class DecisionLog:
    """Capped decision ring: bounded in-memory deque always, an on-disk
    flight-recorder-style ring when ``directory`` is set."""

    def __init__(
        self,
        directory: str = "",
        cap: int = DEFAULT_CAP,
        memory_cap: int = DEFAULT_MEMORY_CAP,
        clock=time.time,
        write_interval: float = DEFAULT_WRITE_INTERVAL_S,
    ):
        self.directory = directory
        self.cap = cap
        self.clock = clock
        self.write_interval = write_interval
        self._last_enqueue_mono = -float("inf")  # guarded-by: self._lock
        self.records_written = 0
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=memory_cap)  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        # consecutive-failure tracker: pod key -> {count, reason, message,
        # decision_id, namespace, name}  # guarded-by: self._lock
        self._failing: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._last_id_by_provisioner: Dict[str, str] = {}  # guarded-by: self._lock
        # what the unschedulable gauge currently shows, by reason: only
        # CHANGED series re-publish (a steady state pays zero prometheus
        # child lookups per round)
        self._gauge_shown: Dict[str, int] = {}  # guarded-by: self._lock
        # async persistence: the writer thread owns every disk touch
        # (serialize replay blob, tmp+rename, prune) so record_round's
        # hot-path cost is build + enqueue
        self._write_cond = threading.Condition(self._lock)
        self._write_queue: deque = deque()  # guarded-by: self._lock
        self._writes_inflight = 0  # guarded-by: self._lock
        self._writer: Optional[threading.Thread] = None  # guarded-by: self._lock
        # set by close(): the writer drains the queue and EXITS — a
        # replaced log (configure_decisions, tests) must not strand an
        # immortal once-a-second thread pinning its memory ring
        self._closed = False  # guarded-by: self._lock
        if directory:
            # best-effort, like every write below: an uncreatable dir
            # degrades to memory-only, never a boot failure — and the
            # degradation is REAL (directory cleared), so no writer
            # thread spins failing one write per interval forever
            try:
                os.makedirs(directory, exist_ok=True)
            except OSError:
                logger.warning(
                    "decision dir %s not writable; memory-only ring", directory
                )
                self.directory = ""

    # -- recording -----------------------------------------------------------

    def record_round(
        self,
        provisioner: str,
        pods,
        nodes,
        context: Optional[Dict[str, Any]] = None,
        trace_id: str = "",
        state: Optional[Dict[str, Any]] = None,
        admission_failures: Optional[List[Dict[str, str]]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Record one provisioning round. NEVER raises and never fails the
        round — a broken disk loses audit detail, not scheduling. Returns
        the record (or None when disabled / the record assembly itself broke)."""
        if not enabled():
            return None
        try:
            return self._record_round(
                provisioner, pods, nodes, context or {}, trace_id,
                state or {}, admission_failures or [],
            )
        except Exception:
            logger.debug("decision record build failed", exc_info=True)
            self._count_drop("error")
            return None

    def _record_round(
        self, provisioner, pods, nodes, context, trace_id, state,
        admission_failures,
    ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        with self._lock:
            self._seq += 1
            seq = self._seq
        batch = context.get("batch")
        assignment = context.get("assignment")
        unschedulable: List[Dict[str, Any]] = []
        if batch is not None and assignment is not None:
            # the assignment names the unplaced pods directly — no
            # whole-batch key scan on the hot path (10k f-string key
            # derivations per round would alone blow the <1% bar)
            a = np.asarray(assignment).reshape(-1)[: batch.n_pods]
            unplaced_idx = [int(i) for i in np.flatnonzero(a < 0)]
            unplaced_keys = [batch.pods[i].key for i in unplaced_idx]
            from karpenter_tpu_torch.solver import explain as expl

            # streak-aware reuse: a pod mid-failure-streak keeps its
            # verdict from the round that started the streak (it resets on
            # placement, and a periodic refresh re-derives it in case the
            # catalog/constraints moved underneath) — re-attributing 50
            # stuck pods every round would alone approach the <1% budget
            with self._lock:
                known = {
                    k: f["verdict"] for k, f in self._failing.items()
                    if f.get("verdict") is not None
                }
            refresh = (seq % VERDICT_REFRESH_ROUNDS) == 0
            # template grouping for the fresh ones: unplaced pods sharing
            # (signature, request, hostname state) share one verdict —
            # attribute the group once, stamp each pod's key on a copy
            sig_arr = np.asarray(batch.pod_open_sig)
            rid_arr = (
                np.asarray(batch.pod_req_id)
                if batch.pod_req_id is not None else None
            )
            oh_arr = np.asarray(batch.pod_open_host)
            host_arr = np.asarray(batch.pod_host)
            group_cache: Dict[Any, Dict[str, Any]] = {}
            for i, key in zip(unplaced_idx, unplaced_keys):
                if len(unschedulable) >= MAX_UNSCHEDULABLE:
                    break
                if not refresh:
                    cached = known.get(key)
                    if cached is not None:
                        unschedulable.append(cached)
                        continue
                gk = (
                    int(sig_arr[i]),
                    int(rid_arr[i]) if rid_arr is not None else i,
                    int(oh_arr[i]),
                    # the hostname id: two pods pinning DIFFERENT
                    # hostnames must not share one verdict — the
                    # hostname_poisoned annotation is per-pin
                    int(host_arr[i]),
                )
                core = group_cache.get(gk)
                if core is None:
                    core = group_cache[gk] = expl.explain_pod(batch, i)
                    unschedulable.append(core)
                else:
                    unschedulable.append({**core, "pod": key})
        else:
            # no tensor context (FFD route / solver: ffd): fall back to
            # the key-set difference — these rounds have no attribution
            placed_keys = {p.key for node in nodes for p in node.pods}
            unplaced_keys = [
                p.key for p in pods if p.key not in placed_keys
            ]
        for af in admission_failures:
            if len(unschedulable) < MAX_UNSCHEDULABLE:
                unschedulable.append(af)

        rec_id = f"d-{os.urandom(8).hex()}"
        record: Dict[str, Any] = {
            "id": rec_id,
            "recorded_at": self.clock(),
            "provisioner": provisioner,
            "trace_id": trace_id,
            "route": context.get("route"),
            "transport": context.get("transport"),
            "solver_address": context.get("address"),
            "session_key": context.get("session_key"),
            "state": state,
            "pods_considered": len(pods),
            "nodes": len(nodes),
            "unschedulable_count": len(unplaced_keys) + len(admission_failures),
            "unschedulable": unschedulable,
            # packing/pod-key listings materialize LAZILY (first read or
            # the async writer): deriving hundreds of pod keys per round
            # on the hot path would alone blow the <1% explain budget.
            # The refs are to post-solve objects nothing mutates.
            "_pods": list(pods[:MAX_POD_KEYS]),
            "_nodes": list(nodes[:MAX_PACKING_NODES]),
        }
        explain_s = time.perf_counter() - t0
        record["explain_s"] = round(explain_s, 6)

        self._enqueue_write(record, batch, assignment, context.get("n_max"), seq)
        with self._lock:
            self._records.append(record)
            self._last_id_by_provisioner[provisioner] = rec_id
            # streak bookkeeping: an unplaced pod extends its consecutive-
            # failure run; a TRACKED pod that was in this batch but not
            # unplaced must have placed — reset it. The reset scan runs
            # only while such candidates exist (the failing table is tiny
            # and usually all still failing), so a healthy steady state
            # never pays a whole-batch key walk.
            by_key = {v["pod"]: v for v in unschedulable if "pod" in v}
            unplaced_set = set(unplaced_keys)
            hits = {
                k for k in self._failing
                if k not in unplaced_set
            }
            if hits:
                for p in pods:
                    k = p.key
                    if k in hits:
                        self._failing.pop(k, None)
                        hits.discard(k)
                        if not hits:
                            break
            for k in unplaced_keys:
                self._bump_failure_locked(k, by_key.get(k), rec_id)
            for af in admission_failures:
                k = af.get("pod")
                if k:
                    self._bump_failure_locked(k, af, rec_id)
        try:
            from karpenter_tpu_torch import metrics

            metrics.DECISIONS_RECORDED.inc()
            metrics.DECISION_EXPLAIN_DURATION.observe(explain_s)
            self._publish_unschedulable_gauge()
        except Exception:
            pass  # trimmed registries
        return record

    def _materialize(self, record: Dict[str, Any], copy: bool = False) -> Dict[str, Any]:
        """Turn the deferred node/pod refs into the serializable
        ``packing`` / ``pod_keys`` listings. Idempotent; runs under the
        log lock so concurrent readers and the writer agree.
        ``copy=True`` returns a shallow copy taken UNDER the lock — what
        readers must serialize, because the async writer later inserts
        ``path`` into the live dict and a json.dumps iterating it at that
        moment would see the dict change size."""
        with self._lock:
            nodes = record.pop("_nodes", None)
            pods = record.pop("_pods", None)
            if nodes is not None:
                record["packing"] = [
                    {
                        "instance_type": (
                            node.instance_type_options[0].name
                            if node.instance_type_options else None
                        ),
                        "surviving_types": len(node.instance_type_options),
                        "pods": [
                            p.key for p in node.pods[:MAX_NODE_POD_KEYS]
                        ],
                        "pod_count": len(node.pods),
                    }
                    for node in nodes
                ]
            if pods is not None:
                record["pod_keys"] = [p.key for p in pods]
            return dict(record) if copy else record

    def _bump_failure_locked(self, key, verdict, rec_id) -> None:
        cur = self._failing.get(key)
        count = (cur["count"] if cur else 0) + 1
        reason = (verdict or {}).get("top_reason") or (cur or {}).get(
            "reason"
        ) or "unknown"
        message = (verdict or {}).get("message") or (cur or {}).get(
            "message"
        ) or "no placement found"
        self._failing[key] = {
            "count": count, "reason": reason, "message": message,
            "decision_id": rec_id,
            # monotonic freshness stamp: entries that stop being bumped
            # (the pod was deleted while stuck) expire after STREAK_TTL_S
            "bumped_mono": time.monotonic(),
            # the full verdict rides the streak so later rounds (and the
            # explain endpoint) reuse it instead of re-attributing
            "verdict": (
                verdict if verdict is not None
                else (cur or {}).get("verdict")
            ),
        }
        self._failing.move_to_end(key)
        while len(self._failing) > MAX_TRACKED_PODS:
            self._failing.popitem(last=False)

    def _expire_stale_locked(self) -> None:
        """Drop streak entries whose pod stopped appearing in batches
        long ago (deleted/evicted while stuck) — without this the gauge
        and the event loop would track ghosts forever."""
        horizon = time.monotonic() - STREAK_TTL_S
        stale = [
            k for k, v in self._failing.items()
            if v.get("bumped_mono", horizon) < horizon
        ]
        for k in stale:
            self._failing.pop(k, None)

    def _publish_unschedulable_gauge(self) -> None:
        from karpenter_tpu_torch import metrics

        with self._lock:
            self._expire_stale_locked()
            counts: Dict[str, int] = {}
            for v in self._failing.values():
                counts[v["reason"]] = counts.get(v["reason"], 0) + 1
            # delta publication: only series whose value moved (incl. a
            # drained reason dropping to 0) touch the registry
            changed = {
                reason: counts.get(reason, 0)
                for reason in set(counts) | set(self._gauge_shown)
                if counts.get(reason, 0) != self._gauge_shown.get(reason)
            }
            self._gauge_shown = counts
        for reason, value in changed.items():
            metrics.PODS_UNSCHEDULABLE.labels(reason=reason).set(value)

    def _count_drop(self, reason: str) -> None:
        try:
            from karpenter_tpu_torch import metrics

            metrics.DECISIONS_DROPPED.labels(reason=reason).inc()
        except Exception:
            pass

    def record_consolidation(
        self,
        provisioner: str,
        victims: List[str],
        keep: int,
        moves: int,
        savings: float,
        context: Optional[Dict[str, Any]] = None,
        trace_id: str = "",
    ) -> Optional[Dict[str, Any]]:
        """Record one consolidation wave decision: which nodes the re-pack
        retires, how many it left untouched (the minimal-move objective's
        receipt), how many pod moves the wave costs, and the hourly
        savings that justify it. The record id is what every wave event
        carries — `/decisions/<id>` answers
        "why is consolidation draining my node". Same contract as
        ``record_round``: NEVER raises, never fails the wave."""
        if not enabled():
            return None
        try:
            with self._lock:
                self._seq += 1
                seq = self._seq
            rec_id = f"d-{os.urandom(8).hex()}"
            record: Dict[str, Any] = {
                "id": rec_id,
                "recorded_at": self.clock(),
                "provisioner": provisioner,
                "trace_id": trace_id,
                "kind": "consolidation",
                "route": (context or {}).get("route"),
                "state": {
                    "victims": list(victims),
                    "kept_nodes": int(keep),
                    "moves": int(moves),
                    "savings_per_hour": float(savings),
                    **{
                        k: v for k, v in (context or {}).items()
                        if k not in ("batch", "assignment", "n_max")
                    },
                },
                "pods_considered": int(moves),
                "nodes": len(victims) + int(keep),
                "unschedulable_count": 0,
                "unschedulable": [],
                "_pods": [],
                "_nodes": [],
            }
            self._enqueue_write(record, None, None, None, seq)
            with self._lock:
                self._records.append(record)
                self._last_id_by_provisioner[provisioner] = rec_id
            return record
        except Exception:
            logger.debug("consolidation decision record failed", exc_info=True)
            self._count_drop("error")
            return None

    def _enqueue_write(self, record, batch, assignment, n_max, seq) -> None:
        """Hand the record to the writer thread. The hot path pays only
        this enqueue; a full queue drops the write (counted), never blocks
        or fails the round. Disk persistence is interval-thinned (the
        in-memory ring keeps every record)."""
        if not self.directory:
            return
        with self._lock:
            if self._closed:
                return
            now = time.monotonic()
            if now - self._last_enqueue_mono < self.write_interval:
                return  # thinning, not loss: the memory ring has it
            self._last_enqueue_mono = now
            if len(self._write_queue) >= MAX_WRITE_QUEUE:
                dropped = True
            else:
                dropped = False
                self._write_queue.append((record, batch, assignment, n_max, seq))
                if self._writer is None or not self._writer.is_alive():
                    self._writer = threading.Thread(
                        target=self._writer_loop,
                        name="karpenter-decision-writer", daemon=True,
                    )
                    # started under the lock (the probe/canary discipline:
                    # is_alive() is False for an assigned-but-unstarted
                    # thread, so a concurrent enqueue could double-spawn)
                    self._writer.start()
                self._write_cond.notify_all()
        if dropped:
            self._count_drop("queue_full")

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._write_queue:
                    if self._closed:
                        return  # drained + closed: the thread ends
                    self._write_cond.wait(timeout=1.0)
                entry = self._write_queue.popleft()
                self._writes_inflight += 1
            try:
                self._write_now(*entry)
            finally:
                with self._lock:
                    self._writes_inflight -= 1
                    self._write_cond.notify_all()

    def close(self) -> None:
        """Stop the writer thread after it drains the queue. A closed log
        still serves its memory ring; new disk writes are refused."""
        with self._lock:
            self._closed = True
            self._write_cond.notify_all()

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait for queued disk writes to land (tests, clean shutdown).
        True when the queue drained in time."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._write_queue or self._writes_inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._write_cond.wait(timeout=min(left, 0.5))
        return True

    def _write_now(self, record, batch, assignment, n_max, seq) -> Optional[str]:
        """Best-effort on-disk persistence; a failed write (full/read-only
        disk) drops THIS record's files, never the round or the in-memory
        copy. Runs on the writer thread. The replay tensors land as an
        ``.npz`` sidecar next to the record json (numpy's C serializer —
        the writer shares the GIL with live solves, so json-encoding
        megabytes of base64 here would tax them)."""
        try:
            payload = dict(self._materialize(record))
            stem = (
                f"decision-{int(self.clock() * 1e3):013d}"
                f"-{seq % 1_000_000:06d}-{record['id'][2:10]}"
            )
            path = os.path.join(self.directory, f"{stem}.json")
            if batch is not None and n_max:
                npz_tmp = os.path.join(
                    self.directory, f"{stem}.npz.{os.getpid()}.tmp"
                )
                npz_path = os.path.join(self.directory, f"{stem}.npz")
                with open(npz_tmp, "wb") as f:
                    np.savez(f, **_replay_arrays(batch, assignment, n_max))
                os.replace(npz_tmp, npz_path)
                payload["replay_file"] = f"{stem}.npz"
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            with self._lock:
                self.records_written += 1
                record["path"] = path
            # prune OUTSIDE the lock: listdir + unlinks on a slow disk
            # must not stall record_round's seq/enqueue/streak bookkeeping
            # (only this writer thread ever prunes, so no racing sweeps)
            self._prune()
            return path
        except Exception:
            logger.debug("decision record write failed", exc_info=True)
            self._count_drop("write_failed")
            return None

    def _prune(self) -> None:
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("decision-") and n.endswith(".json")
        )
        evicted = 0
        for victim in names[: max(len(names) - self.cap, 0)]:
            try:
                os.remove(os.path.join(self.directory, victim))
                evicted += 1
            except OSError:
                pass
            try:
                os.remove(os.path.join(
                    self.directory, victim[: -len(".json")] + ".npz"
                ))
            except OSError:
                pass  # record had no replay sidecar
        if evicted:
            self._count_drop_n("evicted", evicted)

    def _count_drop_n(self, reason: str, n: int) -> None:
        try:
            from karpenter_tpu_torch import metrics

            metrics.DECISIONS_DROPPED.labels(reason=reason).inc(n)
        except Exception:
            pass

    # -- the admission/selection feed ---------------------------------------

    def note_admission_failure(
        self, pod, errors: List[str], provisioner: str = ""
    ) -> Dict[str, str]:
        """Selection-level rejection (no provisioner admitted the pod):
        classify the dimension — taint intolerance vs requirement — and
        extend the pod's consecutive-failure streak outside any solve."""
        from karpenter_tpu_torch.solver.explain import REASON_REQUIREMENT, REASON_TAINT

        msg = "; ".join(errors)[:400] if errors else "no provisioner admitted"
        reason = REASON_TAINT if "tolerate" in msg else REASON_REQUIREMENT
        verdict = {"pod": pod.key, "top_reason": reason, "message": msg}
        with self._lock:
            rec_id = self._last_id_by_provisioner.get(provisioner, "")
            self._bump_failure_locked(pod.key, verdict, rec_id)
        try:
            self._publish_unschedulable_gauge()
        except Exception:
            pass
        return verdict

    # -- the Kubernetes loop -------------------------------------------------

    def _emit_one(self, recorder, key: str, v: Dict[str, Any], threshold: int):
        """One PodUnschedulable Warning. The message is deliberately
        STABLE across rounds (no streak count in it): EventRecorder
        aggregates on the message, so repeats bump the existing Event's
        count instead of minting a fresh apiserver object per round —
        embedding the incrementing count would turn one stuck pod into an
        event storm."""
        namespace, _, name = key.partition("/")
        return recorder.event(
            "Pod", name or key,
            "PodUnschedulable",
            f"pod unschedulable for {threshold}+ consecutive round(s): "
            f"{v['message']} (top reason: {v['reason']}; "
            "GET /debug/explain?pod=<name> has the per-candidate "
            "breakdown)",
            type="Warning",
            namespace=namespace if name else "",
            decision_id=v["decision_id"],
        )

    def emit_unschedulable_events(
        self, cluster, threshold: int = DEFAULT_EVENT_ROUNDS
    ) -> int:
        """Emit a ``PodUnschedulable`` Warning event for every pod whose
        consecutive-failure streak reached ``threshold``, carrying the top
        elimination reason in the message and the decision id in the
        ``karpenter.sh/decision-id`` annotation. Runs ONCE PER ROUND (the
        provisioning worker's seam); per-pod feeds use
        :meth:`maybe_emit_for`. Never raises."""
        try:
            with self._lock:
                self._expire_stale_locked()
                due = [
                    (k, dict(v)) for k, v in self._failing.items()
                    if v["count"] >= threshold
                ]
            if not due:
                return 0
            from karpenter_tpu_torch.kube.events import recorder_for

            recorder = recorder_for(cluster)
            emitted = 0
            for key, v in due:
                # authoritative existence check: a pod deleted while stuck
                # never re-enters a batch to reset its streak — drop the
                # ghost instead of eventing a nonexistent object per round
                namespace, _, name = key.partition("/")
                if name and cluster.try_get("pods", name, namespace) is None:
                    with self._lock:
                        self._failing.pop(key, None)
                    continue
                if self._emit_one(recorder, key, v, threshold) is not None:
                    emitted += 1
            return emitted
        except Exception:
            logger.debug("unschedulable event emission failed", exc_info=True)
            return 0

    def maybe_emit_for(
        self, cluster, pod_key: str, threshold: int = DEFAULT_EVENT_ROUNDS
    ) -> bool:
        """The per-pod twin: emit for THIS pod only when its streak is
        due. Selection's admission feed runs once per rejected pod, and a
        whole-table sweep there would be O(rejected x failing) event
        writes per selection pass. Never raises."""
        try:
            with self._lock:
                v = self._failing.get(pod_key)
                if v is None or v["count"] < threshold:
                    return False
                v = dict(v)
            from karpenter_tpu_torch.kube.events import recorder_for

            return self._emit_one(
                recorder_for(cluster), pod_key, v, threshold
            ) is not None
        except Exception:
            logger.debug("unschedulable event emission failed", exc_info=True)
            return False

    # -- read surface --------------------------------------------------------

    def recent(
        self, limit: int = 20, provisioner: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self._records)
        records.reverse()  # newest first
        if provisioner:
            records = [r for r in records if r["provisioner"] == provisioner]
        return [self._materialize(r, copy=True) for r in records[:limit]]

    def summaries(self, limit: int = 16) -> List[Dict[str, Any]]:
        """The bounded per-member index the telemetry plane flushes — a
        dead replica's decisions survive in /debug/fleet through these."""
        out = []
        for r in self.recent(limit=limit):
            out.append({
                "id": r["id"],
                "recorded_at": r["recorded_at"],
                "provisioner": r["provisioner"],
                "trace_id": r["trace_id"],
                "route": r.get("route"),
                "pods_considered": r["pods_considered"],
                "nodes": r["nodes"],
                "unschedulable_count": r["unschedulable_count"],
                "top_reasons": sorted({
                    v.get("top_reason") for v in r.get("unschedulable", [])
                    if v.get("top_reason")
                }),
            })
        return out

    def explain(self, pod: str) -> Optional[Dict[str, Any]]:
        """The ``/debug/explain?pod=`` body: the newest record mentioning
        the pod (by key or bare name), with its verdict — per-candidate
        breakdown for an unplaced pod, the chosen placement otherwise."""
        with self._lock:
            records = list(self._records)
        for r in reversed(records):
            self._materialize(r)
            verdict = next(
                (
                    v for v in r.get("unschedulable", [])
                    if v.get("pod") == pod
                    or v.get("pod", "").rpartition("/")[2] == pod
                ),
                None,
            )
            if verdict is not None:
                out = {
                    "decision_id": r["id"],
                    "recorded_at": r["recorded_at"],
                    "provisioner": r["provisioner"],
                    "trace_id": r["trace_id"],
                    "route": r.get("route"),
                    "placed": False,
                    **verdict,
                }
                with self._lock:
                    streak = self._failing.get(verdict.get("pod", pod))
                if streak:
                    out["consecutive_failures"] = streak["count"]
                return out
            for node in r.get("packing", []):
                for k in node["pods"]:
                    if k == pod or k.rpartition("/")[2] == pod:
                        return {
                            "decision_id": r["id"],
                            "recorded_at": r["recorded_at"],
                            "provisioner": r["provisioner"],
                            "trace_id": r["trace_id"],
                            "route": r.get("route"),
                            "placed": True,
                            "pod": k,
                            "instance_type": node["instance_type"],
                            "surviving_types": node["surviving_types"],
                        }
        return None

    def failure_streak(self, pod_key: str) -> int:
        with self._lock:
            v = self._failing.get(pod_key)
            return v["count"] if v else 0

    def last_decision_id(self, provisioner: str) -> str:
        with self._lock:
            return self._last_id_by_provisioner.get(provisioner, "")

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._failing.clear()
            self._last_id_by_provisioner.clear()
