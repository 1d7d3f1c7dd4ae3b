"""Resident cluster encoding: per-round deltas over the host encode path.

Steady-state rounds re-see mostly the same pods against the same catalog,
yet ``encode.encode`` rebuilds every pod-side tensor from Python objects each
solve. ``ResidentEncoder`` keeps the encoded batch resident across rounds
and patches it from per-pod cached rows, guarded by a content-keyed
**epoch** so staleness fails loud into a full re-encode, never a
stale-tensor solve.

Three round shapes, cheapest first:

1. **reuse** — same sorted pod identities, same epoch: the previous
   ``EncodedBatch`` is returned as-is (and, because object identity is
   stable, ``fused.PodResidency`` skips its re-upload too).
2. **delta** — pods arrived/bound/deleted under an unchanged epoch: cached
   per-pod rows (stable-vocab core/host/request ids) are gathered in the
   new sorted order, renumbered to batch-local first-seen ids with
   vectorized numpy, and handed to ``encode.finish_encode`` — the SAME tail
   the full path runs, so delta-built tensors are bit-exact against a full
   re-encode by construction (the parity fuzz in
   tests/test_torch_delta.py pins this with byte equality).
3. **full** — cold start, epoch change (constraints/catalog/axes/daemon
   drift), or an evicted table: delegate to ``encode.encode`` and adopt its
   batch-local vocabulary as the new resident state.

Topology batches ride the resident path through **plan reuse** rather than
row deltas: ``inject_plan`` is cluster- and rng-dependent, so a resident
overlay of its per-pod decisions would be guesswork — but the whole
injected round (post-inject constraints, ``DomainPlan``, daemon overhead)
is a deterministic function of (sorted batch, pre-inject constraints
content, cluster state). When none of those moved — same ``sts`` object
from the sort cache, equal requirements tuple, same ``Cluster.version()``
— the cached plan is reused and the encode lands on the zero-churn reuse
rung. Any input moving (a bind bumps the cluster version) falls back to a
counted full inject+re-encode; the per-pod row delta stays reserved for
topology-free batches, whose injected plan is empty by construction.

Threading: owned by one scheduler, which runs one solve at a time (the
``EncodeCache`` contract); no internal locking.
"""

from __future__ import annotations

import hashlib
import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.scheduling.topology import DomainPlan
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.utils import resources as res

# catalog-extras memo entries retained (keyed by catalog fingerprint +
# daemon content — one per recently seen catalog)
_EXTRAS_MEMO_MAX = 4


def _first_seen(stable: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Renumber stable vocab ids to batch-local ids in FIRST-OCCURRENCE
    order — exactly the ids the full encode's interning loop would have
    assigned scanning the same pods in the same order. Returns (local ids
    [n] i32, stable ids indexed by local id)."""
    uniq, first, inv = np.unique(stable, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    return rank[inv.reshape(-1)].astype(np.int32), uniq[order]


class ResidentEncoder:
    """Per-scheduler resident encode state (see module docstring)."""

    def __init__(self, cache: enc.EncodeCache):
        self._cache = cache
        # host epoch: blake2b-16 over every input the encoded tensors are a
        # function of besides the pods themselves — full requirements tuple
        # (hostname included: it feeds hostname_in_base/open-host), catalog
        # fingerprint, resource axes, daemon overhead content
        self._epoch: Optional[bytes] = None
        self._table = None
        self._usable: Optional[np.ndarray] = None
        self._axes: Optional[tuple] = None
        # stable vocabularies (epoch-scoped; reset on every adoption)
        self._cores: list = []
        self._core_ids: dict = {}
        self._hosts: List[str] = []
        self._host_ids: Dict[str, int] = {}
        self._host_hib: List[bool] = []
        self._req_ids: dict = {}  # id(st.req_tid) -> stable rid
        self._req_vecs: List[Optional[np.ndarray]] = []  # UNTRIMMED [R] f32
        # per-pod rows: id(pod) -> (pod, stable_cid, stable_hid, stable_rid,
        # hib). Holds the pod strongly so the id cannot be recycled; pruned
        # to the current round's pods on every delta/adopt.
        self._rows: dict = {}
        # sort cache: pod ids of the last input → its output. Keyed on pod
        # identity alone — the same contract the reuse rung already holds
        # (see sort()); _sorted_pods pins every pod so no id can recycle.
        self._sort_key: Optional[list] = None
        self._sorted_pods: Optional[List[Pod]] = None
        self._sorted_sts: Optional[list] = None
        self._topo_any: bool = True
        # zero-churn reuse: sorted pod ids + batch of the last encode.
        # _last_pods_obj is the sorted list OBJECT (stable across sort-cache
        # hits), so the steady-state reuse check is one identity test
        # instead of a 10k-element id-list build+compare.
        self._last_pids: Optional[list] = None
        self._last_pods_obj: Optional[list] = None
        self._last_batch: Optional[enc.EncodedBatch] = None
        # whether the resident rows were adopted from a topology round:
        # those rows embed the injected plan's decisions, so the per-pod
        # row delta must never rebuild tensors from them
        self._topo_resident: bool = False
        self._extras_memo: dict = {}
        # pod-extras memo: the O(n) extra_res union, keyed on the sts list
        # object (held strongly; sort-cache hits return the same object)
        self._pod_extras_sts: Optional[list] = None
        self._pod_extras: frozenset = frozenset()
        # plan reuse (topology batches): the cached injected round — the
        # post-inject constraints clone, the DomainPlan, and the daemon
        # overhead — valid while (sts object, pre-inject requirements
        # content, cluster version) all match
        self._plan_key: Optional[tuple] = None
        self._plan_sts: Optional[list] = None
        self._plan: Optional[DomainPlan] = None
        self._plan_constraints: Optional[Constraints] = None
        self._plan_daemon: Optional[Dict[str, float]] = None
        # epoch-digest memo: the repr of a catalog-merged requirements
        # tuple is ~MBs of string per round; Requirements is
        # immutable-by-convention and catalog_fingerprint returns a
        # memoized (identity-stable) object, so identity of both plus the
        # small axes/daemon content stands in for the full serialization
        self._digest_memo: Optional[tuple] = None

    # -- sort ----------------------------------------------------------------

    def sort(self, pods: Sequence[Pod]) -> Tuple[List[Pod], list, bool]:
        """``sort_pods_ffd_with_statics`` with a resident fast path: when
        the input's pod identities match the previous round's, the cached
        sorted output is returned without re-sorting. Bit-exact either way:
        the slow branch IS the ffd sort.

        The hit key is pod identity alone — the contract the reuse rung in
        ``encode`` already holds (its ``spids == _last_pids`` guard never
        consults statics either): nothing in this codebase mutates a pod's
        spec in place — selector writes REPLACE the pod (watch updates) or
        go through materialize/restore, which swaps the identical original
        dict back — so an unchanged pod object proves an unchanged spec.
        Running the per-pod statics pass on every hit would re-prove that
        at O(n) Python cost."""
        from karpenter_tpu_torch.scheduling.statics import statics

        n = len(pods)
        key = list(map(id, pods))
        if key == self._sort_key:
            return self._sorted_pods, self._sorted_sts, True
        sts = [statics(p) for p in pods]
        if n < 256:
            order = sorted(range(n), key=lambda i: (-sts[i].cpu, -sts[i].mem))
            spods = [pods[i] for i in order]
            ssts = [sts[i] for i in order]
        else:
            cpu = np.fromiter(
                map(operator.attrgetter("cpu"), sts), dtype=np.float64, count=n
            )
            mem = np.fromiter(
                map(operator.attrgetter("mem"), sts), dtype=np.float64, count=n
            )
            order = np.lexsort((-mem, -cpu)).tolist()
            getter = operator.itemgetter(*order)
            spods, ssts = list(getter(pods)), list(getter(sts))
        self._sort_key = key
        self._sorted_pods = spods
        self._sorted_sts = ssts
        self._topo_any = any(st.topo_any for st in ssts)
        return spods, ssts, False

    # -- inject --------------------------------------------------------------

    def eligible(self, sts: list) -> bool:
        """Topology-free batches only: with no affinity/spread/host-port
        pod, ``inject_plan`` provably returns an empty plan and leaves the
        constraints unmutated, so the resident path can skip its per-pod
        discovery sweep entirely."""
        if self._sorted_sts is sts:
            return not self._topo_any
        return not any(st.topo_any for st in sts)

    @staticmethod
    def empty_plan(pods: List[Pod], sts: list) -> DomainPlan:
        """The plan ``inject_plan`` would build for a topology-free batch:
        no decisions, statics attached for encode's shared-pass fast path."""
        plan = DomainPlan(pods)
        plan.sts = sts
        return plan

    # -- plan reuse (topology batches) ---------------------------------------

    @staticmethod
    def plan_key(constraints: Constraints, cluster_version: int) -> tuple:
        """Everything the injected round is a function of besides the
        sorted batch itself: the PRE-inject requirements content (inject
        mutates its constraints clone, so content — not identity — is the
        stable part) and the cluster version (affinity/spread domains read
        existing cluster pods and nodes; every store mutation bumps it)."""
        reqs = tuple(
            (r.key, r.operator, tuple(r.values))
            for r in constraints.requirements.requirements
        )
        return (cluster_version, reqs)

    def plan_reuse(self, key: tuple, sts: list) -> Optional[tuple]:
        """The cached injected round, or None. Requires the sts OBJECT from
        the sort cache (identity pins pods + order + statics; the strongly
        held ref means the id cannot have been recycled) and an equal plan
        key. Returns (constraints, plan, daemon) — the constraints a fresh
        clone of the cached post-inject clone and the daemon a dict copy,
        so a downstream consumer mutating either cannot poison the cache."""
        if self._plan_sts is not sts or key != self._plan_key:
            return None
        return (
            self._plan_constraints.clone(),
            self._plan,
            dict(self._plan_daemon),
        )

    def remember_plan(
        self, key: tuple, sts: list, constraints: Constraints,
        plan: DomainPlan, daemon: Dict[str, float],
    ) -> None:
        """Cache a freshly injected topology round for reuse. `constraints`
        is the POST-inject clone; the key holds the pre-inject content."""
        self._plan_key = key
        self._plan_sts = sts
        self._plan_constraints = constraints.clone()
        self._plan = plan
        self._plan_daemon = dict(daemon)

    # -- epoch ---------------------------------------------------------------

    def _axes_for(self, sts: list, instance_types, daemon: Dict[str, float]) -> tuple:
        """The resource-axis tuple ``encode`` would derive in plan mode —
        pod extras unioned with the (memoized) catalog+daemon extras."""
        if sts is self._pod_extras_sts:
            # sort-cache hits hand back the same sts object; the union over
            # 10k frozensets is O(n) Python and identical by construction
            pod_extras = self._pod_extras
        else:
            pod_extras = (
                frozenset().union(*map(operator.attrgetter("extra_res"), sts))
                if sts else frozenset()
            )
            self._pod_extras_sts = sts
            self._pod_extras = pod_extras
        fp = enc.catalog_fingerprint(instance_types)
        dk = tuple(sorted(daemon.items()))
        hit = self._extras_memo.get((id(fp), dk))
        if hit is None:
            hit = set(
                res.collect_extra_axes(
                    [it.resources for it in instance_types]
                    + [it.overhead for it in instance_types]
                    + [daemon]
                )
            )
            if len(self._extras_memo) >= _EXTRAS_MEMO_MAX:
                self._extras_memo.clear()
            # the fingerprint tuple rides in the value so its id stays valid
            self._extras_memo[(id(fp), dk)] = (hit, fp)
        cat_extras = hit[0] if isinstance(hit, tuple) else hit
        return tuple(sorted(pod_extras | cat_extras))

    def epoch_digest(
        self, constraints: Constraints, instance_types, axes: tuple,
        daemon: Dict[str, float],
    ) -> bytes:
        """Content key of everything but the pods: a change in any input
        the resident tensors were built from mints a new epoch and forces a
        counted full re-encode — the fail-loud ladder's first rung.

        Memoized on (requirements identity, fingerprint identity, axes,
        daemon content): Requirements mutators return new objects and the
        catalog fingerprint is identity-stable, so an unchanged pair proves
        an unchanged serialization without re-repr'ing the catalog-merged
        requirements tuple every round."""
        fp = enc.catalog_fingerprint(instance_types)
        dk = tuple(sorted(daemon.items()))
        memo = self._digest_memo
        if (
            memo is not None
            and memo[0] is constraints.requirements
            and memo[1] is fp
            and memo[2] == axes
            and memo[3] == dk
        ):
            return memo[4]
        reqs = tuple(
            (r.key, r.operator, tuple(r.values))
            for r in constraints.requirements.requirements
        )
        payload = repr((reqs, fp, axes, dk))
        digest = hashlib.blake2b(payload.encode(), digest_size=16).digest()
        self._digest_memo = (constraints.requirements, fp, axes, dk, digest)
        return digest

    # -- encode --------------------------------------------------------------

    def encode(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        pods: List[Pod],
        sts: list,
        daemon: Dict[str, float],
        plan: DomainPlan,
        *,
        topo: bool = False,
        plan_reused: bool = False,
    ) -> Tuple[enc.EncodedBatch, str]:
        """Encode an already-sorted batch through the resident path.
        Returns ``(batch, kind)`` with kind one of ``"reuse"`` / ``"delta"``
        / ``"full"``; the batch is bit-exact against ``encode.encode`` on
        the same inputs in every case.

        Topology batches (``topo=True``) only ever hit the reuse rung, and
        only when the backend reused the cached injected plan
        (``plan_reused``) — the epoch digest does not cover cluster state,
        and the resident rows of a topology round embed the plan's per-pod
        decisions, so both the zero-churn shortcut and the row delta would
        otherwise trust inputs the guard never checked. Everything else
        falls to a counted ``full("topology")``."""
        from karpenter_tpu_torch import metrics

        axes = self._axes_for(sts, instance_types, daemon)
        epoch = self.epoch_digest(constraints, instance_types, axes, daemon)
        key = enc._table_key(constraints, instance_types, list(axes))
        if epoch != self._epoch:
            reason = "cold" if self._epoch is None else "epoch"
            return self._full(
                constraints, instance_types, pods, sts, daemon, plan,
                epoch, key, axes, reason, topo=topo,
            ), "full"
        # same epoch: the resident table must still BE the cache's table
        # (eviction under catalog churn re-mints equal-content objects whose
        # memoized closures this path's vocab ids don't belong to)
        hit = self._cache.tables.get(key)
        if hit is None or hit[1] is not self._table:
            return self._full(
                constraints, instance_types, pods, sts, daemon, plan,
                epoch, key, axes, "table", topo=topo,
            ), "full"
        # zero-churn reuse: list-object identity first (sort-cache hits
        # return the same sorted list, making steady state O(1)), the
        # id-list compare as the fresh-sort-same-pods fallback
        spids: Optional[list] = None
        if not topo or plan_reused:
            if pods is not self._last_pods_obj:
                spids = list(map(id, pods))
            if spids is None or spids == self._last_pids:
                metrics.SOLVER_DELTA_APPLIED.labels(path="host").inc()
                return self._last_batch, "reuse"
        if topo or self._topo_resident:
            return self._full(
                constraints, instance_types, pods, sts, daemon, plan,
                epoch, key, axes, "topology", topo=topo,
            ), "full"
        if spids is None:
            spids = list(map(id, pods))
        batch = self._delta(pods, sts, spids, constraints, daemon)
        metrics.SOLVER_DELTA_APPLIED.labels(path="host").inc()
        self._last_pids = spids
        self._last_pods_obj = pods
        self._last_batch = batch
        self._publish_resident_bytes(batch)
        return batch, "delta"

    def force_full(self, reason: str) -> None:
        """Count an out-of-band full re-encode (e.g. a topology-bearing
        round routed around the resident path by the backend)."""
        from karpenter_tpu_torch import metrics

        metrics.SOLVER_DELTA_FULL_REENCODES.labels(reason=reason).inc()

    def reset(self) -> None:
        """Drop all resident state (epoch, vocab, rows, cached batch) —
        the overflow-retry path's companion to ``EncodeCache.clear``."""
        self._epoch = None
        self._table = None
        self._usable = None
        self._axes = None
        self._cores = []
        self._core_ids = {}
        self._hosts = []
        self._host_ids = {}
        self._host_hib = []
        self._req_ids = {}
        self._req_vecs = []
        self._rows = {}
        self._last_pids = None
        self._last_pods_obj = None
        self._last_batch = None
        self._topo_resident = False
        self._pod_extras_sts = None
        self._pod_extras = frozenset()
        self._plan_key = None
        self._plan_sts = None
        self._plan = None
        self._plan_constraints = None
        self._plan_daemon = None
        self._digest_memo = None

    # -- internals -----------------------------------------------------------

    def _full(
        self, constraints, instance_types, pods, sts, daemon, plan,
        epoch: bytes, key, axes: tuple, reason: str, *, topo: bool = False,
    ) -> enc.EncodedBatch:
        from karpenter_tpu_torch import metrics

        metrics.SOLVER_DELTA_FULL_REENCODES.labels(reason=reason).inc()
        batch = enc.encode(
            constraints, instance_types, pods, daemon,
            cache=self._cache, plan=plan,
        )
        self._adopt(batch, pods, sts, epoch, key, axes, topo=topo)
        return batch

    def _adopt(
        self, batch: enc.EncodedBatch, pods: List[Pod], sts: list,
        epoch: bytes, key, axes: tuple, *, topo: bool = False,
    ) -> None:
        """Adopt a full encode's batch-local vocabulary as the resident
        stable vocabulary (stable id == batch-local id for this round) and
        cache one row per pod."""
        hit = self._cache.tables.get(key)
        if hit is None:
            # the table never landed (cache disabled edge): no residency
            self._epoch = None
            self._rows = {}
            self._last_pids = None
            self._last_pods_obj = None
            self._last_batch = None
            return
        self._usable, self._table = hit
        self._epoch = epoch
        self._axes = axes
        self._topo_resident = topo
        self._cores = list(batch.cores)
        self._core_ids = {c: i for i, c in enumerate(self._cores)}
        self._hosts = list(batch.hostnames)
        self._host_ids = {h: i for i, h in enumerate(self._hosts)}
        self._host_hib = [self._table.hostname_in_base(h) for h in self._hosts]
        n = batch.n_pods
        pc = batch.pod_core[:n].tolist()
        ph = batch.pod_host[:n].tolist()
        pr = batch.pod_req_id[:n].tolist()
        hb = batch.pod_host_in_base[:n].tolist()
        self._req_ids = {}
        self._req_vecs = [None] * (len(batch.uniq_req) - 1)
        rows = {}
        req_vecs = self._req_vecs
        req_ids = self._req_ids
        for i, pod in enumerate(pods):
            st = sts[i]
            rid = pr[i]
            if req_vecs[rid] is None:
                # UNTRIMMED vector, re-derived exactly as encode interned it
                req_vecs[rid] = res.to_scaled_vector(st.req, list(axes))
                req_ids[id(st.req_tid)] = rid
            rows[id(pod)] = (pod, pc[i], ph[i], rid, hb[i])
        self._rows = rows
        self._last_pids = list(map(id, pods))
        self._last_pods_obj = pods
        self._last_batch = batch
        self._publish_resident_bytes(batch)

    def _add_row(self, pod: Pod, st) -> tuple:
        """Intern one NEW pod into the stable vocabulary — the per-pod cost
        of an arrival, paid once. Topology-free by eligibility, so the core
        and hostname are the statics' undecorated ones (exactly what the
        full encode's plan-mode loop resolves with an empty ztoken and no
        hostname decision)."""
        core, hostname = st.core0, st.hostname0
        cid = self._core_ids.get(core)
        if cid is None:
            cid = len(self._cores)
            self._core_ids[core] = cid
            self._cores.append(core)
        if hostname is None:
            hid, hib = -1, False
        else:
            hid = self._host_ids.get(hostname)
            if hid is None:
                hid = len(self._hosts)
                self._host_ids[hostname] = hid
                self._hosts.append(hostname)
                self._host_hib.append(self._table.hostname_in_base(hostname))
            hib = self._host_hib[hid]
        rid = self._req_ids.get(id(st.req_tid))
        if rid is None:
            rid = len(self._req_vecs)
            self._req_ids[id(st.req_tid)] = rid
            self._req_vecs.append(res.to_scaled_vector(st.req, list(self._axes)))
        row = (pod, cid, hid, rid, hib)
        self._rows[id(pod)] = row
        return row

    def _delta(
        self, pods: List[Pod], sts: list, spids: list,
        constraints: Constraints, daemon: Dict[str, float],
    ) -> enc.EncodedBatch:
        """Churn round: gather cached rows in the new sorted order (new
        arrivals interned on the way), renumber the stable ids to
        batch-local first-seen ids with vectorized numpy, and run the
        shared ``finish_encode`` tail."""
        n = len(pods)
        rows_get = self._rows.get
        cid_l = [0] * n
        hid_l = [0] * n
        rid_l = [0] * n
        hib_l = [False] * n
        rows = {}
        for i, pid in enumerate(spids):
            row = rows_get(pid)
            if row is None:
                row = self._add_row(pods[i], sts[i])
            rows[pid] = row
            _, cid_l[i], hid_l[i], rid_l[i], hib_l[i] = row
        # prune to the current round: bound memory and keep only live pods
        # pinned (a bound/deleted pod's id must not alias a future arrival)
        self._rows = rows

        stable_cid = np.array(cid_l, np.int64)
        stable_hid = np.array(hid_l, np.int64)
        stable_rid = np.array(rid_l, np.int64)
        hib_arr = np.array(hib_l, bool)

        local_cid, core_sel = _first_seen(stable_cid)
        cores = [self._cores[s] for s in core_sel.tolist()]
        local_rid, req_sel = _first_seen(stable_rid)
        uniq_vecs = [self._req_vecs[s] for s in req_sel.tolist()]

        local_hid = np.full(n, -1, np.int32)
        mask = stable_hid >= 0
        hostnames: List[str] = []
        openh = np.full(n, -1, np.int32)
        base_has_hostname = constraints.requirements.has(lbl.HOSTNAME)
        if mask.any():
            loc, host_sel = _first_seen(stable_hid[mask])
            local_hid[mask] = loc
            hostnames = [self._hosts[s] for s in host_sel.tolist()]
            # node hostname state if the pod opens a node: joinable (h) or
            # poisoned (-2) when the base domains exclude it — the same
            # expression the full encode evaluates per pod
            openh[mask] = np.where(
                hib_arr[mask] | (not base_has_hostname), loc, -2
            )
        hib_out = hib_arr & mask

        return enc.finish_encode(
            self._table, self._usable, list(self._axes), daemon, pods,
            local_cid, local_hid, hib_out, openh, local_rid,
            cores, hostnames, uniq_vecs, base_has_hostname,
        )

    def _publish_resident_bytes(self, batch: enc.EncodedBatch) -> None:
        from karpenter_tpu_torch import metrics

        total = sum(
            a.nbytes for a in batch.pack_args() if isinstance(a, np.ndarray)
        )
        metrics.SOLVER_DELTA_RESIDENT_BYTES.labels(side="host").set(total)
