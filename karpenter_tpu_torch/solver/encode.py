"""Tensorize one solve: pods × instance types × constraints → dense arrays.

Host-side preparation for the packing kernel:

1. canonicalize every pod into a (core, hostname) pair and intern cores;
2. build the signature closure (base ⊕ cores under join) with the exact
   requirements algebra (``signature.py``);
3. emit dense arrays — join table ``[S, C]``, capacity frontiers
   ``[S, F, R]``, per-pod core/hostname/request vectors — padded to bucketed
   shapes so XLA compiles once per shape bucket.

Complement-set semantics never reach the device: they are fully resolved into
the join table and frontiers here.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.solver.signature import (
    Core,
    SignatureOverflow,
    SignatureTable,
    pod_core_and_hostname,
)
from karpenter_tpu_torch.utils import resources as res

# Frontier rows are padded with this; requests are non-negative and include a
# pods count ≥ 1, so a padded row can never satisfy a fit test.
FRONTIER_PAD = -1.0

# closure results retained per table (one per recently seen core vocabulary)
CLOSURE_MEMO_MAX = 8


def _bucket(n: int, minimum: int = 64) -> int:
    """Shape bucket ≥ n: powers of two up to 2048, then multiples of 2048 —
    the scan cost is linear in the padded pod count, so pure pow2 buckets
    waste up to 2× of it at large batches (10k pods → 16384). The 2048-step
    ladder keeps the jit cache small; its padding overhead shrinks with
    batch size (≤ 20% from ~10k pods up, larger below)."""
    b = minimum
    while b < n and b < 2048:
        b *= 2
    if n <= b:
        return b
    return ((n + 2047) // 2048) * 2048


@dataclass
class EncodedBatch:
    """Everything the kernel needs, plus the host-side context to decode."""

    pods: List[Pod]  # solve order (FFD-sorted)
    n_pods: int
    # device arrays (padded to p_pad)
    pod_valid: np.ndarray  # [P] bool
    pod_open_sig: np.ndarray  # [P] i32 — signature of a fresh node for this pod
    pod_core: np.ndarray  # [P] i32
    pod_host: np.ndarray  # [P] i32, -1 = no hostname requirement
    pod_host_in_base: np.ndarray  # [P] bool
    pod_open_host: np.ndarray  # [P] i32 node hostname state when opened (-1/h/-2)
    pod_req: np.ndarray  # [P, R] f32
    join_table: np.ndarray  # [S, C] i32, -1 = incompatible
    frontiers: np.ndarray  # [S, F, R] f32
    daemon: np.ndarray  # [R] f32
    # host context
    table: SignatureTable
    signatures: List  # local (batch-scoped) Signature list; kernel sig ids index it
    cores: List[Core]
    hostnames: List[str]
    axes: List[str]
    usable: np.ndarray  # [T, R]
    # compact transfer form: pod_req row i == uniq_req[pod_req_id[i]]; the
    # fused TPU dispatch ships only the unique vectors + per-pod ids (a 10k
    # batch has dozens of distinct request shapes, not 10k). The final
    # uniq_req row is all-zero and backs the padding pods.
    pod_req_id: np.ndarray = None  # [P] i32
    uniq_req: np.ndarray = None  # [U+1, R] f32
    # the TRIMMED axis names matching the emitted arrays' R (inactive
    # resource axes are dropped at emission); decode maps totals back
    # through these, not RESOURCE_AXES + axes
    axis_names: list = None
    # per-core fresh-node signatures + whether the base constraints carry a
    # hostname requirement — the fused dispatch derives pod_open_sig and
    # pod_open_host ON DEVICE from these instead of shipping two more
    # per-pod rows
    open_sig_by_core: np.ndarray = None  # [C] i32
    base_has_hostname: bool = False

    def type_mask_matrix(self) -> np.ndarray:
        """[S_local, T] stacked signature→type masks for THIS batch's
        signature space (what the kernel's sig ids index)."""
        m = getattr(self, "_mask_matrix", None)
        if m is None:
            m = self._mask_matrix = np.stack([s.type_mask for s in self.signatures])
        return m

    def pack_args(self) -> tuple:
        """The canonical positional argument order of ``kernel.pack`` — the
        single definition of the call contract (the backend, the kernel
        wrapper and the parity tests all build this tuple)."""
        return (
            self.pod_valid,
            self.pod_open_sig,
            self.pod_core,
            self.pod_host,
            self.pod_host_in_base,
            self.pod_open_host,
            self.pod_req,
            self.join_table,
            self.frontiers,
            self.daemon,
        )


def usable_capacity(
    instance_types: Sequence[InstanceType], extra_axes: Sequence[str]
) -> np.ndarray:
    """[T, R] allocatable minus overhead — what requests compare against
    (reference: requirements.go:68-80 merges requests+overhead vs capacity;
    subtracting overhead once per type is the same inequality). Scaled to the
    exact-integer device units (resources.AXIS_SCALES)."""
    out = np.zeros((len(instance_types), res.NUM_RESOURCE_AXES + len(extra_axes)), np.float32)
    for i, it in enumerate(instance_types):
        out[i] = res.to_scaled_vector(it.resources, extra_axes) - res.to_scaled_vector(
            it.overhead, extra_axes
        )
    return out


class EncodeCache:
    """Per-scheduler reuse of solve-invariant encode state.

    The signature table (type masks, Pareto frontiers, join closure) and the
    usable-capacity matrix depend only on (hostname-free constraints,
    catalog, resource axes) — stable across a provisioner's batches until
    the catalog changes — yet round 1 rebuilt them every solve (~40ms of the
    10k-pod latency budget). Keyed by a semantic catalog fingerprint, NOT
    object identity (providers build fresh InstanceType objects per
    get_instance_types call), with small-LRU eviction so a drifting catalog
    cannot grow the cache unboundedly. Owned by one scheduler (one worker
    thread), not shared.

    Hit/miss traffic is counted (``solver_encode_cache_{hits,misses}_total``)
    so a thrashing cache is visible on the scrape."""

    MAX_ENTRIES = 4

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self.tables: "OrderedDict[Tuple, Tuple[np.ndarray, SignatureTable]]" = OrderedDict()

    def get(self, key: Tuple):
        from karpenter_tpu_torch import metrics

        hit = self.tables.get(key)
        if hit is not None:
            self.tables.move_to_end(key)
            metrics.SOLVER_ENCODE_CACHE_HITS.inc()
        else:
            metrics.SOLVER_ENCODE_CACHE_MISSES.inc()
        return hit

    def put(self, key: Tuple, value) -> None:
        self.tables[key] = value
        self.tables.move_to_end(key)
        while len(self.tables) > self.max_entries:
            self.tables.popitem(last=False)

    def clear(self) -> None:
        self.tables.clear()


# fingerprint memo keyed by the catalog's object identities: providers
# recreate InstanceType objects per get_instance_types() call, but within a
# worker the same objects recur for many solves, and re-deriving the
# semantic fingerprint walked 400 types every solve. Holding the catalog
# tuple in the value keeps the ids valid for the entry's lifetime.
# Lock-protected: catalog_fingerprint runs from concurrent per-provisioner
# solve workers, and an unlocked popitem can race a sibling's move_to_end
# into a KeyError (same contract as requirements._catreq_cache).
_fp_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()  # guarded-by: _fp_lock
_fp_lock = threading.Lock()
_FP_CACHE_MAX = 8


def catalog_fingerprint(instance_types: Sequence[InstanceType]) -> Tuple:
    """Order-sensitive semantic identity of a catalog — every field that
    feeds type compatibility or the usable-capacity matrix."""
    id_key = tuple(map(id, instance_types))
    with _fp_lock:
        hit = _fp_cache.get(id_key)
        if hit is not None:
            _fp_cache.move_to_end(id_key)
            return hit[1]
    fp = _catalog_fingerprint(instance_types)
    with _fp_lock:
        _fp_cache[id_key] = (tuple(instance_types), fp)
        while len(_fp_cache) > _FP_CACHE_MAX:
            _fp_cache.popitem(last=False)
    return fp


def _catalog_fingerprint(instance_types: Sequence[InstanceType]) -> Tuple:
    return tuple(
        (
            it.name,
            it.architecture,
            tuple(sorted(it.operating_systems)),
            tuple(sorted((o.capacity_type, o.zone) for o in it.offerings)),
            tuple(sorted(it.resources.items())),
            tuple(sorted(it.overhead.items())),
            it.price,
            tuple(sorted(it.labels.items())),
        )
        for it in instance_types
    )


def _table_key(constraints: Constraints, instance_types, axes) -> Tuple:
    reqs = tuple(
        (r.key, r.operator, tuple(r.values))
        for r in constraints.requirements.requirements
        if r.key != lbl.HOSTNAME
    )
    return (reqs, catalog_fingerprint(instance_types), tuple(axes))


def encode(
    constraints: Constraints,
    instance_types: Sequence[InstanceType],
    pods: Sequence[Pod],
    daemon: Dict[str, float],
    cache: Optional[EncodeCache] = None,
    plan=None,
) -> EncodedBatch:
    """Build the dense solve request. ``instance_types`` must already be
    price-sorted and ``pods`` FFD-sorted. Raises SignatureOverflow when
    constraint diversity exceeds the closure cap (caller falls back to FFD).

    Two input modes: with ``plan`` (a ``topology.DomainPlan``), topology
    decisions are overlaid from the plan onto each pod's memoized statics —
    zero pod mutation, the hot path. Without it, decisions must already be
    materialized into the pods' nodeSelectors (legacy callers re-parse each
    pod's spec).
    """
    from karpenter_tpu_torch.scheduling.statics import merged_core, statics

    # resource axes: reserved + any extended resources in play
    if plan is not None:
        # inject_plan already paid the statics pass over this exact list
        if plan.sts is not None and plan._pods is pods:
            sts = plan.sts
        else:
            sts = [statics(p) for p in pods]
        import operator

        pod_extras = frozenset().union(
            *map(operator.attrgetter("extra_res"), sts)
        ) if sts else set()
        extras = sorted(
            pod_extras
            | set(
                res.collect_extra_axes(
                    [it.resources for it in instance_types]
                    + [it.overhead for it in instance_types]
                    + [daemon]
                )
            )
        )
        pod_requests = None
    else:
        sts = None
        pod_requests = [res.requests_for_pods(p) for p in pods]
        extras = res.collect_extra_axes(
            [it.resources for it in instance_types]
            + [it.overhead for it in instance_types]
            + pod_requests
            + [daemon]
        )
    axes = extras  # extra axis names appended after the reserved block
    key = _table_key(constraints, instance_types, axes) if cache is not None else None
    cached = cache.get(key) if cache is not None else None
    if cached is not None:
        usable, table = cached
        table.set_base(constraints)
    else:
        usable = usable_capacity(instance_types, axes)
        table = SignatureTable(constraints, instance_types, usable, axes)
        if cache is not None:
            cache.put(key, (usable, table))

    # canonicalize pods; intern cores + hostnames + request vectors.
    # Plain python lists + one np.array at the end: 10k individual ndarray
    # element stores were a measurable slice of encode.
    cores: List[Core] = []
    core_ids: Dict[Core, int] = {}
    hostnames: List[str] = []
    host_ids: Dict[str, int] = {}
    host_in_base_by_id: List[bool] = []
    req_ids: Dict[Tuple, int] = {}
    uniq_vecs: List[np.ndarray] = []

    n = len(pods)
    core_l = [0] * n
    host_l = [-1] * n
    hib_l = [False] * n
    openh_l = [-1] * n
    reqid_l = [0] * n
    base_has_hostname = constraints.requirements.has(lbl.HOSTNAME)

    # template collapse: pods sharing (selector/affinity template, injected
    # non-hostname decisions, request template) resolve (core id, base
    # hostname, request id) through ONE identity-keyed dict hit; injected
    # hostnames resolve through one more
    tmpl_cache: Dict[Tuple, Tuple] = {}
    if plan is not None:
        tmpl_get = tmpl_cache.get
        host_ids_get = host_ids.get
        EMPTY = ()
        # ztokens/hostdecs ARE the plan storage: gather both columns in two
        # C-level map passes instead of per-pod method calls in the loop
        pids = list(map(id, pods))
        ztoks = [t if t is not None else EMPTY for t in map(plan.ztokens.get, pids)]
        dhs = list(map(plan.hostdecs.get, pids))
        for i, st in enumerate(sts):
            ztok = ztoks[i]
            dh = dhs[i]
            k2 = (id(st.merge_tid), id(ztok), id(st.req_tid))
            hit = tmpl_get(k2)
            if hit is None:
                if ztok:
                    core, base_host = merged_core(st, ztok)
                else:
                    core, base_host = st.core0, st.hostname0
                cid = core_ids.get(core)
                if cid is None:
                    cid = len(cores)
                    core_ids[core] = cid
                    cores.append(core)
                rid = req_ids.get(st.req_key)
                if rid is None:
                    rid = len(uniq_vecs)
                    req_ids[st.req_key] = rid
                    uniq_vecs.append(res.to_scaled_vector(st.req, axes))
                hit = tmpl_cache[k2] = (cid, base_host, rid)
            cid, base_host, rid = hit
            core_l[i] = cid
            reqid_l[i] = rid
            # hostname precedence mirrors the selector-merge order: folded
            # affinity > injected decision > the pod's own selector
            hostname = (
                base_host if (dh is None or st.aff_hostname is not None) else dh
            )
            if hostname is None:
                continue
            hid = host_ids_get(hostname)
            if hid is None:
                hid = len(hostnames)
                host_ids[hostname] = hid
                hostnames.append(hostname)
                host_in_base_by_id.append(table.hostname_in_base(hostname))
            host_l[i] = hid
            in_base = host_in_base_by_id[hid]
            hib_l[i] = in_base
            openh_l[i] = hid if (in_base or not base_has_hostname) else -2
    for i, pod in enumerate(pods if plan is None else ()):
        core, hostname = pod_core_and_hostname(pod)
        requests = pod_requests[i]
        rkey = tuple(sorted(requests.items()))
        cid = core_ids.get(core)
        if cid is None:
            cid = len(cores)
            core_ids[core] = cid
            cores.append(core)
        core_l[i] = cid
        if hostname is not None:
            hid = host_ids.get(hostname)
            if hid is None:
                hid = len(hostnames)
                host_ids[hostname] = hid
                hostnames.append(hostname)
                host_in_base_by_id.append(table.hostname_in_base(hostname))
            host_l[i] = hid
            in_base = host_in_base_by_id[hid]
            hib_l[i] = in_base
            # node hostname state if this pod opens a node: joinable (h) when
            # the merged hostname set stays non-empty ({h}), poisoned (-2)
            # when the base domains exclude h (set intersects to ∅ — later
            # hostname pods can never match, reference requirements.go:175)
            openh_l[i] = hid if (in_base or not base_has_hostname) else -2
        rid = req_ids.get(rkey)
        if rid is None:
            rid = len(uniq_vecs)
            req_ids[rkey] = rid
            uniq_vecs.append(res.to_scaled_vector(requests, axes))
        reqid_l[i] = rid

    return finish_encode(
        table, usable, axes, daemon, pods,
        np.array(core_l, np.int32),
        np.array(host_l, np.int32),
        np.array(hib_l, bool),
        np.array(openh_l, np.int32),
        np.array(reqid_l, np.int32),
        cores, hostnames, uniq_vecs, base_has_hostname,
    )


def finish_encode(
    table: SignatureTable,
    usable: np.ndarray,
    axes: Sequence[str],
    daemon: Dict[str, float],
    pods: Sequence[Pod],
    pod_core: np.ndarray,
    pod_host: np.ndarray,
    pod_host_in_base: np.ndarray,
    pod_open_host: np.ndarray,
    pod_req_id_core: np.ndarray,
    cores: List[Core],
    hostnames: List[str],
    uniq_vecs: List[np.ndarray],
    base_has_hostname: bool,
) -> EncodedBatch:
    """The shared tail of ``encode``: batch-local vocab arrays → signature
    closure → axis trim → pod padding → EncodedBatch. ``delta.py``'s
    resident path reconstructs the vocab arrays from cached per-pod rows and
    calls this directly, so a delta-built batch is bit-exact against a full
    re-encode by construction — both run the identical closure/trim/pad
    code on identical inputs."""
    n = len(pods)
    R = usable.shape[1]
    # final row = zeros, backing the padding pods
    uniq_req = np.vstack(uniq_vecs + [np.zeros(R, np.float32)]).astype(np.float32)
    pod_req = uniq_req[pod_req_id_core]

    # signature closure over THIS batch's cores, scoped to the reachable
    # set and re-indexed densely: a cached table accumulates signatures and
    # joins from earlier batches, and emitting arrays sized (or indexed) by
    # the accumulated closure would both crash on foreign cores and grow
    # the kernel input without bound.
    #
    # The closure is a pure function of (table base+catalog, cores
    # vocabulary) and the table accumulates monotonically, so consecutive
    # batches with the same core vocabulary — the steady state — reuse the
    # memoized (signatures, join_table, frontiers, open sigs) instead of
    # re-sweeping S×C joins (the encode hot spot at high diversity:
    # S=C=201 is 40k join lookups per solve). Memoized ON the table: the
    # EncodeCache key already pins base constraints, catalog, and axes.
    cores_key = tuple(cores)
    closure_memo = table._closure_memo
    hit = closure_memo.get(cores_key)
    if hit is not None:
        closure_memo.move_to_end(cores_key)
        signatures, join_table, frontiers, open_sig_by_core = hit
    else:
        open_sig_global = [table.open_signature(c) for c in cores]
        order: List[int] = []
        local: Dict[int, int] = {}

        def visit(sid: int) -> None:
            if sid >= 0 and sid not in local:
                local[sid] = len(order)
                order.append(sid)

        visit(0)
        for sid in open_sig_global:
            visit(sid)
        i = 0
        while i < len(order):
            sid = order[i]
            i += 1
            for core in cores:
                visit(table.join(sid, core))

        signatures = [table.signatures[sid] for sid in order]
        S = len(signatures)
        C = max(len(cores), 1)  # gathers need a non-empty core axis
        join_table = np.full((S, C), -1, np.int32)
        for li, sid in enumerate(order):
            for cid, core in enumerate(cores):
                out = table._join_cache.get((sid, core), -1)
                if out >= 0:
                    join_table[li, cid] = local[out]

        f_max = max((len(s.frontier) for s in signatures), default=1) or 1
        frontiers = np.full((S, f_max, R), FRONTIER_PAD, np.float32)
        for li, s in enumerate(signatures):
            if len(s.frontier):
                frontiers[li, : len(s.frontier)] = s.frontier

        open_sig_by_core = np.array([local[s] for s in open_sig_global] or [0], np.int32)
        # downstream consumers never mutate these arrays (device_put,
        # np.stack copies); freeze to make sharing safe by construction
        join_table.setflags(write=False)
        frontiers.setflags(write=False)
        open_sig_by_core.setflags(write=False)
        closure_memo[cores_key] = (signatures, join_table, frontiers, open_sig_by_core)
        while len(closure_memo) > CLOSURE_MEMO_MAX:
            closure_memo.popitem(last=False)

    daemon_vec = res.to_scaled_vector(daemon, axes)

    # Trim inactive resource axes from the EMITTED arrays: kernel time and
    # transfer bytes scale with R, and a typical batch exercises 3 of the
    # 8+ reserved axes (cpu/memory/pods). An axis must stay when any pod
    # requests it, the daemon overhead uses it, or some type's usable
    # capacity is NEGATIVE there (overhead > capacity — trimming that axis
    # would stop the fit test from rejecting such types). Fit semantics on
    # a trimmed axis are vacuous (0 ≤ usable), and the frontier PAD rows
    # still fail on the kept axes, so assignments are unchanged (the wide
    # parity sweep pins this). NOTE: stacked multi-solves must encode
    # same-shaped batches — same pod-axis usage, like the existing same-S
    # requirement.
    full_names = res.RESOURCE_AXES + list(axes)
    active = (uniq_req != 0).any(axis=0) | (daemon_vec != 0) | (usable < 0).any(axis=0)
    if not active.any():
        active[0] = True  # keep at least one axis (kernels need R >= 1)
    # The trimmed CATALOG-SIDE arrays (frontiers, daemon, usable) are
    # memoized on the table per (closure, daemon content, active mask):
    # steady-state solves must return identity-STABLE objects, so a caller
    # that fingerprints the catalog side by array id does not re-pay
    # blake2b over the full tensors every batch. The
    # pod-side slices (pod_req, uniq_req) stay per-batch.
    trim_key = (cores_key, daemon_vec.tobytes(), active.tobytes())
    trim_memo = table._trim_memo
    thit = trim_memo.get(trim_key)
    if thit is not None:
        trim_memo.move_to_end(trim_key)
        frontiers, daemon_vec, usable_out, axis_names, keep = thit
    else:
        if not active.all():
            keep = np.flatnonzero(active)
            frontiers = np.ascontiguousarray(frontiers[:, :, keep])
            daemon_vec = daemon_vec[keep]
            usable_out = usable[:, keep]
            axis_names = [full_names[i] for i in keep]
        else:
            keep = None
            usable_out = usable
            axis_names = full_names
        # downstream consumers never mutate these; freeze so the memoized
        # sharing is safe by construction (closure-memo arrays already are)
        frontiers.setflags(write=False)
        daemon_vec.setflags(write=False)
        trim_memo[trim_key] = (frontiers, daemon_vec, usable_out, axis_names, keep)
        while len(trim_memo) > CLOSURE_MEMO_MAX:
            trim_memo.popitem(last=False)
    if keep is not None:
        pod_req = pod_req[:, keep]
        uniq_req = uniq_req[:, keep]

    # pad pods to bucket
    p_pad = _bucket(max(n, 1))
    pad = p_pad - n

    def pad1(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    return EncodedBatch(
        pods=list(pods),
        n_pods=n,
        pod_valid=pad1(np.ones(n, bool), False),
        pod_open_sig=pad1(open_sig_by_core[pod_core], 0),
        pod_core=pad1(pod_core, 0),
        pod_host=pad1(pod_host, -1),
        pod_host_in_base=pad1(pod_host_in_base, False),
        pod_open_host=pad1(pod_open_host, -1),
        pod_req=pad1(pod_req, 0.0),
        join_table=join_table,
        frontiers=frontiers,
        daemon=daemon_vec,
        table=table,
        signatures=signatures,
        cores=cores,
        hostnames=hostnames,
        axes=axes,
        usable=usable_out,
        axis_names=axis_names,
        # padding pods point at uniq_req's final all-zero row
        pod_req_id=pad1(pod_req_id_core, len(uniq_vecs)),
        uniq_req=uniq_req,
        open_sig_by_core=open_sig_by_core,
        base_has_hostname=base_has_hostname,
    )
