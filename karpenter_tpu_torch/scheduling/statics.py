"""Per-pod static scheduling facts, computed once per pod lifetime.

A 10k-pod solve used to re-derive the same per-pod facts on every pass —
requests for the FFD sort, canonical cores for the encode, affinity/spread
terms for the topology grouping, host-port claims for the bucketing — each a
Python loop over the pod's spec. All of it is a pure function of the spec,
and specs are immutable while a pod is pending (the one mutator, preference
relaxation, replaces ``spec.affinity`` wholesale), so it is computed once
and memoized on the pod object here.

Validity is checked structurally on access: the memo stores the raw
nodeSelector items and the affinity object's identity; either changing
recomputes. ``Preferences.relax`` replacing ``spec.affinity`` therefore
invalidates automatically.

The canonicalization here MUST fold exactly like ``Requirements.from_pod``
(nodeSelector + heaviest preferred node-affinity term + first required
OR-term — reference: requirements.go:55-75) and split hostname exactly like
``signature.pod_core_and_hostname``; the solver-parity suite pins this.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import native_build
from karpenter_tpu_torch.utils import resources as res

# keys whose per-domain narrowing topology injection consults
NARROWED_KEYS = (lbl.TOPOLOGY_ZONE, lbl.HOSTNAME)


class PodStatics:
    __slots__ = (
        "sel_raw",          # tuple(pod.spec.node_selector.items()) — validity token
        "sel_ref",          # the node_selector dict itself — identity token
        "aff_ref",          # the affinity object itself — identity token
        "core0",            # canonical core with no injected decisions
        "hostname0",        # hostname with no injected decisions
        "aff_entries",      # folded affinity (key, op, values) minus hostname
        "aff_hostname",     # hostname from FOLDED affinity terms (In, len 1)
        "pinned_aff_hostname",  # first In-len-1 hostname across ALL required terms
        "req",              # requests dict (incl. pods count)
        "req_key",          # tuple(sorted(req.items())) — vector-cache key
        "extra_res",        # resource names outside the reserved axes
        "cpu", "mem",       # FFD sort keys
        "host_ports",       # frozenset of (ip, port, proto) claims
        "labels_key",       # tuple(sorted(metadata.labels.items()))
        "aff_terms",        # tuple of (group_key, term, anti) for supported keys
        "spreads",          # tuple of (group_key, constraint)
        "topo_any",         # bool: any aff_terms/spreads/host_ports (discovery skip)
        "topo_code",        # int id of the (aff keys, spread keys, ports) class;
                            # 0 = no topology, -1 = registry overflow (slow path)
        "key_entries",      # {key: ((op, values_tuple), ...)} for NARROWED_KEYS
        "constrains",       # frozenset of keys the spec itself narrows
        "merge_tid",        # interned id of (sel_raw, aff_entries, aff_hostname)
        "req_tid",          # interned id of req_key
    )


# value-interning tables: template pods share (selector, affinity, requests)
# BY VALUE; interning to a canonical tuple OBJECT at statics-build time lets
# per-solve memos key on object identity (id()) instead of hashing nested
# tuples per pod. Identity keys stay valid even if the table is pruned: a
# live PodStatics keeps its canonical object alive, so the id cannot be
# recycled out from under a memo built during that statics' lifetime.
_merge_interns: Dict[Tuple, Tuple] = {}
_req_interns: Dict[Tuple, Tuple] = {}
_INTERN_MAX = 1 << 20

# topology-class registry: pods whose (affinity group keys, spread group
# keys, has-ports) agree are distributed to the same topology groups, so
# discovery can bucket a batch by ONE int per pod and gather members with
# numpy instead of 10k Python appends. Codes live in statics memos, so the
# table is never cleared — it is capped instead (code -1 = per-pod path).
# The lock makes code assignment atomic: statics are built concurrently
# from the selection reconcile pool, and two classes sharing one code
# would silently merge their topology groups in discovery.
import threading as _threading

_topo_classes: Dict[Tuple, int] = {}  # guarded-by: _topo_lock
_topo_lock = _threading.Lock()
_TOPO_CLASS_MAX = 1 << 16


def _intern(table: Dict[Tuple, Tuple], key: Tuple) -> Tuple:
    hit = table.get(key)
    if hit is not None:
        return hit
    if len(table) >= _INTERN_MAX:
        table.clear()
    table[key] = key
    return key


def _selector_key(sel) -> Tuple:
    if sel is None:
        return ()
    cached = getattr(sel, "_canon_key", None)
    if cached is not None:
        return cached
    key = (
        tuple(sorted(sel.match_labels.items())),
        tuple((e.key, e.operator, tuple(e.values)) for e in sel.match_expressions),
    )
    try:
        sel._canon_key = key
    except AttributeError:
        pass
    return key


def _affinity_key(namespace: str, term, anti: bool) -> Tuple:
    ns = tuple(sorted(term.namespaces)) if term.namespaces else (namespace,)
    return (anti, ns, term.topology_key, _selector_key(term.label_selector))


def _group_key(namespace: str, c) -> Tuple:
    return (namespace, c.max_skew, c.topology_key, c.when_unsatisfiable,
            _selector_key(c.label_selector))


SUPPORTED_AFFINITY_KEYS = (lbl.HOSTNAME, lbl.TOPOLOGY_ZONE)


def _build(pod: Pod) -> PodStatics:
    st = PodStatics()
    spec = pod.spec
    st.sel_raw = tuple(spec.node_selector.items())
    st.sel_ref = spec.node_selector
    st.aff_ref = spec.affinity

    # -- canonical core + hostname (mirrors signature.pod_core_and_hostname)
    reqs: List[Tuple[str, str, Tuple[str, ...]]] = []
    hostname: Optional[str] = None
    key_entries: Dict[str, list] = {}
    constrains = set()
    for key, value in st.sel_raw:
        key = lbl.NORMALIZED_LABELS.get(key, key)
        if key in lbl.IGNORED_LABELS:
            continue
        constrains.add(key)
        if key in NARROWED_KEYS:
            key_entries.setdefault(key, []).append(("In", (value,)))
        if key == lbl.HOSTNAME:
            hostname = value
            continue
        reqs.append((key, "In", (value,)))

    aff_entries: List[Tuple[str, str, Tuple[str, ...]]] = []
    aff_hostname: Optional[str] = None
    pinned_aff_hostname: Optional[str] = None
    aff = spec.affinity
    if aff is not None and aff.node_affinity is not None:
        na = aff.node_affinity
        folded = []
        if na.preferred:
            heaviest = max(na.preferred, key=lambda t: t.weight)
            folded.extend(heaviest.preference.match_expressions)
        if na.required:
            folded.extend(na.required[0].match_expressions)
        for t in folded:
            key = lbl.NORMALIZED_LABELS.get(t.key, t.key)
            if key in lbl.IGNORED_LABELS:
                continue
            constrains.add(key)
            if key in NARROWED_KEYS:
                key_entries.setdefault(key, []).append((t.operator, tuple(t.values)))
            if key == lbl.HOSTNAME and t.operator == "In" and len(t.values) == 1:
                aff_hostname = t.values[0]
                continue
            aff_entries.append((key, t.operator, tuple(t.values)))
        # _pinned_hostname scans ALL required terms (not just the folded
        # first), in order, for an In-len-1 hostname
        for term in na.required:
            for r in term.match_expressions:
                if r.key == lbl.HOSTNAME and r.operator == "In" and len(r.values) == 1:
                    pinned_aff_hostname = r.values[0]
                    break
            if pinned_aff_hostname is not None:
                break
        # every OTHER key mentioned anywhere also counts as "constrained"
        # for the spread fast-path gate (topology._pod_constrains semantics)
        for term in na.required:
            for r in term.match_expressions:
                constrains.add(lbl.NORMALIZED_LABELS.get(r.key, r.key))
        for pref in na.preferred:
            for r in pref.preference.match_expressions:
                constrains.add(lbl.NORMALIZED_LABELS.get(r.key, r.key))

    if aff_hostname is not None:
        hostname = aff_hostname
    st.core0 = tuple(sorted(reqs + aff_entries))
    st.hostname0 = hostname
    st.aff_entries = tuple(aff_entries)
    st.aff_hostname = aff_hostname
    st.pinned_aff_hostname = pinned_aff_hostname
    st.key_entries = {k: tuple(v) for k, v in key_entries.items()}
    st.constrains = frozenset(constrains)

    # -- resources (shares the requests memo with utils.resources)
    st.req = res.requests_for_pods(pod)
    st.req_key = tuple(sorted(st.req.items()))
    st.extra_res = frozenset(k for k in st.req if k not in res.AXIS_INDEX)
    st.cpu = st.req.get(res.CPU, 0.0)
    st.mem = st.req.get(res.MEMORY, 0.0)

    st.host_ports = frozenset(podutil.host_ports(pod))
    st.labels_key = tuple(sorted(pod.metadata.labels.items()))
    st.merge_tid = _intern(_merge_interns, (st.sel_raw, st.aff_entries, st.aff_hostname))
    st.req_tid = _intern(_req_interns, st.req_key)

    # -- topology group membership
    ns = pod.metadata.namespace
    terms = []
    if aff is not None:
        if aff.pod_affinity is not None:
            terms += [(t, False) for t in aff.pod_affinity.required]
        if aff.pod_anti_affinity is not None:
            terms += [(t, True) for t in aff.pod_anti_affinity.required]
    st.aff_terms = tuple(
        (_affinity_key(ns, t, anti), t, anti)
        for t, anti in terms
        if t.topology_key in SUPPORTED_AFFINITY_KEYS
    )
    st.spreads = tuple(
        (_group_key(ns, c), c) for c in spec.topology_spread_constraints
    )
    st.topo_any = bool(st.aff_terms or st.spreads or st.host_ports)
    if st.topo_any:
        ckey = (
            tuple(k for k, _, _ in st.aff_terms),
            tuple(k for k, _ in st.spreads),
            bool(st.host_ports),
        )
        code = _topo_classes.get(ckey)
        st.topo_code = _topo_code(ckey) if code is None else code
    else:
        st.topo_code = 0
    return st


def _topo_code(ckey: Tuple) -> int:
    """The topology class's code, assigned under the registry's lock on
    its first sight (the native pass calls this on a registry miss)."""
    with _topo_lock:
        code = _topo_classes.get(ckey)
        if code is None:
            if len(_topo_classes) >= _TOPO_CLASS_MAX:
                code = -1  # registry full: per-pod discovery path
            else:
                code = len(_topo_classes) + 1
                _topo_classes[ckey] = code
    return code


# what the native pass reads: the Python build it falls back to, the shared
# tables with the code that fills them on a miss, and the label and
# resource constants ``_build`` folds with (the tables are never rebound)
NATIVE_CTX = (
    PodStatics, _build, _intern, _merge_interns, _req_interns, _topo_classes,
    _topo_code, lbl.NORMALIZED_LABELS, lbl.IGNORED_LABELS, NARROWED_KEYS,
    SUPPORTED_AFFINITY_KEYS, lbl.HOSTNAME, res.AXIS_INDEX, res.CPU, res.MEMORY,
    res.PODS, podutil.WILDCARD_HOST_IP,
)
# The native statics pass: ``csrc/statics_native.cpp``, a CPython module in
# C++ whose ``statics_pass`` builds the ``PodStatics`` of a list of pods in
# one call, the objects ``_build`` gives, from ``NATIVE_CTX``. g++ builds it
# for this interpreter into ``build/karpenter_tpu_torch/statics-<hash>/`` on
# a thread started at import, so a first solve never waits for it; until
# it is loaded, or where it cannot be built, the Python ``_build`` serves.
NATIVE_EXT = native_build.extension(
    "statics", Path(__file__).resolve().parent / "csrc", "statics_native.cpp", "_statics_native")
NATIVE = native_build.Loader(
    "native statics pass", lambda: native_build.load_extension(NATIVE_EXT), daemon=False)
NATIVE.get()  # starts the build: it overlaps the rest of the process's start


def statics(pod: Pod) -> PodStatics:
    """The pod's memoized statics, recomputed if the selector or the
    affinity object changed since last computed.

    Validity fast path is by object identity (the memo holds a reference,
    so the identity cannot be recycled): every selector write in this
    codebase REPLACES the dict (``{**sel, k: v}``) — the convention
    ``DomainPlan.materialize`` follows — so an unchanged dict object proves
    an unchanged selector. On identity mismatch (e.g. restore_selectors
    swapped the original dict back) the contents are compared before
    recomputing."""
    spec = pod.spec
    st = getattr(pod, "_solve_statics", None)
    if st is not None and st.aff_ref is spec.affinity:
        if st.sel_ref is spec.node_selector:
            return st
        if st.sel_raw == tuple(spec.node_selector.items()):
            st.sel_ref = spec.node_selector
            return st
    native = NATIVE.get()
    st = native.build(pod, NATIVE_CTX) if native is not None else None
    if st is None:
        st = _build(pod)
    _built.n += 1
    try:
        pod._solve_statics = st
    except AttributeError:
        pass
    return st


class _Built(threading.local):
    n = 0  # the builds ``statics`` made on this thread


_built = _Built()


def _pass(pods: Sequence[Pod]) -> Tuple[list, int, int]:
    """``([statics(p) for p in pods], built, native)``: the pods whose
    statics this call built, and those of them the native pass built (the
    whole pass runs in native code once the extension is loaded)."""
    native = NATIVE.get()
    if native is not None:
        return native.statics_pass(pods, NATIVE_CTX)
    b0 = _built.n
    sts = [statics(p) for p in pods]
    return sts, _built.n - b0, 0


def statics_pass(pods: Sequence[Pod], prof: Optional[Dict] = None) -> list:
    """``[statics(p) for p in pods]``, the one per-pod statics pass of a
    solve. With ``prof`` (a solve's stage profile) it runs under the
    ``solve.statics`` span, whose clock writes ``statics_s``,
    ``statics_built`` (the pods this pass built statics for, counted on the
    calling thread alone: another thread's builds, a prewarm's or a second
    worker's, are not this pass's) and ``statics_native`` (those of them
    the native pass built; the span's ``native``)."""
    if prof is None:
        return _pass(pods)[0]
    from karpenter_tpu_torch import obs

    with obs.tracer().span("solve.statics") as sp:
        t0 = time.perf_counter()
        sts, built, native = _pass(pods)
        prof["statics_s"] = time.perf_counter() - t0
        prof["statics_built"] = built
        prof["statics_native"] = native
        sp.set_attribute("pods", len(pods))
        sp.set_attribute("built", built)
        sp.set_attribute("native", native)
    return sts


def satisfies(entries, domain: str) -> bool:
    """Does this domain satisfy every (op, values) entry? — the per-domain
    form of Requirements' per-key set intersection (requirements.go:78-110:
    In intersects, NotIn subtracts, Exists keeps the universe)."""
    for op, values in entries:
        if op == "In":
            if domain not in values:
                return False
        elif op == "NotIn":
            if domain in values:
                return False
        elif op == "DoesNotExist":
            return False
        # Exists: no narrowing
    return True


# (merge-key, injected items) -> (core, hostname); the vocabulary of merged
# cores in one batch is small (template pods × assigned domains), so this
# global memo turns the per-pod canonicalization into a dict hit
_merged_core_cache: Dict[Tuple, Tuple] = {}
_MERGED_CORE_CACHE_MAX = 65536


def merged_core(st: PodStatics, inj_items: Tuple[Tuple[str, str], ...]):
    """Canonical (core, hostname) after overlaying injected topology
    decisions onto the pod's own selector — byte-identical to mutating
    ``spec.node_selector`` and re-running ``pod_core_and_hostname``."""
    key = (st.sel_raw, st.aff_entries, st.aff_hostname, inj_items)
    hit = _merged_core_cache.get(key)
    if hit is not None:
        return hit
    merged = dict(st.sel_raw)
    merged.update(inj_items)
    reqs: List[Tuple[str, str, Tuple[str, ...]]] = []
    hostname: Optional[str] = None
    for k, v in merged.items():
        k = lbl.NORMALIZED_LABELS.get(k, k)
        if k in lbl.IGNORED_LABELS:
            continue
        if k == lbl.HOSTNAME:
            hostname = v
            continue
        reqs.append((k, "In", (v,)))
    if st.aff_hostname is not None:
        hostname = st.aff_hostname
    out = (tuple(sorted(reqs + list(st.aff_entries))), hostname)
    if len(_merged_core_cache) >= _MERGED_CORE_CACHE_MAX:
        _merged_core_cache.clear()
    _merged_core_cache[key] = out
    return out
