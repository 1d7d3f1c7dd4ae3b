"""Topology handling by pre-assignment: spread constraints AND pod
(anti-)affinity.

Spread mirrors ``pkg/controllers/provisioning/scheduling/topology.go`` +
``topologygroup.go``: pods are grouped by equivalent (namespace, constraint);
existing matching pods are counted per domain from the live cluster (zones:
viable zones from requirements; hostnames: ``ceil(len(pods)/maxSkew)`` fresh
generated names); then each pod gets the current min-count domain assigned,
turning TopologySpreadConstraints into just-in-time NodeSelectors the packing
core understands natively.

Pod affinity/anti-affinity is NEW capability (BASELINE config 3; the
reference rejects it at selection, selection/controller.go:145-150, with its
intended semantics sketched by the skipped suite contexts,
scheduling/suite_test.go:1014-1080). The same pre-assignment trick applies —
pairwise pod×pod×domain constraints become per-pod domain decisions made
sequentially against membership counters:

- affinity(S, zone):    land in a zone already containing a pod matching S
                        (cluster counts seed the table); a self-matching or
                        batch-provided group with no existing matches gets a
                        single seed zone so it co-locates with itself.
- affinity(S, host):    the group shares one fresh hostname — one node.
- anti(S, zone):        land in a zone with zero matches; each placed pod
                        that matches S claims its zone.
- anti(S, host):        pods matching S get one fresh hostname each (pairwise
                        separation); non-matching pods share a separate fresh
                        hostname away from the providers.

Pods with unsatisfiable rules get a sentinel domain no node can offer, so the
packer counts and logs them unschedulable instead of mis-placing them.

Decisions are recorded in a ``DomainPlan`` — NOT written into the pods'
nodeSelectors. The TPU encode consumes the plan directly (zero pod mutation
on the hot path); the FFD packer calls ``plan.materialize`` to get the
classic just-in-time NodeSelector form, so affinity support lands in both
backends from the same decision logic.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    NodeSelectorRequirement,
    Pod,
    PodAffinityTerm,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.statics import (
    SUPPORTED_AFFINITY_KEYS as SUPPORTED_AFFINITY_KEYS_STATICS,
    PodStatics,
    satisfies,
    statics,
)
from karpenter_tpu_torch.utils import pod as podutil

# A domain no catalog offers: forces "no instance type satisfied" for pods
# whose affinity rules cannot be met, keeping them visibly unschedulable.
UNSATISFIABLE_DOMAIN = "unsatisfiable.karpenter.sh"

# re-exported from statics (the grouping pass that enforces it lives there)
SUPPORTED_AFFINITY_KEYS = SUPPORTED_AFFINITY_KEYS_STATICS


class DomainPlan:
    """Per-pod injected topology decisions, keyed by pod identity.

    Reads fall back to the pod's own (raw) nodeSelector, so plan-aware code
    sees exactly the view the old selector-mutation flow produced, without
    touching the pods. ``materialize`` applies the decisions as selector
    overlays for the FFD path (callers snapshot/restore around it)."""

    __slots__ = ("ztokens", "hostdecs", "_pods", "sts")

    # canonical NON-hostname decision tuples, interned PROCESS-WIDE so the
    # encode can memo per (pod template, decisions) on object identity
    # across solves — hostname decisions are excluded because the canonical
    # core never contains the hostname key (the kernel carries it as an int
    # field). Clear-safe: live plans keep their canonical objects alive.
    _tok_intern: Dict[Tuple, Tuple] = {}

    def __init__(self, pods: List[Pod]):
        # THE storage: ztokens maps pod id -> interned sorted tuple of the
        # pod's non-hostname decisions; hostdecs maps pod id -> injected
        # hostname. Decisions per pod are 1-2 items, so the tuple IS the
        # map — no per-pod dict allocation on the hot path, and the encode
        # loop reads both with one plain dict get each.
        self.ztokens: Dict[int, Tuple] = {}
        self.hostdecs: Dict[int, Optional[str]] = {}
        self._pods = pods  # keeps ids stable for the plan's lifetime
        self.sts: Optional[List] = None  # statics parallel to `pods`, set by inject_plan

    def decision(self, pod: Pod, key: str) -> Optional[str]:
        pid = id(pod)
        if key == lbl.HOSTNAME:
            return self.hostdecs.get(pid)
        tok = self.ztokens.get(pid)
        if tok:
            for k, v in tok:
                if k == key:
                    return v
        return None

    def get(self, pod: Pod, key: str) -> Optional[str]:
        v = self.decision(pod, key)
        return v if v is not None else pod.spec.node_selector.get(key)

    def set(self, pod: Pod, key: str, domain: str) -> None:
        pid = id(pod)
        if key == lbl.HOSTNAME:
            self.hostdecs[pid] = domain
            return
        tok = self.ztokens.get(pid)
        if not tok:
            self.ztokens[pid] = self.intern_token(key, domain)
            return
        merged = dict(tok)
        merged[key] = domain
        self.ztokens[pid] = self._intern(tuple(sorted(merged.items())))

    @staticmethod
    def _intern(items: Tuple) -> Tuple:
        intern = DomainPlan._tok_intern
        if len(intern) > (1 << 20):
            intern.clear()
        return intern.setdefault(items, items)

    def zone_token(self, pod: Pod) -> Tuple:
        """Canonical interned tuple of this pod's non-hostname decisions."""
        return self.ztokens.get(id(pod), ())

    @staticmethod
    def intern_token(key: str, domain: str) -> Tuple:
        """The canonical interned token of a single zone-class decision —
        lets bulk writers stamp one shared token across a whole group."""
        return DomainPlan._intern(((key, domain),))

    def set_zone_bulk(self, members, key: str, domain: str) -> None:
        """Assign one non-hostname decision to many pods at once, stamping
        the shared interned token. Pods that already carry a different
        non-hostname decision merge through the generic ``set`` path."""
        tok = self.intern_token(key, domain)
        ztokens = self.ztokens
        ztokens_get = ztokens.get
        for pod in members:
            pid = id(pod)
            old = ztokens_get(pid)
            if not old or (len(old) == 1 and old[0][0] == key):
                ztokens[pid] = tok
            else:
                self.set(pod, key, domain)

    def set_hostname_bulk(self, pods_and_names) -> None:
        """Assign hostname decisions for many (pod, name) pairs; hostname
        never contributes to zone tokens, so no token bookkeeping."""
        self.hostdecs.update((id(pod), name) for pod, name in pods_and_names)

    def items(self, pod: Pod) -> Optional[Dict[str, str]]:
        """This pod's decisions as a dict (fresh object), or None."""
        pid = id(pod)
        tok = self.ztokens.get(pid)
        host = self.hostdecs.get(pid)
        if not tok and host is None:
            return None
        d = dict(tok) if tok else {}
        if host is not None:
            d[lbl.HOSTNAME] = host
        return d

    def materialize(self, pods: List[Pod]) -> None:
        """Write decisions into the pods' nodeSelectors (always replacing
        the dict, never mutating in place, so snapshot/restore works)."""
        for p in pods:
            d = self.items(p)
            if d:
                p.spec.node_selector = {**p.spec.node_selector, **d}


class TopologyGroup:
    """Pods sharing one topology spread constraint, with per-domain skew
    counts (reference: topologygroup.go:22-68)."""

    def __init__(self, pod: Pod, constraint: TopologySpreadConstraint):
        self.constraint = constraint
        self.pods: List[Pod] = [pod]
        self.sts: List[PodStatics] = []
        self.spread: Dict[str, int] = {}

    def register(self, *domains: str) -> None:
        for d in domains:
            self.spread[d] = 0

    def increment(self, domain: str) -> None:
        if domain in self.spread:
            self.spread[domain] += 1

    def next_domain(self, allowed: Optional[Set[str]]) -> str:
        """Argmin over allowed registered domains (``None`` = all of them,
        no membership test); ties broken toward the later-iterated key like
        the reference's `<=` comparison."""
        min_domain = ""
        min_count = None
        for domain, count in self.spread.items():
            if allowed is not None and domain not in allowed:
                continue
            if min_count is None or count <= min_count:
                min_domain = domain
                min_count = count
        self.spread[min_domain] = self.spread.get(min_domain, 0) + 1
        return min_domain


class AffinityGroup:
    """Pods sharing one required pod (anti-)affinity term."""

    def __init__(self, namespace: str, term: PodAffinityTerm, anti: bool):
        self.namespace = namespace
        self.term = term
        self.anti = anti
        self.pods: List[Pod] = []
        self.sts: List[PodStatics] = []  # parallel to pods
        # domain -> number of pods matching the term's selector there
        self.match_counts: Dict[str, int] = {}
        self._namespaces = (
            set(term.namespaces) if term.namespaces else {namespace}
        )
        self._match_memo: Dict[Tuple, bool] = {}

    @property
    def key(self) -> str:
        return self.term.topology_key

    def match_flags(self, members) -> List[bool]:
        """``selector_matches`` over (pod, statics) pairs with the memo and
        namespace test hoisted — this runs O(pods) per group per solve."""
        sel = self.term.label_selector
        nss = self._namespaces
        if sel is None:
            return [p.metadata.namespace in nss for p, _ in members]
        memo = self._match_memo
        out = []
        append = out.append
        matches = sel.matches
        for pod, st in members:
            if pod.metadata.namespace not in nss:
                append(False)
                continue
            lk = st.labels_key
            hit = memo.get(lk)
            if hit is None:
                hit = memo[lk] = matches(pod.metadata.labels)
            append(hit)
        return out

    def selector_matches(self, pod: Pod, st: Optional[PodStatics] = None) -> bool:
        if pod.metadata.namespace not in self._namespaces:
            return False
        sel = self.term.label_selector
        if sel is None:
            return True
        # memoized by label set: a group's pods share few distinct label
        # maps, and this runs O(pods × groups) per solve
        lk = (st or statics(pod)).labels_key
        hit = self._match_memo.get(lk)
        if hit is None:
            hit = self._match_memo[lk] = sel.matches(pod.metadata.labels)
        return hit

    def namespaces(self) -> Set[str]:
        return self._namespaces


class Topology:
    def __init__(self, cluster: Cluster, rng: Optional[random.Random] = None):
        self.cluster = cluster
        self.rng = rng or random.Random()

    # -- public ------------------------------------------------------------
    def inject(self, constraints: Constraints, pods: List[Pod]) -> DomainPlan:
        """Legacy mutating form: compute the plan, then write each pod's
        chosen domains into its nodeSelector (reference: topology.go:41-57).
        Callers snapshot/restore selectors around solves."""
        plan = self.inject_plan(constraints, pods)
        plan.materialize(pods)
        return plan

    def inject_plan(
        self,
        constraints: Constraints,
        pods: List[Pod],
        sts: Optional[List[PodStatics]] = None,
    ) -> DomainPlan:
        """Compute a topology decision per pod WITHOUT mutating the pods.
        Affinity first — its choices narrow what spread sees — then host
        ports, then spread. Hostname domains are registered into the
        constraints' requirements. ``sts`` lets the caller share one
        statics pass across sort → inject → encode."""
        plan = DomainPlan(pods)
        if sts is None:
            sts = [statics(p) for p in pods]  # ONE statics pass for the solve
        plan.sts = sts
        generated_hostnames: List[str] = []
        # ONE discovery pass distributes pods into all three phase
        # structures (three separate 10k-pod scans were a third of inject)
        aff_groups: Dict[Tuple, AffinityGroup] = {}
        spread_groups: Dict[Tuple, TopologyGroup] = {}
        port_members: List[Tuple[Pod, PodStatics]] = []
        self._discover(pods, sts, aff_groups, spread_groups, port_members)
        self._inject_affinity(
            constraints, pods, list(aff_groups.values()), generated_hostnames, plan
        )
        self._inject_host_ports(port_members, generated_hostnames, plan)
        self._inject_spread(
            constraints, list(spread_groups.values()), generated_hostnames, plan
        )
        if generated_hostnames:
            # one registration for the union: per-group adds would intersect
            # per-key sets and empty the hostname domain
            constraints.requirements = constraints.requirements.add(
                NodeSelectorRequirement(
                    key=lbl.HOSTNAME, operator="In", values=generated_hostnames
                )
            )
        return plan

    # -- discovery ---------------------------------------------------------
    @staticmethod
    def _discover(pods, sts, aff_groups, spread_groups, port_members) -> None:
        """Distribute pods into affinity/spread/port structures. Large
        batches are bucketed by the statics-interned topology-class code and
        gathered with numpy — one C-level gather per (class, group) instead
        of 10k Python-level appends — preserving batch order within every
        group (stable argsort). Registry-overflow pods (code -1) ride the
        same bucketed pass as singleton entries at their batch positions so
        member order matches the per-pod (<512) path exactly."""
        n = len(pods)
        if n >= 512:
            import operator

            import numpy as np

            codes = np.fromiter(
                map(operator.attrgetter("topo_code"), sts), np.int64, count=n
            )
            if codes.any():
                order = np.argsort(codes, kind="stable")
                sorted_codes = codes[order]
                uniq, starts = np.unique(sorted_codes, return_index=True)
                bounds = list(starts.tolist()) + [n]
                # visit classes in order of FIRST APPEARANCE in the batch,
                # not registry-code order: group creation order decides
                # processing order downstream (stable anti-first sort), and
                # it must match the per-pod path / be independent of what
                # earlier solves registered
                first_pos = order[starts].tolist()
                aff_idx: Dict[Tuple, list] = {}
                spread_idx: Dict[Tuple, list] = {}
                port_idx: list = []
                # Registry-overflow pods (code -1) join the visit as
                # singleton entries at their own batch positions instead of
                # a trailing per-pod pass: once the class registry fills,
                # member order — which drives zone/hostname assignment —
                # must stay batch-interleaved exactly like the per-pod
                # (<512) path (ADVICE r4).
                entries: list = []
                for j in range(len(uniq)):
                    code = int(uniq[j])
                    if code == 0:
                        continue
                    idx = order[bounds[j]:bounds[j + 1]]
                    if code == -1:
                        entries.extend(
                            (int(i), idx[k:k + 1]) for k, i in enumerate(idx)
                        )
                    else:
                        entries.append((first_pos[j], idx))
                entries.sort(key=operator.itemgetter(0))
                for _, idx in entries:
                    rep = sts[int(idx[0])]
                    for key, term, anti in rep.aff_terms:
                        if key not in aff_groups:
                            aff_groups[key] = AffinityGroup(
                                pods[int(idx[0])].metadata.namespace, term, anti
                            )
                        aff_idx.setdefault(key, []).append(idx)
                    for key, constraint in rep.spreads:
                        if key not in spread_groups:
                            g = spread_groups[key] = TopologyGroup(
                                pods[int(idx[0])], constraint
                            )
                            g.pods.pop()  # ctor added the pod; gathered below
                        spread_idx.setdefault(key, []).append(idx)
                    if rep.host_ports:
                        port_idx.append(idx)

                def gather(target_pods, target_sts, idx_arrays):
                    idx = (
                        np.sort(np.concatenate(idx_arrays))
                        if len(idx_arrays) > 1
                        else idx_arrays[0]
                    ).tolist()
                    getter = operator.itemgetter(*idx)
                    if len(idx) == 1:
                        target_pods.append(getter(pods))
                        target_sts.append(getter(sts))
                    else:
                        target_pods.extend(getter(pods))
                        target_sts.extend(getter(sts))

                for key, arrays in aff_idx.items():
                    g = aff_groups[key]
                    gather(g.pods, g.sts, arrays)
                for key, arrays in spread_idx.items():
                    g = spread_groups[key]
                    gather(g.pods, g.sts, arrays)
                if port_idx:
                    idx = (
                        np.sort(np.concatenate(port_idx))
                        if len(port_idx) > 1
                        else port_idx[0]
                    ).tolist()
                    port_members.extend((pods[i], sts[i]) for i in idx)
                return
            return  # no pod in the batch has topology features
        # small batch: per-pod path
        aff_get = aff_groups.get
        spread_get = spread_groups.get
        for pod, st in zip(pods, sts):
            if not st.topo_any:
                continue
            if st.aff_terms:
                for key, term, anti in st.aff_terms:
                    g = aff_get(key)
                    if g is None:
                        g = aff_groups[key] = AffinityGroup(
                            pod.metadata.namespace, term, anti
                        )
                    g.pods.append(pod)
                    g.sts.append(st)
            if st.host_ports:
                port_members.append((pod, st))
            if st.spreads:
                for key, constraint in st.spreads:
                    g = spread_get(key)
                    if g is None:
                        g = spread_groups[key] = TopologyGroup(pod, constraint)
                        g.pods.pop()  # ctor added the pod; re-add with its st
                    g.pods.append(pod)
                    g.sts.append(st)

    # -- pod (anti-)affinity ----------------------------------------------
    def _inject_affinity(
        self,
        constraints: Constraints,
        pods: List[Pod],
        groups: List[AffinityGroup],
        generated_hostnames: List[str],
        plan: DomainPlan,
    ) -> None:
        if not groups:
            return
        batch = list(pods)
        # anti-affinity first: it is the more constrained rule (needs empty
        # domains), and affinity groups can then adopt whatever domains the
        # anti pass pinned instead of greedily seeding a conflicting one
        groups.sort(key=lambda g: not g.anti)
        for group in groups:
            if group.key == lbl.TOPOLOGY_ZONE:
                self._assign_zonal_affinity(constraints, group, batch, plan)
            elif group.key == lbl.HOSTNAME:
                self._assign_hostname_affinity(group, batch, generated_hostnames, plan)

    def _affinity_groups(
        self, pods: List[Pod], sts: Optional[List[PodStatics]] = None
    ) -> List[AffinityGroup]:
        if sts is None:
            sts = [statics(p) for p in pods]
        groups: Dict[Tuple, AffinityGroup] = {}
        for pod, st in zip(pods, sts):
            for key, term, anti in st.aff_terms:
                group = groups.get(key)
                if group is None:
                    group = groups[key] = AffinityGroup(pod.metadata.namespace, term, anti)
                group.pods.append(pod)
                group.sts.append(st)
        return list(groups.values())

    def _count_cluster_matches(self, group: AffinityGroup) -> None:
        """Seed match counts from scheduled cluster pods, keyed by their
        node's topology domain."""
        for namespace in group.namespaces():
            for p in self.cluster.list_pods_matching(namespace, group.term.label_selector):
                if ignored_for_topology(p):
                    continue
                node = self.cluster.try_get("nodes", p.spec.node_name, namespace="")
                if node is None:
                    continue
                domain = node.metadata.labels.get(group.key)
                if domain is not None:
                    group.match_counts[domain] = group.match_counts.get(domain, 0) + 1

    @staticmethod
    def _narrowed(
        st: PodStatics, pin: Optional[str], key: str, domains: Set[str]
    ) -> Optional[Set[str]]:
        """The subset of ``domains`` this pod may take — or ``None`` meaning
        "all of them" (the overwhelmingly common case, returned without
        copying the domain set). ``pin`` is a domain an earlier injection
        pass already chose (the plan-aware form of re-reading the mutated
        selector); ``domains`` is already constraint-viable, so only the
        pod's OWN narrowing needs checking."""
        entries = st.key_entries.get(key)
        if pin is None and not entries:
            return None
        out = set()
        for d in domains:
            if pin is not None and d != pin:
                continue
            if entries and not satisfies(entries, d):
                continue
            out.add(d)
        return out

    @staticmethod
    def _allowed_domains(
        pod: Pod, key: str, domains: Set[str], plan: DomainPlan
    ) -> Set[str]:
        """Compat form of ``_narrowed`` returning a real set (oracle and
        slow paths)."""
        out = Topology._narrowed(
            statics(pod), plan.decision(pod, key), key, domains
        )
        return set(domains) if out is None else out

    def _assign_zonal_affinity(
        self,
        constraints: Constraints,
        group: AffinityGroup,
        batch: List[Pod],
        plan: DomainPlan,
    ) -> None:
        self._count_cluster_matches(group)
        viable = constraints.requirements.zones()
        key = group.key
        members = list(zip(group.pods, group.sts))
        # bulk fast path: no member is narrowed by its own spec and none is
        # pinned by an earlier pass — the per-pod loops then degenerate to a
        # handful of distinct domains stamped across the whole group (the
        # overwhelmingly common shape: template pods with pod-affinity only)
        unrestricted = _group_unrestricted(key, group.pods, group.sts, plan)
        if unrestricted and group.anti:
            flags = group.match_flags(members)
            n_match = sum(flags)
            clean = sorted(d for d in viable if group.match_counts.get(d, 0) == 0)
            # one clean zone is reserved for the non-matching cohort (see the
            # general path below for the rationale); with no narrowing the
            # reservation choice is simply the first clean zone
            reserved = clean[0] if (n_match and n_match < len(flags) and clean) else None
            free_list = [d for d in clean if d != reserved]
            matching_pods = [p for (p, _), m in zip(members, flags) if m]
            # matchers claim one free zone each; beyond the free zones they
            # are provably unplaceable
            placed = matching_pods[: len(free_list)]
            for d, pod in zip(free_list, placed):
                group.match_counts[d] = 1
                plan.set_zone_bulk((pod,), key, d)
            if len(matching_pods) > len(placed):
                plan.set_zone_bulk(matching_pods[len(placed):], key, UNSATISFIABLE_DOMAIN)
            if n_match < len(flags):
                free_nm = sorted(
                    d for d in viable if group.match_counts.get(d, 0) == 0
                )
                shared_nm = free_nm[0] if free_nm else UNSATISFIABLE_DOMAIN
                plan.set_zone_bulk(
                    [p for (p, _), m in zip(members, flags) if not m], key, shared_nm
                )
            return
        if unrestricted and not group.anti and members:
            # resolve the FIRST member through the general logic (it may
            # seed a domain via a batch provider); every later unrestricted
            # member then picks the populated argmax, which placing there
            # only strengthens — so the rest of the group lands on one
            # domain computed once
            self._assign_zonal_affinity_general(
                constraints, group, batch, plan, [members[0]], viable, key
            )
            rest = members[1:]
            if not rest:
                return
            populated = sorted(
                (d for d in viable if group.match_counts.get(d, 0) > 0),
                key=lambda d: (-group.match_counts[d], d),
            )
            if populated:
                # match_counts is not updated for the bulk members: the
                # group is complete after this write and nothing reads the
                # counts afterwards (cross-group state flows via plan pins)
                plan.set_zone_bulk([p for p, _ in rest], key, populated[0])
            else:
                # first member resolved unsatisfiable with no counts: no
                # provider exists for the whole group
                plan.set_zone_bulk([p for p, _ in rest], key, UNSATISFIABLE_DOMAIN)
            return
        self._assign_zonal_affinity_general(
            constraints, group, batch, plan, members, viable, key
        )

    def _assign_zonal_affinity_general(
        self,
        constraints: Constraints,
        group: AffinityGroup,
        batch: List[Pod],
        plan: DomainPlan,
        members,
        viable,
        key: str,
        pins=None,
    ) -> None:
        if pins is None:
            pins = [plan.decision(p, key) for p, _ in members]
        if group.anti:
            # Selector-matching members claim a zone each (pairwise
            # separation); non-matching members only need SOME zone free of
            # matchers. Placing a matcher in every clean zone would strand
            # the whole non-matching cohort — trading one matcher for N
            # non-matchers is never a win — so one clean zone is reserved
            # for them. This keeps drops to the provable minimum:
            # max(m - (clean - 1), 0) matchers (see scheduling/oracle.py).
            flags = group.match_flags(members)
            matching = [
                (p, st, pin)
                for ((p, st), pin), m in zip(zip(members, pins), flags)
                if m
            ]
            nonmatching = [
                (p, st, pin)
                for ((p, st), pin), m in zip(zip(members, pins), flags)
                if not m
            ]
            reserved: Optional[str] = None
            if nonmatching and matching:
                clean = sorted(
                    d for d in viable if group.match_counts.get(d, 0) == 0
                )
                # reserve the clean zone usable by the most non-matchers;
                # break ties toward the zone the fewest matchers are pinned
                # to — reserving a matcher's only allowed zone would drop a
                # placeable matcher
                matcher_allowed = [
                    self._narrowed(st, pin, key, viable)
                    for _, st, pin in matching
                ]
                best = None
                for d in clean:
                    n_ok = sum(
                        1
                        for _, st, pin in nonmatching
                        if self._narrowed(st, pin, key, {d}) in (None, {d})
                    )
                    m_only = sum(1 for a in matcher_allowed if a == {d})
                    if n_ok and (best is None or (n_ok, -m_only) > (best[0], -best[1])):
                        best = (n_ok, m_only, d)
                if best is not None:
                    reserved = best[2]
            # amortized claim: unrestricted matchers take zones off one
            # shared sorted free list instead of re-sorting per pod
            free_list = sorted(
                d for d in viable
                if group.match_counts.get(d, 0) == 0 and d != reserved
            )
            for pod, st, pin in matching:
                allowed = self._narrowed(st, pin, key, viable)
                if allowed is None:
                    domain = free_list[0] if free_list else UNSATISFIABLE_DOMAIN
                else:
                    free = sorted(
                        d
                        for d in allowed
                        if group.match_counts.get(d, 0) == 0 and d != reserved
                    )
                    domain = free[0] if free else UNSATISFIABLE_DOMAIN
                plan.set(pod, key, domain)
                if domain != UNSATISFIABLE_DOMAIN:
                    group.match_counts[domain] = group.match_counts.get(domain, 0) + 1
                    if free_list and free_list[0] == domain:
                        free_list.pop(0)
                    elif domain in free_list:
                        free_list.remove(domain)
            # non-matchers never increment counts, so they all resolve to
            # the same first free zone — computed once for the unrestricted
            free_nm = sorted(d for d in viable if group.match_counts.get(d, 0) == 0)
            shared_nm = free_nm[0] if free_nm else UNSATISFIABLE_DOMAIN
            for pod, st, pin in nonmatching:
                allowed = self._narrowed(st, pin, key, viable)
                if allowed is None:
                    domain = shared_nm
                else:
                    free = sorted(d for d in allowed if group.match_counts.get(d, 0) == 0)
                    domain = free[0] if free else UNSATISFIABLE_DOMAIN
                plan.set(pod, key, domain)
            return
        # affinity: most-populated existing domain, else a seed the group
        # itself (or a batch provider) will populate. The argmax is
        # recomputed only when the counts' argmax can change (a provider
        # seed or a first placement), not per pod.
        populated_domain: Optional[str] = None
        populated_dirty = True
        for pod, st in members:
            # the pin must be read LIVE, not from the pre-loop snapshot: a
            # provider seeded earlier in THIS loop (plan.set below) must see
            # its own pin when its iteration comes, or it gets re-assigned
            # away from the consumer that adopted it
            pin = plan.decision(pod, key)
            allowed = self._narrowed(st, pin, key, viable)
            if populated_dirty:
                populated = sorted(
                    (d for d in viable if group.match_counts.get(d, 0) > 0),
                    key=lambda d: (-group.match_counts[d], d),
                )
                populated_domain = populated[0] if populated else None
                populated_dirty = False
            if allowed is None and populated_domain is not None:
                # placing here only strengthens the argmax — no recompute
                domain = populated_domain
            elif allowed is not None and any(
                group.match_counts.get(d, 0) > 0 for d in allowed
            ):
                # narrowed pod: argmax over ITS allowed populated domains
                acceptable = sorted(
                    (d for d in allowed if group.match_counts.get(d, 0) > 0),
                    key=lambda d: (-group.match_counts[d], d),
                )
                domain = acceptable[0]
            else:
                provider, pinned = self._batch_provider(group, batch, plan)
                if provider is None or (allowed is not None and not allowed):
                    domain = UNSATISFIABLE_DOMAIN
                elif pinned is not None:
                    # adopt the provider's already-pinned domain if this pod
                    # may go there; else unsatisfiable
                    domain = (
                        pinned
                        if (allowed is None or pinned in allowed) and pinned in viable
                        else UNSATISFIABLE_DOMAIN
                    )
                else:
                    # seed a domain BOTH the consumer and the provider may
                    # use — pinning the provider outside its own node
                    # affinity would render it unschedulable
                    provider_allowed = self._allowed_domains(
                        provider, key, viable, plan
                    )
                    joint = sorted(
                        (viable if allowed is None else allowed) & provider_allowed
                    )
                    domain = joint[0] if joint else UNSATISFIABLE_DOMAIN
                if domain != UNSATISFIABLE_DOMAIN and provider is not pod:
                    # ensure the provider actually lands there
                    plan.set(provider, key, domain)
                    if group.selector_matches(provider):
                        group.match_counts[domain] = group.match_counts.get(domain, 0) + 1
                        populated_dirty = True
            plan.set(pod, key, domain)
            if domain != UNSATISFIABLE_DOMAIN and group.selector_matches(pod, st):
                group.match_counts[domain] = group.match_counts.get(domain, 0) + 1
                if domain != populated_domain:
                    populated_dirty = True

    def _assign_hostname_affinity(
        self,
        group: AffinityGroup,
        batch: List[Pod],
        generated_hostnames: List[str],
        plan: DomainPlan,
    ) -> None:
        if group.anti:
            # pairwise separation: a fresh node per selector-matching
            # member; non-matchers only avoid the providers and share one.
            # Names are drawn in one batched rng call.
            flags = group.match_flags(list(zip(group.pods, group.sts)))
            n_match = sum(flags)
            fresh = self._fresh_hostnames(
                n_match + (1 if n_match < len(flags) else 0), generated_hostnames
            )
            shared_for_nonmatching = fresh[n_match] if n_match < len(flags) else None
            it = iter(fresh)
            plan.set_hostname_bulk(
                (pod, next(it) if matched else shared_for_nonmatching)
                for pod, matched in zip(group.pods, flags)
            )
            return
        # affinity: the whole group lands on one fresh node, provided the
        # match can come from the group itself or another batch pod
        provider, pinned = self._batch_provider(group, batch, plan)
        if provider is None:
            for pod in group.pods:
                _mark_unschedulable(pod, plan)
            return
        shared = pinned if pinned is not None else self._fresh_hostname(generated_hostnames)
        plan.set(provider, group.key, shared)
        plan.set_hostname_bulk((pod, shared) for pod in group.pods)

    @staticmethod
    def _batch_provider(
        group: AffinityGroup, batch: List[Pod], plan: DomainPlan
    ) -> Tuple[Optional[Pod], Optional[str]]:
        """A batch pod that satisfies the group's selector — preferring group
        members (self-affinity), then unpinned batch pods, then batch pods
        already pinned to a domain (returned so the group can adopt it)."""
        pinned_candidate: Optional[Pod] = None
        for pod in group.pods:
            if group.selector_matches(pod):
                return pod, plan.get(pod, group.key)
        for pod in batch:
            if not group.selector_matches(pod):
                continue
            pinned = plan.get(pod, group.key)
            if pinned is None:
                return pod, None
            if pinned_candidate is None:
                pinned_candidate = pod
        if pinned_candidate is not None:
            return pinned_candidate, plan.get(pinned_candidate, group.key)
        return None, None

    def _fresh_hostname(self, generated_hostnames: List[str]) -> str:
        # 40 random bits as hex text: same entropy class as the old 8-char
        # alphanumeric draw at ~1/4 the cost (a host-spread batch generates
        # thousands of these per solve)
        name = f"h{self.rng.getrandbits(40):010x}"
        generated_hostnames.append(name)
        return name

    def _fresh_hostnames(self, n: int, generated_hostnames: List[str]) -> List[str]:
        """n fresh hostnames from ONE rng draw (one 40n-bit integer sliced
        into 10-hex-char chunks) — per-call rng overhead dominated the
        anti-affinity hostname loops at thousands of names per solve."""
        if n <= 0:
            return []
        blob = f"{self.rng.getrandbits(40 * n):0{10 * n}x}"
        names = [f"h{blob[10 * k:10 * (k + 1)]}" for k in range(n)]
        generated_hostnames.extend(names)
        return names

    # -- host ports --------------------------------------------------------
    def _inject_host_ports(
        self,
        port_members: List[Tuple[Pod, PodStatics]],
        generated_hostnames: List[str],
        plan: DomainPlan,
    ) -> None:
        """Host-port claims are per-node mutable state the tensor encoding
        does not carry, so they become hostname pre-assignments like
        anti-affinity: port-claiming pods are bucketed onto fresh hostnames
        such that no bucket holds conflicting claims; pods whose other
        selectors differ never share a bucket (a merged bucket must stay
        jointly feasible). Pods already hostname-pinned (by affinity) keep
        their pin; a conflict inside one pin is unsatisfiable."""
        buckets: List[Tuple[str, set, Tuple]] = []  # (hostname, claims, selector key)
        pinned_claims: Dict[str, set] = {}
        for pod, st in port_members:
            claims = st.host_ports
            pinned = _pinned_hostname(pod, plan, st)
            if pinned is not None:
                existing = pinned_claims.setdefault(pinned, set())
                if podutil.host_ports_conflict(claims, existing):
                    _mark_unschedulable(pod, plan)
                else:
                    existing |= claims
                continue
            dec = plan.items(pod)
            selector_key = tuple(
                sorted(({**dict(st.sel_raw), **dec} if dec else dict(st.sel_raw)).items())
            )
            placed = False
            for hostname, bucket_claims, bucket_key in buckets:
                if bucket_key != selector_key:
                    continue
                if podutil.host_ports_conflict(claims, bucket_claims):
                    continue
                bucket_claims |= claims
                plan.set(pod, lbl.HOSTNAME, hostname)
                placed = True
                break
            if not placed:
                hostname = self._fresh_hostname(generated_hostnames)
                buckets.append((hostname, set(claims), selector_key))
                plan.set(pod, lbl.HOSTNAME, hostname)

    # -- topology spread ---------------------------------------------------
    def _inject_spread(
        self,
        constraints: Constraints,
        groups: List[TopologyGroup],
        generated_hostnames: List[str],
        plan: DomainPlan,
    ) -> None:
        # hostname-spread groups draw their fresh domains from one shared
        # pool: spread only constrains skew WITHIN a group, so different
        # groups may deliberately overlap on the same hostnames and the
        # packer co-locates them when resources allow — materially fewer
        # nodes than private per-group domains. Affinity/anti-affinity/port
        # hostnames stay private (a spread pod could match their selectors).
        hostname_pool: List[str] = []
        for group in groups:
            self._compute_current_topology(
                constraints, group, generated_hostnames, hostname_pool, plan
            )
            key = group.constraint.topology_key
            if key == lbl.HOSTNAME and not any(
                _pod_constrains(p, lbl.HOSTNAME, plan, st)
                for p, st in zip(group.pods, group.sts)
            ):
                # fast path: all-fresh domains, zero seed counts, no pinned
                # pods → min-count assignment degenerates to round-robin
                # (the general path is O(pods × domains) = O(n²/maxSkew)).
                # Inlined plan writes: hostname decisions never touch zone
                # tokens, and this loop runs for thousands of pods per solve
                domains = list(group.spread)  # pool order → cross-group overlap
                n_dom = len(domains)
                n_mem = len(group.pods)
                assigned = [domains[j % n_dom] for j in range(n_mem)]
                plan.hostdecs.update(zip(map(id, group.pods), assigned))
                for j in range(min(n_dom, n_mem)):
                    # members j, j+n_dom, j+2*n_dom, ... landed on domains[j]
                    group.spread[domains[j]] += (n_mem - j + n_dom - 1) // n_dom
                continue
            registered = group.spread.keys()
            soft = group.constraint.when_unsatisfiable == "ScheduleAnyway"
            narrowed = self._narrowed
            decision = plan.decision
            next_domain = group.next_domain
            is_hostname = key == lbl.HOSTNAME
            ztokens = plan.ztokens
            hostdecs = plan.hostdecs
            if not is_hostname and registered:
                # bulk fast path: no member narrowed by its own spec and
                # none pinned by an earlier pass — the per-pod argmin over
                # counts (ties toward the later-iterated key, matching
                # next_domain's <=) becomes a tight water-filling sim with
                # one bulk write per domain
                if _group_unrestricted(key, group.pods, group.sts, plan):
                    doms = list(registered)
                    counts = [group.spread[d] for d in doms]
                    nd = len(doms)
                    by_dom: List[List[Pod]] = [[] for _ in range(nd)]
                    for pod in group.pods:
                        m_i = 0
                        m_c = counts[0]
                        for j in range(1, nd):
                            if counts[j] <= m_c:
                                m_i = j
                                m_c = counts[j]
                        counts[m_i] += 1
                        by_dom[m_i].append(pod)
                    for j, members in enumerate(by_dom):
                        group.spread[doms[j]] = counts[j]
                        if members:
                            plan.set_zone_bulk(members, key, doms[j])
                    continue
            tok_cache: Dict[str, Tuple] = {}
            for pod, st in zip(group.pods, group.sts):
                # the pod's own requirements may narrow the registered
                # domains; registered domains are already constraint-viable
                allowed = narrowed(st, decision(pod, key), key, registered)
                if is_hostname:
                    pinned = plan.get(pod, lbl.HOSTNAME)
                    if pinned is not None:
                        allowed = (
                            {pinned}
                            if allowed is None
                            else (allowed & {pinned})
                        )
                if allowed is not None and not allowed:
                    # the pod's own narrowing excludes every registered
                    # domain. ScheduleAnyway is a SOFT constraint
                    # (reference: 'should violate max-skew when unsat =
                    # schedule anyway'): leave the pod unconstrained by this
                    # spread and let it schedule. DoNotSchedule falls
                    # through to next_domain's empty pick ("" — no offering
                    # provides it), keeping the pod visibly unschedulable.
                    if soft:
                        continue
                domain = next_domain(allowed)
                # inlined plan.set with eager token stamping: zone-spread
                # batches run this for thousands of pods per solve
                pid = id(pod)
                if is_hostname:
                    hostdecs[pid] = domain
                    continue
                old = ztokens.get(pid)
                if not old or (len(old) == 1 and old[0][0] == key):
                    tok = tok_cache.get(domain)
                    if tok is None:
                        tok = tok_cache[domain] = DomainPlan.intern_token(key, domain)
                    ztokens[pid] = tok
                else:
                    plan.set(pod, key, domain)

    def _topology_groups(
        self, pods: List[Pod], sts: Optional[List[PodStatics]] = None
    ) -> List[TopologyGroup]:
        if sts is None:
            sts = [statics(p) for p in pods]
        groups: Dict[Tuple, TopologyGroup] = {}
        for pod, st in zip(pods, sts):
            for key, constraint in st.spreads:
                g = groups.get(key)
                if g is None:
                    g = groups[key] = TopologyGroup(pod, constraint)
                    g.pods.pop()  # ctor added the pod; re-add with its st
                g.pods.append(pod)
                g.sts.append(st)
        return list(groups.values())

    def _compute_current_topology(
        self,
        constraints: Constraints,
        group: TopologyGroup,
        generated_hostnames: List[str],
        hostname_pool: List[str],
        plan: DomainPlan,
    ) -> None:
        key = group.constraint.topology_key
        if key == lbl.HOSTNAME:
            self._compute_hostname_topology(group, generated_hostnames, hostname_pool, plan)
        elif key == lbl.TOPOLOGY_ZONE:
            self._compute_zonal_topology(constraints, group)

    def _compute_hostname_topology(
        self,
        group: TopologyGroup,
        generated_hostnames: List[str],
        hostname_pool: List[str],
        plan: DomainPlan,
    ) -> None:
        """Fresh nodes are empty, so the global hostname minimum is 0; we
        register ceil(n/maxSkew) domains — drawn from the shared pool so
        groups overlap — and skew cannot be violated
        (reference: topology.go:98-112)."""
        n_domains = math.ceil(len(group.pods) / max(group.constraint.max_skew, 1))
        if len(hostname_pool) < n_domains:
            hostname_pool.extend(
                self._fresh_hostnames(
                    n_domains - len(hostname_pool), generated_hostnames
                )
            )
        # pods already pinned to a hostname by affinity participate with that
        # hostname as a registered domain
        for pod in group.pods:
            pinned = plan.get(pod, lbl.HOSTNAME)
            if pinned is not None:
                group.register(pinned)
        group.register(*hostname_pool[:n_domains])

    def _compute_zonal_topology(self, constraints: Constraints, group: TopologyGroup) -> None:
        """Viable zones become the domains; existing matching cluster pods
        seed the skew counts (reference: topology.go:119-127)."""
        group.register(*constraints.requirements.zones())
        self._count_matching_pods(group)

    def _count_matching_pods(self, group: TopologyGroup) -> None:
        namespace = group.pods[0].metadata.namespace
        for p in self.cluster.list_pods_matching(namespace, group.constraint.label_selector):
            if ignored_for_topology(p):
                continue
            node = self.cluster.try_get("nodes", p.spec.node_name, namespace="")
            if node is None:
                continue
            domain = node.metadata.labels.get(group.constraint.topology_key)
            if domain is not None:
                group.increment(domain)


def snapshot_selectors(pods: List[Pod]) -> List[Dict[str, str]]:
    """The pods' nodeSelector dicts before materialization. Materialization
    always replaces the dict (never mutates in place), so restoring the
    original references undoes every injected decision — solving must not
    leave stale domain pins on live pod objects (a retried pod would drag
    its previous round's hostname/zone into the next solve)."""
    return [p.spec.node_selector for p in pods]


def restore_selectors(pods: List[Pod], saved: List[Dict[str, str]]) -> None:
    for p, s in zip(pods, saved):
        p.spec.node_selector = s


def _group_unrestricted(key: str, pods, sts, plan: DomainPlan) -> bool:
    """The bulk fast paths' shared gate: no member's own spec narrows
    ``key`` and no member carries a prior injected decision on it. MUST
    stay in sync with ``_narrowed``'s inputs — key_entries plus the
    plan's non-hostname decisions (zone tokens)."""
    if any(key in st.key_entries for st in sts):
        return False
    ztokens_get = plan.ztokens.get
    return not any(
        (tok := ztokens_get(id(p))) and any(k == key for k, _ in tok)
        for p in pods
    )


def _pinned_hostname(
    pod: Pod, plan: DomainPlan, st: Optional[PodStatics] = None
) -> Optional[str]:
    """The hostname the pod is already pinned to — by an injected decision,
    its own nodeSelector, or its own required node affinity."""
    pinned = plan.get(pod, lbl.HOSTNAME)
    if pinned is not None:
        return pinned
    return (st or statics(pod)).pinned_aff_hostname


def _pod_constrains(
    pod: Pod, key: str, plan: DomainPlan, st: Optional[PodStatics] = None
) -> bool:
    """Does the pod's own spec — or an earlier injection pass — narrow this
    topology key? Cheap pre-check gating the spread fast path."""
    if plan.decision(pod, key) is not None:
        return True
    return key in (st or statics(pod)).constrains


def _mark_unschedulable(pod: Pod, plan: DomainPlan) -> None:
    """Pin the pod to a zone no offering can provide: zone feasibility is
    enforced by the instance-type offering filter for every catalog, unlike
    hostname, so this reliably drops (and logs) the pod at pack time."""
    plan.set(pod, lbl.TOPOLOGY_ZONE, UNSATISFIABLE_DOMAIN)


def ignored_for_topology(p: Pod) -> bool:
    return not podutil.is_scheduled(p) or podutil.is_terminal(p) or podutil.is_terminating(p)
