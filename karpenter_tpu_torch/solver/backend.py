"""TorchScheduler: the GPU-backed solve path.

Same contract as ``FFDScheduler.solve``: sort, inject topology, encode to
dense arrays, run the packing kernel, decode virtual nodes, validate them.
Stage order and profile keys follow the reference package's ``solver: tpu``
backend:

    sort → inject → encode → pack (begin) → fetch → split_fused → decode → validate

The pack runs through one fused dispatch (one compact upload, one kernel,
one flat buffer back), routed by the batch's shapes: ``fused.fused_solve``
over ``pack_first_fit`` (route ``v1``), or, for constraint-diverse batches
whose per-core join tables fit the card's budget, ``fused.fused_solve_v2``
over ``pack_first_fit_v2`` (route ``v2``; ``pack_kernel_v2.fused_route``).
The node table starts at ``min(P, 512)`` slots and, when it saturates with
pods left unscheduled, the solve retries once at ``P`` slots.

Begin launches the work, queues a ``non_blocking`` copy of the result
buffer into pinned host memory and records a CUDA event; finish waits on
that event. A constraint diversity past the signature closure cap
(``SignatureOverflow``), a kernel failure and a plan that fails validation
all raise; nothing falls back to another kernel or to the CPU.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.ffd import (
    VirtualNode,
    daemon_overhead,
    sort_pods_ffd_with_statics,
)
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.solver import fused
from karpenter_tpu_torch.solver import pack_kernel_v2
from karpenter_tpu_torch.solver.signature import SignatureOverflow
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("karpenter.solver")

# first node-table size; a saturated table retries at P slots
N_MAX_FIRST = 512

# kernel name per route: (on the card, plain version on the CPU)
KERNELS = {
    "v1": ("pack_first_fit", "pack_reference"),
    "v2": ("pack_first_fit_v2", "pack_v2_reference"),
}


def kernel_name(route: str, device: torch.device) -> str:
    """The kernel a route runs on ``device``: the CUDA kernel on the card,
    its plain version on the CPU."""
    on_card, plain = KERNELS[route]
    return on_card if device.type == "cuda" else plain


class InvalidPackError(RuntimeError):
    """A decoded plan broke a host-checked invariant."""


def _with_hostname(reqs, hostname: str, cache: dict):
    """``reqs.add(NodeSelectorRequirement(HOSTNAME, In, [hostname]))`` with
    the signature-invariant parts (requirements tuple, sorted sets minus the
    hostname entry, the hostname key's position and prior ValueSet) computed
    once per signature — decode runs this for every hostname-pinned node."""
    from karpenter_tpu_torch.api.requirements import Requirements
    from karpenter_tpu_torch.utils.sets import ValueSet

    hit = cache.get(id(reqs))
    if hit is None:
        items = list(reqs._sets)
        host_pos = None
        base_set = None
        for pos, (k, vs) in enumerate(items):
            if k == lbl.HOSTNAME:
                host_pos = pos
                base_set = vs
                break
        if host_pos is None:
            # insertion point that keeps the items key-sorted
            host_pos = sum(1 for k, _ in items if k < lbl.HOSTNAME)
        hit = cache[id(reqs)] = (reqs, reqs.requirements, items, host_pos, base_set)
    _, base_reqs, items, host_pos, base_set = hit
    vs = ValueSet.of(hostname)
    if base_set is not None:
        vs = vs.intersection(base_set)
        out_items = list(items)
        out_items[host_pos] = (lbl.HOSTNAME, vs)
    else:
        out_items = list(items)
        out_items.insert(host_pos, (lbl.HOSTNAME, vs))
    req = NodeSelectorRequirement(
        key=lbl.HOSTNAME, operator="In", values=[hostname]
    )
    return Requirements(base_reqs + (req,), tuple(out_items))


class TorchScheduler:
    def __init__(
        self,
        cluster: Cluster,
        rng: Optional[random.Random] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cluster = cluster
        self.topology = Topology(cluster, rng=rng)
        # solve-invariant encode state (signature table, capacity matrix),
        # reused across this scheduler's batches
        self._encode_cache = enc.EncodeCache()
        self._invariants = fused.DeviceInvariants(self.device)
        # per-stage timings of the most recent solve
        self.last_profile: Dict[str, float] = {}

    def solve(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        pods: Sequence[Pod],
    ) -> List[VirtualNode]:
        if not pods:
            return []
        prof: Dict[str, float] = {}
        self.last_profile = prof
        t0 = time.perf_counter()
        constraints = constraints.clone()
        pods, sts = sort_pods_ffd_with_statics(pods)
        instance_types = sorted(instance_types, key=lambda it: it.effective_price())
        prof["sort_s"] = time.perf_counter() - t0

        # topology decisions land in the plan, never in the pods' selectors
        t0 = time.perf_counter()
        plan = self.topology.inject_plan(constraints, pods, sts=sts)
        daemon = daemon_overhead(self.cluster, constraints)
        prof["inject_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        batch = self._encode_retry(constraints, instance_types, pods, daemon, plan)
        prof["encode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        result, typemask = self._pack(batch, prof)
        prof["pack_fetch_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        nodes = self._decode(batch, result, typemask, constraints, instance_types)
        prof["decode_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        violation = self._validate_pack(nodes, pods, daemon)
        prof["validate_s"] = time.perf_counter() - t0
        if violation:
            raise InvalidPackError(
                f"{prof['packer_backend']} produced an invalid plan: {violation}"
            )
        return nodes

    def _encode_retry(self, constraints, instance_types, pods, daemon, plan) -> enc.EncodedBatch:
        """Encode with the reusable cache; a cached table accumulates
        signatures across batches, so an overflow may be an accumulation
        artifact — drop the cache and retry fresh. A second overflow means
        the batch itself is too diverse, and raises."""
        try:
            return enc.encode(
                constraints, instance_types, pods, daemon, cache=self._encode_cache,
                plan=plan,
            )
        except SignatureOverflow:
            self._encode_cache.clear()
            return enc.encode(
                constraints, instance_types, pods, daemon, cache=self._encode_cache,
                plan=plan,
            )

    def _pack(self, batch: enc.EncodedBatch, prof: Dict) -> tuple:
        """Small table first, one retry at P slots on saturation. Returns
        (PackResult, typemask) over host numpy arrays."""
        if not fused.ids_fit(batch):
            raise ValueError(
                "batch ids exceed the compact int16 pod table "
                f"({len(batch.hostnames)} hostnames, {len(batch.cores)} cores)"
            )
        p = len(batch.pod_valid)
        n_max = min(p, N_MAX_FIRST)
        prof["pack_dispatches"] = 0
        while True:
            route = self._fused_route(batch)  # re-derived for the retry
            prof["pack_dispatches"] += 1
            prof["packer_backend"] = kernel_name(route, self.device)
            finish = self._pack_begin(batch, n_max, route)
            result, typemask = finish()
            saturated = int(result.n_nodes) == n_max and bool(
                (np.asarray(result.assignment)[: batch.n_pods] < 0).any()
            )
            if not saturated or n_max >= p:
                return result, typemask
            n_max = p

    @staticmethod
    def _fused_route(batch: enc.EncodedBatch) -> str:
        """``"v1"`` or ``"v2"`` for this batch. The reference's gate also
        weighs the node-table size (its v2 kernel keeps a one-hot
        ``[S, n_max]`` state in VMEM); the card's weighs only the per-core
        tables, so both table sizes of one batch take the same route."""
        S, F, R = batch.frontiers.shape
        return pack_kernel_v2.fused_route(S, F, R, batch.join_table.shape[1])

    def _pack_begin(self, batch: enc.EncodedBatch, n_max: int, route: str):
        """Launch one fused solve on ``route`` and return ``finish()``,
        which blocks until its buffer is on the host and splits it."""
        dev = self.device
        tab, open_by_core, bhh = fused.pack_pod_table(batch)
        uniq = fused.pad_uniq_req(batch.uniq_req)
        pod_side = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)
            for a in (tab, open_by_core, bhh, uniq)
        )
        if route == "v2":
            F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
            buf = fused.fused_solve_v2(
                *pod_side, *self._invariants.get_v2(batch), n_max=n_max, F=F, R=R
            )
        else:
            buf = fused.fused_solve(*pod_side, *self._invariants.get(batch), n_max=n_max)
        if dev.type == "cuda":
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        else:
            host, done = buf, None

        def finish():
            if done is not None:
                done.synchronize()
            return fused.split_fused(
                host.numpy(), len(batch.pod_valid), n_max,
                batch.usable.shape[1], batch.usable.shape[0],
            )

        return finish

    @staticmethod
    def _validate_pack(nodes, pods, daemon) -> Optional[str]:
        """Host-verified invariants of a decoded plan: every pod placed at
        most once, every placed pod from THIS batch, and every node's
        recomputed totals (pod requests + daemon overhead) fit at least one
        of its surviving instance types. Returns a description of the first
        violation, or None."""
        batch_keys = {p.key for p in pods}
        seen: set = set()
        for i, node in enumerate(nodes):
            for pod in node.pods:
                if pod.key in seen:
                    return f"pod {pod.key} assigned to more than one node"
                if pod.key not in batch_keys:
                    return f"pod {pod.key} not part of this batch"
                seen.add(pod.key)
            if not node.instance_type_options:
                return f"node {i} has no surviving instance type"
            totals = res.merge(
                daemon, *[res.requests_for_pods(p) for p in node.pods]
            )
            if not any(
                res.fits(totals, it.resources)
                for it in node.instance_type_options
            ):
                return (
                    f"node {i} capacity exceeded: {res.to_string(totals)} "
                    "fits none of its surviving instance types"
                )
        return None

    def _decode(
        self,
        batch: enc.EncodedBatch,
        result,
        typemask,  # [N, T] bool from the fused solve
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
    ) -> List[VirtualNode]:
        assignment, node_sig, node_host, node_req, n_nodes_arr = result
        assignment = assignment[: batch.n_pods]
        n_nodes = int(np.asarray(n_nodes_arr).reshape(-1)[0])

        unschedulable = int((assignment < 0).sum())
        if unschedulable:
            logger.error("Failed to schedule %d pods", unschedulable)

        # group pods per node (order-preserving, like FFD append order);
        # indices ≥ n_nodes are outside the kernel contract and skipped
        a = np.asarray(assignment)
        valid_idx = np.flatnonzero((a >= 0) & (a < n_nodes))
        order = valid_idx[np.argsort(a[valid_idx], kind="stable")]
        groups, starts = np.unique(a[order], return_index=True)
        bounds = np.append(starts, len(order)).tolist()
        order_l = order.tolist()
        batch_pods = batch.pods
        pods_by_node: Dict[int, List[Pod]] = {
            int(g): [batch_pods[i] for i in order_l[bounds[k]:bounds[k + 1]]]
            for k, g in enumerate(groups)
        }
        live = sorted(pods_by_node)
        nodes: List[VirtualNode] = []
        if not live:
            return nodes

        scales = np.array(
            [res.AXIS_SCALES.get(nm, res._DEFAULT_SCALE) for nm in batch.axis_names]
        )
        live_idx = np.asarray(live, np.int64)
        ok_all = typemask[live_idx]
        types_arr = np.array(instance_types, dtype=object)
        # most nodes share identical surviving-type masks: build each
        # distinct list once and share it (VirtualNode.add REPLACES
        # instance_type_options, never mutates it)
        _, uniq_row, row_of = np.unique(
            np.packbits(ok_all, axis=1), axis=0,
            return_index=True, return_inverse=True,
        )
        uniq_lists = [list(types_arr[ok_all[int(r)]]) for r in uniq_row]
        row_of_l = row_of.reshape(-1).tolist()

        totals_live = np.asarray(node_req)[live_idx]  # [L, R]
        totals_l = totals_live.tolist()
        scaled_l = (totals_live / scales[None, :]).tolist()
        sig_l = np.asarray(node_sig)[live_idx].tolist()
        host_l = np.asarray(node_host)[live_idx].tolist()
        sig_host_cache: Dict[int, tuple] = {}
        for row, n in enumerate(live):
            sig = batch.signatures[sig_l[row]]
            total = totals_l[row]
            scaled = scaled_l[row]
            node_constraints = constraints.clone()
            reqs = sig.requirements
            h = host_l[row]
            if h >= 0:
                reqs = _with_hostname(reqs, batch.hostnames[h], sig_host_cache)
            node_constraints.requirements = reqs
            nodes.append(
                VirtualNode(
                    constraints=node_constraints,
                    instance_type_options=uniq_lists[row_of_l[row]],
                    pods=pods_by_node[n],
                    requests={
                        name: scaled[i]
                        for i, name in enumerate(batch.axis_names)
                        if total[i]
                    },
                )
            )
        return nodes
