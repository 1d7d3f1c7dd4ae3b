"""The packing recurrence's contract and its plain PyTorch version.

Exact first-fit in FFD order over pods. Per-node state is {signature id,
hostname id, resource total}; the accept test per (pod, node) is:

    join_table[node_sig, pod_core] ≥ 0          (requirements compatibility)
  ∧ hostname fields agree                       (single-value hostname join)
  ∧ ∃ frontier row f: total + pod_req ≤ f       (∃ surviving type that fits)

The lowest-index node that accepts wins (first fit); otherwise the pod
opens node ``count`` when ``daemon + req`` fits a frontier row of its open
signature and the table has room below ``n_max``.

``pack_reference`` is the plain version: a Python loop over pods,
vectorised over the node table. It is what ``pack_kernel.pack_first_fit``
runs for CPU tensors and what the CUDA kernel is held against on the card.
``pack_v2_reference`` is the same recurrence over the v2 kernel's inputs
(per-core joined-frontier tables in place of the join table and
frontiers), the plain version of ``pack_kernel_v2.pack_first_fit_v2``.
``cheapest_fitting_type`` picks each packed node's cheapest surviving type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PackResult(NamedTuple):
    assignment: torch.Tensor  # [P] i32 node index, -1 = unschedulable/padding
    node_sig: torch.Tensor  # [N] i32 final signature per node, -1 = unopened
    node_host: torch.Tensor  # [N] i32
    node_req: torch.Tensor  # [N, R] f32 total requests (incl. daemon)
    n_nodes: torch.Tensor  # scalar i32


def pack_reference(
    pod_valid,  # [P] bool
    pod_open_sig,  # [P] i32
    pod_core,  # [P] i32
    pod_host,  # [P] i32, -1 = no hostname requirement
    pod_host_in_base,  # [P] bool — hostname ∈ base constraint domains
    pod_open_host,  # [P] i32 — node hostname state when opened by this pod
    #   (-1 none, h ≥ 0 joinable, -2 poisoned: hostname set became empty)
    pod_req,  # [P, R] f32
    join_table,  # [S, C] i32
    frontiers,  # [S, F, R] f32
    daemon,  # [R] f32
    n_max: int,
) -> PackResult:
    P, R = pod_req.shape
    dev = pod_req.device
    node_sig = torch.full((n_max,), -1, dtype=torch.int32, device=dev)
    node_host = torch.full((n_max,), -1, dtype=torch.int32, device=dev)
    node_req = torch.zeros((n_max, R), dtype=torch.float32, device=dev)
    assignment = torch.full((P,), -1, dtype=torch.int32, device=dev)

    # fresh-node fit for every pod at once: daemon + req against the open
    # signature's frontier rows (f32 sum, exact <= compare)
    open_req = daemon[None, :] + pod_req  # [P, R]
    open_fits = (
        (open_req[:, None, :] <= frontiers[pod_open_sig.long()]).all(-1).any(-1)
    ).tolist()

    valid = pod_valid.tolist()
    core_l = pod_core.tolist()
    host_l = pod_host.tolist()
    hib_l = pod_host_in_base.tolist()
    open_sig_l = pod_open_sig.tolist()
    open_host_l = pod_open_host.tolist()
    join_l = join_table.long()
    count = 0
    for i in range(P):
        if not valid[i]:
            continue
        req = pod_req[i]
        target = -1
        if count:
            # nodes at index >= count were never opened: they cannot accept
            sig = node_sig[:count]
            is_open = sig >= 0
            j = torch.where(is_open, join_l[sig.clamp(min=0).long(), core_l[i]], -1)
            new_req = node_req[:count] + req
            fr = frontiers[j.clamp(min=0)]  # [count, F, R]
            ok = (j >= 0) & (new_req[:, None, :] <= fr).all(-1).any(-1)
            host = host_l[i]
            if host >= 0:
                nh = node_host[:count]
                ok &= ((nh == -1) & bool(hib_l[i])) | (nh == host)
            hits = ok.nonzero()
            if hits.numel():
                target = int(hits[0, 0])  # lowest passing index: first fit
        if target >= 0:
            if host_l[i] < 0:
                upd_host = int(node_host[target])
            else:
                upd_host = host_l[i]
            node_sig[target] = int(j[target])
            node_host[target] = upd_host
            node_req[target] = new_req[target]
        elif open_fits[i] and count < n_max:
            target = count
            node_sig[target] = open_sig_l[i]
            node_host[target] = open_host_l[i]
            node_req[target] = open_req[i]
            count += 1
        else:
            continue
        assignment[i] = target
    return PackResult(
        assignment,
        node_sig,
        node_host,
        node_req,
        torch.tensor(count, dtype=torch.int32, device=dev),
    )


def pack_v2_reference(
    pod_scal,  # [6, P] i32 rows: valid, open_sig, core, host, host_in_base, open_host
    pod_req,  # [R, P] f32
    front_j,  # [C, FRp, S_pad] f32 — front_j[c, f·R + r, s]: joined-frontier limit
    compat_j,  # [C, 8, S_pad] f32 — row 0: 1.0 where signature s joins core c
    jvals,  # [C, 8, S_pad] f32 — row 0: the joined signature id
    open_fits,  # [1, P] i32 — daemon + req fits a frontier row of the open signature
    daemon,  # [R, 1] f32
    n_max: int,
    F: int,
    R: int,
) -> PackResult:
    """The recurrence of ``pack_reference``, read from the v2 kernel's own
    inputs only: joinability is ``compat_j[core, 0, sig] > 0.5``, the limits
    are ``front_j[core, f·R + r, sig]`` for f < F, the joined id is
    ``round(jvals[core, 0, sig])`` and the fresh-node fit is ``open_fits``.
    It never consults the join table or the frontiers, so a fault in the
    tables' precompute shows here. What ``pack_kernel_v2.pack_first_fit_v2``
    runs for CPU tensors and what the CUDA kernel is held against."""
    P = pod_scal.shape[1]
    dev = pod_req.device
    node_sig = torch.full((n_max,), -1, dtype=torch.int32, device=dev)
    node_host = torch.full((n_max,), -1, dtype=torch.int32, device=dev)
    node_req = torch.zeros((n_max, R), dtype=torch.float32, device=dev)
    assignment = torch.full((P,), -1, dtype=torch.int32, device=dev)

    valid, open_sig_l, core_l, host_l, hib_l, open_host_l = pod_scal.tolist()
    fits_open = open_fits[0].tolist()
    req_all = pod_req.t()  # [P, R]
    open_req = daemon[:, 0][None, :] + req_all  # [P, R], f32 sum
    limits_all = front_j[:, : F * R, :]  # frontier rows only: the NEG padding is never read
    count = 0
    for i in range(P):
        if not valid[i]:
            continue
        req = req_all[i]
        core = core_l[i]
        target = -1
        if count:
            # nodes at index >= count were never opened: they cannot accept
            sig = node_sig[:count]
            ok = (sig >= 0) & (compat_j[core, 0, sig.clamp(min=0).long()] > 0.5)
            host = host_l[i]
            if host >= 0:
                nh = node_host[:count]
                ok &= ((nh == -1) & bool(hib_l[i])) | (nh == host)
            # the fit test only for the nodes that join and admit the pod,
            # in index order
            cand = ok.nonzero()[:, 0]
            if cand.numel():
                new_req = node_req[cand] + req
                limits = limits_all[core][:, node_sig[cand].long()].t().reshape(-1, F, R)
                hits = (new_req[:, None, :] <= limits).all(-1).any(-1).nonzero()
                if hits.numel():
                    target = int(cand[hits[0, 0]])  # lowest passing index: first fit
        if target >= 0:
            if host_l[i] >= 0:
                node_host[target] = host_l[i]
            node_sig[target] = int(torch.round(jvals[core, 0, node_sig[target].long()]))
            node_req[target] = node_req[target] + req
        elif fits_open[i] and count < n_max:
            target = count
            node_sig[target] = open_sig_l[i]
            node_host[target] = open_host_l[i]
            node_req[target] = open_req[i]
            count += 1
        else:
            continue
        assignment[i] = target
    return PackResult(
        assignment,
        node_sig,
        node_host,
        node_req,
        torch.tensor(count, dtype=torch.int32, device=dev),
    )


def cheapest_fitting_type(node_req, node_sig, sig_type_mask, usable) -> torch.Tensor:
    """Post-pack, one shot: for every node, the index of the cheapest
    instance type that survives its signature and fits its total —
    ``node_req`` [N, R], ``node_sig`` [N], ``sig_type_mask`` [S, T] bool,
    ``usable`` [T, R]. Types are price-sorted, so "cheapest" = first True.
    Returns [N] i32 on the inputs' device, -1 for unopened nodes
    (``node_sig`` < 0) and nodes no type fits. Plain torch ops: the
    reference's is jitted XLA, not a Pallas kernel."""
    mask = sig_type_mask[node_sig.clamp(min=0).long()]  # [N, T]
    fits = (node_req[:, None, :] <= usable[None, :, :]).all(-1)  # [N, T]
    ok = mask & fits
    idx = torch.arange(ok.shape[-1], device=ok.device)
    first = torch.where(ok, idx, ok.shape[-1]).min(dim=-1).values
    has = ok.any(-1) & (node_sig >= 0)
    return torch.where(has, first, -1).to(torch.int32)


def fuse_result(result: PackResult) -> torch.Tensor:
    """Flatten a PackResult into ONE i32 buffer (f32 totals are bitcast,
    not converted), so the host needs a single transfer."""
    return torch.cat(
        [
            result.assignment.reshape(-1),
            result.node_sig.reshape(-1),
            result.node_host.reshape(-1),
            result.node_req.contiguous().view(torch.int32).reshape(-1),
            result.n_nodes.reshape(-1).to(torch.int32),
        ]
    )


def split_result(buf, p: int, n: int, r: int) -> PackResult:
    """Host-side inverse of ``fuse_result`` (numpy): ``p`` pods scanned,
    ``n`` node slots, ``r`` resource axes."""
    buf = np.asarray(buf)
    assignment = buf[:p]
    node_sig = buf[p : p + n]
    node_host = buf[p + n : p + 2 * n]
    node_req = buf[p + 2 * n : p + 2 * n + n * r].view(np.float32).reshape(n, r)
    n_nodes = buf[p + 2 * n + n * r]
    return PackResult(assignment, node_sig, node_host, node_req, n_nodes)
