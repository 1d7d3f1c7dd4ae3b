"""Single-dispatch solve: compact pod table → pack → typemask → one buffer.

Per solve the host uploads one compact ``[4, P] int16`` pod table plus the
``[U, R] float32`` unique request vectors; the solve-invariant arrays (join
table, frontiers, daemon, signature→type masks, usable capacities) stay
resident on the device in a small content-keyed cache
(``DeviceInvariants``). ``fused_solve`` then runs three steps on the
device:

1. unpack the pod table into the kernel's per-pod inputs (torch ops);
2. ``pack_kernel.pack_first_fit`` (the CUDA kernel on the card, the plain
   version on the CPU);
3. compute each node's surviving-type bitmask and flatten everything —
   the f32 totals bitcast — into ONE int32 buffer for a single fetch.

``fused_solve_v2`` is the same dispatch for constraint-diverse batches: it
derives each pod's fresh-node fit on the device and runs
``pack_kernel_v2.pack_first_fit_v2`` over the per-core join tables, which
``DeviceInvariants.get_v2`` keeps resident.

With the resident path on, ``PodResidency`` keeps the pod-side upload on the
device across rounds: reused while the encoded batch is the same object,
column-patched in place when a few pods changed.

The buffers are byte-for-byte the ones ``karpenter_tpu``'s fused solves
return, so ``split_fused`` reads either.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.solver import pack_kernel_v2, session_stats
from karpenter_tpu_torch.solver.kernel import PackResult
from karpenter_tpu_torch.solver.pack_kernel import pack_first_fit

# pod scalar rows in the packed [4, P] i16 table. open_sig and open_host are
# DERIVED on the device: open_sig = open_sig_by_core[core], open_host = host
# when joinable (host in base domains, or no base hostname requirement) else
# the poison value -2 — exactly encode's host-side formulas.
ROW_FLAGS = 0  # bit0 = valid, bit1 = host_in_base
ROW_CORE = 1
ROW_HOST = 2
ROW_REQ_ID = 3

I16_MAX = 32766


def ids_fit(batch) -> bool:
    """All interned ids fit int16 (hostname ids are the only axis that can
    realistically approach the cap, at 32k+ distinct hostnames in one
    batch)."""
    return (
        len(batch.hostnames) < I16_MAX
        and len(batch.cores) < I16_MAX
        and batch.uniq_req is not None
        and batch.uniq_req.shape[0] < I16_MAX
        and len(batch.signatures) < I16_MAX
    )


def pad_uniq_req(uniq: np.ndarray) -> np.ndarray:
    """Pad the unique-request matrix to a power-of-two row count (min 16).
    The padding rows are zeros, like the batch's own final all-zero row
    backing the padding pods."""
    u_pad = 16
    while u_pad < uniq.shape[0]:
        u_pad *= 2
    if u_pad != uniq.shape[0]:
        uniq = np.vstack(
            [uniq, np.zeros((u_pad - uniq.shape[0], uniq.shape[1]), np.float32)]
        )
    return uniq


def pack_pod_table(batch):
    """The per-solve compact upload: ([4, P] i16 pod table,
    [C] i16 per-core open signatures, [1] i32 base_has_hostname)."""
    flags = batch.pod_valid.astype(np.int16) | (
        batch.pod_host_in_base.astype(np.int16) << 1
    )
    tab = np.stack(
        [
            flags,
            batch.pod_core.astype(np.int16),
            batch.pod_host.astype(np.int16),
            batch.pod_req_id.astype(np.int16),
        ]
    )
    open_by_core = np.asarray(batch.open_sig_by_core).astype(np.int16)
    bhh = np.array([1 if batch.base_has_hostname else 0], np.int32)
    return tab, open_by_core, bhh


class DeviceInvariants:
    """Content-keyed LRU of device-resident solve invariants.

    A provisioner's consecutive batches share (signature table, closure,
    catalog): re-uploading the join table, frontiers, type masks and usable
    capacities per solve moves bytes that did not change. Keyed by a
    blake2b digest of their content, so a changed catalog or closure simply
    misses. ``get_v2`` additionally holds the v2 kernel's per-core join
    tables (by far the largest arrays of a constraint-diverse solve) under
    the same digest, evicted with the rest."""

    MAX_ENTRIES = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache: "Dict[bytes, tuple]" = {}  # guarded-by: self._lock
        self._cache_v2: "Dict[bytes, tuple]" = {}  # guarded-by: self._lock
        self._order: list = []  # guarded-by: self._lock
        self._lock = threading.Lock()

    @staticmethod
    def _digest(arrays) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for a in arrays:
            h.update(a.tobytes())
        return h.digest()

    def _touch_locked(self, key: bytes) -> None:
        # LRU over both caches: one order, one eviction per digest
        if key in self._order:
            self._order.remove(key)
        self._order.append(key)
        while len(self._order) > self.MAX_ENTRIES:
            dead = self._order.pop(0)
            self._cache.pop(dead, None)
            self._cache_v2.pop(dead, None)
            session_stats.record_eviction()

    @staticmethod
    def _arrays(batch) -> tuple:
        return (
            np.ascontiguousarray(batch.join_table, np.int32),
            np.ascontiguousarray(batch.frontiers, np.float32),
            np.ascontiguousarray(batch.daemon, np.float32),
            np.ascontiguousarray(batch.type_mask_matrix(), bool),
            np.ascontiguousarray(batch.usable, np.float32),
        )

    def get(self, batch, record: bool = True) -> tuple:
        """(join, frontiers, daemon, mask, usable) tensors on the device.
        ``record=False`` keeps the lookup out of the session-residency hit
        rate (``session_stats``): shadow probes and saturation re-dispatches
        are not solves."""
        return self._lookup(self._cache, batch, record, self._upload)

    def get_v2(self, batch, record: bool = True) -> tuple:
        """(front_j, compat_j, jvals, frontiers, daemon, mask, usable,
        front_s) tensors on the device: the v2 route's per-core tables and
        the signature-major copy of the limits the kernel walks, computed
        once per closure under the same digest as ``get``. ``record`` as in
        :meth:`get`."""
        return self._lookup(self._cache_v2, batch, record, self._upload_v2)

    def _upload(self, arrays) -> tuple:
        return tuple(torch.tensor(a, device=self.device) for a in arrays)

    def _upload_v2(self, arrays) -> tuple:
        join, frontiers = arrays[0], arrays[1]
        front_j, compat_j, jvals, _ = pack_kernel_v2._precompute(join, frontiers)
        hit = self._upload((front_j, compat_j, jvals) + arrays[1:])
        return hit + (pack_kernel_v2.signature_major(hit[0]),)

    def _lookup(self, cache: dict, batch, record: bool, upload) -> tuple:
        """The digest of the batch's invariants, then ``cache``'s entry or
        ``upload(arrays)`` on a miss, under the ``pack.invariants`` span
        (attribute ``hit``)."""
        with obs.tracer().child_span("pack.invariants") as sp:
            arrays = self._arrays(batch)
            key = self._digest(arrays)
            with self._lock:
                hit = cache.get(key)
            sp.set_attribute("hit", hit is not None)
            if record:
                session_stats.record(hit is not None)
            if hit is None:
                session_stats.record_upload()  # a real transfer, whoever asked
                hit = upload(arrays)
            with self._lock:
                cache[key] = hit
                self._touch_locked(key)
            return hit


class PodResidency:
    """Device-resident pod-side upload: ``DeviceInvariants``' twin for the
    pod side of resident (delta) rounds.

    The host ``ResidentEncoder`` returns the SAME ``EncodedBatch`` object on
    a no-churn round, so object identity is the residency key: the entry
    holds the batch ref (pinning the id) plus the device tensors of its
    compact upload, and a steady-state round skips ``pack_pod_table`` AND
    the transfer entirely. A churn round whose pod-table shape survived
    patches the resident table in place (``index_copy_`` of the changed
    columns into the same allocation).

    One entry, not an LRU: interleaving provisioners churn the batch
    identity every round anyway, and a stale entry costs exactly one
    re-upload — the miss path IS the non-resident behavior."""

    # past a quarter of the columns the full upload is barely bigger
    PATCH_MAX_COL_FRACTION = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self._entry = None  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.stats = {"reused": 0, "patched": 0, "uploaded": 0}  # guarded-by: self._lock

    def _count(self, what: str) -> None:
        from karpenter_tpu_torch import metrics

        with self._lock:
            self.stats[what] += 1
        if what != "uploaded":
            metrics.SOLVER_DELTA_APPLIED.labels(path="device").inc()

    @staticmethod
    def _publish_bytes(devs) -> None:
        """The resident pod table's device bytes (tensor metadata: no
        wait on the card)."""
        from karpenter_tpu_torch import metrics

        metrics.SOLVER_DELTA_RESIDENT_BYTES.labels(side="device").set(
            sum(int(a.nbytes) for a in devs)
        )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """One host array as a new tensor on the device (a copy on the CPU
        too: the resident table is patched in place)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True, copy=True
        )

    def get(self, batch):
        """``(pod_tab, open_by_core, bhh, uniq)`` as device tensors,
        reusing or patching the resident upload when ``batch`` allows."""
        with self._lock:
            entry = self._entry
        if entry is not None and entry[0] is batch:
            self._count("reused")
            return entry[1]
        tab, open_by_core, bhh = pack_pod_table(batch)
        uniq = pad_uniq_req(batch.uniq_req)
        host = (tab, open_by_core, bhh, uniq)
        devs = None
        if entry is not None:
            _, (tab_d, obc_d, bhh_d, uniq_d), prev = entry
            ptab, pobc, pbhh, puniq = prev
            if ptab.shape == tab.shape:
                changed = np.flatnonzero((ptab != tab).any(axis=0))
                if (
                    0 < changed.size
                    <= max(1, tab.shape[1] // self.PATCH_MAX_COL_FRACTION)
                ):
                    # in-place column patch of the resident table; the
                    # stream orders it after the previous round's kernel
                    tab_d.index_copy_(
                        1, self._upload(changed.astype(np.int64)),
                        self._upload(tab[:, changed]),
                    )
                elif changed.size:
                    tab_d = self._upload(tab)
                side_ok = (
                    np.array_equal(pobc, open_by_core)
                    and np.array_equal(pbhh, bhh)
                    and np.array_equal(puniq, uniq)
                )
                devs = (
                    tab_d,
                    obc_d if side_ok else self._upload(open_by_core),
                    bhh_d if side_ok else self._upload(bhh),
                    uniq_d if side_ok else self._upload(uniq),
                )
                self._count("patched" if changed.size else "reused")
        if devs is None:
            devs = tuple(self._upload(a) for a in host)
            self._count("uploaded")
        with self._lock:
            self._entry = (batch, devs, host)
        self._publish_bytes(devs)
        return devs


def _unpack_pods(pod_tab, open_by_core, bhh, uniq_req):
    """Inverse of ``pack_pod_table`` on the device: the per-pod kernel
    inputs from the compact i16 upload (encode's host-side formulas)."""
    tab = pod_tab.to(torch.int32)
    flags = tab[ROW_FLAGS]
    pod_valid = (flags & 1) != 0
    pod_host_in_base = (flags & 2) != 0
    pod_core = tab[ROW_CORE].contiguous()
    pod_host = tab[ROW_HOST].contiguous()
    pod_open_sig = open_by_core.to(torch.int32)[pod_core.long()]
    # joinable hostname state when the merged hostname set stays non-empty,
    # poisoned (-2) otherwise
    joinable = pod_host_in_base | (bhh[0] == 0)
    pod_open_host = torch.where(
        pod_host >= 0,
        torch.where(joinable, pod_host, torch.full_like(pod_host, -2)),
        torch.full_like(pod_host, -1),
    )
    pod_req = uniq_req[tab[ROW_REQ_ID].long()].contiguous()  # [P, R] gather
    return (
        pod_valid, pod_open_sig, pod_core, pod_host, pod_host_in_base,
        pod_open_host, pod_req,
    )


def _pack_typebits(ok: torch.Tensor) -> torch.Tensor:
    """[N, T32*32] bool → [N, T32] i32 bit-packed (bit t%32 of word t//32).
    Summed in int64 and wrapped to the int32 with the same bits: a type at
    bit 31 makes the word negative, as the unsigned word's bitcast does."""
    N = ok.shape[0]
    okp = ok.to(torch.int64).reshape(N, -1, 32)
    weights = torch.ones(32, dtype=torch.int64, device=ok.device) << torch.arange(
        32, dtype=torch.int64, device=ok.device
    )
    words = (okp * weights).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def _finalize(result: PackResult, sig_type_mask, usable) -> torch.Tensor:
    """Surviving-type bitmask per node + everything flattened into ONE
    int32 buffer for one fetch."""
    T = usable.shape[0]
    T32 = (T + 31) // 32
    node_sig = result.node_sig
    mask = sig_type_mask[node_sig.clamp(min=0).long()]  # [N, T]
    fits = (result.node_req[:, None, :] <= usable[None, :, :]).all(dim=-1)
    ok = mask & fits & (node_sig >= 0)[:, None]
    if T32 * 32 != T:
        ok = torch.nn.functional.pad(ok, (0, T32 * 32 - T))
    typebits = _pack_typebits(ok)
    return torch.cat(
        [
            result.assignment.reshape(-1),
            node_sig.reshape(-1),
            result.node_host.reshape(-1),
            result.node_req.contiguous().view(torch.int32).reshape(-1),
            typebits.reshape(-1),
            result.n_nodes.reshape(-1).to(torch.int32),
        ]
    )


def fused_solve(
    pod_tab,  # [4, P] i16
    open_by_core,  # [C] i16 — per-core fresh-node signatures
    bhh,  # [1] i32 — base constraints carry a hostname requirement
    uniq_req,  # [U, R] f32 (last rows zeros = padding pods)
    join_table,  # [S, C] i32 (device-resident)
    frontiers,  # [S, F, R] f32 (device-resident)
    daemon,  # [R] f32 (device-resident)
    sig_type_mask,  # [S, T] bool (device-resident)
    usable,  # [T, R] f32 (device-resident)
    n_max: int,
) -> torch.Tensor:
    """Unpack → ``pack_first_fit`` → finalize, on the inputs' device.
    Returns the flat int32 buffer ``split_fused`` reads."""
    args = _unpack_pods(pod_tab, open_by_core, bhh, uniq_req) + (
        join_table, frontiers, daemon,
    )
    result = pack_first_fit(*args, n_max=n_max)
    return _finalize(result, sig_type_mask, usable)


def fused_solve_v2(
    pod_tab,  # [4, P] i16
    open_by_core,  # [C] i16
    bhh,  # [1] i32
    uniq_req,  # [U, R] f32
    front_j,  # [C, FRp, S_pad] f32 (device-resident; pack_kernel_v2._precompute)
    compat_j,  # [C, 8, S_pad] f32 (device-resident)
    jvals,  # [C, 8, S_pad] f32 (device-resident)
    frontiers,  # [S, F, R] f32 (device-resident; the fresh-node fit)
    daemon,  # [R] f32 (device-resident)
    sig_type_mask,  # [S, T] bool (device-resident)
    usable,  # [T, R] f32 (device-resident)
    front_s=None,  # [C, S_pad, FRp] f32 (device-resident; signature_major(front_j))
    *,
    n_max: int,
    F: int,
    R: int,
) -> torch.Tensor:
    """The fused solve through ``pack_first_fit_v2``, the route for
    constraint-diverse batches: unpack → each pod's fresh-node fit and the
    kernel's layouts (``pack_kernel_v2.kernel_inputs``) → the v2 kernel →
    finalize. Returns the buffer ``fused_solve`` returns."""
    args = pack_kernel_v2.kernel_inputs(
        *_unpack_pods(pod_tab, open_by_core, bhh, uniq_req),
        frontiers, daemon, front_j, compat_j, jvals,
    )
    result = pack_kernel_v2.pack_first_fit_v2(*args, n_max=n_max, F=F, R=R, front_s=front_s)
    return _finalize(result, sig_type_mask, usable)


def split_fused(buf, p: int, n: int, r: int, t: int):
    """Host-side inverse of ``fused_solve``'s flat buffer. Returns
    (PackResult, typemask[n_live, T] bool) over numpy arrays: the mask
    covers only the live rows, ``n_live`` = the buffer's ``n_nodes``
    clamped to ``[0, n]`` (rows past it are empty by the kernel contract
    and decode never reads them). ``PackResult.n_nodes`` stays the raw
    value, so a corrupt count is ``integrity.screen_result``'s to refuse."""
    buf = np.asarray(buf)
    t32 = (t + 31) // 32
    o = 0
    assignment = buf[o : o + p]; o += p
    node_sig = buf[o : o + n]; o += n
    node_host = buf[o : o + n]; o += n
    node_req = buf[o : o + n * r].view(np.float32).reshape(n, r); o += n * r
    typebits = buf[o : o + n * t32].view(np.uint32).reshape(n, t32); o += n * t32
    n_nodes = buf[o]
    n_live = min(max(int(n_nodes), 0), n)
    # column j is bit j % 32 of word j // 32 on any host byte order
    words = typebits[:n_live].astype("<u4", copy=False).view(np.uint8)
    typemask = np.unpackbits(words, axis=1, count=t, bitorder="little").view(bool)
    return (
        PackResult(assignment, node_sig, node_host, node_req, n_nodes),
        typemask,
    )
