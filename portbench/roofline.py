"""The kernels' least times: a frozen copy of ``chip_smoke.py``'s ``bound``,
``walk``, ``replay_work``, ``v1_work`` and ``v2_work``, so that no later
change to the program moves the yardstick.

Each counts the work a kernel needs on one run's own data (the replay
follows the first-fit recurrence along the kernel's own assignment, and
raises where the kernel's first fit is not the replay's), and ``bound``
turns bytes and operations into the least time on one NVIDIA H100 SXM
(NVIDIA's data sheet): HBM at 3.35 TB/s, 67 TFLOP/s in float32 outside
the tensor cores.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(n_bytes: int, ops: int):
    """(bound_ms, bound_by): the bytes over HBM bandwidth against the
    operations over the f32 rate, whichever takes longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def walk(le):
    """A first-fit frontier walk over ``le`` [k, F, R] (does total r fit
    row f?) for k nodes: the compares each needs (each row until its first
    failing axis, rows until the first that fits), the rows each reads, and
    whether a row fits."""
    k, F, R = le.shape
    row_fit = le.all(2)
    fits = row_fit.any(1)
    rows = np.where(fits, row_fit.argmax(1) + 1, F)
    per_row = np.where(row_fit, R, (~le).argmax(2) + 1)
    return (per_row * (np.arange(F)[None, :] < rows[:, None])).sum(1), rows, fits


def replay_work(pods, assignment, joins, limits, shape):
    """Replay the first-fit recurrence along a kernel's own assignment and
    count the work this run's data needs. Per valid pod: one joinability
    compare per open node, one hostname compare per joining node when the
    pod pins a hostname, and, for the nodes that join and admit it up to
    the first that fits, R adds and the frontier walk; R adds when it opens
    a node. ``joins(core, sigs)`` gives (joinable, joined id) and
    ``limits(core, sigs, ids)`` the [k, F, R] limits. Returns (ops, compat,
    rows, jv): which (core, sig) joinabilities were read, how many frontier
    rows each (core, sig) column had read, and which joined ids were read.
    Raises where the replay's first fit is not the kernel's."""
    valid, open_sig, core, host, hib, open_host, req, daemon = pods
    n_cap, C, S = shape
    R = req.shape[1]
    node_sig = np.full(n_cap, -1, np.int64)
    node_host = np.full(n_cap, -1, np.int64)
    node_req = np.zeros((n_cap, R), np.float32)
    compat = np.zeros((C, S), bool)
    rows_read = np.zeros((C, S), np.int64)
    jv = np.zeros((C, S), bool)
    count = ops = 0
    for i in np.flatnonzero(valid):
        c, h, a = int(core[i]), int(host[i]), int(assignment[i])
        target, jid = -1, None
        if count:
            sigs = node_sig[:count]
            ok, jid = joins(c, np.maximum(sigs, 0))
            ok = ok & (sigs >= 0)
            ops += count
            compat[c, sigs[sigs >= 0]] = True
            if h >= 0:
                ops += int(ok.sum())
                nh = node_host[:count]
                ok &= ((nh == -1) & bool(hib[i])) | (nh == h)
            cand = np.flatnonzero(ok)
            if cand.size:
                totals = node_req[cand] + req[i]
                cmps, rows, fits = walk(totals[:, None, :] <= limits(c, sigs[cand], jid[cand]))
                stop = int(fits.argmax()) + 1 if fits.any() else cand.size
                ops += stop * R + int(cmps[:stop].sum())
                np.maximum.at(rows_read[c], sigs[cand[:stop]], rows[:stop])
                if fits.any():
                    target = int(cand[stop - 1])
        if target >= 0:
            if a != target:
                raise AssertionError(f"work replay: pod {i} fits node {target}, kernel gave {a}")
            jv[c, node_sig[target]] = True
            node_req[target] += req[i]
            node_sig[target] = jid[target]
            if h >= 0:
                node_host[target] = h
        elif a == count:
            node_sig[a], node_host[a] = open_sig[i], open_host[i]
            node_req[a] = daemon + req[i]
            ops += R
            count += 1
        elif a != -1:
            raise AssertionError(f"work replay: pod {i} fits no open node, kernel gave {a}")
    return ops, compat, rows_read, jv


def nbytes(arrays) -> int:
    return sum(int(a.size) * a.itemsize for a in arrays)


def v1_work(args, assignment, outputs):
    """(bytes, ops) pack_first_fit needs on this run: every input read once
    (the join table and frontiers whole; they are a few hundred bytes at the
    headline) and every output written once; the replay's operations plus
    each valid pod's fresh-node walk (R adds, then its open signature's
    frontier rows). ``args`` and ``outputs`` are numpy arrays in the
    kernel's order; ``assignment`` is the first output."""
    valid, open_sig, core, host, hib, open_host, req, join, frontiers, daemon = args
    F, R = frontiers.shape[1:]
    ops, _, _, _ = replay_work(
        (valid, open_sig, core, host, hib, open_host, req, daemon),
        assignment,
        lambda c, sigs: (join[sigs, c] >= 0, join[sigs, c]),
        lambda c, sigs, ids: frontiers[ids],
        (outputs[1].shape[-1], join.shape[1], join.shape[0]),
    )
    cmps, _, _ = walk((daemon + req)[valid][:, None, :] <= frontiers[open_sig[valid]])
    ops += int(valid.sum()) * R + int(cmps.sum())
    return nbytes(args) + nbytes(outputs), ops


def v2_work(args, assignment, outputs, F: int, R: int):
    """(bytes, ops) pack_first_fit_v2 needs on this run: the pod side read
    once, of the tables only the joinabilities, the frontier rows and the
    joined ids that the recurrence reads, and every output written once; the
    replay's operations (the fresh-node fits are an input)."""
    pod_scal, pod_req, front_j, compat_j, jvals, open_fits, daemon = args
    C, _, S_pad = front_j.shape
    ops, compat, rows_read, jv = replay_work(
        (pod_scal[0] != 0, *pod_scal[1:4], pod_scal[4] != 0, pod_scal[5],
         np.ascontiguousarray(pod_req.T), daemon[:, 0]),
        assignment,
        lambda c, sigs: (compat_j[c, 0, sigs] > 0.5, np.rint(jvals[c, 0, sigs]).astype(np.int64)),
        lambda c, sigs, ids: front_j[c, : F * R, sigs].reshape(-1, F, R),
        (outputs[1].shape[-1], C, S_pad),
    )
    n_bytes = nbytes((pod_scal, pod_req, open_fits, daemon)) + nbytes(outputs)
    n_bytes += 4 * (int(compat.sum()) + int(rows_read.sum()) * R + int(jv.sum()))
    return n_bytes, ops


def launch_bound_ms(kernel: str, args, assignment, outputs, kw) -> float:
    """The least time of one captured launch of ``kernel``."""
    if kernel == "pack_first_fit":
        n_bytes, ops = v1_work(args, assignment, outputs)
    elif kernel == "pack_first_fit_v2":
        n_bytes, ops = v2_work(args, assignment, outputs, kw["F"], kw["R"])
    else:
        raise ValueError(f"no work count for kernel {kernel!r}")
    return bound(n_bytes, ops)[0]


def _resolve(target: str):
    """``"package.module:attr"`` -> (module, attr)."""
    import importlib

    module, attr = target.split(":")
    return importlib.import_module(module), attr


class Capture:
    """A kernel's share of its roofline over the traced stretch: the
    wrapper functions named in ``patch`` are wrapped to keep each launch's
    inputs and outputs, the profiler's events whose name holds ``event``
    give each launch's device time, and the launches counted by the
    wrapper's ``counter`` have to equal both. The first ``N_BOUNDED``
    launches are replayed (a replay takes about a second); the share is
    their least times over their device times."""

    N_BOUNDED = 3

    def __init__(self, kernel: str, event: str, patch, counter: str):
        self.kernel, self.event, self.patch, self.counter = kernel, event, patch, counter

    def prepare(self, ctx) -> None:
        calls = ctx.store.setdefault(self.kernel, {"calls": [], "saved": []})
        module, attr = _resolve(self.counter)
        calls["counter0"] = getattr(module, attr)
        for target in self.patch:
            module, attr = _resolve(target)
            orig = getattr(module, attr)
            calls["saved"].append((module, attr, orig))
            setattr(module, attr, self._wrap(orig, calls["calls"]))

    @staticmethod
    def _wrap(orig, calls):
        def capture(*args, **kw):
            out = orig(*args, **kw)
            calls.append((args, kw, out))
            return out
        return capture

    def finish(self, ctx) -> None:
        calls = ctx.store[self.kernel]
        for module, attr, orig in reversed(calls["saved"]):
            setattr(module, attr, orig)
        module, attr = _resolve(self.counter)
        calls["launched"] = getattr(module, attr) - calls["counter0"]

    def read(self, ctx):
        if ctx.trace is None or self.kernel not in ctx.store:
            return None
        calls = ctx.store[self.kernel]
        events = sorted((s, e) for name, s, e in ctx.trace["device"] if self.event in name)
        launches = [c for c in calls["calls"] if c[0][0].is_cuda]
        if not events and not launches:
            return None
        if not (len(events) == len(launches) == calls["launched"]):
            raise RuntimeError(
                f"{self.kernel}: the profiler saw {len(events)} launches, the capture "
                f"{len(launches)}, the wrapper's counter {calls['launched']}")
        n = min(self.N_BOUNDED, len(launches))
        bound_ms = 0.0
        for args, kw, out in launches[:n]:
            host = [a.cpu().numpy() for a in args]
            outputs = [o.cpu().numpy() for o in out]
            bound_ms += launch_bound_ms(self.kernel, host, outputs[0], outputs, kw)
        device_ms = sum(e - s for s, e in events[:n]) * 1e3
        mean_ms = sum(e - s for s, e in events) * 1e3 / len(events)
        ctx.log(f"{self.kernel}: {len(events)} launches traced, mean {mean_ms:.4f} ms; "
                f"the first {n}: bound {bound_ms:.6f} ms over {device_ms:.4f} ms on the device")
        return 100.0 * bound_ms / device_ms
