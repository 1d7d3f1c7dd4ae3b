"""Drive the PyTorch port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):

1. build   — compile every kernel of the port from the checkout's sources
             (one nvcc per kernel source, sm_90a, all started together) and
             print what ptxas reports for each, and the card's name and
             power limit;
2. parity  — on the headline batch (instance_types(400) x
             diverse_pods(10000, Random(42)), encoded by the port), run
             pack_first_fit on the card and its plain version on CPU copies
             of the same inputs; all five outputs must be bit-exact at
             n_max 512, n_max P and a saturating n_max 64, and on a seeded
             synthetic problem with large tables; time the kernel (CUDA
             events, and per pod step) and the plain version; time it at
             each block size (bit-exact at each) beside the launch plan's;
3. main    — Scheduler.solve(solver: tpu) on cuda: one warm-up round whose
             plan must equal the device="cpu" plan of the same solve and
             open the reference's 431 nodes, then
             5 rounds with the launch counts set to 0 just before them;
             every round must pass validation and launch the kernel; then
             one more round under torch.profiler for the device's busy time
             by kernel and its idle share;
4. retry   — a batch that opens more than 512 nodes through
             Scheduler.solve: pack_dispatches == 2 and cuda == cpu;
5. v2 parity — pack_first_fit_v2 on the card against its plain version on
             CPU copies of the same inputs, all five outputs bit-exact: the
             full-width constraint-diverse batch (instance_types_tradeoff(400)
             x 10,000 pods with 64 team selectors, Random(9)) at n_max 512,
             n_max P and a saturating n_max 64; the tradeoff(64) batch at
             n_max 512; the bench's synthetic shape (P=256, S=256, C=8, F=8,
             R=4, n_max 128); a synthetic shape with pinned hostnames. Then
             CUDA-event times of pack_first_fit_v2 and of pack_first_fit on
             the full-width batch (and per pod step), the plain version's
             time on the card, and the bound; v2 with its cached
             signature-major copy against the wrapper making it per call,
             the copy itself, and both kernels at each block size;
6. diverse — Scheduler.solve on the full-width mix: a warm-up whose plan
             equals the device="cpu" plan and opens 128 nodes, then 5 rounds
             (launch counts set to 0 just before) through pack_first_fit_v2
             with their stage timings, and one profiled round;
7. multi   — sharded_multi_solve on two stacks of 8 batches of 1,250 pods:
             diverse_pods x instance_types(400) (route v1) and the team mix
             x tradeoff(400) (route v2); each equals the CPU result for every
             batch and for the cheapest types, and is timed;
8. resident — the resident delta path (Scheduler(solver_delta=True)) at
             full width. (a) headline: a warm-up whose plan equals the
             knob-off device="cpu" plan (431 nodes), then 5 steady rounds
             (launch counts set to 0 just before) that must each serve
             sort, inject, encode, decode and validate from resident state
             (*_delta_s keys), reuse PodResidency's upload, launch
             pack_first_fit once and return the warm-up's plan; one
             profiled steady round; then a cluster create + bind, after
             which the round must re-inject and encode in full and equal a
             device="cpu" resident scheduler taken through the same
             rounds. (b) team mix: 5 churn rounds (100 pods leave, 100
             arrive) and one one-pod swap that patches the resident pod
             table in place, each through pack_first_fit_v2 on the row
             delta encode rung and equal to a knob-off cuda scheduler's
             plan (first and last also to the device="cpu" plan);
9. route   — the native packer and the unfused ladder beside the kernels.
             (a) build the native packer (printing the build time) and hold
             its five outputs bit-exact against pack_first_fit (headline) and
             the unfused v2 caller (team mix) at the backend's n_max; host
             clock of native over 5 calls beside the kernels' CUDA-event
             times and the unfused callers' host times. (b) 3 headline
             rounds under KARPENTER_PACKER=pallas: pack_first_fit on the
             unfused route, one launch a round, the plan equal to phase 3's
             fused and cpu plans. (d) pack_best on the card on synthetic
             problems whose hostname ids pass 32,767 (v1 and v2 rungs), bit-
             exact against the plain version. (e) 3 headline and 3 team-mix
             rounds under auto with a fresh router: every round launches its
             kernel on the fused route, the plan equals the cpu plan, and the
             router stays empty with no native call (only a device="cpu"
             scheduler routes); pack_fetch_s is printed against (a)'s native
             time. (f) 4 resident headline rounds under
             KARPENTER_PACKER=native: from round 1 the decode and validation
             memos hit with typemask None. (c), run last: a team-mix round
             with its fused shape in the failed-fused memo takes
             pack_first_fit_v2 through pack_best (one launch, the plan equal
             to phase 6's), and pack_best on the team mix's pack_args() on
             the card is bit-exact with the plain version; at the end both
             failed-shape memos hold only what (c) put there;
11. degrade — (after phase 9; it fails first if the integrity counters
             show a quarantine, a screen failure or a canary mismatch from
             the earlier phases) the degrade ladder around both kernels, on
             fresh schedulers, both failed-shape memos restored after each
             part. (a) canary_rate=1.0 on healthy full-width rounds: 3
             headline, 3 team-mix, the retry batch (its canary at n_max =
             P) and 2 resident headline rounds; every round launches its
             kernel, equals the device="cpu" plan, and its native re-solve
             agrees (canary_solves == rounds, 0 mismatches, 0 quarantines;
             the canary's and the screen's host times printed). (b)-(f)
             reach each trigger only by injection at the Python level, at
             full width; a card scheduler has no FFD floor, so each round
             the reference would serve from its floor must raise here,
             after the reference's bookkeeping: (b) both kernels raise on
             the headline — 2 rounds raise, then the breaker is open and
             the third round raises BreakerOpen with no kernel called; (c)
             a NaN in node_req of the fetched headline buffer — screen
             failure, 1 quarantine, breaker open, one IntegrityQuarantine
             Warning event, InvalidPackError, the next round BreakerOpen
             with no launch; (d) a pod placed twice after decode on the
             team mix — 1 quarantine, InvalidPackError, the next round
             BreakerOpen with no launch; (e) SignatureOverflow on both
             encode attempts — it raises, no packer_backend, no launch; (f)
             one cpu core (1000 in the device's millicore units) added to
             node_req[0, 0] after the screen with the canary on — served
             by the kernel, 1 canary mismatch, the shape quarantined, the
             next round BreakerOpen with no launch;
12. sidecar — (after phase 11) the solver sidecar on the card at full
             width (the headline and the team mix, nothing cut). (a) always:
             a warm-up SolverService must turn ready; frames built with the
             port's codec from each batch's pack_args() go straight to
             SolverService.open_session_bytes / solve_bytes on the card:
             the session tensors pinned on the card, 3 untraced rounds at
             the node table the backend sends a sidecar (max(256, P // 4))
             whose fused buffers must equal kernel.fuse_result of the
             in-process backend.pack_unfused on the same tensors byte for
             byte, one traced round for the sidecar's [solve_s, fetch_s,
             serialize_s] trailer, served naming pack_first_fit (headline)
             or pack_first_fit_v2 (team mix) on every dispatch; then one
             frame each reaching NEEDS_CATALOG, DEADLINE_EXCEEDED,
             NEEDS_DELTA_BASE, INTEGRITY and OVERLOADED, none dispatched.
             (b) when grpc imports on this host (else it prints that the
             CPU tests hold it): serve() on the card and a device="cpu"
             Scheduler pointed at it under KARPENTER_PACKER=fused: 3
             headline and 3 team-mix rounds, 3 resident headline rounds
             (delta establish, elide, elide), a team-mix one-pod swap
             (delta patch), a checksummed round, and a round after a
             sidecar restart on the same address (re-opened through
             NEEDS_CATALOG); every round served by the sidecar with the
             card's plan, its wire and pack stages printed;
13. stream — (after phase 12) the sidecar's persistent stream at full
             width. (a) always: 8 headline and 4 team-mix Pack frames of
             equal shapes and different content (a different seeded 1% of
             each one's pods invalid) parsed by stream_parse_solve and
             served by solve_stream_group as groups of 8 and 3 (padded to
             B=4) headline and 4 team mix: each group is ONE launch of its
             kernel (pack_first_fit, pack_first_fit_v2) over the batch
             axis, every answer equals that frame's solve_bytes answer
             byte for byte, the coalesced counters move by the group; each
             group's time and its traced dispatch_s / fetch_s beside its
             frames' single solve_bytes times, and the catalog tensors'
             copy to the batch axis; a headline frame through a ShmArena
             descriptor, byte-equal; an expired deadline shed with no
             launch. (b) when grpc imports: serve(shm_dir=...) on the card
             and device="cpu" controllers with solver_stream under
             KARPENTER_PACKER=fused: 3 headline and 3 team-mix rounds on
             the stream, 3 headline rounds through the arena (wire_ser_s
             beside phase 12's), 3 resident headline rounds (establish,
             elide, elide), a round after a restart re-opened over the
             re-established stream, an 8-client salvo repeated until a
             group coalesces (every result the card's), a two-member pool
             whose session member is killed (failover through
             NEEDS_CATALOG, the outer breaker closed), and two threads on
             one scheduler through a chaos-slowed (0.5 s) sidecar in under
             2 floors; every round served by the sidecar with the card's
             plan, its transport and wire and pack stages printed;
14. obs    — (after phase 13) the observability plane around both kernels,
             at full width. Every round launches its kernel once, and each
             part (a)-(g) reads both kernels' launch counters before and
             after it and fails where they differ from its rounds; the
             kernels line reports these measured launches. (a) fresh card
             schedulers with the ring
             exporter: a warm-up and 5 traced knob-off rounds of the
             headline and of the team mix; each round launches its kernel
             once (its wrapper timed by CUDA events), equals the
             device="cpu" plan, exports one solver.solve tree with the six
             stage spans as children, each host stage within 1 ms of
             last_stage_profile() (pack_begin + pack_fetch within 1 ms of
             pack_fetch_s); a tracer hook asks the kernel's end event, as
             solve.pack_begin and solve.pack_fetch close, whether it is
             done: every fetch closes with it done, and in at least one
             round of each batch the begin closes with it running (a
             begin that waited would never); each tree's critical path
             printed. (b)
             those rounds move the encode-cache, session and
             SCHEDULING_DURATION counters by the reference's amounts; 3
             resident headline rounds move SOLVER_DELTA_APPLIED (host,
             device, decode) by 3 and set both resident-bytes gauges; a
             session opened on a card SolverService sets its HBM gauge and
             SOLVER_HBM_HEADROOM within 64 MiB of torch.cuda.mem_get_info;
             generate_latest's first 40 lines printed. (c) with
             configure_flight(budget_s=0.100), 3 knob-off headline rounds
             of a fresh scheduler: each round over budget lands on disk
             with the scheduler's five panels (the first, cold, always
             is), a resident round under it does not. (d) 5 + 5 interleaved untraced and traced rounds of each
             batch (walls printed), and under torch.profiler a traced and an
             untraced headline round do the same device work (kernel
             launches, device-to-host and host-to-device copies, after a
             discarded warm-up step). (e) the headline with a
             seeded 1% of its pods replaced by cpu: 100000 pods: one card
             round recorded by a DecisionLog ring; the stuck pods get
             resource_fit, every other unplaced pod is a zone
             anti-affinity pod with zone_topology (the batch's own, as
             tests/test_torch_explain.py holds against the JAX package),
             the verdicts equal a device="cpu" scheduler's, the
             .npz replays bit-exact on the native packer (obs/replay.py) and
             through pack_best on the card (one more launch), and a
             corrupted assignment is caught. (f) an SloEngine with the
             default objectives and a 5 s window: 12 knob-off headline
             rounds of a fresh scheduler (the first cold) must burn
             solve.p99 < 100ms; a BrownoutController ticked
             by hand climbs to rung 2, the router's probes pause and a
             canary_rate=1.0 round runs its kernel with no canary solve;
             resident rounds clean the window, the ladder walks back to 0
             and the next canaried round is checked again. (g) when grpc
             imports: serve() on the card with its health port and traced
             device="cpu" controller rounds — a unary headline round and a
             streamed team-mix round: each controller solver.wire span
             holds the grafted sidecar.solve / sidecar.fetch /
             sidecar.serialize records, GET /debug/traces?trace_id= on the
             sidecar's port returns its sidecar.pack tree under the
             controller's trace, parented on solve.pack_begin, and GET
             /metrics serves the port's families;
10. kernels — one JSON line listing every kernel of the port, with its
             launches on the main paths (phases 3 and 8 for pack_first_fit,
             6 and 8 for pack_first_fit_v2), on the unfused route (phase 9)
             and through the sidecar and the stream (phases 12 and 13, by
             part), the native packer's time on the same batches,
             ``degrade``: phase 11's canary solves and mismatches and its
             launches under injection, and ``stream``: phase 13's launches
             by part and the B of each coalesced launch, and ``obs``: phase
             14's launches by part, traced kernel and fetch times, and what
             (a)-(g) measured.

Every phase runs the default KARPENTER_PACKER (unset) unless it names a
value: on the card that is the device path, routed by shape. The
device="cpu" schedulers that give the reference plans route between their
plain versions and the native packer, as the default does on the CPU.
Every round of phases 3, 4, 6, 8 and 9 must name what served it (its
kernel, or native where 9 forces it): a round the FFD floor served
(ffd-degraded) or that names nothing fails the run.

Every garbage collection that stops the process for more than 0.1 s is
logged as a [gc] line with the objects still tracked.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_SOURCE = "karpenter_tpu_torch/solver/csrc/pack_first_fit.cu"
REPLACES = "karpenter_tpu/solver/pallas_kernel.py:51"  # _pack_kernel (pallas_call at :197)
V2_SOURCE = "karpenter_tpu_torch/solver/csrc/pack_first_fit_v2.cu"
V2_REPLACES = "karpenter_tpu/solver/pallas_kernel_v2.py:63"  # _pack_kernel_v2 (pallas_call at :243)
# nodes the JAX package's lax.scan kernel opens on the headline batch
HEADLINE_NODES = 431
# ... and on the full-width team mix (64 teams, two 110-pod nodes each)
DIVERSE_NODES = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def log_gc_pauses(over_s: float = 0.1):
    """Log every garbage collection that stops the process for longer than
    ``over_s``, with the objects it still tracks: a full collection of the
    script's heap stops every thread, which explains a host-clock outlier
    in whichever stage it lands. Returns the hook, for
    ``gc.callbacks.remove`` before the last lines are printed."""
    began = {}

    def hook(phase: str, info: dict) -> None:
        me = threading.get_ident()
        if phase == "start":
            began[me] = time.perf_counter()
            return
        took = time.perf_counter() - began.pop(me, time.perf_counter())
        if took > over_s:
            log(f"[gc] generation {info['generation']} collection {took * 1e3:.1f} ms, "
                f"{len(gc.get_objects())} objects tracked")

    gc.callbacks.append(hook)
    return hook


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def encode_batch(catalog, pods, topo_seed: int = 1):
    """The main path's host stages up to the kernel, with the port alone:
    catalog requirements, FFD sort, topology injection (Random(topo_seed)),
    daemon overhead, encode."""
    from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.ffd import daemon_overhead, sort_pods_ffd_with_statics
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.testing import make_provisioner

    catalog = sorted(catalog, key=lambda it: it.effective_price())
    c = make_provisioner(solver="tpu").spec.constraints.clone()
    c.requirements = c.requirements.merge(catalog_requirements(catalog))
    pods, sts = sort_pods_ffd_with_statics(pods)
    cluster = Cluster()
    plan = Topology(cluster, rng=random.Random(topo_seed)).inject_plan(c, pods, sts=sts)
    return enc.encode(c, catalog, pods, daemon_overhead(cluster, c), plan=plan)


def headline_batch(n_pods: int, n_types: int, seed: int):
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.testing import diverse_pods

    return encode_batch(instance_types(n_types), diverse_pods(n_pods, random.Random(seed)))


def team_pods(n_pods: int, seed: int, k_teams: int = 64):
    """The constraint-diverse pod mix (bench.py:171-199): cpu requests of
    0.25, 0.5 or 1 and k distinct nodeSelector team values."""
    from karpenter_tpu_torch.testing import make_pod

    rng = random.Random(seed)
    return [
        make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                 node_selector={"team": f"t{i % k_teams}"})
        for i in range(n_pods)
    ]


def v2_inputs(batch, device):
    """pack_first_fit_v2's inputs exactly as the main path builds them (the
    compact pod table unpacked on the device, the per-core tables from the
    invariants cache, the fresh-node fits derived on the device) and the
    cached signature-major copy the kernel walks: (inputs, front_s)."""
    import torch

    from karpenter_tpu_torch.solver import fused, pack_kernel_v2

    tab, open_by_core, bhh = fused.pack_pod_table(batch)
    uniq = fused.pad_uniq_req(batch.uniq_req)
    pod_side = [torch.tensor(np.ascontiguousarray(a), device=device)
                for a in (tab, open_by_core, bhh, uniq)]
    front_j, compat_j, jvals, frontiers, daemon, _, _, front_s = (
        fused.DeviceInvariants(device).get_v2(batch))
    return pack_kernel_v2.kernel_inputs(
        *fused._unpack_pods(*pod_side), frontiers, daemon, front_j, compat_j, jvals
    ), front_s


def kernel_inputs(batch, device):
    """pack_first_fit's inputs exactly as the main path builds them: the
    compact pod table unpacked on the device, the invariants uploaded."""
    import torch

    from karpenter_tpu_torch.solver import fused

    tab, open_by_core, bhh = fused.pack_pod_table(batch)
    uniq = fused.pad_uniq_req(batch.uniq_req)
    pod_side = [torch.tensor(np.ascontiguousarray(a), device=device)
                for a in (tab, open_by_core, bhh, uniq)]
    join, front, daemon, _, _ = fused.DeviceInvariants(device).get(batch)
    return fused._unpack_pods(*pod_side) + (join, front, daemon)


def compare(ref, out) -> float:
    """Max |difference| over the five outputs; raises unless bit-exact."""
    import torch

    worst = 0.0
    for name, a, b in zip(ref._fields, ref, out):
        a, b = a.cpu(), b.cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        worst = max(worst, diff)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"{name} differs (max |diff| {diff}) at {bad}")
    return worst


def events_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean CUDA-event time of ``fn()`` over ``iters`` calls, after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(args, n_max: int, iters: int, kernel=None, warmup: int = 3, **kw) -> float:
    """Mean CUDA-event time of ``kernel`` (pack_first_fit by default) over
    ``iters`` launches, after ``warmup`` launches."""
    from karpenter_tpu_torch.solver.pack_kernel import pack_first_fit

    kernel = kernel or pack_first_fit
    return events_ms(lambda: kernel(*args, n_max=n_max, **kw), iters, warmup)


def sweep(name: str, args, n_max: int, shape, ref, iters: int, card: str,
          kernel=None, **kw) -> None:
    """The kernel at each block size (G and the node table's place from the
    launch plan for ``shape`` = (F, R)), each result bit-exact with ``ref``;
    CUDA-event times."""
    from karpenter_tpu_torch.solver import pack_kernel

    kernel = kernel or pack_kernel.pack_first_fit
    F, R = shape
    default = pack_kernel.launch_plan(F, R, n_max)
    parts = []
    for threads in (t for t in (128, 256, 512, 1024) if t <= pack_kernel.max_threads(default.G)):
        plan = pack_kernel.launch_plan(F, R, n_max, threads=threads)
        compare(ref, kernel(*args, n_max=n_max, plan=plan, **kw))
        ms = kernel_ms(args, n_max, iters, kernel, 1, plan=plan, **kw)
        mark = " (the plan's)" if plan == default else ""
        parts.append(f"{threads} threads {ms:.4f} ms{mark}")
    log(f"[sweep] {name} n_max={n_max} G={default.G} smem nodes={default.node_state_in_smem}: "
        + ", ".join(parts) + f"; CUDA events, mean of {iters}; card {card}")


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


def nbytes(tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def v1_work(args, result):
    """(bytes, ops) pack_first_fit needs on this run: every input read once
    (the join table and frontiers whole; they are a few hundred bytes at the
    headline) and every output written once; the replay's operations plus
    each valid pod's fresh-node walk (R adds, then its open signature's
    frontier rows)."""
    valid, open_sig, core, host, hib, open_host, req, join, frontiers, daemon = (
        a.cpu().numpy() for a in args)
    F, R = frontiers.shape[1:]
    ops, _, _, _ = replay_work(
        (valid, open_sig, core, host, hib, open_host, req, daemon),
        result.assignment.cpu().numpy(),
        lambda c, sigs: (join[sigs, c] >= 0, join[sigs, c]),
        lambda c, sigs, ids: frontiers[ids],
        (result.node_sig.shape[-1], join.shape[1], join.shape[0]),
    )
    cmps, _, _ = walk((daemon + req)[valid][:, None, :] <= frontiers[open_sig[valid]])
    ops += int(valid.sum()) * R + int(cmps.sum())
    return nbytes(args) + nbytes(result), ops


def v2_work(args, result, F: int, R: int):
    """(bytes, ops) pack_first_fit_v2 needs on this run: the pod side read
    once, of the tables only the joinabilities, the frontier rows and the
    joined ids that the recurrence reads, and every output written once; the
    replay's operations (the fresh-node fits are an input)."""
    pod_scal, pod_req, front_j, compat_j, jvals, open_fits, daemon = (
        a.cpu().numpy() for a in args)
    C, _, S_pad = front_j.shape
    ops, compat, rows_read, jv = replay_work(
        (pod_scal[0] != 0, *pod_scal[1:4], pod_scal[4] != 0, pod_scal[5],
         np.ascontiguousarray(pod_req.T), daemon[:, 0]),
        result.assignment.cpu().numpy(),
        lambda c, sigs: (compat_j[c, 0, sigs] > 0.5, np.rint(jvals[c, 0, sigs]).astype(np.int64)),
        lambda c, sigs, ids: front_j[c, : F * R, sigs].reshape(-1, F, R),
        (result.node_sig.shape[-1], C, S_pad),
    )
    n_bytes = nbytes((args[0], args[1], args[5], args[6])) + nbytes(result)
    n_bytes += 4 * (int(compat.sum()) + int(rows_read.sum()) * R + int(jv.sum()))
    return n_bytes, ops


def profile_round(run, card: str) -> None:
    """One more main-path round under torch.profiler: device busy time by
    kernel, and the device's idle share of the round's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for row in prof.key_averages():
        us = row.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, row.count, row.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    if not rows:
        log(f"[profile] round {wall_ms:.3f} ms; device time not measured "
            "(the profiler recorded no device activity)")
        return
    log(f"[profile] round {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}; card {card}")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms:9.4f} ms  x{count:<3d} {key[:90]}")


def plan_of(nodes, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    return [
        ([index[id(p)] for p in n.pods], [it.name for it in n.instance_type_options],
         n.requests, n.constraints.requirements.requirements)
        for n in nodes
    ]


def served(sched, want: str, where: str) -> dict:
    """The round's profile; raises unless ``want`` served it — never the
    FFD floor (``ffd-degraded``), never a round without a name."""
    prof = sched.last_stage_profile()
    got = prof.get("packer_backend")
    if got != want:
        floor = " (the FFD floor)" if got in ("ffd-degraded", None) else ""
        raise AssertionError(f"{where}: served by {got!r}{floor}, expected {want}")
    return prof


def not_degraded(sched, where: str) -> dict:
    """A device="cpu" reference round's profile; raises when the floor
    served it or it names nothing."""
    prof = sched.last_stage_profile()
    if prof.get("packer_backend") in ("ffd-degraded", None):
        raise AssertionError(f"{where}: the reference round took the FFD floor "
                             f"({prof.get('packer_backend')!r})")
    return prof


def v2_parity(name: str, gpu, n_max: int, F: int, R: int, front_s=None) -> tuple:
    """pack_first_fit_v2 on the card against pack_v2_reference on CPU copies
    of the same inputs; raises unless bit-exact. Returns (result, max |diff|)."""
    import torch

    from karpenter_tpu_torch.solver import pack_kernel_v2
    from karpenter_tpu_torch.solver.kernel import pack_v2_reference

    out = pack_kernel_v2.pack_first_fit_v2(*gpu, n_max=n_max, F=F, R=R, front_s=front_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pack_v2_reference(*(a.cpu() for a in gpu), n_max=n_max, F=F, R=R)
    cpu_s = time.perf_counter() - t0
    worst = compare(ref, out)
    n = int(out.n_nodes)
    hosts = set(out.node_host[:n].tolist())
    log(f"[v2 parity] {name} n_max={n_max}: bit-exact, nodes={n} "
        f"unscheduled={int(((out.assignment < 0) & (gpu[0][0] != 0)).sum())} "
        f"host states -2:{-2 in hosts} -1:{-1 in hosts} h:{bool(hosts) and max(hosts) >= 0} "
        f"(plain version on CPU {cpu_s:.2f}s)")
    return out, worst


def synthetic_args(P: int, S: int, F: int, R: int, C: int, seed: int, n_hosts: int, device,
                   host_base: int = 0):
    """A seeded synthetic problem in pack_args() form. With ``n_hosts`` > 0
    half the pods pin a hostname id in [host_base, host_base + n_hosts)
    (node states -2, -1 and h), a tenth of the signatures have only
    FRONTIER_PAD rows and the back half of every frontier is PAD; with 0 it
    is the bench's shape (bench.py:206-220: no hostnames, no daemon)."""
    import torch

    rng = np.random.default_rng(seed)
    if n_hosts:
        host = np.where(rng.random(P) < 0.5, host_base + rng.integers(0, n_hosts, P), -1)
        hib = rng.random(P) < 0.7
        frontiers = rng.uniform(2.0, 8.0, (S, F, R))
        frontiers[:, F // 2:, :] = -1.0
        frontiers[rng.random(S) < 0.1] = -1.0
        core = rng.integers(0, C, P)
        open_sig = rng.integers(0, S, C)[core]
        req = rng.uniform(0.1, 1.5, (P, R))
        join = rng.integers(-1, S, (S, C))
        daemon = rng.uniform(0.0, 0.5, R)
        valid = rng.random(P) < 0.95
    else:
        host, hib, valid = np.full(P, -1), np.ones(P, bool), np.ones(P, bool)
        open_sig = rng.integers(0, S, P)
        core = rng.integers(0, C, P)
        req = rng.uniform(0.1, 1.0, (P, R))
        join = rng.integers(-1, S, (S, C))
        frontiers = rng.uniform(2.0, 16.0, (S, F, R))
        daemon = np.zeros(R)
    i32, f32 = torch.int32, torch.float32
    return (
        torch.tensor(valid, device=device),
        torch.tensor(open_sig, dtype=i32, device=device),
        torch.tensor(core, dtype=i32, device=device),
        torch.tensor(host, dtype=i32, device=device),
        torch.tensor(hib, device=device),
        torch.tensor(np.where(host >= 0, np.where(hib, host, -2), -1), dtype=i32, device=device),
        torch.tensor(req, dtype=f32, device=device),
        torch.tensor(join, dtype=i32, device=device),
        torch.tensor(frontiers, dtype=f32, device=device),
        torch.tensor(daemon, dtype=f32, device=device),
    )


def synthetic_v2(P: int, S: int, F: int, R: int, C: int, seed: int, n_hosts: int, device):
    """``synthetic_args``' problem as pack_first_fit_v2's inputs."""
    from karpenter_tpu_torch.solver import pack_kernel_v2

    return pack_kernel_v2.v2_args(*synthetic_args(P, S, F, R, C, seed, n_hosts, device))


def multi_stack(batches, catalog):
    """Stack batches that share their encoded shapes (asserted) for
    sharded_multi_solve: (arrays, type masks, usable, prices)."""
    shapes = {tuple(np.asarray(a).shape for a in b.pack_args()) for b in batches}
    if len(shapes) != 1:
        raise AssertionError(f"batches of one stack encode to different shapes: {shapes}")
    arrays = tuple(np.stack([np.asarray(b.pack_args()[i]) for b in batches]) for i in range(10))
    mask = np.stack([b.type_mask_matrix() for b in batches])
    prices = np.array(sorted(it.effective_price() for it in catalog), np.float32)
    return arrays, mask, batches[0].usable, prices


def diverse_phases(dev, card: str) -> tuple:
    """Phases 5-7: the v2 kernel against its plain version, the diverse main
    path, the multi-solve. Returns pack_first_fit_v2's kernels-line numbers
    and what phase 9 reuses of the team mix."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.parallel.sharding import sharded_multi_solve
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver.backend import KERNELS
    from karpenter_tpu_torch.solver.kernel import pack_v2_reference
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner

    # -- 5. v2 kernel against its plain version ---------------------------
    t0 = time.perf_counter()
    batch = encode_batch(instance_types_tradeoff(400), team_pods(10000, 9))
    P = len(batch.pod_valid)
    S, C = batch.join_table.shape
    F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
    route = pack_kernel_v2.fused_route(S, F, R, C)
    log(f"[v2 parity] full-width batch P={P} S={S} F={F} R={R} C={C} S*F={S * F} "
        f"tables={pack_kernel_v2.v2_table_bytes(S, F, R, C)} bytes route={route} "
        f"(encoded in {time.perf_counter() - t0:.2f}s)")
    if route != "v2":
        raise AssertionError(f"full-width batch routed {route}")
    gpu, front_s = v2_inputs(batch, dev)
    worst = 0.0
    results = {}
    for n_max in (512, P, 64):
        results[n_max], err = v2_parity("full width", gpu, n_max, F, R, front_s)
        worst = max(worst, err)
    if int(results[512].n_nodes) != DIVERSE_NODES or int(results[64].n_nodes) != 64:
        raise AssertionError(f"full width opened {int(results[512].n_nodes)} nodes at 512 "
                             f"and {int(results[64].n_nodes)} at 64")
    b64 = encode_batch(instance_types_tradeoff(64), team_pods(10000, 9))
    F64 = b64.frontiers.shape[1]
    gpu64, front_s64 = v2_inputs(b64, dev)
    worst = max(worst, v2_parity(f"tradeoff(64) F={F64}", gpu64, 512, F64, R, front_s64)[1])
    worst = max(worst, v2_parity("bench synthetic P=256 S=256 C=8 F=8 R=4",
                                 synthetic_v2(256, 256, 8, 4, 8, 7, 0, dev), 128, 8, 4)[1])
    pinned = synthetic_v2(4096, 200, 8, 4, 16, 7, 120, dev)
    for n_max in (1024, 4096):
        worst = max(worst, v2_parity("pinned synthetic P=4096 S=200 C=16 F=8 R=4",
                                     pinned, n_max, 8, 4)[1])

    t0 = time.perf_counter()
    pack_kernel_v2.pack_first_fit_v2(*gpu, n_max=512, F=F, R=R, front_s=front_s)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    iters = max(3, min(20, int(2000 / max(first_ms, 1e-3))))
    v2_kw = dict(F=F, R=R, front_s=front_s)
    ms_v2 = kernel_ms(gpu, 512, iters, pack_kernel_v2.pack_first_fit_v2, 1, **v2_kw)
    ms_v2_p = kernel_ms(gpu, P, iters, pack_kernel_v2.pack_first_fit_v2, 1, **v2_kw)
    v1 = kernel_inputs(batch, dev)
    ms_v1 = kernel_ms(v1, 512, iters, warmup=1)
    same = compare(pack_kernel.pack_first_fit(*v1, n_max=512), results[512])

    # the signature-major copy the walk reads: cached per closure on the main
    # path, made per call by the wrapper on the multi-solve; and the copy alone
    ms_copy = events_ms(lambda: pack_kernel_v2.signature_major(gpu[2]), 20)
    ms_per_call = kernel_ms(gpu, 512, iters, pack_kernel_v2.pack_first_fit_v2, 1, F=F, R=R)
    log(f"[v2 layout] full width n_max=512: with the cached signature-major copy "
        f"{ms_v2:.4f} ms; the wrapper copying per call {ms_per_call:.4f} ms; the copy "
        f"{ms_copy:.4f} ms; CUDA events, mean of {iters}; card {card}")
    sweep("pack_first_fit_v2 diverse", gpu, 512, (F, R), results[512], iters, card,
          pack_kernel_v2.pack_first_fit_v2, **v2_kw)
    sweep("pack_first_fit diverse", v1, 512, (F, R), results[512], iters, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pack_v2_reference(*gpu, n_max=512, F=F, R=R)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare(plain, results[512]), same)
    n_bytes, n_ops = v2_work(gpu, results[512], F, R)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"[v2 parity] full width: pack_first_fit_v2 {ms_v2:.4f} ms at n_max=512 "
        f"({ms_v2 * 1e6 / P:.1f} ns per pod step), {ms_v2_p:.4f} ms at n_max={P}; "
        f"pack_first_fit on the same batch {ms_v1:.4f} ms ({ms_v1 * 1e6 / P:.1f} ns per pod "
        f"step; same five outputs); CUDA events, mean of {iters}; plain version on the card "
        f"{plain_ms:.1f} ms; bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, "
        f"{n_ops} ops); card {card}")

    # -- 6. diverse main path ---------------------------------------------
    catalog = instance_types_tradeoff(400)
    pods = team_pods(10000, 9)
    prov = make_provisioner(solver="tpu")
    sched = Scheduler(Cluster(), rng=random.Random(1))
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit_v2", "diverse warm-up")
    log(f"[diverse] warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    t0 = time.perf_counter()
    cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    cpu_nodes = cpu_sched.solve(prov, catalog, pods)
    cpu_s = time.perf_counter() - t0
    not_degraded(cpu_sched, "diverse cpu plan")
    if plan_of(warm, pods) != plan_of(cpu_nodes, pods):
        raise AssertionError("diverse: cuda plan differs from the device='cpu' plan")
    if len(warm) != DIVERSE_NODES:
        raise AssertionError(f"diverse path opened {len(warm)} nodes, expected {DIVERSE_NODES}")
    log(f"[diverse] cuda plan == cpu plan ({len(cpu_nodes)} nodes, "
        f"{sum(len(n.pods) for n in cpu_nodes)} pods placed; cpu solve {cpu_s:.2f}s)")

    pack_kernel_v2.launches = 0
    rounds = []
    for r in range(5):
        before = pack_kernel_v2.launches
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit_v2", f"diverse round {r}")
        if pack_kernel_v2.launches <= before:
            raise AssertionError(f"diverse round {r} did not launch pack_first_fit_v2")
        if len(nodes) != DIVERSE_NODES:
            raise AssertionError(f"diverse round {r}: {len(nodes)} nodes")
        rounds.append(wall)
        stages = " ".join(
            f"{k}={prof[k] * 1e3:.3f}ms"
            for k in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s")
        )
        log(f"[diverse] round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, dispatches={prof['pack_dispatches']}, {stages}")
    launches = pack_kernel_v2.launches
    mean = sum(rounds) / len(rounds)
    log(f"[diverse] 5 rounds: mean {mean * 1e3:.3f} ms, {len(pods) / mean:.1f} pods/s, "
        f"pack_first_fit_v2 launches {launches}; kernel alone {ms_v2:.4f} ms (CUDA events); "
        f"card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    # -- 7. multi-solve -----------------------------------------------------
    stacks = {
        "v1": (instance_types(400), [diverse_pods(1250, random.Random(100 + b)) for b in range(8)]),
        "v2": (instance_types_tradeoff(400), [team_pods(1250, 100 + b) for b in range(8)]),
    }
    for want, (cat, pod_sets) in stacks.items():
        t0 = time.perf_counter()
        batches = [encode_batch(cat, ps, topo_seed=b) for b, ps in enumerate(pod_sets)]
        arrays, mask, usable, prices = multi_stack(batches, cat)
        encode_s = time.perf_counter() - t0
        B, Pm = arrays[6].shape[:2]
        n_max = max(256, Pm // 4)
        module = pack_kernel_v2 if want == "v2" else pack_kernel
        ref, ref_cheapest, _ = sharded_multi_solve("cpu", arrays, mask, usable, prices, n_max)
        before = module.launches
        out, cheapest, report = sharded_multi_solve(dev, arrays, mask, usable, prices, n_max)
        torch.cuda.synchronize()
        if report["route"] != KERNELS[want][0] or module.launches != before + 1:
            raise AssertionError(f"multi {want}: route {report}, {module.launches - before} launches")
        compare(ref, out)
        if not torch.equal(ref_cheapest, cheapest.cpu()):
            raise AssertionError(f"multi {want}: cheapest types differ from the cpu result")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            sharded_multi_solve(dev, arrays, mask, usable, prices, n_max)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3 / 3
        log(f"[multi] {want}: B={B} P={Pm} S={report['S']} F={report['F']} n_max={n_max} "
            f"route={report['route']} nodes={out.n_nodes.tolist()} == cpu for every batch and "
            f"cheapest; sharded_multi_solve {solve_ms:.3f} ms (host clock, mean of 3, "
            f"stack encoded in {encode_s:.2f}s); card {card}")

    return {
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms_v2,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "ns_per_pod": ms_v2 * 1e6 / P,
    }, {
        # for phase 9: the team mix's pods and device="cpu" plan, and the v2
        # result at n_max 512 that phase 5 held bit-exact with the plain version
        "pods": pods,
        "cpu_plan": plan_of(cpu_nodes, pods),
        "plain_512": results[512],
    }


DELTA_KEYS = ("sort_delta_s", "inject_delta_s", "encode_delta_s", "decode_delta_s",
              "validate_delta_s")


def stage_line(prof) -> str:
    """Every ``*_s`` stage of a round's profile, in the order it ran."""
    order = ("sort", "inject", "encode", "pack_fetch", "decode", "validate")
    keys = [k for st in order for k in (f"{st}_s", f"{st}_delta_s") if k in prof]
    return " ".join(f"{k}={prof[k] * 1e3:.3f}ms" for k in keys)


def resident_phase(dev, card: str) -> dict:
    """Phase 8: the resident delta path at full width on both routes.
    Returns each kernel's launches in the phase's measured rounds."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.testing import diverse_pods, make_pod, make_provisioner

    prov = make_provisioner(solver="tpu")

    # -- (a) headline, steady state ----------------------------------------
    catalog = instance_types(400)
    pods = diverse_pods(10000, random.Random(42))
    cluster = Cluster()
    sched = Scheduler(cluster, rng=random.Random(1), solver_delta=True)
    residency = sched.torch._pod_residency
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    log(f"[resident] headline warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}, "
        f"{stage_line(served(sched, 'pack_first_fit', 'resident headline warm-up'))}")
    warm_plan = plan_of(warm, pods)
    off_cpu = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_delta=False)
    if warm_plan != plan_of(off_cpu.solve(prov, catalog, pods), pods):
        raise AssertionError("resident headline: warm-up plan differs from the knob-off cpu plan")
    not_degraded(off_cpu, "resident headline knob-off cpu plan")
    if len(warm) != HEADLINE_NODES:
        raise AssertionError(f"resident headline opened {len(warm)} nodes, expected {HEADLINE_NODES}")
    # the cpu twin takes the warm-up and, later, the same mutation; the
    # steady rounds in between reuse the plan and draw no hostname
    twin_cluster = Cluster()
    twin = Scheduler(twin_cluster, rng=random.Random(1), device="cpu", solver_delta=True)
    if plan_of(twin.solve(prov, catalog, pods), pods) != warm_plan:
        raise AssertionError("resident headline: the cpu twin's warm-up plan differs")
    not_degraded(twin, "resident headline cpu twin warm-up")
    log(f"[resident] headline warm-up plan == knob-off cpu plan == cpu twin ({len(warm)} nodes)")

    pack_kernel.launches = 0
    rounds = []
    for r in range(5):
        before, reused = pack_kernel.launches, residency.stats["reused"]
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit", f"resident headline round {r}")
        missing = [k for k in DELTA_KEYS if k not in prof]
        if missing:
            raise AssertionError(f"resident headline round {r}: no {missing} in {sorted(prof)}")
        if pack_kernel.launches != before + 1:
            raise AssertionError(f"resident headline round {r}: {pack_kernel.launches - before} "
                                 f"launches of {prof['packer_backend']}")
        if residency.stats["reused"] != reused + 1:
            raise AssertionError(f"resident headline round {r}: PodResidency {residency.stats}")
        if plan_of(nodes, pods) != warm_plan:
            raise AssertionError(f"resident headline round {r}: plan differs from the warm-up's")
        rounds.append(wall)
        log(f"[resident] headline round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, {stage_line(prof)}")
    launches_v1 = pack_kernel.launches
    mean = sum(rounds) / len(rounds)
    log(f"[resident] headline 5 steady rounds: mean {mean * 1e3:.3f} ms, "
        f"{len(pods) / mean:.1f} pods/s, pack_first_fit launches {launches_v1}, "
        f"PodResidency {residency.stats}; card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    for c in (cluster, twin_cluster):
        late = c.create("pods", make_pod(name="resident-late", requests={"cpu": "0.5"}))
        c.bind(late, "resident-node-0")
    t0 = time.perf_counter()
    nodes = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = served(sched, "pack_first_fit", "resident headline after create + bind")
    if "inject_s" not in prof or "encode_s" not in prof:
        raise AssertionError(f"resident headline: the round after a bind kept {sorted(prof)}")
    if plan_of(nodes, pods) != plan_of(twin.solve(prov, catalog, pods), pods):
        raise AssertionError("resident headline: the post-bind plan differs from the cpu twin's")
    not_degraded(twin, "resident headline cpu twin after create + bind")
    log(f"[resident] headline after create + bind: {wall * 1e3:.3f} ms, re-injected and "
        f"encoded in full, plan == cpu twin ({len(nodes)} nodes), {stage_line(prof)}")

    # -- (b) team mix, churn -------------------------------------------------
    catalog = instance_types_tradeoff(400)
    pods = team_pods(10000, 9)
    sched = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
    residency = sched.torch._pod_residency
    off = Scheduler(Cluster(), rng=random.Random(1), solver_delta=False)
    off_cpu = Scheduler(Cluster(), rng=random.Random(1), device="cpu", solver_delta=False)
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit_v2", "resident team mix warm-up")
    log(f"[resident] team mix warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    if plan_of(warm, pods) != plan_of(off.solve(prov, catalog, pods), pods):
        raise AssertionError("resident team mix: warm-up plan differs from the knob-off plan")
    served(off, "pack_first_fit_v2", "resident team mix knob-off warm-up")

    rng = random.Random(11)
    churn = []
    for r in range(5):
        leave = set(rng.sample(range(len(pods)), 100))
        arrive = [make_pod(requests={"cpu": f"{rng.choice([0.25, 0.5, 1])}"},
                           node_selector={"team": f"t{rng.randrange(64)}"}) for _ in range(100)]
        pods = [p for i, p in enumerate(pods) if i not in leave] + arrive
        churn.append(("churn", pods))
    # the last pod swapped for one with its cpu request and another team
    # that has pods earlier in the batch: same sorted position, one column
    last = pods[-1]
    team = last.spec.node_selector["team"]
    other = next(p.spec.node_selector["team"] for p in pods
                 if p.spec.node_selector["team"] != team)
    swap = make_pod(requests={"cpu": str(last.spec.containers[0].requests["cpu"])},
                    node_selector={"team": other})
    churn.append(("swap", pods[:-1] + [swap]))

    def timed(scheduler, batch_pods):
        t0 = time.perf_counter()
        nodes = scheduler.solve(prov, catalog, batch_pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return nodes, wall, served(scheduler, "pack_first_fit_v2", "resident team mix round")

    # the knob-off comparisons launch the kernel too: only the resident
    # scheduler's launches are summed. The knob-off round on the same pods
    # runs beside each resident round, first on odd rounds, so the two are
    # timed in turns on one host
    pack_kernel_v2.launches = 0
    launches_v2 = 0
    off_walls, res_walls = [], []
    for r, (kind, batch_pods) in enumerate(churn):
        if r % 2:
            off_nodes, off_wall, off_prof = timed(off, batch_pods)
        before, stats = pack_kernel_v2.launches, dict(residency.stats)
        table = residency._entry[1][0]
        ptr = table.data_ptr()
        nodes, wall, prof = timed(sched, batch_pods)
        launched = pack_kernel_v2.launches - before
        launches_v2 += launched
        if launched != 1 or prof["packer_backend"] != "pack_first_fit_v2":
            raise AssertionError(f"resident team mix round {r}: {launched} "
                                 f"launches of {prof['packer_backend']}")
        if "encode_delta_s" not in prof:
            raise AssertionError(f"resident team mix round {r}: not the row delta, {sorted(prof)}")
        if not r % 2:
            off_nodes, off_wall, off_prof = timed(off, batch_pods)
        off_walls.append(off_wall)
        res_walls.append(wall)
        plan = plan_of(nodes, batch_pods)
        if plan != plan_of(off_nodes, batch_pods):
            raise AssertionError(f"resident team mix round {r}: plan differs from knob off")
        checked = "knob-off cuda plan"
        if r in (0, len(churn) - 1):
            if plan != plan_of(off_cpu.solve(prov, catalog, batch_pods), batch_pods):
                raise AssertionError(f"resident team mix round {r}: plan differs from the cpu plan")
            not_degraded(off_cpu, f"resident team mix round {r} cpu plan")
            checked += " and cpu plan"
        if kind == "swap":
            patched_in_place = (residency.stats["patched"] == stats["patched"] + 1
                                and residency._entry[1][0] is table and table.data_ptr() == ptr)
            if not patched_in_place:
                raise AssertionError(f"resident team mix swap round: not patched in place, "
                                     f"{stats} -> {residency.stats}")
        log(f"[resident] team mix round {r} ({kind}): {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(batch_pods) / wall:.1f}, == {checked}, {stage_line(prof)}, "
            f"PodResidency {residency.stats}")
        log(f"[resident] team mix round {r} knob off ({'first' if r % 2 else 'second'}): "
            f"{off_wall * 1e3:.3f} ms, {stage_line(off_prof)}")
    log(f"[resident] team mix: mean {sum(res_walls) / len(res_walls) * 1e3:.3f} ms resident, "
        f"{sum(off_walls) / len(off_walls) * 1e3:.3f} ms knob off over the same {len(churn)} "
        f"rounds; card {card}")
    log(f"[resident] team mix: {len(churn)} rounds, pack_first_fit_v2 launches {launches_v2}, "
        f"PodResidency {residency.stats}; card {card}")
    return {"pack_first_fit": launches_v1, "pack_first_fit_v2": launches_v2}


def host_ms(fn, iters: int) -> tuple:
    """(mean, min) host-clock ms of ``fn()`` over ``iters`` calls, after
    one call not timed."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / len(times), min(times)


def device_args(batch, device):
    """``batch.pack_args()`` as tensors on ``device``."""
    import torch

    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES

    return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
                 for a, (_, dtype) in zip(batch.pack_args(), PACK_ARG_DTYPES))


def host_result(result):
    """A PackResult over numpy arrays (the native packer's) as tensors."""
    import torch

    from karpenter_tpu_torch.solver.kernel import PackResult

    return PackResult(*(torch.as_tensor(np.asarray(a)) for a in result))


def route_phase(dev, card: str, classes: dict, n_pods: int = 10000) -> dict:
    """Phase 9: the cost router, the native packer and the unfused ladder.
    ``classes`` holds, for the headline and the team mix of ``n_pods``
    pods, phase 3's and phase 6's pods and device="cpu" plans (and the
    team mix's plain-version result at n_max 512). Returns each kernel's
    kernels-line additions."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, native, pack_kernel, pack_kernel_v2, router
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    head_cat, team_cat = instance_types(400), instance_types_tradeoff(400)
    batches = {
        "headline": headline_batch(n_pods, 400, 42),
        "team mix": encode_batch(team_cat, team_pods(n_pods, 9)),
    }
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    module_of = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    catalog_of = {"headline": head_cat, "team mix": team_cat}
    out = {name: {} for name in module_of}

    def timed(sched, pods, cls):
        # a knob-off scheduler draws new hostnames on every topology round:
        # each round replays the same draws (the topology rng reseeded as a
        # new scheduler's), so its plan is held against the cpu plan. solve
        # returns once its result is on the host
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog_of[cls], pods)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        prof = sched.last_stage_profile()
        if prof.get("packer_backend") in ("ffd-degraded", None):
            raise AssertionError(f"route {cls}: the round took the FFD floor "
                                 f"({prof.get('packer_backend')!r})")
        if plan_of(nodes, pods) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"route {cls}: plan differs from the device='cpu' plan "
                                 f"({prof.get('packer_backend')}, {prof.get('pack_route')})")
        return prof, wall

    # -- (a) the native packer against the kernels on the same batches -----
    t0 = time.perf_counter()
    if not native.native_available(wait=180):
        raise AssertionError("the native packer did not build (g++ -O3 -shared -fPIC)")
    log(f"[route] native packer built and loaded in {time.perf_counter() - t0:.2f}s "
        f"({native.lib_path().parent.name})")
    for cls, batch in batches.items():
        name = kernel_of[cls]
        P = len(batch.pod_valid)
        n_max = max(256, P // 4)  # the backend's native and unfused table
        args = batch.pack_args()
        gpu = device_args(batch, dev)
        unfused = (pack_kernel.pack_first_fit if name == "pack_first_fit"
                   else pack_kernel_v2.pack_unfused_v2)
        ref = unfused(*gpu, n_max=n_max)
        torch.cuda.synchronize()
        worst = compare(ref, host_result(native.pack_native(*args, n_max=n_max)))
        nat_ms, nat_min = host_ms(lambda: native.pack_native(*args, n_max=n_max), 5)
        nat512_ms, nat512_min = host_ms(lambda: native.pack_native(*args, n_max=512), 5)
        if name == "pack_first_fit":
            k_ms = kernel_ms(gpu, n_max, 5, warmup=1)
        else:
            inputs = pack_kernel_v2.v2_args(*gpu)
            F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
            k_ms = kernel_ms(inputs, n_max, 5, pack_kernel_v2.pack_first_fit_v2, 1, F=F, R=R,
                             front_s=pack_kernel_v2.signature_major(inputs[2]))

        def unfused_call():
            unfused(*gpu, n_max=n_max)
            torch.cuda.synchronize()

        unf_ms, unf_min = host_ms(unfused_call, 3)
        log(f"[route] (a) {cls} P={P} n_max={n_max}: native == {name} bit for bit "
            f"(max |diff| {worst}), {int(ref.n_nodes)} nodes; native {nat_ms:.4f} ms "
            f"(min {nat_min:.4f}) at n_max={n_max}, {nat512_ms:.4f} ms (min {nat512_min:.4f}) "
            f"at n_max=512, host clock, mean of 5; {name} {k_ms:.4f} ms at n_max={n_max} "
            f"(CUDA events, mean of 5); the unfused caller whole {unf_ms:.4f} ms "
            f"(min {unf_min:.4f}; host clock after a synchronize, mean of 3); card {card}")
        out[name].update(native_ms=nat_ms, native_ms_n_max=n_max, native_ms_512=nat512_ms,
                         unfused_ms=unf_ms, ms_at_native_n_max=k_ms)

    # -- (b) the unfused v1 route: KARPENTER_PACKER=pallas -----------------
    head_pods = classes["headline"]["pods"]
    sched = Scheduler(Cluster(), rng=random.Random(1))
    with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "pallas"}):
        pack_kernel.launches = 0
        for r in range(3):
            before = pack_kernel.launches
            prof, wall = timed(sched, head_pods, "headline")
            if (pack_kernel.launches != before + 1 or prof["packer_backend"] != "pack_first_fit"
                    or prof["pack_route"] != "unfused"):
                raise AssertionError(f"route (b) round {r}: {pack_kernel.launches - before} "
                                     f"launches, {prof['packer_backend']} {prof['pack_route']}")
            log(f"[route] (b) pallas headline round {r}: {wall * 1e3:.3f} ms, "
                f"{prof['packer_backend']} via {prof['pack_route']}, plan == fused == cpu, "
                f"dispatches={prof['pack_dispatches']}, {stage_line(prof)}")
        out["pack_first_fit"]["launches_unfused"] = pack_kernel.launches

    # -- (d) ids past int16 through pack_best on the card -------------------
    for rung, (S, F) in (("pack_first_fit", (12, 4)), ("pack_first_fit_v2", (300, 8))):
        args = synthetic_args(4096, S, F, 3, 16, 23, 6000, dev, host_base=32_000)
        host_hi = int(args[3].max())
        served, res = pack_kernel.pack_best(*args, n_max=1024)
        torch.cuda.synchronize()
        if served != rung or host_hi <= 32_767:
            raise AssertionError(f"route (d): {served} served (want {rung}), hostname ids to {host_hi}")
        worst = compare(pack_reference(*(a.cpu() for a in args), n_max=1024), res)
        log(f"[route] (d) pack_best P=4096 S={S} F={F} hostname ids to {host_hi}: {served}, "
            f"bit-exact with the plain version (max |diff| {worst}), {int(res.n_nodes)} nodes")

    # -- (e) auto on the card: the device path, no router -----------------
    # the router weighs native only for a device="cpu" scheduler; a fresh
    # one must stay empty however many card rounds run
    router.reset_default()
    shared = router.default_router()
    for cls in ("headline", "team mix"):
        name = kernel_of[cls]
        module = module_of[name]
        module.launches, native.calls = 0, 0
        sched = Scheduler(Cluster(), rng=random.Random(1))
        fetch = []
        for r in range(3):
            before = module.launches
            prof, wall = timed(sched, classes[cls]["pods"], cls)
            if (module.launches != before + 1 or prof["packer_backend"] != name
                    or prof["pack_route"] != "fused"):
                raise AssertionError(f"route (e) {cls} round {r}: {module.launches - before} "
                                     f"launches, {prof['packer_backend']} via {prof['pack_route']}")
            fetch.append(prof["pack_fetch_s"] * 1e3)
            log(f"[route] (e) {cls} round {r} (auto): {wall * 1e3:.3f} ms, {name} via fused, "
                f"plan == cpu, {stage_line(prof)}")
        if shared.report() or native.calls or sched.torch._probe_thread is not None:
            raise AssertionError(f"route (e) {cls}: the card consulted the router "
                                 f"({shared.report()}, {native.calls} native calls)")
        nat = out[name]["native_ms"]
        log(f"[route] (e) {cls}: 3 rounds under auto, {name} launches {module.launches}, native "
            f"calls 0, router empty; pack_fetch_s {min(fetch):.4f}-{max(fetch):.4f} ms against "
            f"native {nat:.4f} ms from (a) ({min(fetch) / nat:.2f}-{max(fetch) / nat:.2f}x); "
            f"card {card}")
        out[name].update(launches_route=module.launches, native_calls=native.calls)

    # -- (f) the resident path with the native packer forced ----------------
    # phase 8 holds the memos with the device typemask; here native (no
    # typemask) must hit them too
    sched = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
    with mock.patch.dict(os.environ, {"KARPENTER_PACKER": "native"}):
        for r in range(4):
            prof, wall = timed(sched, head_pods, "headline")
            memo = sched.torch._dec_memo
            hit = "decode_delta_s" in prof and "validate_delta_s" in prof
            if (prof["packer_backend"] != "native" or memo is None or memo[8] is not None
                    or hit != (r > 0)):
                raise AssertionError(f"route (f) round {r}: {prof['packer_backend']}, "
                                     f"memo hit {hit}, {sorted(prof)}")
            log(f"[route] (f) resident headline round {r} (native forced): {wall * 1e3:.3f} ms, "
                f"memos {'hit' if hit else 'filled'} with typemask None, {stage_line(prof)}")

    # -- (c) the unfused v2 route: a failed fused shape ---------------------
    team = batches["team mix"]
    shape = backend.TorchScheduler._fused_shape(team, backend.N_MAX_FIRST)
    with backend._fused_failed_lock:
        backend._fused_failed_shapes.add(shape)
    sched = Scheduler(Cluster(), rng=random.Random(1))
    pack_kernel_v2.launches = 0
    prof, wall = timed(sched, classes["team mix"]["pods"], "team mix")
    launched = pack_kernel_v2.launches
    if (launched != 1 or prof["packer_backend"] != "pack_first_fit_v2"
            or prof["pack_route"] != "unfused"):
        raise AssertionError(f"route (c): {launched} launches, {prof['packer_backend']} "
                             f"via {prof['pack_route']}")
    log(f"[route] (c) team mix with fused shape {shape} failed: {wall * 1e3:.3f} ms, "
        f"{prof['packer_backend']} via {prof['pack_route']}, 1 launch, plan == fused == cpu, "
        f"{stage_line(prof)}")
    out["pack_first_fit_v2"]["launches_unfused"] = launched
    served, res = pack_kernel.pack_best(*device_args(team, dev), n_max=512)
    if served != "pack_first_fit_v2":
        raise AssertionError(f"route (c): pack_best served {served}")
    worst = compare(classes["team mix"]["plain_512"], res)
    log(f"[route] (c) pack_best on the team mix's pack_args() at n_max=512: {served}, "
        f"bit-exact with the plain version (max |diff| {worst})")
    with backend._fused_failed_lock:
        fused_memo = set(backend._fused_failed_shapes)
    with pack_kernel._failed_shapes_lock:
        ladder_memo = set(pack_kernel._failed_shapes)
    if fused_memo != {shape} or ladder_memo:
        raise AssertionError(f"route: failed-shape memos {fused_memo}, {ladder_memo}")
    log(f"[route] failed-shape memos: fused {fused_memo}, ladder {ladder_memo}")
    return out


def degrade_phase(card: str, classes: dict) -> dict:
    """Phase 11: the degrade ladder around both kernels, at full width. (a)
    runs healthy with the canary on every round; (b)-(f) reach each trigger
    only by injection at the Python level (a kernel or split function
    made to raise, a fetched host buffer altered, a forced overflow; never
    a device fault), and each round that the reference would serve from its
    FFD floor must raise: the card has no floor. ``classes`` holds the
    earlier phases' pods and device="cpu" plans. Returns each kernel's
    kernels-line ``degrade`` entry."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.resilience import BreakerOpen
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, fused, integrity, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.backend import InvalidPackError
    from karpenter_tpu_torch.solver.signature import SignatureOverflow
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    catalogs = {"headline": instance_types(400), "team mix": instance_types_tradeoff(400),
                "retry": instance_types(50)}
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2",
                 "retry": "pack_first_fit"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {"canary_solves": 0, "canary_mismatches": 0, "launches_injected": 0}
           for name in modules}
    memos = ((pack_kernel._failed_shapes_lock, pack_kernel._failed_shapes),
             (backend._fused_failed_lock, backend._fused_failed_shapes))
    saved = []
    for lock, memo in memos:
        with lock:
            saved.append(set(memo))

    def restore_memos():
        for (lock, memo), was in zip(memos, saved):
            with lock:
                memo.clear()
                memo.update(was)

    def launches():
        return {name: m.launches for name, m in modules.items()}

    def run(sched, cls, pods):
        """One round: the topology rng of a knob-off scheduler reseeded (its
        plan is held against a plan that drew from Random(1)); returns
        (nodes, profile, wall ms, launches by kernel)."""
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        before = launches()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], pods)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = launches()
        return nodes, sched.last_stage_profile(), wall, {k: after[k] - before[k] for k in after}

    def delta(before):
        now = integrity.totals()
        return {k: now[k] - before[k] for k in now if now[k] != before[k]}

    integrity.reset()
    try:
        # -- (a) the canary on every healthy round, full width ---------------
        canary_ms, canary_n_max, screen_ms = [], [], []
        real_check, real_screen = backend.TorchScheduler._canary_check, integrity.screen_result

        def timed_check(self, batch, result, address=""):
            t0 = time.perf_counter()
            real_check(self, batch, result, address)
            canary_ms.append((time.perf_counter() - t0) * 1e3)
            canary_n_max.append(int(np.asarray(result[1]).shape[0]))

        def timed_screen(result, n_pods):
            t0 = time.perf_counter()
            verdict = real_screen(result, n_pods=n_pods)
            screen_ms.append((time.perf_counter() - t0) * 1e3)
            return verdict

        plan = [("headline", False, 3), ("team mix", False, 3), ("retry", False, 1),
                ("headline", True, 2)]
        n_rounds = sum(n for _, _, n in plan)
        with mock.patch.object(backend.TorchScheduler, "_canary_check", timed_check), \
                mock.patch.object(integrity, "screen_result", timed_screen):
            for cls, resident, n in plan:
                sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0,
                                  solver_delta=resident)
                name = kernel_of[cls]
                for r in range(n):
                    before = integrity.totals()
                    nodes, prof, wall, launched = run(sched, cls, classes[cls]["pods"])
                    thread = sched.torch._canary_thread
                    if thread is None:
                        raise AssertionError(f"degrade (a) {cls} round {r}: no canary started")
                    thread.join(timeout=300)
                    if thread.is_alive():
                        raise AssertionError(f"degrade (a) {cls} round {r}: the canary hangs")
                    got = delta(before)
                    want_launches = prof["pack_dispatches"]
                    if (prof.get("packer_backend") != name or launched[name] != want_launches
                            or got != {"canary_solves": 1}):
                        raise AssertionError(f"degrade (a) {cls} round {r}: "
                                             f"{prof.get('packer_backend')}, {launched}, {got}")
                    if plan_of(nodes, classes[cls]["pods"]) != classes[cls]["cpu_plan"]:
                        raise AssertionError(f"degrade (a) {cls} round {r}: plan differs "
                                             "from the device='cpu' plan")
                    out[name]["canary_solves"] += 1
                    log(f"[degrade] (a) {cls}{' resident' if resident else ''} round {r}: "
                        f"{wall:.3f} ms, {name} x{launched[name]}, plan == cpu, canary "
                        f"clean (native re-solve and compare {canary_ms[-1]:.3f} ms off the "
                        f"path, n_max={canary_n_max[-1]}), screen {screen_ms[-1]:.4f} ms; "
                        f"{stage_line(prof)}")
        totals = integrity.totals()
        if (totals["canary_solves"] != n_rounds or totals["canary_mismatches"]
                or totals["quarantines"] or totals["screen_failures"]):
            raise AssertionError(f"degrade (a): {totals} over {n_rounds} rounds")
        log(f"[degrade] (a) {n_rounds} healthy rounds with canary_rate=1.0: canary_solves "
            f"{totals['canary_solves']}, 0 mismatches, 0 quarantines; canary "
            f"{min(canary_ms):.3f}-{max(canary_ms):.3f} ms off the path, screen "
            f"{min(screen_ms):.4f}-{max(screen_ms):.4f} ms a round (host clock); card {card}")

        head_pods, team = classes["headline"]["pods"], classes["team mix"]["pods"]

        def inject_count(launched):
            for k, v in launched.items():
                out[k]["launches_injected"] += v

        def refused(where, sched, cls, pods, error, match):
            """One round that must raise ``error`` (its message holding
            ``match``): the card serves no floor. Returns (profile, wall
            ms, launches by kernel, the message)."""
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            before = launches()
            t0 = time.perf_counter()
            try:
                sched.solve(prov, catalogs[cls], pods)
            except error as e:
                message = str(e)
            else:
                raise AssertionError(f"degrade {where}: served "
                                     f"({sched.last_stage_profile().get('packer_backend')}), "
                                     f"expected {error.__name__}")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            after = launches()
            launched = {k: after[k] - before[k] for k in after}
            inject_count(launched)
            prof = sched.last_stage_profile()
            if match not in message or prof.get("packer_backend") == "ffd-degraded":
                raise AssertionError(f"degrade {where}: {error.__name__}({message!r}), "
                                     f"{prof.get('packer_backend')}")
            return prof, wall, launched, message

        def breaker_refuses(where, sched, cls, pods):
            """The quarantined or failing shape's next round: BreakerOpen,
            no kernel launched."""
            prof, wall, launched, message = refused(where, sched, cls, pods, BreakerOpen, "pack:")
            if any(launched.values()):
                raise AssertionError(f"degrade {where}: launched {launched}")
            log(f"[degrade] {where}: {wall:.3f} ms, {message}, no launch; "
                f"{stage_line(prof)}; card {card}")

        # -- (b) both kernels raise for the headline shape --------------------
        calls = []

        def broken(*a, **kw):
            calls.append(1)
            raise RuntimeError("kernel launch failed (injected)")

        sched = Scheduler(Cluster(), rng=random.Random(1))
        with mock.patch.object(fused, "pack_first_fit", broken), \
                mock.patch.object(pack_kernel, "pack_first_fit", broken), \
                mock.patch.object(pack_kernel_v2, "pack_first_fit_v2", broken):
            for r in range(2):
                n_calls = len(calls)
                prof, wall, launched, message = refused(
                    f"(b) round {r}", sched, "headline", head_pods, RuntimeError, "no kernel served")
                # round 1 may find both shapes in the ladder's failed memo
                if any(launched.values()) or (r == 0 and len(calls) == n_calls):
                    raise AssertionError(f"degrade (b) round {r}: launched {launched}, "
                                         f"kernel calls {len(calls) - n_calls}")
                log(f"[degrade] (b) both kernels raise, round {r}: {wall:.3f} ms, raised "
                    f"{message!r} after {len(calls) - n_calls} kernel calls; "
                    f"{stage_line(prof)}; card {card}")
            n_calls = len(calls)
            breaker_refuses("(b) round 2", sched, "headline", head_pods)
            opened = sched.torch._pack_breakers.open_dependencies()
            if len(calls) != n_calls or len(opened) != 1 or integrity.totals()["quarantines"]:
                raise AssertionError(f"degrade (b) round 2: kernel calls {len(calls) - n_calls}, "
                                     f"open {opened}")
        restore_memos()

        # -- (c) a NaN in the fetched headline buffer -------------------------
        real_split = fused.split_fused

        def nan_split(*a, **kw):
            result, typemask = real_split(*a, **kw)
            result.node_req[0, 0] = np.nan  # a view into the fetched host buffer
            return result, typemask

        cluster = Cluster()
        sched = Scheduler(cluster, rng=random.Random(1))
        before = integrity.totals()
        with mock.patch.object(fused, "split_fused", nan_split):
            prof, wall, launched, message = refused(
                "(c)", sched, "headline", head_pods, InvalidPackError, "integrity screen")
        got = delta(before)
        events = [e for e in cluster.list("events")
                  if (e.type, e.reason) == ("Warning", "IntegrityQuarantine")]
        opened = sched.torch._pack_breakers.open_dependencies()
        if (got != {"screen_failures": 1, "quarantines": 1} or len(events) != 1 or not opened
                or launched["pack_first_fit"] != 1 or prof["packer_backend"] != "pack_first_fit"):
            raise AssertionError(f"degrade (c): {got}, {len(events)} events, open {opened}, "
                                 f"launched {launched}")
        log(f"[degrade] (c) NaN in node_req of the fetched buffer: {wall:.3f} ms, "
            f"pack_first_fit x1, screen failed, 1 quarantine, breaker open {opened}, 1 "
            f"IntegrityQuarantine Warning ({events[0].message!r}), raised {message!r}; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(c) next round", sched, "headline", head_pods)
        restore_memos()

        # -- (d) an invalid plan on the team mix -------------------------------
        sched = Scheduler(Cluster(), rng=random.Random(1))
        real_decode = sched.torch._decode

        def double_placed(*a, **kw):
            nodes = real_decode(*a, **kw)
            nodes[1].pods.append(nodes[0].pods[0])
            return nodes

        sched.torch._decode = double_placed
        before = integrity.totals()
        prof, wall, launched, message = refused(
            "(d)", sched, "team mix", team, InvalidPackError, "invalid plan")
        got = delta(before)
        if got != {"quarantines": 1} or launched["pack_first_fit_v2"] != 1:
            raise AssertionError(f"degrade (d): {got}, launched {launched}")
        log(f"[degrade] (d) a pod placed twice after decode (team mix): {wall:.3f} ms, "
            f"pack_first_fit_v2 x1, 1 quarantine, raised {message!r}; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(d) next round", sched, "team mix", team)
        restore_memos()

        # -- (e) a signature overflow on both encode attempts ------------------
        encodes = []

        def overflow(*a, **kw):
            encodes.append(1)
            raise SignatureOverflow("forced signature overflow (injected)")

        sched = Scheduler(Cluster(), rng=random.Random(1))
        before = integrity.totals()
        with mock.patch.object(enc, "encode", overflow):
            prof, wall, launched, message = refused(
                "(e)", sched, "headline", head_pods, SignatureOverflow, "forced")
        if (any(launched.values()) or len(encodes) != 2 or delta(before)
                or "packer_backend" in prof):
            raise AssertionError(f"degrade (e): launched {launched}, {len(encodes)} encodes, "
                                 f"{prof.get('packer_backend')}")
        log(f"[degrade] (e) overflow on both encode attempts: {wall:.3f} ms, raised "
            f"{message!r}, no packer_backend, no launch; {stage_line(prof)}; card {card}")

        # -- (f) a screen-clean wrong total, caught by the canary --------------
        # one cpu core: node totals are in millicores, and +1.0 (one
        # millicore) on a node of 100 cores is inside the comparator's
        # rtol of 1e-5
        def wrong_after_screen(result, n_pods):
            verdict = real_screen(result, n_pods=n_pods)
            np.asarray(result[3])[0, 0] += 1000.0  # the served host buffer
            return verdict

        sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0)
        before = integrity.totals()
        with mock.patch.object(integrity, "screen_result", wrong_after_screen):
            nodes, prof, wall, launched = run(sched, "headline", head_pods)
        inject_count(launched)
        sched.torch._canary_thread.join(timeout=300)
        if sched.torch._canary_thread.is_alive():
            raise AssertionError("degrade (f): the canary hangs")
        got = delta(before)
        if (prof.get("packer_backend") != "pack_first_fit" or launched["pack_first_fit"] != 1
                or got != {"canary_solves": 1, "canary_mismatches": 1, "quarantines": 1}):
            raise AssertionError(f"degrade (f): {prof.get('packer_backend')}, {launched}, {got}")
        log(f"[degrade] (f) one cpu core on node_req[0, 0] after the screen: {wall:.3f} ms, "
            f"served by pack_first_fit, the canary mismatched, 1 quarantine; "
            f"{stage_line(prof)}; card {card}")
        breaker_refuses("(f) next round", sched, "headline", head_pods)
    finally:
        restore_memos()
    log(f"[degrade] launches under injection: "
        f"{ {k: v['launches_injected'] for k, v in out.items()} }; card {card}")
    return out




def free_address() -> str:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def sidecar_inputs() -> tuple:
    """Phases 12 and 13's catalogs and encoded batches at full width: the
    headline (instance_types(400) x diverse_pods(10000, Random(42))) and
    the team mix (instance_types_tradeoff(400) x 10,000 pods, 64 teams)."""
    from karpenter_tpu_torch.cloudprovider.fake import instance_types, instance_types_tradeoff

    catalogs = {"headline": instance_types(400), "team mix": instance_types_tradeoff(400)}
    batches = {"headline": headline_batch(10000, 400, 42),
               "team mix": encode_batch(catalogs["team mix"], team_pods(10000, 9))}
    return catalogs, batches


def sidecar_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict) -> dict:
    """Phase 12: the solver sidecar on the card, at full width. (a) the
    device half, byte level: frames built with the port's codec from each
    batch's pack_args() go straight to a SolverService on the card; every
    untraced response's fused buffer must equal kernel.fuse_result of the
    in-process backend.pack_unfused on the same tensors, and every status
    is reached once. (b) when grpc imports on this host: a device="cpu"
    scheduler (a controller has no card) against serve() on the card,
    every round served by the sidecar with the in-process card plan.
    ``classes`` holds phases 3 and 6's pods and device="cpu" plans (equal
    to the card plans there). Returns each kernel's launches by part, and
    the knob-off rounds' ``wire_ser_s`` (ms) by batch under
    ``"wire_ser_ms"``."""
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import backend, integrity, kernel, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import service as svc_mod
    from karpenter_tpu_torch.testing import make_pod, make_provisioner

    S = svc_mod
    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {} for name in modules}
    out["wire_ser_ms"] = {cls: [] for cls in kernel_of}

    def zero():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    def key_arr(key):
        return np.frombuffer(key, np.int32)

    def status_of(resp):
        return int(S.unpack_arrays(resp)[0].reshape(-1)[0])

    # -- (a) the device half, byte level -------------------------------------
    svc = S.SolverService()
    warm = S.SolverService()
    t0 = time.perf_counter()
    warm.warmup()
    if not warm.ready.is_set():
        raise AssertionError(f"sidecar warm-up left the service unready ({warm.served})")
    log(f"[sidecar] (a) warm-up {time.perf_counter() - t0:.3f}s: ready, served {warm.served}")
    frames = {}
    for cls, batch in batches.items():
        args = [np.ascontiguousarray(a) for a in batch.pack_args()]
        P = len(args[0])
        n_max = max(256, P // 4)  # what TorchScheduler sends a sidecar
        key = S.catalog_session_key(*args[7:])
        opened = S.unpack_arrays(svc.open_session_bytes(S.pack_arrays([key_arr(key)] + args[7:])))
        if int(opened[0][0]) != S.STATUS_OK or int(opened[1][0]) != S.SIDECAR_FEATURES:
            raise AssertionError(f"sidecar {cls}: open answered {opened}")
        pinned = svc.session_tensors(key)
        if any(t.device.type != dev.type for t in pinned):
            raise AssertionError(f"sidecar {cls}: session tensors not on the card")
        gpu = device_args(batch, dev)
        ref_name, ref = backend.pack_unfused(*gpu, n_max=n_max)
        want = kernel.fuse_result(ref).cpu().numpy().tobytes()
        if ref_name != kernel_of[cls]:
            raise AssertionError(f"sidecar {cls}: in-process pack_unfused served {ref_name}")
        frame = S.pack_arrays([key_arr(key), np.asarray([n_max, 1], np.int32)] + args[:7])
        frames[cls] = (args, key, n_max, frame)
        zero()
        before = dict(svc.served)
        walls = []
        for r in range(3):
            t0 = time.perf_counter()
            resp = svc.solve_bytes(frame)
            walls.append((time.perf_counter() - t0) * 1e3)
            arrays = S.unpack_arrays(resp)
            if int(arrays[0][0]) != S.STATUS_OK or arrays[1].tobytes() != want:
                raise AssertionError(f"sidecar {cls} round {r}: status {int(arrays[0][0])}, "
                                     "fused buffer differs from the in-process pack_unfused")
            log(f"[sidecar] (a) {cls} untraced round {r}: {walls[-1]:.3f} ms solve_bytes, "
                f"{len(resp)} bytes, == in-process pack_unfused ({ref_name}, n_max={n_max})")
        ctx = S._trace_ctx_array(S.TraceContext("5a" * 16, "a5" * 8))
        t0 = time.perf_counter()
        resp = svc.solve_bytes(S.pack_arrays(
            [key_arr(key), np.asarray([n_max, 1], np.int32)] + args[:7] + [ctx]))
        wall = (time.perf_counter() - t0) * 1e3
        arrays = S.unpack_arrays(resp)
        if arrays[1].tobytes() != want:
            raise AssertionError(f"sidecar {cls}: traced round's buffer differs")
        solve_s, fetch_s, ser_s = (float(x) for x in arrays[2])
        log(f"[sidecar] (a) {cls} traced round: {wall:.3f} ms solve_bytes; stage trailer "
            f"solve_s={solve_s * 1e3:.3f}ms fetch_s={fetch_s * 1e3:.3f}ms "
            f"serialize_s={ser_s * 1e3:.3f}ms; card {card}")
        launched = counts()
        got = {k: svc.served.get(k, 0) - before.get(k, 0) for k in svc.served}
        got = {k: v for k, v in got.items() if v}
        if got != {kernel_of[cls]: 4} or launched[kernel_of[cls]] < 4:
            raise AssertionError(f"sidecar {cls}: served {got}, launches {launched}")
        out[kernel_of[cls]]["launches_sidecar_device"] = launched[kernel_of[cls]]
        out[kernel_of[cls]]["sidecar_solve_bytes_ms"] = walls
    # every refusal once, none of them dispatched
    args, key, n_max, frame = frames["headline"]
    dispatches = svc.dispatches
    head = [key_arr(key), np.asarray([n_max, 1], np.int32)]
    refusals = {
        S.STATUS_NEEDS_CATALOG: svc.solve_bytes(S.pack_arrays(
            [key_arr(bytes(16)), head[1]] + args[:7])),
        S.STATUS_DEADLINE_EXCEEDED: svc.solve_bytes(S.pack_arrays(
            head + args[:7] + [np.asarray([0.0], np.float32)])),
        S.STATUS_NEEDS_DELTA_BASE: svc.solve_bytes(S.pack_arrays(
            [head[0], np.asarray([n_max, 1, S.PACK_FLAG_DELTA], np.int32),
             S.delta_header(S.DELTA_ELIDE, 0, bytes(16), bytes(range(16)))])),
    }
    corrupt = bytearray(S.append_checksum(frame))
    corrupt[len(corrupt) // 2] ^= 0x01
    refusals[S.STATUS_INTEGRITY] = svc.solve_bytes(bytes(corrupt))
    full = S.SolverService(max_inflight=1, queue_depth=0)
    if full.admission.enter() != "admitted":
        raise AssertionError("sidecar: could not hold the one admission slot")
    try:
        refusals[S.STATUS_OVERLOADED] = full.solve_bytes(frame)
    finally:
        full.admission.leave()
    for want_status, resp in refusals.items():
        if status_of(resp) != want_status:
            raise AssertionError(f"sidecar: expected status {want_status}, got {status_of(resp)}")
    if svc.dispatches != dispatches or full.dispatches:
        raise AssertionError("sidecar: a refused frame reached the device")
    log(f"[sidecar] (a) statuses NEEDS_CATALOG, DEADLINE_EXCEEDED, NEEDS_DELTA_BASE, "
        f"INTEGRITY, OVERLOADED each answered, 0 dispatched; shed {svc.shed}, "
        f"checksum failures {svc.checksum_failures}; sessions {svc.session_count()} pinning "
        f"{svc.resident_bytes()} bytes, device headroom "
        f"{S.publish_device_headroom(dev)} bytes")

    # -- (b) the client and the transport ------------------------------------
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[sidecar] grpc not installed on this host: (b) is held by the CPU tests")
        log(f"[sidecar] served {svc.served}, dispatches {svc.dispatches}")
        return out
    address = free_address()
    server = S.serve(address, service=S.SolverService())
    os.environ["KARPENTER_PACKER"] = "fused"
    try:
        # the card plan of the swapped team mix (phases 3 and 6 held the
        # card's plans of the other batches equal to the cpu plans)
        team = classes["team mix"]["pods"]
        last = team[-1]
        other = next(p.spec.node_selector["team"] for p in team
                     if p.spec.node_selector["team"] != last.spec.node_selector["team"])
        swapped = team[:-1] + [make_pod(
            requests={"cpu": str(last.spec.containers[0].requests["cpu"])},
            node_selector={"team": other})]
        card_sched = Scheduler(Cluster(), rng=random.Random(1))
        swapped_plan = plan_of(card_sched.solve(prov, catalogs["team mix"], swapped), swapped)
        served(card_sched, "pack_first_fit_v2", "sidecar swapped team mix card plan")

        def sidecar_round(sched, cls, pods, want_plan, what):
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            svc_now = server.solver_service
            before = dict(svc_now.served)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalogs[cls], pods)
            wall = (time.perf_counter() - t0) * 1e3
            prof = served(sched, "sidecar", f"sidecar {what}")
            got = {k: svc_now.served.get(k, 0) - before.get(k, 0) for k in svc_now.served}
            got = {k: v for k, v in got.items() if v}
            if got != {kernel_of[cls]: prof["pack_dispatches"]}:
                raise AssertionError(f"sidecar {what}: the sidecar served {got}")
            if plan_of(nodes, pods) != want_plan:
                raise AssertionError(f"sidecar {what}: plan differs from the card plan")
            log(f"[sidecar] (b) {what}: {wall:.3f} ms, nodes={len(nodes)}, "
                f"wire_ser_s={prof['wire_ser_s'] * 1e3:.3f}ms "
                f"wire_deser_s={prof['wire_deser_s'] * 1e3:.3f}ms "
                f"pack_fetch_s={prof['pack_fetch_s'] * 1e3:.3f}ms "
                f"delta_kind={prof.get('delta_kind')} served {got}; {stage_line(prof)}")
            return prof

        zero()
        sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address)
        for cls in ("headline", "team mix"):
            for r in range(3):
                prof = sidecar_round(sched, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                                     f"{cls} round {r}")
                out["wire_ser_ms"][cls].append(prof["wire_ser_s"] * 1e3)
        res = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                        solver_service_address=address, solver_delta=True)
        kinds = [sidecar_round(res, "headline", classes["headline"]["pods"],
                               classes["headline"]["cpu_plan"],
                               f"resident headline round {r}").get("delta_kind")
                 for r in range(3)]
        if kinds != ["establish", "elide", "elide"]:
            raise AssertionError(f"sidecar resident headline: delta kinds {kinds}")
        churn = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address, solver_delta=True)
        kinds = [sidecar_round(churn, "team mix", pods, plan, f"team mix churn {what}")
                 .get("delta_kind") for pods, plan, what in (
                     (team, classes["team mix"]["cpu_plan"], "base"),
                     (swapped, swapped_plan, "one-pod swap"))]
        if kinds != ["establish", "patch"]:
            raise AssertionError(f"sidecar team mix churn: delta kinds {kinds}")
        checked = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                            solver_service_address=address, pack_checksum=True)
        sidecar_round(checked, "headline", classes["headline"]["pods"],
                      classes["headline"]["cpu_plan"], "checksummed headline round")
        if integrity.totals()["checksum_failures"] or server.solver_service.checksum_failures:
            raise AssertionError("sidecar: checksum failures on a healthy wire")
        # a restart on the same address: the next round re-opens through
        # NEEDS_CATALOG and the new sidecar serves it
        old = server.solver_service
        log(f"[sidecar] (b) before restart: served {old.served}, dispatches {old.dispatches}")
        server.stop(grace=None)
        server = S.serve(address, service=S.SolverService())
        uploads = sched.torch._remote.session_uploads
        sidecar_round(sched, "headline", classes["headline"]["pods"],
                      classes["headline"]["cpu_plan"], "headline round after a restart")
        if sched.torch._remote.session_uploads != uploads + 1:
            raise AssertionError("sidecar restart: no re-open")
        launched = counts()
        for name in modules:
            if not launched[name]:
                raise AssertionError(f"sidecar (b): {name} never launched")
            out[name]["launches_sidecar_wire"] = launched[name]
        log(f"[sidecar] (b) kernel launches {launched}; after restart served "
            f"{server.solver_service.served}, dispatches {server.solver_service.dispatches}; "
            f"card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        server.stop(grace=None)
    log(f"[sidecar] served {svc.served}, dispatches {svc.dispatches} (device half)")
    return out


def wait_for(predicate, timeout: float, what: str) -> None:
    """Poll ``predicate`` every 20 ms; raise after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f}s waiting for {what}")
        time.sleep(0.02)


def stream_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict,
                 wire_ser_unary: dict) -> dict:
    """Phase 13: the sidecar's persistent stream at full width. (a) the
    device half, byte level: distinct headline and team-mix frames parsed
    by stream_parse_solve and served by solve_stream_group in groups of 8,
    3 (padded to 4) and 4; each group is ONE launch of its kernel with
    B > 1 and answers every entry with its solve_bytes bytes; an arena
    descriptor solve; an expired deadline shed with no launch. (b) when
    grpc imports: device="cpu" controllers against serve() on the card
    over the stream, the arena, the resident delta frames, a restart, an
    8-client salvo that coalesces, a two-member pool that fails over, and
    two threads on one scheduler overlapping a chaos-slowed sidecar.
    Returns per kernel its launches by part and the B of each coalesced
    launch."""
    import shutil

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import kernel, native, pack_kernel, pack_kernel_v2
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.solver import stream as ST
    from karpenter_tpu_torch.solver.pool import HashRing
    from karpenter_tpu_torch.testing import make_provisioner
    from karpenter_tpu_torch.testing.chaos import ChaosPolicy, chaos_wrap

    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    out = {name: {"coalesced_B": []} for name in modules}
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           f"stream-smoke-{os.getpid()}")
    os.makedirs(scratch, exist_ok=True)

    def zero():
        for m in modules.values():
            m.launches = 0

    def counts():
        return {name: m.launches for name, m in modules.items()}

    def key_arr(key):
        return np.frombuffer(key, np.int32)

    def status_of(resp):
        return int(S.unpack_arrays(resp)[0].reshape(-1)[0])

    def bucket(n):
        return next(b for b in (1, 2, 4, 8) if b >= n)

    # -- (a) the device half, byte level -------------------------------------
    if not native.native_available(wait=180):
        raise AssertionError("the native packer did not build (g++ -O3 -shared -fPIC)")
    svc = S.SolverService()
    rng = np.random.default_rng(13)
    inputs = {}
    zero()
    for cls, n_frames, groups in (("headline", 8, ([*range(8)], [0, 1, 2])),
                                  ("team mix", 4, ([*range(4)],))):
        args = [np.ascontiguousarray(a) for a in batches[cls].pack_args()]
        P, R = args[6].shape
        n_max = max(256, P // 4)  # what TorchScheduler sends a sidecar
        key = S.catalog_session_key(*args[7:])
        opened = S.unpack_arrays(svc.open_session_bytes(S.pack_arrays([key_arr(key)] + args[7:])))
        if int(opened[0][0]) != S.STATUS_OK or int(opened[1][0]) != S.PROTO_FEATURES:
            raise AssertionError(f"stream {cls}: open answered {opened}")
        head = [key_arr(key), np.asarray([n_max, 1], np.int32)]
        # equal shapes, different content: a different seeded 1% of the
        # valid rows cleared in each, so a demultiplexing error shows
        pods_of = []
        for _ in range(n_frames):
            pods = [a.copy() for a in args[:7]]
            valid = np.flatnonzero(pods[0])
            pods[0][rng.choice(valid, max(1, len(valid) // 100), replace=False)] = False
            pods_of.append(pods)
        frames = [S.pack_arrays(head + pods) for pods in pods_of]
        unary, unary_ms = [], []
        for f in frames:
            t0 = time.perf_counter()
            unary.append(svc.solve_bytes(f))
            unary_ms.append((time.perf_counter() - t0) * 1e3)
        if len(set(unary)) != n_frames or any(status_of(r) != S.STATUS_OK for r in unary):
            raise AssertionError(f"stream {cls}: the {n_frames} frames' answers are not distinct")
        # the unmodified pods' answer: what the arena and the salvo send
        inputs[cls] = (args, key, n_max, head, svc.solve_bytes(S.pack_arrays(head + args[:7])))
        kern = kernel_of[cls]
        for idx in groups:
            B = bucket(len(idx))
            answers = {}
            entries = [svc.stream_parse_solve(frames[i], respond=lambda b, i=i: answers.__setitem__(i, b))
                       for i in idx]
            if any(isinstance(e, bytes) for e in entries):
                raise AssertionError(f"stream {cls}: a frame was refused at parse")
            stats0 = dict(svc.stream_stats)
            served0 = svc.served.get(kern, 0)
            before = counts()
            t0 = time.perf_counter()
            svc.solve_stream_group(entries)
            wall = (time.perf_counter() - t0) * 1e3
            launched = {k: v - before[k] for k, v in counts().items()}
            if launched != {k: int(k == kern) for k in modules}:
                raise AssertionError(f"stream {cls} group of {len(idx)}: launches {launched}")
            if [answers.get(i) for i in idx] != [unary[i] for i in idx]:
                raise AssertionError(f"stream {cls} group of {len(idx)}: an answer differs "
                                     "from solve_bytes")
            if idx is groups[0]:
                # each demultiplexed answer against the native packer (a
                # plain version, bit-exact with both kernels: phase 9) on
                # host copies of that entry's own frame
                t0 = time.perf_counter()
                for i in idx:
                    plain = kernel.fuse_result(host_result(
                        native.pack_native(*pods_of[i], *args[7:], n_max=n_max)))
                    if S.unpack_arrays(answers[i])[1].tobytes() != plain.numpy().tobytes():
                        raise AssertionError(f"stream {cls} group of {len(idx)}: entry {i} "
                                             "differs from the native packer")
                log(f"[stream] (a) {cls} group of {len(idx)}: every answer == the native "
                    f"packer on its own frame ({(time.perf_counter() - t0) * 1e3:.3f} ms "
                    "on the host)")
            moved = (svc.stream_stats["coalesced_dispatches"] - stats0["coalesced_dispatches"],
                     svc.stream_stats["coalesced_solves"] - stats0["coalesced_solves"])
            if moved != (1, len(idx)) or svc.served.get(kern, 0) != served0 + 1:
                raise AssertionError(f"stream {cls}: coalesced counters moved {moved}")
            # the same group traced: the shared [dispatch_s, fetch_s, 0] trailer
            ctx = S._trace_ctx_array(S.TraceContext("5a" * 16, "a5" * 8))
            traced = []
            svc.solve_stream_group([
                svc.stream_parse_solve(S.pack_arrays(head + pods_of[i] + [ctx]), respond=traced.append)
                for i in idx])
            dispatch_s, fetch_s, _ = (float(x) for x in S.unpack_arrays(traced[0])[2])
            out[kern]["coalesced_B"] += [B, B]
            log(f"[stream] (a) {cls} group of {len(idx)} (B={B}): one {kern} launch, "
                f"{len(idx)} answers == solve_bytes byte for byte; group {wall:.3f} ms "
                f"(traced: dispatch_s={dispatch_s * 1e3:.3f}ms fetch_s={fetch_s * 1e3:.3f}ms); "
                f"{len(idx)} single solve_bytes {sum(unary_ms[i] for i in idx):.3f} ms "
                f"({', '.join(f'{unary_ms[i]:.3f}' for i in idx)}); card {card}")
        resident = svc.session_tensors(key)
        for B in sorted({bucket(len(idx)) for idx in groups}):
            ms = events_ms(lambda: [t.expand(B, *t.shape).contiguous() for t in resident], 10)
            log(f"[stream] (a) {cls}: the session's catalog tensors to B={B} "
                f"({B * sum(t.nbytes for t in resident)} bytes, expand().contiguous()) "
                f"{ms:.4f} ms (CUDA events, mean of 10)"
                + (f"; the v2 tables stacked B times hold "
                   f"{B * pack_kernel_v2.v2_table_bytes(*resident[1].shape[:2], R, resident[0].shape[1])}"
                   " bytes" if kern == "pack_first_fit_v2" else ""))
    out["pack_first_fit"]["launches_stream_device"] = counts()["pack_first_fit"]
    out["pack_first_fit_v2"]["launches_stream_device"] = counts()["pack_first_fit_v2"]

    # the arena: one headline frame's pod arrays through a ShmArena
    args, key, n_max, head, want = inputs["headline"]
    arena = ST.ShmArena(scratch, size=64 << 20)
    reader = ST.ShmArenaReader(arena.path)
    try:
        t0 = time.perf_counter()
        token, desc = arena.write(args[:7])
        write_ms = (time.perf_counter() - t0) * 1e3
        got = []
        entry = svc.stream_parse_solve(S.pack_arrays(head + [desc]), respond=got.append,
                                       arena=reader)
        if isinstance(entry, bytes) or not entry.shm:
            raise AssertionError("stream arena: the descriptor frame was refused")
        svc.solve_stream_group([entry])
        if got != [want]:
            raise AssertionError("stream arena: the answer differs from solve_bytes")
        arena.free(token)
        log(f"[stream] (a) arena: the headline pod arrays written in {write_ms:.3f} ms, the "
            f"descriptor solve == solve_bytes byte for byte ({arena.live_blocks()} live blocks)")
    finally:
        reader.close()
        arena.close()
    # an expired deadline is shed at parse time, with no launch
    got = []
    entry = svc.stream_parse_solve(S.pack_arrays(head + args[:7] + [np.asarray([0.0], np.float32)]),
                                   respond=got.append)
    dispatches, before = svc.dispatches, counts()
    shed = svc.shed_if_expired(entry)
    if shed is None or status_of(shed) != S.STATUS_DEADLINE_EXCEEDED or counts() != before \
            or svc.dispatches != dispatches:
        raise AssertionError("stream: the expired solve was not shed before the card")
    log(f"[stream] (a) expired deadline shed by shed_if_expired, 0 launches; stream_stats "
        f"{svc.stream_stats}, served {svc.served}")

    # -- (b) the transport -----------------------------------------------------
    try:
        import grpc  # noqa: F401
    except ImportError:
        log("[stream] grpc not installed on this host: (b) is held by the CPU tests")
        shutil.rmtree(scratch, ignore_errors=True)
        return out
    # every open stream holds one of the gRPC server's worker threads for
    # its life, so a sidecar serving N streaming clients needs more than N
    # workers (serve's default is 4): phase 13 keeps up to 12 streams open
    workers = 32
    address = free_address()
    servers = {address: S.serve(address, max_workers=workers, service=S.SolverService(),
                                shm_dir=scratch, coalesce_window_s=0.25)}
    os.environ["KARPENTER_PACKER"] = "fused"
    closers = []  # the controllers and clients to close

    def close_all():
        for c in closers:
            remote = c.torch._remote if hasattr(c, "torch") else c
            if remote is not None:
                remote.close()
        closers.clear()

    try:
        def stream_round(sched, cls, pods, want_plan, what, transport):
            if not sched.torch.solver_delta:
                sched.torch.topology.rng = random.Random(1)
            t0 = time.perf_counter()
            nodes = sched.solve(prov, catalogs[cls], pods)
            wall = (time.perf_counter() - t0) * 1e3
            prof = served(sched, "sidecar", f"stream {what}")
            if transport is not None and prof["solver_transport"] != transport:
                raise AssertionError(f"stream {what}: carried by {prof['solver_transport']}, "
                                     f"expected {transport}")
            if plan_of(nodes, pods) != want_plan:
                raise AssertionError(f"stream {what}: plan differs from the card plan")
            log(f"[stream] (b) {what}: {wall:.3f} ms, transport={prof['solver_transport']} "
                f"nodes={len(nodes)} wire_ser_s={prof['wire_ser_s'] * 1e3:.3f}ms "
                f"wire_deser_s={prof['wire_deser_s'] * 1e3:.3f}ms "
                f"pack_fetch_s={prof['pack_fetch_s'] * 1e3:.3f}ms "
                f"delta_kind={prof.get('delta_kind')} address={prof['solver_address']}; "
                f"{stage_line(prof)}")
            return prof

        def controller(address_spec, **kw):
            sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                              solver_service_address=address_spec, solver_stream=True, **kw)
            closers.append(sched)
            return sched

        zero()
        streamed = controller(address)
        for cls in ("headline", "team mix"):
            for r in range(3):
                stream_round(streamed, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                             f"{cls} streamed round {r}", "stream")
        shm = controller(address, solver_shm_dir=scratch)
        head_pods, head_plan = classes["headline"]["pods"], classes["headline"]["cpu_plan"]
        stream_round(shm, "headline", head_pods, head_plan, "headline shm warm-up", None)
        wait_for(lambda: shm.torch._remote._stream.shm_active, 20, "the arena's ack")
        shm_ser = [stream_round(shm, "headline", head_pods, head_plan,
                                f"headline shm round {r}", "stream_shm")["wire_ser_s"] * 1e3
                   for r in range(3)]
        log(f"[stream] (b) wire_ser_s through the arena {', '.join(f'{x:.3f}' for x in shm_ser)} "
            f"ms against phase 12's unary headline rounds "
            f"{', '.join(f'{x:.3f}' for x in wire_ser_unary['headline'])} ms; card {card}")
        res = controller(address, solver_delta=True)
        kinds = [stream_round(res, "headline", head_pods, head_plan,
                              f"resident headline round {r}", "stream").get("delta_kind")
                 for r in range(3)]
        if kinds != ["establish", "elide", "elide"]:
            raise AssertionError(f"stream resident headline: delta kinds {kinds}")
        # a restart on the same address: the stream re-establishes and the
        # re-open (NEEDS_CATALOG) rides it
        client = streamed.torch._remote
        established, uploads = client._stream.established_count, client.session_uploads
        servers.pop(address).stop(grace=None)
        servers[address] = S.serve(address, max_workers=workers, service=S.SolverService(),
                                   shm_dir=scratch, coalesce_window_s=0.25)
        wait_for(lambda: client._stream.established_count > established and client._stream.up,
                 30, "the stream's re-establishment")
        stream_round(streamed, "headline", head_pods, head_plan,
                     "headline round after a restart", "stream")
        opens = servers[address].stream_server_box[0].snapshot()["stream_opens"]
        if client.session_uploads != uploads + 1 or opens < 1:
            raise AssertionError(f"stream restart: uploads {client.session_uploads}, "
                                 f"streamed opens {opens}")
        launched = counts()
        if not all(launched.values()):
            raise AssertionError(f"stream (b): launches {launched}")

        # the salvo: 8 clients on one session, until a group coalesces
        args, key, n_max, head, want = inputs["headline"]
        P, R = args[6].shape
        want_result = kernel.split_result(S.unpack_arrays(want)[1], P, n_max, R)
        clients = [S.RemoteSolver(address, timeout=30, cold_timeout=120, stream=True)
                   for _ in range(8)]
        closers.extend(clients)
        for c in clients:
            c.pack(*args, n_max=n_max)
        wait_for(lambda: all(c._stream is not None and c._stream.up for c in clients), 20,
                 "8 streams")
        svc_b = servers[address].solver_service
        stats0, before = dict(svc_b.stream_stats), counts()
        for salvo in range(10):
            waits, errs = [None] * 8, []
            gate = threading.Barrier(8, timeout=30)

            def fire(i):
                try:
                    gate.wait()
                    waits[i] = clients[i].pack_begin(*args, n_max=n_max)
                except Exception as e:
                    errs.append(e)

            threads = [threading.Thread(target=fire, args=(i,), daemon=True) for i in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            if errs or any(w is None for w in waits):
                raise AssertionError(f"stream salvo {salvo}: {errs}")
            for w in waits:
                if any(not np.array_equal(a, b) for a, b in zip(w(), want_result)):
                    raise AssertionError(f"stream salvo {salvo}: a result differs from the card's")
            wall = (time.perf_counter() - t0) * 1e3
            dd = svc_b.stream_stats["coalesced_dispatches"] - stats0["coalesced_dispatches"]
            ds = svc_b.stream_stats["coalesced_solves"] - stats0["coalesced_solves"]
            log(f"[stream] (b) salvo {salvo}: 8 clients, {wall:.3f} ms, every result == the card's; "
                f"coalesced dispatches {dd} carrying {ds} solves so far")
            if dd:
                break
        else:
            raise AssertionError("stream salvo: 10 salvos and no group coalesced")
        salvo_launches = {k: v - before[k] for k, v in counts().items()}
        if dd == 1:
            out["pack_first_fit"]["coalesced_B"].append(bucket(ds))
        out["pack_first_fit"]["salvo"] = {"coalesced_dispatches": dd, "coalesced_solves": ds,
                                          "launches": salvo_launches["pack_first_fit"]}
        log(f"[stream] (b) salvo: {salvo_launches['pack_first_fit']} pack_first_fit launches "
            f"for {8 * (salvo + 1)} solves")

        # the pool: two members on the one card. The earlier controllers
        # and clients close first: their streams would all reconnect to the
        # restarted survivor below and hold its channel in backoff
        close_all()
        second = free_address()
        servers[second] = S.serve(second, max_workers=workers, service=S.SolverService())
        members = [address, second]
        pool_sched = controller(",".join(members))
        profs = [stream_round(pool_sched, "headline", head_pods, head_plan,
                              f"pool headline round {r}", "stream") for r in range(2)]
        owner = profs[0]["solver_address"]
        if owner != HashRing(members).route(bytes.fromhex(profs[0]["session_key"])) or \
                profs[1]["solver_address"] != owner:
            raise AssertionError(f"stream pool: rounds served by {owner}, not the ring's member")
        survivor = next(a for a in members if a != owner)
        pool = pool_sched.torch._remote
        # the survivor's client holds the session as open while its store is
        # empty (a restart): the failover re-opens it through NEEDS_CATALOG
        key = bytes.fromhex(profs[0]["session_key"])
        catalog_side = next(arrays for arrays, k in pool._key_memo._memo.values() if k == key)
        pool._client(survivor)._open_session(key, catalog_side, timeout=30)
        servers.pop(survivor).stop(grace=None)
        servers[survivor] = S.serve(survivor, max_workers=workers, service=S.SolverService(),
                                    shm_dir=scratch)
        servers.pop(owner).stop(grace=None)
        uploads = pool._client(survivor).session_uploads
        prof = stream_round(pool_sched, "headline", head_pods, head_plan,
                            "pool round after killing the session's member", None)
        if prof["solver_address"] != survivor or pool.failovers != 1 or \
                pool._client(survivor).session_uploads != uploads + 1:
            raise AssertionError(f"stream pool failover: served by {prof['solver_address']}, "
                                 f"failovers {pool.failovers}")
        if pool_sched.torch._remote_breaker.state != "closed":
            raise AssertionError("stream pool failover: the outer remote breaker moved")
        log(f"[stream] (b) pool: {owner} owned the session (the ring's member), killed; "
            f"failover to {survivor} through NEEDS_CATALOG, plan equal, outer breaker closed")

        # the pipeline: two threads on one scheduler, a 0.5 s chaos floor,
        # one solving the headline and one the team mix at full width
        floor = 0.5
        pipe_addr = free_address()
        servers[pipe_addr] = S.serve(pipe_addr, max_workers=workers, service=chaos_wrap(
            S.SolverService(), ChaosPolicy(
            latency_floor=floor, methods=frozenset({"solve_bytes", "solve_stream_group"}))))
        pipe = controller(pipe_addr)
        for cls in ("headline", "team mix"):  # warm: both sessions, the stream
            stream_round(pipe, cls, classes[cls]["pods"], classes[cls]["cpu_plan"],
                         f"pipeline warm-up {cls}", None)
        results, profs_of, errs = {}, {}, []

        def run(cls):
            try:
                pods = classes[cls]["pods"]
                nodes = pipe.solve(prov, catalogs[cls], pods)
                results[cls] = plan_of(nodes, pods)
                profs_of[cls] = pipe.last_stage_profile()
            except Exception as e:
                errs.append(e)

        # only the headline's topology draws hostnames: reseeded once, the
        # rng gives it the device="cpu" plan's draws whichever thread
        # encodes first
        pipe.torch.topology.rng = random.Random(1)
        threads = [threading.Thread(target=run, args=(cls,), daemon=True)
                   for cls in ("headline", "team mix")]
        # by now the script holds over a million tracked objects, and a
        # full collection of them stops every thread for a second or more
        # (the [gc] lines); collected here, none falls due inside the timed
        # window
        gc.collect()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        if errs or any(results.get(cls) != classes[cls]["cpu_plan"] for cls in results) \
                or len(results) != 2 \
                or any(p["packer_backend"] != "sidecar" for p in profs_of.values()):
            raise AssertionError(f"stream pipeline: {errs} {profs_of}")
        host = {cls: {k: v for k, v in p.items() if k.endswith("_s") and k.split("_")[0] in
                      ("sort", "inject", "encode", "decode", "validate")}
                for cls, p in profs_of.items()}
        host_s = {cls: sum(h.values()) for cls, h in host.items()}
        bar = 2 * floor + max(host_s.values())
        log(f"[stream] (b) pipeline: the headline and the team mix on one scheduler, two "
            f"threads, through a sidecar with a {floor}s floor: wall {wall:.3f}s against "
            f"2 x floor + the larger thread's host stages = {bar:.3f}s (serial >= "
            f"{2 * floor + sum(host_s.values()):.3f}s); host stages "
            + "; ".join(f"{cls} {host_s[cls] * 1e3:.3f} ms ("
                        + ", ".join(f"{k}={v * 1e3:.3f}" for k, v in host[cls].items()) + ")"
                        for cls in host)
            + "; " + ", ".join(f"{cls} pack_fetch_s={p['pack_fetch_s'] * 1e3:.3f}ms "
                               f"transport={p['solver_transport']}"
                               for cls, p in profs_of.items())
            + f"; card {card}")
        if wall >= bar:
            raise AssertionError(f"stream pipeline: {wall:.3f}s >= {bar:.3f}s, the host "
                                 "stages did not overlap the other solve in flight")
        launched = counts()
        for name in modules:
            out[name]["launches_stream_wire"] = launched[name]
        log(f"[stream] (b) kernel launches {launched}; card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        close_all()
        for server in servers.values():
            server.stop(grace=None)
        shutil.rmtree(scratch, ignore_errors=True)
    return out


OBS_STAGES = ("solve.sort", "solve.inject", "solve.encode", "solve.pack_begin",
              "solve.pack_fetch", "solve.decode")
# each host stage span and the profile key (full, or served from resident
# state) its prof clock writes
OBS_STAGE_KEYS = {
    "solve.sort": ("sort_s", "sort_delta_s"),
    "solve.inject": ("inject_s", "inject_delta_s"),
    "solve.encode": ("encode_s", "encode_delta_s"),
    "solve.decode": ("decode_s", "decode_delta_s"),
}
# the flight-recorder panels the scheduler registers
OBS_PANELS = ("router_ema", "pack_breakers_open", "remote_breaker", "session_cache", "integrity")
# phase 14 (f)'s SLO window: 12 knob-off headline rounds (≈ 2-3 s) fit in
# it, and the ladder's recovery waits it out with resident rounds
SLO_WINDOW_S = 5.0


class KernelClock:
    """CUDA events recorded around each call of a kernel's wrapper, and a
    tracer finish-hook that asks the end event, as solve.pack_begin and
    solve.pack_fetch close, whether the kernel is done (``query()``
    neither waits nor queues work). A round keeps its one synchronize (its
    fetch); the times are read after the round returned."""

    STAGES = ("solve.pack_begin", "solve.pack_fetch")

    def __init__(self):
        self.calls = []

    def wrap(self, fn):
        import torch

        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.calls.append((e0, e1, {}))
            return out

        return timed

    def __call__(self, span) -> None:
        if span.name in self.STAGES and self.calls:
            self.calls[-1][2][span.name] = self.calls[-1][1].query()

    def take(self) -> list:
        """``(CUDA-event ms, done when pack_begin closed, done when
        pack_fetch closed)`` per call."""
        calls, self.calls = self.calls, []
        out = []
        for e0, e1, done in calls:
            e1.synchronize()
            out.append((e0.elapsed_time(e1), done.get(self.STAGES[0]), done.get(self.STAGES[1])))
        return out


def metric(name: str, labels=None) -> float:
    from karpenter_tpu_torch import metrics

    return metrics.REGISTRY.get_sample_value(name, labels or {}) or 0.0


def check_tree(tree: dict, prof: dict, what: str) -> float:
    """One exported solve tree against the round's profile: a solver.solve
    root with the six stage spans as children, each host stage within 1 ms
    of its prof key, and pack_begin + pack_fetch within 1 ms of
    pack_fetch_s. Returns the largest disagreement (ms)."""
    if tree["name"] != "solver.solve":
        raise AssertionError(f"{what}: root span {tree['name']}")
    names = tuple(c["name"] for c in tree["children"])
    if names != OBS_STAGES:
        raise AssertionError(f"{what}: stage spans {names}")
    spans = {c["name"]: c for c in tree["children"]}
    worst = 0.0
    for name, keys in OBS_STAGE_KEYS.items():
        key = next((k for k in keys if k in prof), None)
        if key is None:
            raise AssertionError(f"{what}: no profile key for {name}")
        worst = max(worst, abs(spans[name]["duration_ms"] - prof[key] * 1e3))
    packed = spans["solve.pack_begin"]["duration_ms"] + spans["solve.pack_fetch"]["duration_ms"]
    worst = max(worst, abs(packed - prof["pack_fetch_s"] * 1e3))
    if worst >= 1.0:
        raise AssertionError(f"{what}: a stage span differs from the profile by {worst:.3f} ms")
    return worst


def check_kernel_timing(rounds: list, what: str) -> None:
    """On the card the begin only enqueues and the fetch holds the wait.
    ``rounds``: per round, whether the kernel was done when
    solve.pack_begin closed and when solve.pack_fetch closed. Every fetch
    must close with the kernel done. A begin closes with the kernel
    running unless its host work after the launch outlasted the kernel (a
    slow host round can); a begin that waited for the kernel would close
    with it done in every round, so at least one round must show it
    running."""
    if not all(fetch for _, fetch in rounds):
        raise AssertionError(f"{what}: a solve.pack_fetch closed before its kernel was done: "
                             f"{rounds}")
    if all(begin for begin, _ in rounds):
        raise AssertionError(f"{what}: every solve.pack_begin closed with its kernel done "
                             f"(a wait inside the begin): {rounds}")


def profiled_device_work(run) -> dict:
    """``run()`` under torch.profiler: the device work it caused, counted
    by kind (kernel launches, device-to-host and host-to-device copies,
    other copies and memsets). A warm-up step, whose events are
    discarded, comes first: device activity just after tracing starts can
    go unrecorded (a round's first uploads and kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: events.extend(prof.events())) as p:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        p.step()
        run()
        torch.cuda.synchronize()
        p.step()
    tally = {"kernels": 0, "memcpy_dtoh": 0, "memcpy_htod": 0, "other": 0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name.lower()
        if "memcpy" in n and "dtoh" in n:
            tally["memcpy_dtoh"] += 1
        elif "memcpy" in n and "htod" in n:
            tally["memcpy_htod"] += 1
        elif "memcpy" in n or "memset" in n:
            tally["other"] += 1
        else:
            tally["kernels"] += 1
    return tally


def obs_phase(dev, card: str, classes: dict, catalogs: dict, batches: dict) -> dict:
    """Phase 14: the observability plane around both kernels on the card,
    at full width. (a) traced knob-off rounds, (b) metrics, (c) the flight
    recorder, (d) what tracing costs, (e) decisions, explain and replay,
    (f) the SLO engine and the brownout ladder driven by the card's own
    spans, (g) the sidecar traced. ``classes`` holds the headline's and the
    team mix's pods and device="cpu" plans (phases 3 and 6). Each part
    reads both kernels' launch counters before and after it, and fails
    where a kernel's launches differ from the rounds the part ran on it.
    Returns each kernel's measured launches by part and the numbers the
    kernels line carries."""
    import collections
    import contextlib
    import shutil
    import tempfile

    import torch
    from karpenter_tpu_torch import metrics, obs
    from karpenter_tpu_torch.api import labels as lbl
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.obs import replay as replay_tool
    from karpenter_tpu_torch.resilience.brownout import BrownoutController
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import (
        backend, explain, fused, integrity, pack_kernel, pack_kernel_v2,
    )
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.solver import session_stats
    from karpenter_tpu_torch.solver.carry import PACK_ARG_DTYPES
    from karpenter_tpu_torch.solver.router import default_router
    from karpenter_tpu_torch.testing import make_pod, make_provisioner

    prov = make_provisioner(solver="tpu")
    kernel_of = {"headline": "pack_first_fit", "team mix": "pack_first_fit_v2"}
    modules = {"pack_first_fit": pack_kernel, "pack_first_fit_v2": pack_kernel_v2}
    # where the fused route calls each wrapper (fused imports pack_first_fit
    # by name; the v2 route calls it through its module)
    targets = {"pack_first_fit": (fused, "pack_first_fit"),
               "pack_first_fit_v2": (pack_kernel_v2, "pack_first_fit_v2")}
    out = {name: {} for name in modules}
    summary = {}
    scratch = tempfile.mkdtemp(prefix="karpenter-obs-")
    # the main path's fused route for both batches: phase 9 (c) left the
    # team mix's fused shape in the failed-fused memo; both memos are
    # emptied here and restored at the end
    memos = ((pack_kernel._failed_shapes_lock, pack_kernel._failed_shapes),
             (backend._fused_failed_lock, backend._fused_failed_shapes))
    saved = []
    for lock, memo in memos:
        with lock:
            saved.append(set(memo))
            memo.clear()

    def counts() -> dict:
        return {name: m.launches for name, m in modules.items()}

    @contextlib.contextmanager
    def part(label: str):
        """One part of the phase. Yields a dict the part fills with the
        launches its rounds make, per kernel; on leaving, each kernel's
        launches measured over the part must equal it. The measured
        launches are what the kernels line reports."""
        rounds = {}
        start = counts()
        yield rounds
        got = {name: n - start[name] for name, n in counts().items()}
        want = {name: rounds.get(name, 0) for name in modules}
        if got != want:
            raise AssertionError(f"obs ({label}): launches {got}, its rounds make {want}")
        for name, n in got.items():
            if n:
                out[name][f"launches_{label}"] = n

    def solve(sched, cls, pods=None, what=""):
        """One round; it must launch its kernel once, and the plan must
        equal the device="cpu" plan."""
        pods = pods if pods is not None else classes[cls]["pods"]
        if not sched.torch.solver_delta:
            sched.torch.topology.rng = random.Random(1)
        start = counts()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, kernel_of[cls], what)
        launched = {name: n - start[name] for name, n in counts().items()}
        if launched != {name: int(name == kernel_of[cls]) for name in modules}:
            raise AssertionError(f"{what}: launches {launched}")
        if plan_of(nodes, pods) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"{what}: plan differs from the device='cpu' plan")
        return wall, prof, nodes

    try:
        # -- (a) traced rounds -----------------------------------------------
        obs.reset_for_tests()
        clock = KernelClock()
        obs.tracer().add_hook(clock)
        knob_off = {}
        for cls in ("headline", "team mix"):
            name = kernel_of[cls]
            with part("traced") as rounds:
                sched = knob_off[cls] = Scheduler(Cluster(), rng=random.Random(1))
                solve(sched, cls, what=f"obs (a) {cls} warm-up")
                before = {
                    "hits": metric("karpenter_solver_encode_cache_hits_total"),
                    "misses": metric("karpenter_solver_encode_cache_misses_total"),
                    "solves": metric(
                        "karpenter_allocation_controller_scheduling_duration_seconds_count",
                        {"provisioner": prov.name}),
                        "uploads": metric("karpenter_solver_session_catalog_uploads_total"),
                    **{f"session_{k}": v for k, v in session_stats.snapshot().items()
                       if k in ("hits", "misses")},
                }
                fetch_ms, kernel_ms_, done, worst = [], [], [], 0.0
                with mock.patch.object(*targets[name], clock.wrap(getattr(*targets[name]))):
                    for r in range(5):
                        obs.exporter().clear()
                        wall, prof, nodes = solve(sched, cls, what=f"obs (a) {cls} round {r}")
                        if prof["pack_route"] != "fused":
                            raise AssertionError(f"obs (a) {cls} round {r}: "
                                                 f"route {prof['pack_route']}")
                        trees = obs.exporter().trees()
                        if len(trees) != 1:
                            raise AssertionError(f"obs (a) {cls} round {r}: {len(trees)} trees")
                        tree = trees[0]
                        worst = max(worst, check_tree(tree, prof, f"obs (a) {cls} round {r}"))
                        (k_ms, done_at_begin, done_at_fetch), = clock.take()
                        spans = {c["name"]: c for c in tree["children"]}
                        begin, fetch = spans["solve.pack_begin"], spans["solve.pack_fetch"]
                        done.append((done_at_begin, done_at_fetch))
                        fetch_ms.append(fetch["duration_ms"])
                        kernel_ms_.append(k_ms)
                        path = " > ".join(f"{s['name']} {s['duration_ms']:.3f}/{s['self_ms']:.3f}"
                                          for s in obs.critical_path(tree))
                        log(f"[obs] (a) {cls} round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
                            f"1 launch of {name}; kernel {k_ms:.3f} ms (CUDA events), "
                            f"solve.pack_begin {begin['duration_ms']:.3f} ms (kernel done when it "
                            f"closed: {done_at_begin}), solve.pack_fetch "
                            f"{fetch['duration_ms']:.3f} ms "
                            f"(kernel done: {done_at_fetch}); critical path (ms total/self) {path}")
                check_kernel_timing(done, f"obs (a) {cls}")
                # -- (b) the counters these rounds move, by the reference's amounts
                session = session_stats.snapshot()
                moved = {
                    "encode cache hits": metric("karpenter_solver_encode_cache_hits_total")
                    - before["hits"],
                    "encode cache misses": metric("karpenter_solver_encode_cache_misses_total")
                    - before["misses"],
                    "scheduling_duration count": metric(
                        "karpenter_allocation_controller_scheduling_duration_seconds_count",
                        {"provisioner": prov.name}) - before["solves"],
                    "session hits": session["hits"] - before["session_hits"],
                    "session misses": session["misses"] - before["session_misses"],
                    "session uploads": metric("karpenter_solver_session_catalog_uploads_total")
                    - before["uploads"],
                }
                want = {"encode cache hits": 5, "encode cache misses": 0,
                        "scheduling_duration count": 5, "session hits": 5, "session misses": 0,
                        "session uploads": 0}
                if moved != want:
                    raise AssertionError(f"obs (b) {cls}: metric deltas {moved}, expected {want}")
                rounds[name] = 1 + 5
                out[name]["traced_kernel_ms"] = kernel_ms_
                out[name]["traced_pack_fetch_ms"] = fetch_ms
                out[name]["kernel_done_at_begin_fetch_close"] = done
                out[name]["stage_span_max_diff_ms"] = worst
                log(f"[obs] (a) {cls}: 5 traced rounds, each one launch, one solver.solve tree "
                    f"with "
                    f"the six stage spans, stage spans within {worst:.4f} ms of the profile; "
                    f"(b) metric deltas {moved}; card {card}")
        obs.tracer().remove_hook(clock)

        # -- (b) resident rounds and the registry ---------------------------
        with part("resident") as rounds:
            res = Scheduler(Cluster(), rng=random.Random(1), solver_delta=True)
            solve(res, "headline", what="obs (b) resident warm-up")
            paths = ("host", "device", "decode")
            before = {p: metric("karpenter_solver_delta_applied_total", {"path": p})
                      for p in paths}
            for r in range(3):
                obs.exporter().clear()
                wall, prof, _ = solve(res, "headline", what=f"obs (b) resident round {r}")
                check_tree(obs.exporter().trees()[0], prof, f"obs (b) resident round {r}")
            rounds["pack_first_fit"] = 1 + 3
        applied = {p: metric("karpenter_solver_delta_applied_total", {"path": p}) - before[p]
                   for p in paths}
        resident_bytes = {
            side: metric("karpenter_solver_delta_resident_bytes", {"side": side})
            for side in ("host", "device")
        }
        if applied != {p: 3.0 for p in paths} or min(resident_bytes.values()) <= 0:
            raise AssertionError(f"obs (b) resident: applied {applied}, bytes {resident_bytes}")
        log(f"[obs] (b) resident headline: 3 steady rounds, SOLVER_DELTA_APPLIED {applied}, "
            f"resident bytes {resident_bytes}")
        headroom_svc = S.SolverService()
        args = [np.ascontiguousarray(a) for a in batches["headline"].pack_args()]
        key = S.catalog_session_key(*args[7:])
        headroom_svc.open_session_bytes(
            S.pack_arrays([np.frombuffer(key, np.int32)] + args[7:]))
        free = torch.cuda.mem_get_info()[0]
        gauge = metric("karpenter_solver_device_hbm_headroom_bytes",
                       {"device": str(torch.cuda.current_device())})
        hbm = metric("karpenter_solver_session_hbm_bytes", {"session": key.hex()[:12]})
        if abs(gauge - free) > 64 * 2**20 or hbm <= 0:
            raise AssertionError(f"obs (b): headroom gauge {gauge}, mem_get_info {free}, "
                                 f"session bytes {hbm}")
        log(f"[obs] (b) SOLVER_HBM_HEADROOM {gauge:.0f} bytes, torch.cuda.mem_get_info "
            f"{free} (|diff| {abs(gauge - free) / 2**20:.3f} MiB); session HBM {hbm:.0f} bytes")
        del headroom_svc
        from prometheus_client import generate_latest

        exposition = generate_latest(metrics.REGISTRY).decode().splitlines()
        log(f"[obs] (b) generate_latest: {len(exposition)} lines, first 40:")
        for line in exposition[:40]:
            log(f"[obs] (b)   {line}")

        # -- (c) the flight recorder -----------------------------------------
        flight_dir = os.path.join(scratch, "flight")
        rec = obs.configure_flight(flight_dir, budget_s=0.100)
        # a fresh scheduler's first round (its cold encode and upload take
        # most of a second) is over budget on any host; the warm rounds
        # after it land or not by their own time
        with part("flight") as rounds:
            cold = Scheduler(Cluster(), rng=random.Random(1))
            durations = []
            for r in range(3):
                obs.exporter().clear()
                solve(cold, "headline", what=f"obs (c) knob-off round {r}")
                durations.append(obs.exporter().trees()[0]["duration_ms"])
            records = rec.recent(limit=64)
            over = [d for d in durations if d > 100.0]
            if len(records) != len(over) or durations[0] <= 100.0:
                raise AssertionError(f"obs (c): {len(records)} flight records for rounds "
                                     f"{durations}")
            for record in records:
                missing = [p for p in OBS_PANELS if p not in record["state"]]
                if missing or record["name"] != "solver.solve":
                    raise AssertionError(f"obs (c): record {record['name']} lacks panels {missing}")
            obs.exporter().clear()
            solve(res, "headline", what="obs (c) resident round")
            res_ms = obs.exporter().trees()[0]["duration_ms"]
            landed = len(rec.recent(limit=64)) - len(records)
            if landed != (1 if res_ms > 100.0 else 0):
                raise AssertionError(f"obs (c): resident round {res_ms:.3f} ms, {landed} records")
            rounds["pack_first_fit"] = 3 + 1
        summary["flight"] = {"knob_off_ms": durations, "records": len(records),
                             "resident_ms": res_ms, "resident_records": landed}
        log(f"[obs] (c) knob-off rounds (the first cold) "
            f"{', '.join(f'{d:.3f}' for d in durations)} ms: "
            f"{len(records)} flight records, each with panels {list(OBS_PANELS)}; a resident "
            f"round {res_ms:.3f} ms: {landed} records")
        obs.reset_for_tests()

        # -- (d) what tracing costs -------------------------------------------
        with part("cost") as rounds:
            walls = {(cls, on): [] for cls in kernel_of for on in (False, True)}
            for i in range(5):
                for cls in kernel_of:
                    for on in ((False, True) if i % 2 == 0 else (True, False)):
                        obs.set_enabled(on)
                        wall, _, _ = solve(knob_off[cls], cls, what=f"obs (d) {cls} traced={on}")
                        walls[(cls, on)].append(wall * 1e3)
            obs.set_enabled(True)
            cost = {}
            for cls in kernel_of:
                off, on = walls[(cls, False)], walls[(cls, True)]
                cost[cls] = {"untraced_ms": off, "traced_ms": on,
                             "median_diff_ms": float(np.median(on) - np.median(off))}
                log(f"[obs] (d) {cls}: untraced {', '.join(f'{w:.3f}' for w in off)} ms; traced "
                    f"{', '.join(f'{w:.3f}' for w in on)} ms; median traced - untraced "
                    f"{cost[cls]['median_diff_ms']:.3f} ms; card {card}")

            def device_work(on: bool) -> dict:
                obs.set_enabled(on)
                try:
                    return profiled_device_work(
                        lambda: solve(knob_off["headline"], "headline",
                                      what=f"obs (d) profiled traced={on}"))
                finally:
                    obs.set_enabled(True)

            untraced, traced = device_work(False), device_work(True)
            if untraced != traced or not traced["kernels"] or not traced["memcpy_dtoh"]:
                raise AssertionError(f"obs (d): device work traced {traced}, untraced {untraced}")
            cost["profiled_device_work"] = traced
            summary["tracing_cost"] = cost
            log(f"[obs] (d) under torch.profiler a traced and an untraced headline round do the "
                f"same device work: {traced}")
            rounds["pack_first_fit"] = 5 * 2 + 2
            rounds["pack_first_fit_v2"] = 5 * 2

        # -- (e) decisions, explain, replay -----------------------------------
        with part("decisions") as rounds:
            rng = random.Random(5)
            head_pods = list(classes["headline"]["pods"])
            stuck_at = sorted(rng.sample(range(len(head_pods)), len(head_pods) // 100))
            for i in stuck_at:
                head_pods[i] = make_pod(name=f"stuck-{i}", requests={"cpu": "100000"})
            card_sched = Scheduler(Cluster(), rng=random.Random(1))
            start = counts()
            nodes = card_sched.solve(prov, catalogs["headline"], head_pods)
            served(card_sched, "pack_first_fit", "obs (e) card round")
            if counts()["pack_first_fit"] - start["pack_first_fit"] != 1:
                raise AssertionError("obs (e): the card round did not launch pack_first_fit once")
            ctx = card_sched.last_decision_context()
            decision_dir = os.path.join(scratch, "decisions")
            log_ = obs.DecisionLog(directory=decision_dir, write_interval=0.0)
            record = log_.record_round(prov.name, head_pods, nodes, context=ctx)
            if not log_.flush(60.0):
                raise AssertionError("obs (e): the decision ring did not flush")
            # every unplaced pod's verdict (the record lists the first 50)
            stuck_keys = {head_pods[i].key for i in stuck_at}
            unplaced = {v["pod"]: v for v in explain.explain_batch(ctx["batch"], ctx["assignment"])}
            verdicts = record["unschedulable"]
            if (record["unschedulable_count"] != len(unplaced) or stuck_keys - set(unplaced)
                    or any(unplaced[k]["top_reason"] != "resource_fit" for k in stuck_keys)):
                reasons = sorted({unplaced[k]["top_reason"] for k in stuck_keys & set(unplaced)})
                raise AssertionError(f"obs (e): {record['unschedulable_count']} unschedulable, "
                                     f"{len(stuck_keys - set(unplaced))} stuck pods placed, "
                                     f"reasons {reasons}")
            # the others are the batch's own zone anti-affinity pods: a required
            # anti-affinity term over the zone admits one pod of a selector
            # group per zone, and the catalog offers three (the JAX package's
            # scheduler leaves the same pods unplaced with the same verdicts on
            # this batch, tests/test_torch_explain.py)
            by_key = {p.key: p for p in head_pods}
            others = [k for k in unplaced if k not in stuck_keys]
            other_reasons = dict(collections.Counter(unplaced[k]["top_reason"] for k in others))

            def zone_anti_affinity(pod) -> bool:
                anti = pod.spec.affinity and pod.spec.affinity.pod_anti_affinity
                return bool(anti) and [t.topology_key for t in anti.required] == [
                    lbl.TOPOLOGY_ZONE]

            if set(other_reasons) - {"zone_topology"} or not all(
                    zone_anti_affinity(by_key[k]) for k in others):
                raise AssertionError(f"obs (e): besides the stuck pods, {len(others)} unplaced "
                                     f"with reasons {other_reasons}, not all of them zone "
                                     f"anti-affinity pods")
            os.environ["KARPENTER_PACKER"] = "fused"
            try:
                cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
                cpu_nodes = cpu_sched.solve(prov, catalogs["headline"], head_pods)
            finally:
                os.environ.pop("KARPENTER_PACKER", None)
            not_degraded(cpu_sched, "obs (e) cpu round")
            if plan_of(cpu_nodes, head_pods) != plan_of(nodes, head_pods):
                raise AssertionError("obs (e): the card plan differs from the cpu plan")
            cpu_ctx = cpu_sched.last_decision_context()
            cpu_record = obs.DecisionLog().record_round(prov.name, head_pods, cpu_nodes,
                                                        context=cpu_ctx)
            if (cpu_record["unschedulable"] != verdicts or explain.explain_batch(
                    cpu_ctx["batch"], cpu_ctx["assignment"]) != list(unplaced.values())):
                raise AssertionError("obs (e): explain verdicts differ from the cpu scheduler's")
            path = replay_tool.find_record(decision_dir, record_id=record["id"])
            verdict = replay_tool.replay(replay_tool.load_record(path), record_path=path)
            if verdict["ok"] is not True or verdict["replay_unschedulable"] != len(unplaced):
                raise AssertionError(f"obs (e): native replay {verdict}")
            with np.load(os.path.join(decision_dir, replay_tool.load_record(path)["replay_file"]),
                         allow_pickle=False) as blob:
                arrays = {k: blob[k] for k in blob.files}
            arrays["pod_req"] = arrays["uniq_req"][arrays["pod_req_id"]]
            tensors = [torch.tensor(arrays[n], dtype=dt, device=dev) for n, dt in PACK_ARG_DTYPES]
            start = counts()
            best, result = pack_kernel.pack_best(*tensors, n_max=int(arrays["n_max"]))
            n_pods = int(arrays["n_pods"])
            once = counts()["pack_first_fit"] - start["pack_first_fit"] == 1
            if best != "pack_first_fit" or not once or not np.array_equal(
                    result.assignment.cpu().numpy()[:n_pods], arrays["assignment"][:n_pods]):
                raise AssertionError(f"obs (e): the blob through pack_best ({best}) is not "
                                     f"bit-exact")
            bad_ctx = dict(ctx)
            bad = np.asarray(ctx["assignment"]).copy()
            bad[0] = bad[0] + 1 if bad[0] >= 0 else 0
            bad_ctx["assignment"] = bad
            bad_record = log_.record_round(prov.name, head_pods, nodes, context=bad_ctx)
            log_.flush(60.0)
            bad_path = replay_tool.find_record(decision_dir, record_id=bad_record["id"])
            caught = replay_tool.replay(replay_tool.load_record(bad_path), record_path=bad_path)
            if caught["ok"] is not False:
                raise AssertionError(f"obs (e): a corrupted assignment replayed as {caught}")
            log_.close()
            rounds["pack_first_fit"] = 2
            summary["decisions"] = {"stuck": len(stuck_at), "unschedulable": len(unplaced),
                                    "others": other_reasons, "listed": len(verdicts),
                                    "replay": "bit-exact", "corrupt_caught": caught["diff"]}
            log(f"[obs] (e) {len(head_pods)} pods, {len(stuck_at)} stuck: one launch, "
                f"{record['unschedulable_count']} unschedulable ({len(verdicts)} listed; every "
                f"stuck pod resource_fit; the {len(others)} others zone anti-affinity pods, "
                f"reasons "
                f"{other_reasons}; all verdicts equal to the device='cpu' scheduler's); "
                f"explain took "
                f"{record['explain_s'] * 1e3:.3f} ms; the .npz replays on the native packer "
                f"bit-exact and through pack_best ({best}, one launch) bit-exact; a corrupted "
                f"assignment caught: {caught['diff']}")

        # -- (f) the SLO engine and the brownout ladder ------------------------
        with part("slo") as rounds:
            obs.reset_for_tests()
            engine = obs.configure_slo(window_s=SLO_WINDOW_S)
            walls_f = []
            # the first of the 12 rounds is a fresh scheduler's (cold, over
            # 100 ms on any host); the warm ones burn the objective as well
            # wherever the host holds them over 100 ms
            fresh = Scheduler(Cluster(), rng=random.Random(1))
            for r in range(12):
                wall, _, _ = solve(fresh, "headline", what=f"obs (f) knob-off round {r}")
                walls_f.append(wall * 1e3)
            snap = engine.snapshot()["objectives"]["solve_p99"]
            log(f"[obs] (f) SLO window {SLO_WINDOW_S} s (slow {engine.slow_window_s} s); "
                f"12 knob-off "
                f"rounds (the first cold) {', '.join(f'{w:.1f}' for w in walls_f)} ms, "
                f"{sum(w > 100.0 for w in walls_f)} over 100 ms: solve.p99 "
                f"{snap['value'] * 1e3:.3f} ms, burn fast {snap['burn_rate']['fast']} slow "
                f"{snap['burn_rate']['slow']}, burning {snap['burning']}")
            if not snap["burning"]:
                raise AssertionError(f"obs (f): solve.p99 < 100ms is not burning: {snap}")
            router = default_router()
            ladder = BrownoutController(router=router, escalate_after=1, recover_after=1)
            climbed = [ladder.tick(), ladder.tick()]
            if climbed[-1] < 1 or not router.probes_paused():
                raise AssertionError(f"obs (f): the ladder reached {climbed}, probes paused "
                                     f"{router.probes_paused()}")
            log(f"[obs] (f) brownout ticks -> levels {climbed}, transitions "
                f"{ladder.transitions}; karpenter_brownout_level "
                f"{metric('karpenter_brownout_level')}; probes paused")

            def canary_round(what):
                sched = Scheduler(Cluster(), rng=random.Random(1), canary_rate=1.0)
                before = integrity.totals()["canary_solves"]
                solve(sched, "headline", what=what)
                if sched.torch._canary_thread is not None:
                    sched.torch._canary_thread.join(timeout=120)
                    if sched.torch._canary_thread.is_alive():
                        raise AssertionError(f"{what}: the canary did not finish")
                return integrity.totals()["canary_solves"] - before

            paused_canaries = canary_round("obs (f) canary round under brownout")
            if paused_canaries:
                raise AssertionError(f"obs (f): {paused_canaries} canary solves while paused")
            t0 = time.perf_counter()
            clean = 0
            while time.perf_counter() - t0 < 3 * SLO_WINDOW_S:
                solve(res, "headline", what="obs (f) resident round")
                clean += 1
                state = engine.snapshot()["objectives"]["solve_p99"]
                if not state["burning"] and state["events"]["fast"] >= 10 and not any(
                        v["burning"] for v in engine.burning_panel().values()):
                    break
            else:
                raise AssertionError(f"obs (f): still burning after {clean} resident rounds: "
                                     f"{state}")
            recovered = []
            while ladder.level() > 0 and len(recovered) < 8:
                recovered.append(ladder.tick())
            if ladder.level() != 0 or router.probes_paused():
                raise AssertionError(f"obs (f): the ladder did not recover: {recovered}")
            resumed = canary_round("obs (f) canary round after recovery")
            if resumed != 1:
                raise AssertionError(f"obs (f): {resumed} canary solves after recovery")
            ladder.stop()
            summary["slo"] = {"window_s": SLO_WINDOW_S, "knob_off_ms": walls_f,
                              "p99_ms": snap["value"] * 1e3, "burn_fast": snap["burn_rate"]["fast"],
                              "burn_slow": snap["burn_rate"]["slow"], "levels_up": climbed,
                              "levels_down": recovered, "resident_rounds": clean}
            log(f"[obs] (f) {clean} resident rounds cleaned the fast window "
                f"({state['events']['fast']} events, p99 {state['value'] * 1e3:.3f} ms, burn "
                f"{state['burn_rate']}); ladder -> {recovered}; transitions {ladder.transitions}; "
                f"karpenter_brownout_level {metric('karpenter_brownout_level')}; canary solves "
                f"{paused_canaries} paused, {resumed} after recovery")
            rounds["pack_first_fit"] = 12 + 2 + clean

        # -- (g) the sidecar, traced ------------------------------------------
        try:
            import grpc  # noqa: F401
        except ImportError:
            log("[obs] grpc not installed on this host: (g) is held by the CPU tests")
        else:
            with part("sidecar") as rounds:
                summary["sidecar"] = sidecar_traced(card, classes, catalogs, rounds)
    finally:
        obs.reset_for_tests()
        shutil.rmtree(scratch, ignore_errors=True)
        for (lock, memo), was in zip(memos, saved):
            with lock:
                memo.clear()
                memo.update(was)
    for name in modules:
        out[name]["launches_obs"] = sum(v for k, v in out[name].items()
                                        if k.startswith("launches_"))
    out["summary"] = summary
    return out


def sidecar_traced(card: str, classes: dict, catalogs: dict, rounds: dict) -> dict:
    """Phase 14 (g): serve() on the card with its health port, and traced
    device="cpu" controller rounds through it: a unary headline round and
    a streamed team-mix round. The controller's solver.wire span holds the
    sidecar's grafted stage records; the sidecar's ring (GET /debug/traces
    on its health port) holds its sidecar.pack tree under the controller's
    trace id; GET /metrics serves the port's families. Fills ``rounds``
    with the rounds each kernel served."""
    import urllib.request

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import service as S
    from karpenter_tpu_torch.testing import make_provisioner

    prov = make_provisioner(solver="tpu")
    address = free_address()
    health_port = int(free_address().rsplit(":", 1)[1])
    server = S.serve(address, max_workers=8, health_port=health_port, service=S.SolverService())
    os.environ["KARPENTER_PACKER"] = "fused"
    closers = []
    found = {}

    def get(path: str) -> bytes:
        with urllib.request.urlopen(f"http://127.0.0.1:{health_port}{path}", timeout=30) as r:
            return r.read()

    def traced_round(sched, cls, what):
        sched.torch.topology.rng = random.Random(1)
        obs.exporter().clear()
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalogs[cls], classes[cls]["pods"])
        wall = (time.perf_counter() - t0) * 1e3
        prof = served(sched, "sidecar", what)
        if plan_of(nodes, classes[cls]["pods"]) != classes[cls]["cpu_plan"]:
            raise AssertionError(f"{what}: plan differs from the card plan")
        root = next(t for t in obs.exporter().trees() if t["name"] == "solver.solve")
        wires = obs.spans_named(root, "solver.wire")
        if len(wires) != 1 or wires[0]["attrs"].get("transport") != prof["solver_transport"]:
            raise AssertionError(f"{what}: solver.wire spans {wires}")
        grafted = [c["name"] for c in wires[0]["children"]]
        if grafted != ["sidecar.solve", "sidecar.fetch", "sidecar.serialize"]:
            raise AssertionError(f"{what}: solver.wire holds {grafted}")
        log(f"[obs] (g) {what}: {wall:.3f} ms, transport={prof['solver_transport']}, "
            f"solver.wire {wires[0]['duration_ms']:.3f} ms holding "
            + ", ".join(f"{c['name']} {c['duration_ms']:.3f}" for c in wires[0]["children"])
            + f" ms; trace {root['trace_id']}")
        return prof, root

    try:
        unary = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                          solver_service_address=address)
        closers.append(unary)
        _, root = traced_round(unary, "headline", "unary headline round")
        rounds["pack_first_fit"] = 1
        body = json.loads(get(f"/debug/traces?trace_id={root['trace_id']}"))
        packs = [t for t in body["traces"] if t["name"] == "sidecar.pack"]
        if len(packs) != 1 or packs[0]["trace_id"] != root["trace_id"]:
            raise AssertionError(f"obs (g): sidecar ring holds {[t['name'] for t in body['traces']]}")
        begin = next(c for c in root["children"] if c["name"] == "solve.pack_begin")
        if packs[0]["parent_id"] != begin["span_id"]:
            raise AssertionError("obs (g): sidecar.pack is not parented on solve.pack_begin")
        found["sidecar_pack"] = [c["name"] for c in packs[0]["children"]]
        streamed = Scheduler(Cluster(), rng=random.Random(1), device="cpu",
                             solver_service_address=address, solver_stream=True)
        closers.append(streamed)
        transport = None
        for r in range(4):
            prof, _ = traced_round(streamed, "team mix", f"streamed team mix round {r}")
            rounds["pack_first_fit_v2"] = r + 1
            transport = prof["solver_transport"]
            if transport == "stream":
                break
        if transport != "stream":
            raise AssertionError(f"obs (g): the team mix never rode the stream ({transport})")
        text = get("/metrics").decode()
        for family in ("karpenter_solver_session_hbm_bytes{", "karpenter_solver_stream_solves_total{",
                       "karpenter_trace_spans_total", "karpenter_solver_admission_queue_depth"):
            if family not in text:
                raise AssertionError(f"obs (g): /metrics lacks {family}")
        found["metrics_lines"] = len(text.splitlines())
        log(f"[obs] (g) sidecar ring: sidecar.pack under the controller's trace, parented on "
            f"its solve.pack_begin, children {found['sidecar_pack']}; /metrics "
            f"{found['metrics_lines']} lines with the session HBM, stream, trace and admission "
            f"families; card {card}")
    finally:
        os.environ.pop("KARPENTER_PACKER", None)
        for c in closers:
            if c.torch._remote is not None:
                c.torch._remote.close()
        server.health_server.shutdown()
        server.stop(grace=None)
    return found


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gc_hook = log_gc_pauses()

    from karpenter_tpu_torch.kube.client import Cluster
    from karpenter_tpu_torch.cloudprovider.fake import instance_types
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler
    from karpenter_tpu_torch.solver import pack_kernel
    from karpenter_tpu_torch.solver.kernel import pack_reference
    from karpenter_tpu_torch.testing import diverse_pods, make_provisioner
    from karpenter_tpu_torch.testing.factories import make_pod
    from karpenter_tpu_torch.api.objects import LabelSelector, PodAffinityTerm
    from karpenter_tpu_torch.api import labels as lbl

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # every phase runs the default packer unless it says otherwise: on the
    # card that is the device path, routed by shape
    os.environ.pop("KARPENTER_PACKER", None)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = pack_kernel.build()
    log(f"[build] {', '.join(sorted(libs))} built in {time.perf_counter() - t0:.2f}s")
    for name in sorted(libs):
        for line in pack_kernel.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 2. kernel against its plain version ------------------------------
    t0 = time.perf_counter()
    batch = headline_batch(10000, 400, 42)
    P = len(batch.pod_valid)
    S, C = batch.join_table.shape
    F, R = batch.frontiers.shape[1], batch.frontiers.shape[2]
    log(f"[parity] headline batch P={P} S={S} F={F} R={R} C={C} "
        f"T={batch.usable.shape[0]} U={batch.uniq_req.shape[0]} "
        f"hostnames={len(batch.hostnames)} (encoded in {time.perf_counter() - t0:.2f}s)")
    gpu = kernel_inputs(batch, dev)
    cpu = tuple(a.cpu() for a in gpu)
    worst = 0.0
    results = {}
    for n_max in (512, P, 64):
        out = pack_kernel.pack_first_fit(*gpu, n_max=n_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pack_reference(*cpu, n_max=n_max)
        cpu_s = time.perf_counter() - t0
        worst = max(worst, compare(ref, out))
        results[n_max] = out
        log(f"[parity] headline n_max={n_max}: bit-exact, nodes={int(out.n_nodes)} "
            f"unscheduled={int((out.assignment[: batch.n_pods] < 0).sum())} "
            f"(plain version on CPU {cpu_s:.2f}s)")
    if int(results[64].n_nodes) != 64:
        raise AssertionError("n_max=64 did not saturate the node table")

    rng = np.random.default_rng(7)
    Ps, Ss, Fs, Rs, Cs, H = 4096, 200, 8, 4, 16, 120
    host = np.where(rng.random(Ps) < 0.5, rng.integers(0, H, Ps), -1)
    hib = rng.random(Ps) < 0.7
    frontiers = rng.uniform(2.0, 8.0, (Ss, Fs, Rs))
    frontiers[:, Fs // 2:, :] = -1.0
    open_sig_by_core = rng.integers(0, Ss, Cs)
    core = rng.integers(0, Cs, Ps)
    synth = (
        torch.tensor(rng.random(Ps) < 0.95),
        torch.tensor(open_sig_by_core[core], dtype=torch.int32),
        torch.tensor(core, dtype=torch.int32),
        torch.tensor(host, dtype=torch.int32),
        torch.tensor(hib),
        torch.tensor(np.where(host >= 0, np.where(hib, host, -2), -1), dtype=torch.int32),
        torch.tensor(rng.uniform(0.1, 1.5, (Ps, Rs)), dtype=torch.float32),
        torch.tensor(rng.integers(-1, Ss, (Ss, Cs)), dtype=torch.int32),
        torch.tensor(frontiers, dtype=torch.float32),
        torch.tensor(rng.uniform(0.0, 0.5, Rs), dtype=torch.float32),
    )
    for n_max in (1024, Ps):
        out = pack_kernel.pack_first_fit(*(a.to(dev) for a in synth), n_max=n_max)
        torch.cuda.synchronize()
        worst = max(worst, compare(pack_reference(*synth, n_max=n_max), out))
        hosts = set(out.node_host[: int(out.n_nodes)].tolist())
        log(f"[parity] synthetic P={Ps} S={Ss} F={Fs} R={Rs} C={Cs} n_max={n_max}: "
            f"bit-exact, nodes={int(out.n_nodes)} host states -2:{-2 in hosts} "
            f"-1:{-1 in hosts} h:{max(hosts) >= 0}")

    ms_512 = kernel_ms(gpu, 512, 20)
    ms_p = kernel_ms(gpu, P, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = pack_reference(*gpu, n_max=512)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare(plain, results[512]))
    n_bytes, n_ops = v1_work(gpu, results[512])
    bound_ms, bound_by = bound(n_bytes, n_ops)
    bound_p, _ = bound(*v1_work(gpu, results[P]))
    log(f"[parity] kernel {ms_512:.4f} ms at n_max=512 ({ms_512 * 1e6 / P:.1f} ns per pod "
        f"step), {ms_p:.4f} ms at n_max={P} (CUDA events, mean of 20); plain version on "
        f"the card {plain_ms:.1f} ms; "
        f"bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes, {n_ops} ops), "
        f"{bound_p:.6f} ms at n_max={P}; card {card}")
    sweep("pack_first_fit headline", gpu, 512, (F, R), results[512], 20, card)

    # -- 3. main path -----------------------------------------------------
    catalog = instance_types(400)
    pods = diverse_pods(10000)
    prov = make_provisioner(solver="tpu")
    sched = Scheduler(Cluster(), rng=random.Random(1))
    t0 = time.perf_counter()
    warm = sched.solve(prov, catalog, pods)
    torch.cuda.synchronize()
    served(sched, "pack_first_fit", "main warm-up")
    log(f"[main] warm-up round {time.perf_counter() - t0:.3f}s, nodes={len(warm)}")
    cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    cpu_nodes = cpu_sched.solve(prov, catalog, pods)
    not_degraded(cpu_sched, "main cpu plan")
    if plan_of(warm, pods) != plan_of(cpu_nodes, pods):
        raise AssertionError("cuda plan differs from the device='cpu' plan")
    if len(warm) != HEADLINE_NODES:
        raise AssertionError(f"main path opened {len(warm)} nodes, expected {HEADLINE_NODES}")
    log(f"[main] cuda plan == cpu plan ({len(cpu_nodes)} nodes, "
        f"{sum(len(n.pods) for n in cpu_nodes)} pods placed)")

    pack_kernel.launches = 0
    rounds = []
    for r in range(5):
        before = pack_kernel.launches
        t0 = time.perf_counter()
        nodes = sched.solve(prov, catalog, pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = served(sched, "pack_first_fit", f"main round {r}")
        if pack_kernel.launches <= before:
            raise AssertionError(f"round {r} did not launch pack_first_fit")
        rounds.append(wall)
        stages = " ".join(
            f"{k}={prof[k] * 1e3:.3f}ms"
            for k in ("sort_s", "inject_s", "encode_s", "pack_fetch_s", "decode_s", "validate_s")
        )
        log(f"[main] round {r}: {wall * 1e3:.3f} ms, nodes={len(nodes)}, "
            f"pods/s={len(pods) / wall:.1f}, dispatches={prof['pack_dispatches']}, "
            f"{stages}")
    main_launches = pack_kernel.launches
    mean = sum(rounds) / len(rounds)
    log(f"[main] 5 rounds: mean {mean * 1e3:.3f} ms, {len(pods) / mean:.1f} pods/s, "
        f"kernel launches {main_launches}; kernel alone {ms_512:.4f} ms (CUDA events); "
        f"card {card}")
    profile_round(lambda: sched.solve(prov, catalog, pods), card)

    # -- 4. retry path ----------------------------------------------------
    sel = {"app": "solo"}
    term = PodAffinityTerm(label_selector=LabelSelector(match_labels=sel),
                           topology_key=lbl.HOSTNAME)
    solo = [make_pod(labels=sel, requests={"cpu": "0.25"}, pod_anti_requirements=[term])
            for _ in range(600)]
    small = instance_types(50)
    before = pack_kernel.launches
    retry_sched = Scheduler(Cluster(), rng=random.Random(1))
    retry_nodes = retry_sched.solve(prov, small, solo)
    torch.cuda.synchronize()
    prof = served(retry_sched, "pack_first_fit", "retry")
    if prof["pack_dispatches"] != 2 or pack_kernel.launches - before != 2:
        raise AssertionError(f"retry path: {prof['pack_dispatches']} dispatches, "
                             f"{pack_kernel.launches - before} launches")
    retry_cpu_sched = Scheduler(Cluster(), rng=random.Random(1), device="cpu")
    retry_cpu = retry_cpu_sched.solve(prov, small, solo)
    not_degraded(retry_cpu_sched, "retry cpu plan")
    if plan_of(retry_nodes, solo) != plan_of(retry_cpu, solo):
        raise AssertionError("retry path: cuda plan differs from the cpu plan")
    log(f"[retry] 600 one-per-node pods: {len(retry_nodes)} nodes, dispatches=2, "
        f"cuda == cpu")

    v2, team = diverse_phases(dev, card)
    resident = resident_phase(dev, card)
    classes = {
        "headline": {"pods": pods, "cpu_plan": plan_of(cpu_nodes, pods)},
        "team mix": team,
        "retry": {"pods": solo, "cpu_plan": plan_of(retry_cpu, solo)},
    }
    route = route_phase(dev, card, classes)

    # -- 11. degrade ------------------------------------------------------
    # every earlier phase ran healthy: nothing quarantined, screened out or
    # contradicted by a canary
    from karpenter_tpu_torch.solver import integrity

    totals = integrity.totals()
    bad = {k: totals[k] for k in ("quarantines", "screen_failures", "canary_mismatches")
           if totals[k]}
    if bad:
        raise AssertionError(f"integrity counters before phase 11: {bad}")
    log(f"[degrade] before phase 11: integrity {totals}")
    degrade = degrade_phase(card, classes)

    # -- 12. sidecar ------------------------------------------------------
    catalogs, batches = sidecar_inputs()
    sidecar = sidecar_phase(dev, card, classes, catalogs, batches)

    # -- 13. stream -------------------------------------------------------
    stream = stream_phase(dev, card, classes, catalogs, batches, sidecar["wire_ser_ms"])

    # -- 14. obs ----------------------------------------------------------
    observed = obs_phase(dev, card, classes, catalogs, batches)

    # -- 10. kernels ------------------------------------------------------
    def sidecar_launches(name):
        return {k.replace("launches_", ""): v
                for part in (sidecar[name], stream[name]) for k, v in part.items()
                if k.startswith("launches_")}

    kernels = [{
        "name": "pack_first_fit",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + resident["pack_first_fit"],
        "launches_by_path": {"main": main_launches, "resident": resident["pack_first_fit"],
                             "route": route["pack_first_fit"]["launches_route"],
                             "obs": observed["pack_first_fit"]["launches_obs"],
                             **sidecar_launches("pack_first_fit")},
        **{k: v for k, v in route["pack_first_fit"].items() if k != "launches_route"},
        "degrade": degrade["pack_first_fit"],
        "stream": stream["pack_first_fit"],
        "obs": {**observed["pack_first_fit"], **observed["summary"]},
        "max_abs_err": worst,
        "ms": ms_512,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "parity": "bit-exact",
        "ns_per_pod": ms_512 * 1e6 / P,
    }, {
        "name": "pack_first_fit_v2",
        "route": "cuda",
        "source": V2_SOURCE,
        "replaces": V2_REPLACES,
        **v2,
        "launches": v2["launches"] + resident["pack_first_fit_v2"],
        "launches_by_path": {"diverse": v2["launches"], "resident": resident["pack_first_fit_v2"],
                             "route": route["pack_first_fit_v2"]["launches_route"],
                             "obs": observed["pack_first_fit_v2"]["launches_obs"],
                             **sidecar_launches("pack_first_fit_v2")},
        **{k: v for k, v in route["pack_first_fit_v2"].items() if k != "launches_route"},
        "degrade": degrade["pack_first_fit_v2"],
        "stream": stream["pack_first_fit_v2"],
        "obs": {**observed["pack_first_fit_v2"], **observed["summary"]},
        "library_ms": None,
        "parity": "bit-exact",
    }]
    if main_launches < 5:
        raise AssertionError(f"main path launched pack_first_fit {main_launches} times")
    if v2["launches"] < 5:
        raise AssertionError(f"diverse path launched pack_first_fit_v2 {v2['launches']} times")
    if resident["pack_first_fit"] < 5 or resident["pack_first_fit_v2"] < 6:
        raise AssertionError(f"resident path launches {resident}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    gc.callbacks.remove(gc_hook)  # nothing may print after the last line
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
