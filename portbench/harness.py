"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

A cell is ``workloads/<name>.json``; it names a configuration
(``configs/<name>.json``, which names its catalog and pod mix, found by
``generate``) and a traffic mix (``traffic/<name>.json``).
Per-layer metrics are ``metrics/<name>.py`` files, found by the names
``BENCHMARK.json`` lists for the cell; each has ``read(ctx)`` and may
have ``prepare(ctx)`` and ``finish(ctx)``, called around the traced
stretch.

The window drives ``Scheduler.solve(provisioner, catalog, pods)`` of
``karpenter_tpu_torch`` back to back from one worker, for ``seconds``; each
round hands over pod objects the program has never seen, and building them
is taken out of the window's time.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import adapter
import check
import generate
import stats
from reference import scheduler as reference

HERE = Path(__file__).resolve().parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")
# what serves a round on the CPU, where each card kernel has its plain twin
CPU_TWIN = {"pack_first_fit": "pack_reference", "pack_first_fit_v2": "pack_v2_reference"}
OUTSIDE = "harness (no span open)"
STRETCH = "portbench.stretch"  # the traced stretch's mark in the profiler's trace
PROFILED_ROUNDS = 12  # rounds under torch.profiler in a --trace 1 run
COMPARED_ROUNDS = 2  # rounds checked against the reference: one drawn from the seed, the last
WARMUP_ROUNDS = 3  # set-up's rounds: the kernels loaded, the card's buffers and the port's memos sized


class NoCard(RuntimeError):
    pass


def load(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str) -> Dict:
    workload = load("workloads", name)
    return {
        "name": name,
        "workload": workload,
        "config": load("configs", workload["config"]),
        "traffic": load("traffic", workload["traffic"]),
    }


def benchmark_metrics(cell_name: str) -> Dict[str, List[Dict]]:
    """The cell's metrics as ``BENCHMARK.json`` lists them."""
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)

    def mine(m):
        return cell_name in m.get("workloads", [cell_name])

    return {kind: [m for m in bench[kind] if mine(m)] for kind in ("end_to_end", "per_layer")}


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a per-layer metric reads: the window's rounds and the traced
    stretch. ``store`` is the metrics' own scratch space."""

    def __init__(self, device: str):
        self.device = device
        self.rounds: List[Dict] = []  # window rounds: wall_s, profile, backend, n_pods
        self.trace: Optional[Dict] = None
        self.store: Dict = {}
        self.log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


class Cell:
    """The program set up for one cell: the traffic, the templates of its
    pods, the program's catalog and provisioner, and the scheduler."""

    def __init__(self, cell: Dict, seed: int, device: str):
        import torch  # noqa: F401  (the card's runtime before the program's import)
        from karpenter_tpu_torch.kube.client import Cluster
        from karpenter_tpu_torch.scheduling.scheduler import Scheduler

        config = cell["config"]
        self.kernel = config["kernel"]
        self.expect = self.kernel if device == "cuda" else CPU_TWIN[self.kernel]
        t0 = time.perf_counter()
        self.traffic = generate.traffic(config, cell["traffic"], seed)
        self.catalog_records = generate.catalog(config["catalog"])
        t1 = time.perf_counter()
        self.catalog = adapter.instance_types(self.catalog_records)
        self.provisioner = adapter.provisioner()
        self.templates = adapter.pods(self.traffic.records)
        self.setup_parts = {"records_s": t1 - t0, "templates_s": time.perf_counter() - t1}
        self.scheduler = Scheduler(
            Cluster(), rng=random.Random(f"portbench:{seed}:topology"), device=device,
            solver_delta=False,  # the port's default, whatever the environment says
        )

    def next_round(self):
        """The next round's record numbers and its pods: new objects, in a
        new list."""
        ids = self.traffic.next()
        return ids, adapter.fresh([self.templates[i] for i in ids], self.traffic.round)

    def solve(self, pods):
        """One round; returns (nodes, wall seconds, profile, error)."""
        import torch

        t0 = time.perf_counter()
        try:
            nodes = self.scheduler.solve(self.provisioner, self.catalog, pods)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        except Exception as e:  # a failed round; the window goes on
            return None, time.perf_counter() - t0, {}, e
        wall = time.perf_counter() - t0
        return nodes, wall, self.scheduler.last_stage_profile(), None


def profile_stretch(cell: Cell, ctx: Context, readers: Dict, n_rounds: int) -> Dict:
    """``n_rounds`` more rounds under ``torch.profiler``: the device's
    operations, the port's spans, and the stretch's host-clock ends. The
    rounds' pods are built before the profiler starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from karpenter_tpu_torch import obs

    spans: List = []

    def hook(span):
        if span.end is not None:
            spans.append((span.name, span.start, span.end))

    for r in readers.values():
        if hasattr(r, "prepare"):
            r.prepare(ctx)
    on_card = ctx.device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    batches = [cell.next_round()[1] for _ in range(n_rounds)]
    tracer = obs.tracer()
    tracer.add_hook(hook)
    try:
        sync()
        with profile(activities=activities) as prof:
            lo = time.perf_counter()
            with record_function(STRETCH):
                for pods in batches:
                    nodes, _, prof_keys, err = cell.solve(pods)
                    if err is not None or prof_keys.get("packer_backend") != cell.expect:
                        raise RuntimeError(f"a traced round failed: {err!r}, served by "
                                           f"{prof_keys.get('packer_backend')!r}")
            sync()
            hi = time.perf_counter()
    finally:
        tracer.remove_hook(hook)
        for r in readers.values():
            if hasattr(r, "finish"):
                r.finish(ctx)
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    marks = [e for e in events if e.name == STRETCH and e.device_type == cpu]
    if len(marks) != 1:
        raise RuntimeError(f"the profiler recorded {len(marks)} stretch marks on the host")
    offset = lo - marks[0].time_range.start / 1e6  # trace microseconds -> perf_counter
    # the device's operations: kernels and copies, not the annotation that
    # mirrors the stretch's mark on the device's timeline
    device = [
        (e.name, e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset)
        for e in events
        if e.device_type == cuda and e.name != STRETCH
        and not getattr(e, "is_user_annotation", False)
    ]
    spans = [s for s in spans if s[2] > lo and s[1] < hi]
    return {"lo": lo, "hi": hi, "device": device, "spans": spans}


def breakdown(trace: Dict) -> Dict:
    lo, hi = trace["lo"], trace["hi"]
    by_name: Dict[str, float] = {}
    for name, s, e in trace["device"]:
        by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo))
    ops = sorted(((n, t) for n, t in by_name.items() if t > 0), key=lambda x: -x[1])[:10]
    idle = stats.gaps([(s, e) for _, s, e in trace["device"]], lo, hi)
    by_span = stats.idle_by_span(idle, trace["spans"], OUTSIDE)
    gaps = sorted(by_span.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:160], t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps]}


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", cell_def: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object, with ``check_lines`` for
    standard error. ``device="cpu"`` and ``cell_def`` (a cell's files as
    loaded, at a smaller size) are for the CPU tests."""
    import torch

    if device == "cuda":
        chips = (cell_def or load_cell(cell_name))["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cell_def = cell_def or load_cell(cell_name)
    names = benchmark_metrics(cell_name)
    ctx = Context(device)
    from karpenter_tpu_torch.utils import gcpolicy

    t_run = time.perf_counter()
    cell = Cell(cell_def, seed, device)
    t_warm = time.perf_counter()
    for _ in range(WARMUP_ROUNDS):
        _, pods = cell.next_round()
        _, _, prof, err = cell.solve(pods)
        if err is not None:
            raise RuntimeError(f"a warm-up round failed: {err!r}") from err
    gcpolicy.freeze_after_warmup()
    setup_s = time.perf_counter() - t_start
    setup_parts = {"imports_and_card_s": t_run - t_start, **cell.setup_parts,
                   "warmup_rounds_s": time.perf_counter() - t_warm}
    gc_full = [0]  # full collections since set-up

    def count_full(phase, info):
        if phase == "start" and info["generation"] == 2:
            gc_full[0] += 1

    gc.callbacks.append(count_full)

    # -- the window: back-to-back rounds from one worker. Building a round's
    # pods is the harness's work, not the program's: its time (``paused``)
    # is taken out of the window's.
    sampler = random.Random(f"portbench:{seed}:sample")
    n_draw = COMPARED_ROUNDS - 1
    drawn: List = []  # reservoir of (round, ids, pods, nodes), drawn from the seed
    last = None
    failed = 0
    paused = 0.0
    cpu0 = time.process_time()
    window_start = time.perf_counter()
    while True:
        t_build = time.perf_counter()
        ids, pods = cell.next_round()
        paused += time.perf_counter() - t_build
        nodes, wall, prof, err = cell.solve(pods)
        last_end = time.perf_counter()
        backend = prof.get("packer_backend")
        ok = err is None and backend == cell.expect
        failed += not ok
        k = len(ctx.rounds)
        ctx.rounds.append({"wall_s": wall, "profile": prof, "backend": backend,
                           "n_pods": len(pods), "ok": ok})
        if ok:
            kept = (k, ids, pods, nodes)
            if len(drawn) < n_draw:
                drawn.append(kept)
            elif n_draw and sampler.randrange(k + 1) < n_draw:
                drawn[sampler.randrange(n_draw)] = kept
            last = kept
        if last_end - window_start - paused >= seconds:
            break
    window_full = gc_full[0]
    cpu1 = time.process_time()
    window_s = last_end - window_start - paused
    done = [r["n_pods"] for r in ctx.rounds if r["ok"]]
    rate = stats.pods_per_s(done, window_s)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    readers = {m["name"]: load_reader(m["name"]) for m in names["per_layer"]} if trace else {}
    if trace:
        ctx.trace = profile_stretch(cell, ctx, readers, PROFILED_ROUNDS)

    # -- the program's plans of the compared rounds, then the program freed ---
    compared = {r[0]: r for r in drawn}
    if last is not None:
        compared[last[0]] = last
    plans = [(k, ids, adapter.plan(nodes, pods)) for k, ids, pods, nodes in
             sorted(compared.values(), key=lambda r: r[0])]
    records, catalog_records = cell.traffic.records, cell.catalog_records
    del cell, drawn, last, compared
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    result: Dict = {"attempted": len(ctx.rounds), "failed": failed}
    if trace:
        metrics = {}
        for m in names["per_layer"]:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = ctx.trace["lo"], ctx.trace["hi"]
        busy = stats.busy_s([(s, e) for _, s, e in ctx.trace["device"]], lo, hi)
        extra_device = {"busy_s": busy, "window_s": hi - lo}
    else:
        values = {"pods_per_s": rate, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in names["end_to_end"]}
        extra_device = {}

    # -- the check: each compared round's plan against the reference's -------
    total = 0
    lines = []
    for k, ids, got in plans:
        t0 = time.perf_counter()
        want = reference.solve([records[i] for i in ids], catalog_records)
        n = check.mismatches(got, want, len(ids))
        total += n
        lines.append(f"check round {k}: plan_mismatches {n} over {len(ids)} pods and "
                     f"{len(want['nodes'])} nodes (reference {time.perf_counter() - t0:.2f} s)")
    correct = bool(plans) and total <= check.LIMIT
    result.update({
        "correct": correct,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": memory_peak,
            **extra_device,
        },
    })
    if trace:
        result["breakdown"] = breakdown(ctx.trace)
    walls = sorted(r["wall_s"] * 1e3 for r in ctx.rounds if r["ok"])
    result["info"] = {
        "rounds": len(ctx.rounds), "pods_done": sum(done), "window_s": window_s,
        "building_pods_s": paused,  # taken out of the window
        "pods_per_s": rate, "setup_s": setup_s, "setup_parts": setup_parts,
        "first_rounds_ms": [r["wall_s"] * 1e3 for r in ctx.rounds[:3]],
        "round_ms": [walls[0], *stats.quartiles(walls), walls[-1]],
        "full_collections": window_full,
        "cpu_s": cpu1 - cpu0,  # the process's CPU seconds in the window
    }
    result["checks"] = {
        "plan_mismatches": {"value": total, "limit": check.LIMIT},
        "rounds_compared": {"value": len(plans), "limit": 1},
    }
    result["check_lines"] = lines + [
        f"plan_mismatches {total} (limit {check.LIMIT}) over {len(plans)} compared rounds",
        f"rounds_compared {len(plans)} (at least 1)",
    ]
    return result
