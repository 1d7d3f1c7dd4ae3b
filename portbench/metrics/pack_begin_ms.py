"""The pack's begin, mean (ms) per round of the window: ``pack_begin_s``
from ``Scheduler.last_stage_profile()``, the clock of the
``solve.pack_begin`` span (the pod table, its upload, the invariants, the
kernel wrapper's bounds check and the launch; part of ``pack_fetch_s``).
Nothing where no round carries the key (a program without it)."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not any("pack_begin_s" in p or "pack_begin_delta_s" in p for p in rounds):
        return None
    return 1e3 * sum(stage_seconds(p, "pack_begin") for p in rounds) / len(rounds)
