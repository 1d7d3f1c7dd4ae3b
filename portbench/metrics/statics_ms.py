"""The per-pod statics pass's mean (ms) per round of the window:
``statics_s`` from ``Scheduler.last_stage_profile()``, the clock of the
``solve.statics`` span inside ``solve.sort`` (a round whose sort came from
resident state ran no pass and counts 0). Nothing where no round carries
the key (a program without the span)."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not any("statics_s" in p or "statics_delta_s" in p for p in rounds):
        return None
    return 1e3 * sum(stage_seconds(p, "statics") for p in rounds) / len(rounds)
