"""Validate's mean (ms) per round of the window: ``validate_s`` or
``validate_delta_s`` from ``Scheduler.last_stage_profile()``."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not rounds:
        return None
    return 1e3 * sum(stage_seconds(p, "validate") for p in rounds) / len(rounds)
