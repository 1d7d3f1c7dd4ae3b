"""The host stages' mean (ms) per round of the window: sort + inject +
encode + decode + validate from ``Scheduler.last_stage_profile()``, each
stage's full or resident (``_delta``) key."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not rounds:
        return None
    stages = ("sort", "inject", "encode", "decode", "validate")
    return 1e3 * sum(stage_seconds(p, s) for p in rounds for s in stages) / len(rounds)
