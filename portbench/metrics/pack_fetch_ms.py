"""The device path's mean (ms) per round of the window: ``pack_fetch_s``
from ``Scheduler.last_stage_profile()`` (the launch and the wait for the
card's answer)."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not rounds:
        return None
    return 1e3 * sum(stage_seconds(p, "pack_fetch") for p in rounds) / len(rounds)
