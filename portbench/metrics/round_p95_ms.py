"""The 95th percentile (ms) of the host-clock wall of every completed
``Scheduler.solve`` in the measured window (not the traced stretch); a
failed round is left out."""

import stats


def read(ctx):
    walls = [r["wall_s"] for r in ctx.rounds if r["ok"]]
    return stats.percentile(walls, 95) * 1e3 if walls else None
