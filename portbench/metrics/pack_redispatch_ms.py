"""The saturated table's full-table re-dispatch, mean (ms) per round of the
window: ``pack_redispatch_s`` from ``Scheduler.last_stage_profile()``, the
clock of the ``pack.redispatch`` span inside ``solve.pack_fetch`` (the
retry at P slots and its fetch; part of ``pack_fetch_s``; 0 in a round
whose first table did not saturate). Nothing where no round carries the
key (a program without the span)."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not any("pack_redispatch_s" in p for p in rounds):
        return None
    return 1e3 * sum(stage_seconds(p, "pack_redispatch") for p in rounds) / len(rounds)
