"""Decode's options lists, mean (ms) per round of the window:
``decode_options_s`` from ``Scheduler.last_stage_profile()``, the clock of
the ``decode.options`` span inside ``solve.decode`` (each node's
surviving-type row, their dedup and each distinct list of instance-type
options; part of ``decode_s``). Nothing where no round carries the key (a
program without the span)."""

from stats import stage_seconds


def read(ctx):
    rounds = [r["profile"] for r in ctx.rounds if r["ok"]]
    if not any("decode_options_s" in p for p in rounds):
        return None
    return 1e3 * sum(stage_seconds(p, "decode_options") for p in rounds) / len(rounds)
