"""The device's idle share (%) of the traced stretch: 1 - (the union of
the device's operations in ``torch.profiler``'s trace / the stretch's wall
time). Nothing when the trace holds no device operation."""

import stats


def read(ctx):
    if ctx.trace is None or not ctx.trace["device"]:
        return None
    lo, hi = ctx.trace["lo"], ctx.trace["hi"]
    busy = stats.busy_s([(s, e) for _, s, e in ctx.trace["device"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
