"""device_idle.online (share): 1 - the union of the device's kernel, copy and
set intervals over the traced window."""

from slam_bench.harness import stats


def read(ctx):
    if ctx.trace is None:
        return None
    return stats.idle_share(ctx.trace.busy_s, ctx.trace.window_s)
