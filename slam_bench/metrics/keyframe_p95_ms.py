"""keyframe_p95_ms (ms): the 95th percentile over every keyframe of the window
of the host-clock time from the moment its inputs are in (its second
neighbour's DR tick read back) to its optimised pose's read-back."""

from slam_bench.harness import stats


def read(ctx):
    if not ctx.window.latency_s:
        return None
    return 1e3 * stats.percentile(ctx.window.latency_s, 95.0)
