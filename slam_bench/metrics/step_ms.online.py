"""step_ms.online (ms): the median over the window of one ``keyframe_step`` and
its pose's read-back, host clock."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("step")
    return 1e3 * stats.median(xs) if xs else None
