"""stage_s.mapping (s): ``pipeline.occupancy_map`` and the grid's read-back,
host clock, averaged over the window's passes."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("mapping")
    return stats.mean(xs) if xs else None
