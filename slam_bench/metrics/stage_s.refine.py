"""stage_s.refine (s): the replay's ``refine`` stage, host clock ending in a
device sync, averaged over the window's passes."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("refine")
    return stats.mean(xs) if xs else None
