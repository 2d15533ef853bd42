"""stage_s.odometry (s): the replay's ``dr_gate`` stage, host clock ending in a
device sync, averaged over the window's passes."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("dr_gate")
    return stats.mean(xs) if xs else None
