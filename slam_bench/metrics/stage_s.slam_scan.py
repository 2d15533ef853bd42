"""stage_s.slam_scan (s): the replay's ``slam_scan`` stage, host clock ending
in a device sync, averaged over the window's passes."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("slam_scan")
    return stats.mean(xs) if xs else None
