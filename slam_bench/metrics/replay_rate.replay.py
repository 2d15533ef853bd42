"""replay_rate.replay (survey_s/s): ``replay_rate`` read in the cells where
it is a per-layer metric: simulated survey seconds of every whole pass in
the window over the wall time from the first pass's start to the last
pass's end."""

from slam_bench.harness import stats


def read(ctx):
    return stats.rate(ctx.window.survey_s, ctx.window.wall_s)
