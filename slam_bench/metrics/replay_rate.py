"""replay_rate (survey_s/s): simulated survey seconds of every whole pass in
the window over the wall time from the first pass's start to the last pass's
end; each pass ends in a device sync and the read-back of its result."""

from slam_bench.harness import stats


def read(ctx):
    return stats.rate(ctx.window.survey_s, ctx.window.wall_s)
