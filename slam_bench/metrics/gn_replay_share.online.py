"""gn_replay_share.online (share): of the factor graph's Gauss-Newton sweeps
and marginals inside the traced stretch's ``keyframe_step`` spans, the share
that replayed a captured CUDA graph."""

from slam_bench.harness import graph_runs


def read(ctx):
    return graph_runs.replay_share(ctx, ("keyframe_step",))
