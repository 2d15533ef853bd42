"""gn_replay_share.replay (share): of the factor graph's Gauss-Newton sweeps
and marginals inside the traced pass's ``slam_scan`` and ``refine`` spans,
the share that replayed a captured CUDA graph."""

from slam_bench.harness import graph_runs


def read(ctx):
    return graph_runs.replay_share(ctx, ("slam_scan", "refine"))
