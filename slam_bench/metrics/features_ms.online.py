"""features_ms.online (ms): the median over the window of one keyframe's
feature node: the three pings' upload, ``extract_batch_conf`` and
``corroborate``, ending in a sync, host clock."""

from slam_bench.harness import stats


def read(ctx):
    xs = ctx.window.layers.get("node_features")
    return 1e3 * stats.median(xs) if xs else None
