"""launches_per_kf.replay (launches/kf): kernel launches (the runtime's launch
calls in the profiler's trace) inside the ``slam_scan`` span of the traced
pass, over its keyframes."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.trace.launches.get("slam_scan")
    kf = ctx.traced["keyframes"]
    return n / kf if n and kf else None
