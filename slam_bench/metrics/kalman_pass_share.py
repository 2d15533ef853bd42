"""kalman_pass_share (share): the self time of the program's
``kalman.filter`` spans (the filter's event loop) over the traced window,
one whole pass."""

from slam_bench.harness import kalman_records


def read(ctx):
    if ctx.trace is None:
        return None
    s = kalman_records.phase_s(ctx, "kalman.filter")
    return s / ctx.trace.window_s if s is not None else None
