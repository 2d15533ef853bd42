"""kalman_launches_per_event (launches/event): kernel launches (the
runtime's launch calls in the profiler's trace) inside the benchmark's
``odometry`` span of the traced pass, over the events the program's Kalman
filter counted as run there (gated DVL events left out)."""

from slam_bench.harness import kalman_records


def read(ctx):
    events = kalman_records.filtered_events(ctx)
    if events is None:
        return None
    n = ctx.trace.launches.get("odometry")
    return n / events if n else None
