"""kalman_kernel_share (share): of the events the program's Kalman filter
ran in the traced pass, the share that its CUDA kernel ran (the ``kernel``
count beside ``filtered`` on the ``kalman.filter`` records under
``dr_gate``). A program whose records carry no such count gives None."""

from slam_bench.harness import kalman_records, program_spans


def read(ctx):
    events = kalman_records.filtered_events(ctx)
    if events is None:
        return None
    recs, _, owner = program_spans.under(ctx, kalman_records.ROOT)
    held = [recs[i] for i in owner]
    if not all(hasattr(r, "kernel") for r in held):
        return None
    return sum(r.kernel for r in held) / events
