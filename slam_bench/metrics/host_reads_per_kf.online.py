"""host_reads_per_kf.online (reads/kf): the program's host reads (each
place the host waits for the device) inside the traced stretch's
``keyframe_step`` spans, over the steps."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.reads_under(ctx, "keyframe_step")
    return got[0] / got[3] if got else None
