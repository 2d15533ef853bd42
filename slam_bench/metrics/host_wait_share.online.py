"""host_wait_share.online (share): the nanoseconds the host blocked in the
host reads of the traced stretch's ``keyframe_step`` spans, over the spans'
summed duration: near 0 the host's dispatch sets the step's pace, near 1
the device does."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.reads_under(ctx, "keyframe_step")
    return got[1] / got[2] if got and got[2] > 0 else None
