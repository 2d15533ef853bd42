"""phase_ms.step_other (ms): the self time of the traced stretch's
``keyframe_step`` spans (factor insertion and the carry's updates), over
the steps."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "keyframe_step", "keyframe_step")
    return got[0] * 1e-6 / got[1] if got else None
