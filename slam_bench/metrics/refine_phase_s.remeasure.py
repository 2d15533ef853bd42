"""refine_phase_s.remeasure (s): the self time of the program's
``refine.remeasure`` spans inside the traced pass's ``refine`` span."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "refine", "refine.remeasure")
    return got[0] * 1e-9 if got else None
