"""refine_phase_s.sweep (s): the self time of the program's
``refine.sweep`` spans inside the traced pass's ``refine`` span."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "refine", "refine.sweep")
    return got[0] * 1e-9 if got else None
