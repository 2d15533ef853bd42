"""refine_phase_s.prune (s): the self time of the program's
``refine.prune`` spans inside the traced pass's ``refine`` span."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "refine", "refine.prune")
    return got[0] * 1e-9 if got else None
