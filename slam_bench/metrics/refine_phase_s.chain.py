"""refine_phase_s.chain (s): the self time of the program's
``refine.chain`` spans inside the traced pass's ``refine`` span."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "refine", "refine.chain")
    return got[0] * 1e-9 if got else None
