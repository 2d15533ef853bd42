"""phase_ms.nssm_sampling (ms): the self time of the program's ``nssm.sampling``
spans inside the traced stretch's ``keyframe_step`` spans, over the
steps (the seven ``phase_ms`` metrics add up to the mean traced step)."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.phase_self_ns(ctx, "keyframe_step", "nssm.sampling")
    return got[0] * 1e-6 / got[1] if got else None
