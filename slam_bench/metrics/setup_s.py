"""setup_s (s): from process start to the first timed operation: imports, CUDA
initialisation, the kernels' build or load, the survey's simulation, the
program's set-up and the warm-up on a prefix of the survey."""


def read(ctx):
    return ctx.setup_s
