"""kalman_s.integrate (s): the self time of the program's ``kalman.integrate``
spans under its ``dr_gate`` span in the traced pass."""

from slam_bench.harness import kalman_records


def read(ctx):
    return kalman_records.phase_s(ctx, "kalman.integrate")
