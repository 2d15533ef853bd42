"""host_reads.refine (reads): the program's host reads (each place the host
waits for the device) inside the traced pass's ``refine`` span."""

from slam_bench.harness import program_spans


def read(ctx):
    got = program_spans.reads_under(ctx, "refine")
    return got[0] if got else None
