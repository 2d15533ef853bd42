"""cfar_roofline (%): the CFAR calls' bytes bound over their device time in the
traced stretch. The bound is the bytes each call's shape needs (every image
byte read once, the mask written once) at the H100's 3.35 TB/s; the time is
the summed device time of every kernel launched inside the ``cfar`` span the
benchmark puts around the front end's ``cfar_detect`` call."""

from slam_bench.harness import stats


def read(ctx):
    if ctx.trace is None or not ctx.cfar_calls:
        return None
    device_s = ctx.trace.device_s.get("cfar", 0.0)
    if device_s <= 0:
        return None
    moved = sum(stats.cfar_bytes(shape, thr) for shape, thr in ctx.cfar_calls)
    return stats.roofline_percent(moved, device_s)
