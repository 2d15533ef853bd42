"""launches_per_kf.online (launches/kf): kernel launches inside the ``step``
spans (one ``keyframe_step`` and its pose's read-back each) of the traced
stretch, over the steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    n = ctx.trace.launches.get("step")
    steps = len(ctx.trace.spans.get("step", ()))
    return n / steps if n and steps else None
