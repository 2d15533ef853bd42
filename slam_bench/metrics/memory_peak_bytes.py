"""memory_peak_bytes (B): the device allocator's peak over the measured
window (``torch.cuda.max_memory_allocated`` after a reset at the window's
start), the number ``device.memory_peak_bytes`` reports."""


def read(ctx):
    peak = getattr(ctx, "memory_peak_bytes", 0)
    return int(peak) if peak > 0 else None
