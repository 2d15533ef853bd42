"""The benchmark's arithmetic: rates over whole passes, percentiles, the
device's busy and idle time from kernel intervals, and the CFAR call's bytes
bound. Pure functions of numbers, so the CPU tests hold them."""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12


def rate(work: float, seconds: float) -> float:
    """Work done over the wall time it took (``replay_rate``: survey seconds
    of all passes over the time from the first pass's start to the last
    pass's end)."""
    if seconds <= 0:
        raise ValueError("a rate needs a positive time")
    return work / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values, q: float) -> int:
    """How many samples lie above the ``q``-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)


def mean(values) -> float:
    xs = list(values)
    if not xs:
        raise ValueError("no samples")
    return sum(xs) / len(xs)


def median(values) -> float:
    return percentile(values, 50.0)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total = 0.0
    end = -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, start: float, stop: float):
    """The gaps in [start, stop] that no interval covers, as (start, end)."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, stop)))
        cur = max(cur, e)
        if cur >= stop:
            break
    if cur < stop:
        gaps.append((cur, stop))
    return [g for g in gaps if g[1] > g[0]]


def idle_share(busy_s: float, window_s: float) -> float:
    """1 - busy / window: the share of the traced window in which no
    operation ran on the device."""
    if window_s <= 0:
        raise ValueError("empty traced window")
    return 1.0 - busy_s / window_s


def cfar_bytes(shape, with_threshold: bool = False) -> int:
    """Bytes a CFAR call over float32 frames of ``shape`` (B, R, C) must move:
    each image byte read once and the bool mask written once (the threshold
    map written once more when asked for). At (128, 512, 256): 67.1 MB read
    and 16.8 MB of mask."""
    b, r, c = shape
    px = b * r * c
    return 4 * px + px + (4 * px if with_threshold else 0)


def roofline_percent(bytes_moved: float, device_s: float,
                     peak_bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The bytes bound's time over the measured device time, in percent."""
    if device_s <= 0:
        raise ValueError("no device time")
    return 100.0 * (bytes_moved / peak_bytes_per_s) / device_s
