"""The traced stretch: ``torch.profiler`` over a bounded piece of a run, kept
as aggregates.

The drivers mark the layers with ``span(name)`` from the benchmark's own
files: a host-clock range (``time.time_ns``, the clock of the profiler's
events) kept in memory while ``capture`` runs, so the profiler records only
the device's activity and the runtime's calls (recording every CPU op too
made a replay's trace take minutes to reduce). ``capture`` profiles a
callable and reduces the raw events to: the device's busy time
(the union of every kernel, copy and set interval), the traced window, the
kernel launches (runtime launch calls) and the device time of the kernels
launched under each span name, the spans themselves, and the top device
operations. Nothing is written to disk unless ``chrome_trace`` names a
file.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from . import stats

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """The spans of one traced stretch: name -> [(start_ns, end_ns)]."""

    active = None  # the Recorder of the stretch being traced, if any

    def __init__(self):
        self.spans = defaultdict(list)


@contextlib.contextmanager
def span(name: str):
    """A benchmark span around a call into one layer (kept only while a
    stretch is traced)."""
    rec = Recorder.active
    if rec is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        rec.spans[name].append((t0, time.time_ns()))


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    spans: dict  # name -> [(start_ns, end_ns)]
    launches: dict  # span name -> kernel launches started inside it
    device_s: dict  # span name -> device seconds of kernels launched in it
    total_launches: int
    device_ops: list  # [(kernel name, seconds)], most time first
    idle_gaps: list  # [(span name, seconds)] idle device time by host span
    kernels: int
    matched: float  # share of device events whose launch was found


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cuLaunch")


def _kind(e) -> str:
    """The event's kineto activity (``activity_type`` where the torch build
    has it; else from its device, annotation flag and name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if _is_launch(name) else "cpu_op"


def _holder(ranges):
    """A test ``t -> bool``: whether any of ``ranges`` holds ``t`` (spans of
    one name do not overlap one another, except nested calls)."""
    ranges = sorted(ranges)
    starts = [a for a, _ in ranges]
    ends, reach = [], None
    for _, b in ranges:
        reach = b if reach is None else max(reach, b)
        ends.append(reach)

    def holds(t) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    return holds


def reduce(events, spans: dict, labels=()) -> Trace:
    """Reduce kineto events with the stretch's host spans. ``labels`` orders
    the span names that label an idle gap (the first span that holds the
    gap's midpoint names it; ``host`` when none does)."""
    launches = []  # (start_ns, correlation)
    device = []  # (start_ns, end_ns, name, correlation, activity)
    for e in events:
        act = _kind(e)
        name = e.name()
        if act in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.end_ns(), name, e.correlation_id(),
                           act))
        elif act in ("cuda_runtime", "cuda_driver") and _is_launch(name):
            launches.append((e.start_ns(), e.correlation_id()))
    if "trace" not in spans:
        raise RuntimeError("the traced stretch has no trace span")
    w0, w1 = spans["trace"][0]
    intervals = [(s, e) for s, e, *_ in device]
    busy_ns = stats.union_length(intervals)

    launched = {c for _, c in launches}
    matched = (sum(1 for d in device if d[3] in launched) / len(device)
               if device else 0.0)
    by_corr = defaultdict(float)
    per_kernel = defaultdict(float)
    for s, e, name, corr, act in device:
        by_corr[corr] += (e - s) * 1e-9
        if act == "kernel":
            per_kernel[name] += (e - s) * 1e-9
    holders = {name: _holder(ranges) for name, ranges in spans.items()}
    launch_n, dev_s = {}, {}
    for name, holds in holders.items():
        inside = [c for t, c in launches if holds(t)]
        launch_n[name] = len(inside)
        dev_s[name] = sum(by_corr.get(c, 0.0) for c in inside)

    gap_by = defaultdict(float)
    for a, b in stats.idle_gaps(intervals, w0, w1):
        mid = 0.5 * (a + b)
        label = next((lab for lab in labels
                      if lab in holders and holders[lab](mid)), "host")
        gap_by[label] += (b - a) * 1e-9
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 spans=dict(spans), launches=launch_n, device_s=dev_s,
                 total_launches=len(launches), device_ops=top,
                 idle_gaps=gaps, kernels=sum(1 for d in device
                                             if d[4] == "kernel"),
                 matched=matched)


def capture(fn, labels=(), chrome_trace: str | None = None):
    """Profile ``fn()`` inside a ``trace`` span that ends in a device sync;
    returns (fn's result, Trace, seconds spent reducing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    rec = Recorder()
    Recorder.active = rec
    try:
        with profile(activities=acts) as prof:
            with span("trace"):
                out = fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        Recorder.active = None
    if chrome_trace:
        prof.export_chrome_trace(chrome_trace)
    t0 = time.perf_counter()
    tr = reduce(prof.profiler.kineto_results.events(), dict(rec.spans), labels)
    return out, tr, time.perf_counter() - t0
