"""Wall-clock span timing and a ``torch.profiler`` trace.

Counterpart of ``sonar_slam_tpu/utils/timing.py`` (the reference's
``CodeTimer``): a context manager that times a span on the host clock,
accumulates a per-span report and logs each span at debug level. PyTorch
returns before a CUDA device finishes, so a span that times device work
passes ``sync=``: a device, a device name, a tensor or a (nested) tuple,
list or dict of tensors; the span then ends in ``torch.cuda.synchronize`` on
every CUDA device among them. ``torch_profile_trace`` records a
``torch.profiler`` trace (CPU, and CUDA where a card is present) around a
block.
"""

from __future__ import annotations

import contextlib
import os
import timeit
from collections import defaultdict

import torch

from .logging import logdebug

_ENABLED = True
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


def set_timing_enabled(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


def _cuda_devices(sync) -> set:
    """The CUDA devices that ``sync`` names or holds tensors on."""
    if isinstance(sync, (str, torch.device)):
        dev = torch.device(sync)
        return {dev} if dev.type == "cuda" else set()
    if isinstance(sync, torch.Tensor):
        return {sync.device} if sync.is_cuda else set()
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (tuple, list)):
        return set().union(*(_cuda_devices(s) for s in sync)) if sync else set()
    return set()


def synchronize(sync) -> None:
    """Wait for every CUDA device that ``sync`` names or holds tensors on."""
    for dev in _cuda_devices(sync):
        torch.cuda.synchronize(dev)


class CodeTimer:
    """``with CodeTimer("name", sync=device_or_tensors): ...`` wall-clock
    span; ``took`` holds its seconds."""

    def __init__(self, name: str = "code block", silent: bool = False, sync=None):
        self.name = name
        self.silent = silent
        self.sync = sync
        self.took = 0.0

    def __enter__(self):
        self.start = timeit.default_timer()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if self.sync is not None:
            synchronize(self.sync)
        self.took = timeit.default_timer() - self.start
        _TOTALS[self.name] += self.took
        _COUNTS[self.name] += 1
        if _ENABLED and not self.silent:
            logdebug(f"{self.name} took {self.took * 1000.0:.2f} ms")
        return False


def timing_report() -> dict[str, tuple[float, int]]:
    """{span: (total_seconds, calls)} accumulated since start/reset."""
    return {k: (_TOTALS[k], _COUNTS[k]) for k in _TOTALS}


def reset_timing() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def torch_profile_trace(logdir: str):
    """Record a ``torch.profiler`` trace around a block and write it to
    ``logdir/trace.json`` (Chrome trace format). Yields the profiler, whose
    ``key_averages()`` sums the recorded events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
