"""Named spans and host-read counters on the profiler's clock.

Counterpart of ``sonar_slam_tpu/utils/timing.py`` (the reference's
``CodeTimer``): a context manager that times a span on the host clock,
accumulates a per-span report and logs each span at debug level. PyTorch
returns before a CUDA device finishes, so a span that times device work
passes ``sync=``: a device, a device name, a tensor or a (nested) tuple,
list or dict of tensors; the span then ends in ``torch.cuda.synchronize`` on
every CUDA device among them. No other span synchronizes.

The clock is ``time.time_ns``, the clock of ``torch.profiler``'s events. While
a profiler is active on the thread (``torch.autograd._profiler_enabled()``),
every span also appends a :class:`Record` to an in-memory trace: its name,
start and end, the index of the span that encloses it, a request id shared
by the spans of one request (a keyframe's index for ``keyframe_step`` and
its children), and the host reads made in it. :func:`host_read` wraps each
place where the program waits for the device to hand a value to the host;
while recording, it adds one read and the nanoseconds the host blocked in it
to the innermost open span (:func:`to_device` for a copy to the device).
:func:`count_graph_run` counts each Gauss-Newton sweep and each marginal of
the factor graph on the innermost open span, as ``replayed`` (a captured
CUDA graph) or ``eager``; :func:`count_filter_events` counts the Kalman
filter's events on it, as ``filtered`` (run through the filter) or
``gated`` (DVL events the over-speed gate skipped), and as ``kernel`` the
events of ``filtered`` that its CUDA kernel ran. With no profiler active
nothing is recorded and
no device memory is touched: a span costs one profiler check and two clock
reads, a host read one list check. :func:`trace_records` returns the
records; :func:`reset_timing` clears them and the report.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from .logging import logdebug

_ENABLED = True
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_RECORDS: list = []  # every Record since start or reset, in start order
_OPEN: list = []  # the open records, innermost last


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


class Record:
    """One recorded span: times in ``time.time_ns`` nanoseconds, ``parent``
    the index in :func:`trace_records` of the enclosing span (None for a
    root), ``reads`` and ``read_ns`` the host reads made directly in it and
    the nanoseconds the host blocked in them, ``replayed`` and ``eager`` the
    factor graph's sweeps and marginals run directly in it as captured CUDA
    graphs and op by op, ``filtered`` and ``gated`` the Kalman filter's
    events run in it and the DVL events its gate skipped, ``kernel`` those
    of ``filtered`` that its CUDA kernel ran."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "reads",
                 "read_ns", "replayed", "eager", "filtered", "gated", "kernel",
                 "index")

    def __init__(self, name, parent, request, index):
        self.name = name
        self.start_ns = self.end_ns = None
        self.parent = parent
        self.request = request
        self.reads = 0
        self.read_ns = 0
        self.replayed = 0
        self.eager = 0
        self.filtered = 0
        self.gated = 0
        self.kernel = 0
        self.index = index

    def __repr__(self):
        return (f"Record({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, request={self.request}, "
                f"reads={self.reads}, read_ns={self.read_ns}, "
                f"replayed={self.replayed}, eager={self.eager}, "
                f"filtered={self.filtered}, gated={self.gated}, "
                f"kernel={self.kernel})")


def _open(name: str, request) -> Record:
    """Append an open record of ``name`` inside the innermost open span,
    whose request it inherits unless ``request`` is given."""
    parent = _OPEN[-1] if _OPEN else None
    if request is None and parent is not None:
        request = parent.request
    rec = Record(name, None if parent is None else parent.index, request,
                 len(_RECORDS))
    _RECORDS.append(rec)
    _OPEN.append(rec)
    return rec


class CodeTimer:
    """``with CodeTimer("name", sync=device_or_tensors): ...`` wall-clock
    span; ``took`` holds its seconds. ``request`` names the request the span
    serves (its children inherit it) in the recorded trace."""

    def __init__(self, name: str = "code block", silent: bool = False, sync=None,
                 request=None):
        self.name = name
        self.silent = silent
        self.sync = sync
        self.request = request
        self.took = 0.0
        self._record = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._record = _open(self.name, self.request)
        self._start = time.time_ns()
        if self._record is not None:
            self._record.start_ns = self._start
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if self.sync is not None:
            synchronize(self.sync)
        end = time.time_ns()
        self.took = (end - self._start) * 1e-9
        _TOTALS[self.name] += self.took
        _COUNTS[self.name] += 1
        rec, self._record = self._record, None
        if rec is not None:
            rec.end_ns = end
            if _OPEN and _OPEN[-1] is rec:
                _OPEN.pop()
        if _ENABLED and not self.silent:
            logdebug(f"{self.name} took {self.took * 1000.0:.2f} ms")
        return False


def host_read(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call in which the host waits for the
    device: a ``bool`` or ``int`` of a device tensor, a copy to the host, a
    ``nonzero``, or a copy of host values to the device (PyTorch waits for
    the device before it copies from pageable host memory). While
    recording, one read and the nanoseconds it blocked are added to the
    innermost open span."""
    if not _OPEN:
        return fn(*args, **kwargs)
    t0 = time.time_ns()
    out = fn(*args, **kwargs)
    rec = _OPEN[-1]
    rec.reads += 1
    rec.read_ns += time.time_ns() - t0
    return out


def count_graph_run(replayed: bool) -> None:
    """While recording, add one Gauss-Newton sweep or marginal to the
    innermost open span: ``replayed`` when it ran as a captured CUDA graph,
    else ``eager``."""
    if _OPEN:
        if replayed:
            _OPEN[-1].replayed += 1
        else:
            _OPEN[-1].eager += 1


def count_filter_events(filtered: int, gated: int, kernel: int = 0) -> None:
    """While recording, add to the innermost open span the Kalman filter's
    events: ``filtered`` run through the filter, ``gated`` DVL events its
    over-speed gate skipped, ``kernel`` the events of ``filtered`` that its
    CUDA kernel ran."""
    if _OPEN:
        _OPEN[-1].filtered += filtered
        _OPEN[-1].gated += gated
        _OPEN[-1].kernel += kernel


def to_device(x, device, dtype=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)``; a value not yet on
    ``device`` (a Python number, a list, a tensor elsewhere) is copied there,
    a :func:`host_read`."""
    if isinstance(x, torch.Tensor) and x.device == device:
        return torch.as_tensor(x, dtype=dtype, device=device)
    return host_read(torch.as_tensor, x, dtype=dtype, device=device)


def trace_records() -> list:
    """The recorded spans since start or reset, in start order."""
    return list(_RECORDS)


def timing_report() -> dict[str, tuple[float, int]]:
    """{span: (total_seconds, calls)} accumulated since start/reset."""
    return {k: (_TOTALS[k], _COUNTS[k]) for k in _TOTALS}


def reset_timing() -> None:
    _TOTALS.clear()
    _COUNTS.clear()
    _RECORDS.clear()
    _OPEN.clear()
