"""What the drivers (``slam_bench/drivers/<driver>.py``) share: the
window's record, syncs and read-backs, temporary patches, the benchmark's
spans around the program's public calls, the CFAR call's shapes, the
recorder of SLAM steps, and carries as host arrays."""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .trace import span


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class Window(NamedTuple):
    passes: int
    survey_s: float  # simulated survey seconds completed
    wall_s: float  # first pass's start to last pass's end
    pass_s: list  # each pass's wall seconds
    layers: dict  # layer name -> [seconds], per pass or per event
    latency_s: list  # per keyframe, where the driver has a latency


@contextlib.contextmanager
def patched(pairs):
    """Temporarily replace ``(object, attribute, value)`` triples."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in pairs]
    try:
        for o, a, v in pairs:
            setattr(o, a, v)
        yield
    finally:
        for o, a, v in saved:
            setattr(o, a, v)


def spanned(name: str, fn):
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


class CfarCalls:
    """Wraps the front end's ``cfar_detect`` in a ``cfar`` span and keeps
    each call's frame shape for the bytes bound."""

    def __init__(self, fn):
        self.fn = fn
        self.shapes = []

    def __call__(self, imgs, *args, **kwargs):
        self.shapes.append((tuple(imgs.shape),
                            bool(kwargs.get("with_threshold", False))))
        with span("cfar"):
            return self.fn(imgs, *args, **kwargs)


class Steps:
    """Records every SLAM step a pass makes: wraps a ``keyframe_step`` and
    keeps, for the n-th step, (carry before, frame, carry after) as the
    program handed them on (references, no copies: the carries are
    immutable)."""

    def __init__(self, fn):
        self.fn = fn
        self.steps = {}

    def __call__(self, carry, frame, params, dims):
        after, out = self.fn(carry, frame, params, dims)
        if frame.valid:
            self.steps[len(self.steps)] = (carry, frame, after)
        return after, out


def sample_steps(steps: dict, n: int, seed: int) -> dict:
    """The first step and ``n`` further steps drawn from ``seed``, as host
    arrays: key -> (carry before, frame, carry after)."""
    keys = sorted(steps)[1:]
    rng = np.random.default_rng(int(seed) % 2**64)
    pick = (rng.choice(keys, size=min(int(n), len(keys)), replace=False)
            if keys else [])
    sample = sorted({0, *(int(k) for k in pick)} & set(steps))
    return {k: tuple(to_host(x) for x in steps[k]) for k in sample}


def to_host(x):
    """A carry or a frame (nested NamedTuples of tensors and numbers) as
    host arrays."""
    if isinstance(x, torch.Tensor):
        return host(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_host(v) for k, v in zip(x._fields, x)}
    return x
