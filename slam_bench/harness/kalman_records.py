"""The Kalman filter's spans and event counter in the traced stretch.

The port's ``estimators/kalman.py::kalman_scan`` keeps three spans inside
the replay's ``dr_gate`` span: ``kalman.prepare`` (the IMU measurement and
the DVL gate for the whole stream), ``kalman.filter`` (the event loop) and
``kalman.integrate`` (the pose integral and the forward fill). The
``kalman.filter`` record counts the events the filter ran (``filtered``)
and the DVL events its gate skipped (``gated``). A program without these
spans or this counter gives None, as does a stretch in which the filter did
not run.
"""

from __future__ import annotations

from . import program_spans

ROOT = "dr_gate"


def phase_s(ctx, phase: str) -> float | None:
    """Summed self time, in seconds, of the ``phase`` records whose parent
    is a ``dr_gate`` record; None where there is none."""
    got = program_spans.under(ctx, ROOT)
    if got is None:
        return None
    recs = got[0]
    if not any(r.name == phase and r.parent in recs
               and recs[r.parent].name == ROOT for r in recs.values()):
        return None
    return program_spans.phase_self_ns(ctx, ROOT, phase)[0] * 1e-9


def filtered_events(ctx) -> int | None:
    """The events the filter ran, summed over every record that a
    ``dr_gate`` record holds; None without the counter or without events."""
    got = program_spans.under(ctx, ROOT)
    if got is None:
        return None
    recs, _, owner = got
    held = [recs[i] for i in owner]
    if not all(hasattr(r, "filtered") for r in held):
        return None
    n = sum(r.filtered for r in held)
    return n or None
