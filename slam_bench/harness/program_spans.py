"""The program's own spans in the traced stretch.

While a profiler runs, the port's tracer (``sonar_slam_torch.utils.timing``)
keeps a record of each of its spans: name, start and end on
``time.time_ns`` (the clock of the harness's spans and of the profiler's
events), the index of the enclosing span, and the host reads made in it.
This module keeps the records that lie inside the harness's ``trace`` span
and sums them under the spans of one name. A span's self time is its
duration less the part of it that its child spans cover. A program without
the tracer gives no records, and every function here then returns None.
"""

from __future__ import annotations

from collections import defaultdict

from . import stats


def records(ctx) -> dict | None:
    """{index: record} of the program's records inside the traced stretch;
    None where the run was not traced or the program keeps no records."""
    if ctx.trace is None or "trace" not in ctx.trace.spans:
        return None
    try:
        from sonar_slam_torch.utils.timing import trace_records
    except ImportError:
        return None
    w0, w1 = ctx.trace.spans["trace"][0]
    return {i: r for i, r in enumerate(trace_records())
            if r.end_ns is not None and w0 <= r.start_ns and r.end_ns <= w1}


def under(ctx, root: str):
    """(records, the indices of those named ``root``, {index: the ``root``
    record that holds it, itself included}), or None when the stretch has
    no ``root`` record."""
    recs = records(ctx)
    roots = [i for i, r in (recs or {}).items() if r.name == root]
    if not roots:
        return None
    owner = {}
    for i in recs:
        j = i
        while j in recs and recs[j].name != root:
            j = recs[j].parent
        if j in recs:
            owner[i] = j
    return recs, roots, owner


def phase_self_ns(ctx, root: str, phase: str):
    """(summed self time of the ``phase`` records whose parent is a
    ``root`` record, number of ``root`` records), or None. ``phase`` equal
    to ``root`` sums the roots' own self time."""
    got = under(ctx, root)
    if got is None:
        return None
    recs, roots, _ = got
    kids = defaultdict(list)
    for r in recs.values():
        kids[r.parent].append((r.start_ns, r.end_ns))
    picked = (roots if phase == root else
              [i for i, r in recs.items() if r.name == phase
               and r.parent in recs and recs[r.parent].name == root])
    total = sum(recs[i].end_ns - recs[i].start_ns
                - stats.union_length(kids[i]) for i in picked)
    return total, len(roots)


def reads_under(ctx, root: str):
    """(host reads, ns the host blocked in them, summed duration of the
    ``root`` records, number of ``root`` records) over every record that a
    ``root`` record holds, or None."""
    got = under(ctx, root)
    if got is None:
        return None
    recs, roots, owner = got
    held = [recs[i] for i in owner]
    return (sum(r.reads for r in held), sum(r.read_ns for r in held),
            sum(recs[i].end_ns - recs[i].start_ns for i in roots), len(roots))
