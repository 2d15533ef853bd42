"""The factor graph's Gauss-Newton sweeps and marginals in the traced
stretch, as the program counts them on its span records: ``replayed`` (a
captured CUDA graph) or ``eager`` (op by op). A program whose records carry
no such counts gives None."""

from __future__ import annotations

from . import program_spans


def replay_share(ctx, roots) -> float | None:
    """Replayed over all counted runs in every record that a record named
    in ``roots`` holds; None without records, counts or runs."""
    replayed = runs = 0
    for root in roots:
        got = program_spans.under(ctx, root)
        if got is None:
            continue
        recs, _, owner = got
        for i in owner:
            r = recs[i]
            if not hasattr(r, "replayed"):
                return None
            replayed += r.replayed
            runs += r.replayed + r.eager
    return replayed / runs if runs else None
