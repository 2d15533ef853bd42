"""The tracer's host-read counter against CUDA's own count of the calls that
make the host wait for the device.

Marked ``cuda``: they skip without a card (``python -m pytest --noconftest
-m cuda tests/test_torch_trace_cuda.py`` on one).

* Every ``keyframe_step`` of bench.py's small survey, once with the
  configuration of ``chip_smoke.small_config`` and once with DR-basis
  aggregation, the DVL scale and the SSM covariance samples on (the
  offline cell's path), runs under ``torch.cuda.set_sync_debug_mode("warn")``
  while a profiler records: the synchronizing warnings of each step equal
  the host reads its recorded spans count, so no read site is missed. The
  first update captures the Gauss-Newton sweep and the marginal; the later
  steps replay them, and their reads still equal their syncs.
* The Kalman front end's odometry on a short 200 Hz survey: its
  synchronizing calls equal the host reads its spans count (the
  configuration's and the stream's uploads, the indices, the DVL gate's
  read, the event codes' upload, the read of the kernel's event count that
  ends the filter's span), the kernel ran every event the filter counted,
  and its poses are those of the event loop as it stood before the spans
  (``kalman_frozen.py``, run on the card) within float32 rounding (the
  kernel sums in another order; ``tests/test_torch_kalman_cuda.py``).
* The benchmark's traced stretch (``slam_bench/harness/trace.py``, a
  profiler of CUDA activity alone) turns the tracer's recording on.
"""

import dataclasses
import warnings
from unittest import mock

import pytest
import torch

import chip_smoke
import kalman_frozen
from sonar_slam_torch import pipeline
from sonar_slam_torch.io.simulate import simulate_bag
from sonar_slam_torch.pipeline import replay
from sonar_slam_torch.slam import core
from sonar_slam_torch.utils import timing

VARIANTS = {
    "small": {},
    "basis": dict(aggregate_with_dr=True, aggregate_with_dr_basis=True,
                  estimate_dvl_scale=True, ssm_cov_samples=8),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def step_reads(records, root: int, field: str = "reads") -> int:
    """Host reads (or another count of the records, ``field``) of the span
    ``root`` and of every span inside it."""
    held = {root}
    total = getattr(records[root], field)
    for i in range(root + 1, len(records)):
        if records[i].parent in held:
            held.add(i)
            total += getattr(records[i], field)
    return total


def counted_steps(variant: str, dev):
    """(syncs, host reads, names of the recorded spans, replayed sweeps and
    marginals) of every keyframe step of a replay without refinement."""
    sim, dims, params_on, fcfg = chip_smoke.small_config(seed=0)
    dims = dataclasses.replace(dims, **VARIANTS[variant])
    bag = simulate_bag(sim)
    step = core.keyframe_step
    rows = []

    def checked(carry, frame, params, d):
        first = len(timing.trace_records())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = step(carry, frame, params, d)
        syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
        recs = timing.trace_records()
        rows.append((syncs, step_reads(recs, first),
                     {r.name for r in recs[first:]},
                     step_reads(recs, first, "replayed")))
        return out

    from torch.profiler import ProfilerActivity, profile

    timing.reset_timing()
    core.keyframe_step = checked
    try:
        with profile(activities=[ProfilerActivity.CUDA]), \
                warnings.catch_warnings():
            # the syncs outside the steps are not counted
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                replay(bag, fcfg, params_on(dev), dims, dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        core.keyframe_step = step
        timing.reset_timing()
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_host_reads_equal_cuda_syncs(card, variant):
    rows = counted_steps(variant, card)
    assert len(rows) >= 10
    assert [s for s, _, _, _ in rows] == [r for _, r, _, _ in rows], rows
    # every step after the first replays its update's sweeps and marginal
    assert all(p >= 2 for _, _, _, p in rows[1:]), rows
    names = set().union(*(n for _, _, n, _ in rows))
    assert {"keyframe_step", "ssm.sampling", "ssm.icp", "graph",
            "nssm.sampling", "nssm.icp", "pcm"} <= names


@pytest.mark.cuda
def test_kalman_reads_equal_cuda_syncs_and_keep_the_bits(card):
    sim = chip_smoke.small_config(seed=0)[0]
    bag = simulate_bag(dataclasses.replace(sim, duration=30.0, imu_rate=200.0))
    from torch.profiler import ProfilerActivity, profile

    timing.reset_timing()
    try:
        with profile(activities=[ProfilerActivity.CUDA]), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with timing.CodeTimer("dr_gate", silent=True):
                    _, poses, _ = pipeline.odometry(bag, card, "kalman")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        recs = timing.trace_records()
    finally:
        timing.reset_timing()
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    assert syncs == step_reads(recs, 0) > 0
    assert [r.name for r in recs[1:]] == ["kalman.prepare", "kalman.filter",
                                         "kalman.integrate"]
    # the indices, the gate and the codes; the kernel's count; the
    # integral's indices
    assert [r.reads for r in recs[1:]] == [4, 1, 2]
    assert recs[2].kernel == recs[2].filtered > 0
    with mock.patch.object(pipeline, "kalman_scan", kalman_frozen.kalman_scan):
        _, old, _ = pipeline.odometry(bag, card, "kalman")
    torch.testing.assert_close(poses, old, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_harness_profiler_turns_recording_on(card):
    from slam_bench.harness import trace

    on, _, _ = trace.capture(torch.autograd._profiler_enabled)
    assert on
    assert not torch.autograd._profiler_enabled()
