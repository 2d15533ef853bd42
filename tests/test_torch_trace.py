"""The port's tracer: spans and host reads recorded while a profiler runs.

* With no profiler active a replay records nothing; recording leaves the
  carry bit for bit as it is (bench.py's small survey at 60 s, refinement
  on).
* The recorded tree: a ``keyframe_step`` span per valid keyframe carrying
  its index, the six phases inside the steps that reach them, children
  inside their parent and never overlapping, self times adding up to the
  step; the replay's stages and refinement's phases.
* Host reads land in the innermost open span; spans share the profiler's
  clock; ``pipeline.replay``'s ``stage_s`` keeps its keys.
* The Kalman front end's three spans, children of ``dr_gate``, and its
  counter of the events filtered and gated; with and without a profiler its
  odometry is the frozen pre-span filter's (``kalman_frozen.py``) bit for
  bit.
* The benchmark's readers of these records on a synthetic record list.
"""

import dataclasses
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
import kalman_frozen
from sonar_slam_torch import pipeline
from sonar_slam_torch.cloud import ICPConfig, icp
from sonar_slam_torch.graph import (GraphConfig, add_between, add_prior,
                                    graph_init)
from sonar_slam_torch.graph.factor_graph import (optimize, set_pose_estimate,
                                                 sigmas_to_sqrt_info)
from sonar_slam_torch.io.simulate import simulate_bag
from sonar_slam_torch.pipeline import replay
from sonar_slam_torch.utils import (CodeTimer, host_read, reset_timing, timing,
                                    trace_records)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_PHASES = ("ssm.sampling", "ssm.icp", "graph", "nssm.sampling",
               "nssm.icp", "pcm")
REFINE_PHASES = ("refine.remeasure", "refine.chain", "refine.sweep",
                 "refine.prune", "refine.optimize")


def _carry_leaves(carry):
    out = []
    for x in carry:
        if isinstance(x, tuple):
            out.extend(_carry_leaves(x))
        else:
            out.append(x)
    return out


@pytest.fixture(scope="module")
def replays():
    """A small replay with refinement, with no profiler and under one:
    (result off, records off, result on, records on)."""
    sim, dims, params_on, fcfg = chip_smoke.small_config(seed=0)
    sim = dataclasses.replace(sim, duration=60.0)
    dims = dataclasses.replace(dims, refine_iters=1, refine_sweep=True,
                               refine_chain=True)
    bag = simulate_bag(sim)
    reset_timing()
    off = replay(bag, fcfg, params_on("cpu"), dims, "cpu")
    rec_off = trace_records()
    with profile(activities=[ProfilerActivity.CPU]):
        on = replay(bag, fcfg, params_on("cpu"), dims, "cpu")
    rec_on = trace_records()
    reset_timing()
    return off, rec_off, on, rec_on


def test_no_profiler_records_nothing(replays):
    off, rec_off, _, _ = replays
    assert off.num_keyframes >= 10
    assert rec_off == []


def test_recording_leaves_the_carry_bit_for_bit(replays):
    off, _, on, _ = replays
    a, b = _carry_leaves(off.carry), _carry_leaves(on.carry)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y
    assert np.array_equal(off.trajectory, on.trajectory)


def test_one_step_span_per_keyframe_with_its_index(replays):
    _, _, on, recs = replays
    steps = [r for r in recs if r.name == "keyframe_step"]
    assert [r.request for r in steps] == list(range(on.num_keyframes))
    assert all(recs[r.parent].name == "slam_scan" for r in steps)
    for i, r in enumerate(recs):
        if r.parent is not None and recs[r.parent].name == "keyframe_step":
            assert r.name in STEP_PHASES
            assert r.request == recs[r.parent].request


def test_phases_where_they_should_be(replays):
    _, _, _, recs = replays
    kids = {}
    for i, r in enumerate(recs):
        if r.name == "keyframe_step":
            kids[i] = [c.name for c in recs if c.parent == i]
    orders = list(kids.values())
    # every step matches, registers and updates the graph; a step that
    # searches for a loop samples and registers it, and one that found it
    # runs PCM, then a second update when PCM inserted a loop
    nssm = ["nssm.sampling", "nssm.icp"]
    for o in orders:
        assert o[:3] == ["ssm.sampling", "ssm.icp", "graph"]
        assert o[3:] in ([], nssm, nssm + ["pcm"], nssm + ["pcm", "graph"])
    assert orders[0] == ["ssm.sampling", "ssm.icp", "graph"]
    assert any(o[3:] == nssm + ["pcm", "graph"] for o in orders)


def test_children_nest_and_self_times_add_up(replays):
    _, _, _, recs = replays
    for i, r in enumerate(recs):
        assert r.start_ns <= r.end_ns
        kids = sorted((c for c in recs if c.parent == i),
                      key=lambda c: c.start_ns)
        for c in kids:
            assert r.start_ns <= c.start_ns and c.end_ns <= r.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        if r.name == "keyframe_step":
            own = (r.end_ns - r.start_ns) - sum(c.end_ns - c.start_ns
                                                for c in kids)
            assert own >= 0
            assert own + sum(c.end_ns - c.start_ns for c in kids) == (
                r.end_ns - r.start_ns)


def test_stage_and_refine_spans(replays):
    off, _, on, recs = replays
    roots = [r.name for r in recs if r.parent is None]
    assert roots == ["dr_gate", "features", "slam_scan", "refine"]
    index = next(i for i, r in enumerate(recs) if r.name == "refine")
    assert {r.name for r in recs if r.parent == index} == set(REFINE_PHASES)
    assert set(off.stage_s) == set(on.stage_s) == {
        "dr_gate", "features", "slam_scan", "refine"}
    assert all(v > 0 for v in on.stage_s.values())
    # the GN early exits and the ICP early stops are counted where they run
    reads = {}
    for r in recs:
        reads[r.name] = reads.get(r.name, 0) + r.reads
    assert reads["refine.optimize"] > 0 and reads["ssm.icp"] > 0
    assert reads["graph"] > 0 and reads["nssm.icp"] > 0 and reads["pcm"] > 0
    assert reads["slam_scan"] == 0


def test_reads_of_icp_and_gn_land_in_their_span():
    rng = np.random.default_rng(3)
    tgt = torch.as_tensor(rng.uniform(0, 10, (64, 2)).astype(np.float32))
    src = tgt + 0.05
    mask = torch.ones(64, dtype=torch.bool)
    cfg = GraphConfig(max_poses=4, max_factors=8)
    g = graph_init(cfg, "cpu")
    g = add_prior(g, torch.zeros(3), sigmas_to_sqrt_info(torch.ones(3) * 0.1))
    g = add_between(g, 0, 1, torch.tensor([1.0, 0.0, 0.0]),
                    sigmas_to_sqrt_info(torch.ones(3) * 0.1))
    g = set_pose_estimate(g, 1, torch.tensor([0.8, 0.1, 0.0]))
    reset_timing()
    assert host_read(bool, torch.tensor(True)) is True  # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        with CodeTimer("outer", silent=True):
            with CodeTimer("icp_call", silent=True):
                res = icp(src, mask, tgt, mask, torch.zeros(3),
                          ICPConfig(max_iterations=6))
            with CodeTimer("gn_call", silent=True):
                optimize(g, cfg)
        host_read(int, torch.tensor(3))  # outside every span: not counted
    recs = {r.name: r for r in trace_records()}
    reset_timing()
    assert recs["outer"].reads == 0
    iters = int(res.iterations)
    assert 1 <= recs["icp_call"].reads <= 6
    assert recs["icp_call"].reads in (iters, iters + 1)
    # one early-exit read per sweep, each sweep counted as run op by op
    assert 1 <= recs["gn_call"].reads <= cfg.gn_iters
    assert recs["gn_call"].eager == recs["gn_call"].reads
    assert recs["gn_call"].replayed == 0
    assert recs["icp_call"].parent == recs["gn_call"].parent
    assert all(r.read_ns >= 0 for r in recs.values())


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_optimize_with_marginal_reads_only_its_early_exits(estimate_scale):
    """One update as the step runs it: a read of each sweep's early exit
    and nothing else (no host value is copied in); each sweep and the
    marginal counted, op by op on the CPU."""
    from sonar_slam_torch.graph import optimize_with_marginal

    cfg = GraphConfig(max_poses=6, max_factors=8, gn_iters=5,
                      convergence_tol=1e-9, estimate_scale=estimate_scale,
                      scale_prior_sigma=(0.05, 0.01))
    g = graph_init(cfg, "cpu")
    g = add_prior(g, torch.zeros(3), sigmas_to_sqrt_info(torch.ones(3) * 0.1))
    for k in range(1, 4):
        g = add_between(g, k - 1, k, torch.tensor([1.0, 0.0, 0.1]),
                        sigmas_to_sqrt_info(torch.ones(3) * 0.1),
                        scaled=estimate_scale)
        g = set_pose_estimate(g, k, torch.tensor([0.9 * k, 0.1, 0.0]))
    reset_timing()
    with profile(activities=[ProfilerActivity.CPU]):
        with CodeTimer("update", silent=True):
            _, cov = optimize_with_marginal(g, 3, cfg)
    rec = next(r for r in trace_records() if r.name == "update")
    reset_timing()
    assert cov.shape == (3, 3)
    assert 1 <= rec.reads <= cfg.gn_iters
    assert rec.eager == rec.reads + 1  # the sweeps and the marginal
    assert rec.replayed == 0


def test_spans_share_the_profilers_clock():
    reset_timing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with CodeTimer("clock", silent=True):
            with record_function("beside"):
                torch.ones(4).sum()
    rec = next(r for r in trace_records() if r.name == "clock")
    reset_timing()
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "beside")
    assert abs(ev.start_ns() - rec.start_ns) < 5_000_000


def test_code_timer_keeps_its_report_and_took_without_records():
    reset_timing()
    with CodeTimer("plain", silent=True) as span:
        sum(range(1000))
    assert span.took > 0
    assert timing.timing_report()["plain"][1] == 1
    assert trace_records() == []


# ---- the Kalman front end ----


@pytest.fixture(scope="module")
def kalman_replay():
    """A Kalman replay of a 40 s survey with a 200 Hz IMU under a profiler:
    (bag, result, records)."""
    sim, dims, params_on, fcfg = chip_smoke.small_config(seed=0)
    bag = simulate_bag(dataclasses.replace(sim, duration=40.0, imu_rate=200.0))
    reset_timing()
    with profile(activities=[ProfilerActivity.CPU]):
        res = replay(bag, fcfg, params_on("cpu"), dims, "cpu",
                     frontend="kalman")
    recs = trace_records()
    reset_timing()
    return bag, res, recs


def test_kalman_spans_are_children_of_dr_gate(kalman_replay):
    _, _, recs = kalman_replay
    gate = [i for i, r in enumerate(recs) if r.name == "dr_gate"]
    assert len(gate) == 1
    kids = [r for r in recs if r.parent == gate[0]]
    assert [r.name for r in kids] == ["kalman.prepare", "kalman.filter",
                                      "kalman.integrate"]
    assert not any(r.name.startswith("kalman.") for r in recs
                   if r.parent != gate[0])
    outer = recs[gate[0]]
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert all(outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns
               for r in kids)
    # the loop never waits for the device: the IMU and DVL indices and the
    # gate's read before it, the forward fill's two indices after it
    assert [r.reads for r in kids] == [3, 0, 2]


def test_kalman_counter_counts_events_filtered_and_gated(kalman_replay):
    bag, _, recs = kalman_replay
    over = int(np.sum(np.any(np.abs(bag.dvl_vel) > 0.5, axis=-1)))
    events = len(bag.imu_time) + len(bag.dvl_time) + len(bag.depth_time)
    assert over > 0  # kalman.yaml's 0.5 m/s gate skips some of this survey
    (filt,) = [r for r in recs if r.name == "kalman.filter"]
    assert (filt.filtered, filt.gated) == (events - over, over)
    assert all(r.filtered == r.gated == 0 for r in recs if r is not filt)


def test_kalman_odometry_keeps_its_bits(kalman_replay):
    """Without a profiler nothing is recorded; with or without one the
    odometry is the frozen pre-span filter's, bit for bit."""
    bag, res, _ = kalman_replay
    reset_timing()
    times, poses, basis = pipeline.odometry(bag, "cpu", "kalman")
    assert trace_records() == [] and basis is None
    with mock.patch.object(pipeline, "kalman_scan", kalman_frozen.kalman_scan):
        old_times, old, _ = pipeline.odometry(bag, "cpu", "kalman")
    assert np.array_equal(times, old_times)
    assert torch.equal(poses, old)
    assert np.array_equal(res.dr_poses_at_ticks, old.numpy())


# ---- the benchmark's readers of the records ----


def _rec(name, start, end, parent, reads=0, read_ns=0, runs=(0, 0)):
    r = timing.Record(name, parent, None, 0)
    r.start_ns, r.end_ns, r.reads, r.read_ns = start, end, reads, read_ns
    r.replayed, r.eager = runs
    return r


def _synthetic_records():
    """Two steps (the second inside a scan) and a refinement inside the
    window (0, 100000), a step outside it."""
    R = []

    def add(name, start, end, parent=None, reads=0, read_ns=0, runs=(0, 0)):
        R.append(_rec(name, start, end, parent, reads, read_ns, runs))
        return len(R) - 1

    a = add("keyframe_step", 2000, 12000)
    add("ssm.sampling", 2500, 4000, a)
    add("ssm.icp", 4000, 7000, a, 3, 600)
    add("graph", 7000, 9000, a, 2, 400, (3, 1))
    add("nssm.sampling", 9000, 10000, a)
    add("nssm.icp", 10000, 11000, a, 1, 100)
    add("pcm", 11000, 11500, a, 1, 100)
    scan = add("slam_scan", 19000, 27000)
    b = add("keyframe_step", 20000, 26000, scan, reads=1, read_ns=50)
    add("ssm.sampling", 20500, 22000, b)
    add("ssm.icp", 22000, 24000, b, 2, 250)
    add("graph", 24000, 25500, b, 1, 100, (2, 0))
    f = add("refine", 30000, 60000)
    add("refine.remeasure", 31000, 35000, f, 4, 10)
    add("refine.optimize", 35000, 40000, f, 3, 10, (3, 0))
    add("refine.chain", 40000, 45000, f, 2, 10)
    add("refine.optimize", 45000, 47000, f, 1, 10)
    add("refine.sweep", 47000, 50000, f, 1, 10)
    add("refine.prune", 50000, 52000, f, 1, 10)
    add("refine.optimize", 52000, 55000, f, 1, 10, (1, 1))
    c = add("keyframe_step", 200000, 210000)
    add("ssm.icp", 200500, 209000, c, 50, 5000)
    add("graph", 209000, 209500, c, 1, 10, (0, 9))
    return R


def _reader(name):
    sys.path.insert(0, os.path.join(ROOT, "slam_bench"))
    import run as bench_run

    return bench_run.reader(name)


def test_metric_readers_on_synthetic_records(monkeypatch):
    recs = _synthetic_records()
    monkeypatch.setattr(timing, "trace_records", lambda: list(recs))
    tr = types.SimpleNamespace(spans={"trace": [(0, 100000)]})
    ctx = types.SimpleNamespace(trace=tr)
    phases = {p: _reader("phase_ms." + p)(ctx) for p in (
        "ssm_sampling", "ssm_icp", "graph", "nssm_sampling", "nssm_icp",
        "pcm", "step_other")}
    assert phases["ssm_sampling"] == pytest.approx(1.5e-3)
    assert phases["ssm_icp"] == pytest.approx(2.5e-3)
    assert phases["pcm"] == pytest.approx(0.25e-3)
    # the seven add up to the mean step: (10000 + 6000) / 2 ns
    assert sum(phases.values()) == pytest.approx(8e-3)
    assert _reader("host_reads_per_kf.online")(ctx) == pytest.approx(5.5)
    assert _reader("host_wait_share.online")(ctx) == pytest.approx(
        1600 / 16000)
    refine = {p: _reader("refine_phase_s." + p)(ctx) for p in (
        "remeasure", "chain", "sweep", "prune", "optimize")}
    assert refine == pytest.approx({"remeasure": 4e-6, "chain": 5e-6,
                                    "sweep": 3e-6, "prune": 2e-6,
                                    "optimize": 10e-6})
    assert _reader("host_reads.refine")(ctx) == 13
    # the two steps in the window: 3 + 2 replayed, 1 run op by op
    assert _reader("gn_replay_share.online")(ctx) == pytest.approx(5 / 6)
    # the scan's step 2 and the refinement's 3 + 1 replayed, 1 op by op
    assert _reader("gn_replay_share.replay")(ctx) == pytest.approx(6 / 7)


@pytest.mark.parametrize("name", [
    "phase_ms.ssm_icp", "phase_ms.step_other", "host_reads_per_kf.online",
    "host_wait_share.online", "refine_phase_s.chain", "host_reads.refine",
    "gn_replay_share.online", "gn_replay_share.replay", "kalman_s.prepare",
    "kalman_s.filter", "kalman_s.integrate", "kalman_launches_per_event",
    "kalman_pass_share"])
def test_metric_readers_find_nothing_to_read(monkeypatch, name):
    """No traced run, no records, or a program without the tracer: None."""
    read = _reader(name)
    assert read(types.SimpleNamespace(trace=None)) is None
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(spans={"trace": [(0, 100000)]}))
    monkeypatch.setattr(timing, "trace_records", lambda: [])
    assert read(ctx) is None
    monkeypatch.delattr(timing, "trace_records")
    assert read(ctx) is None


@pytest.mark.parametrize("name", ["gn_replay_share.online",
                                  "gn_replay_share.replay"])
def test_replay_share_silent_without_the_counter(monkeypatch, name):
    """Records of a tracer that counts no sweeps (no ``replayed`` or
    ``eager``), or spans that ran none: None."""

    class Bare:
        def __init__(self, rec):
            for k in ("name", "start_ns", "end_ns", "parent", "request",
                      "reads", "read_ns"):
                setattr(self, k, getattr(rec, k))

    recs = _synthetic_records()
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(spans={"trace": [(0, 100000)]}))
    monkeypatch.setattr(timing, "trace_records",
                        lambda: [Bare(r) for r in recs])
    assert _reader(name)(ctx) is None
    for r in recs:
        r.replayed = r.eager = 0
    monkeypatch.setattr(timing, "trace_records", lambda: list(recs))
    assert _reader(name)(ctx) is None


def _kalman_records():
    """A replay's ``dr_gate`` with the filter's three spans (800 events
    filtered, 20 gated), then a ``features`` span, inside (0, 100000)."""
    R = [_rec("dr_gate", 1000, 50000, None)]
    R.append(_rec("kalman.prepare", 2000, 3000, 0, reads=3))
    R.append(_rec("kalman.filter", 3000, 43000, 0))
    R.append(_rec("kalman.integrate", 43000, 45000, 0, reads=2))
    R.append(_rec("features", 50000, 60000, None))
    R[2].filtered, R[2].gated = 800, 20
    return R


def _kalman_ctx():
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        spans={"trace": [(0, 100000)]}, launches={"odometry": 16000},
        window_s=1e-4, busy_s=2.5e-5))


def test_kalman_readers_on_synthetic_records(monkeypatch):
    recs = _kalman_records()
    monkeypatch.setattr(timing, "trace_records", lambda: list(recs))
    ctx = _kalman_ctx()
    assert _reader("kalman_s.prepare")(ctx) == pytest.approx(1e-6)
    assert _reader("kalman_s.filter")(ctx) == pytest.approx(40e-6)
    assert _reader("kalman_s.integrate")(ctx) == pytest.approx(2e-6)
    assert _reader("kalman_pass_share")(ctx) == pytest.approx(0.4)
    # launches in the odometry span over the events filtered, not gated
    assert _reader("kalman_launches_per_event")(ctx) == pytest.approx(20.0)
    # the Kalman cell's device idle share is the replay cell's reader's
    assert _reader("device_idle.replay")(ctx) == pytest.approx(0.75)


@pytest.mark.parametrize("name", [
    "kalman_s.prepare", "kalman_s.filter", "kalman_s.integrate",
    "kalman_launches_per_event", "kalman_pass_share"])
def test_kalman_readers_silent_on_a_program_without_them(monkeypatch, name):
    """A ``dr_gate`` without the filter's spans, from a tracer without the
    event counter (the parent of the spans), or one whose filter ran no
    event: None, not 0."""

    class Bare:
        def __init__(self, rec):
            for k in ("name", "start_ns", "end_ns", "parent", "request",
                      "reads", "read_ns", "replayed", "eager"):
                setattr(self, k, getattr(rec, k))

    recs = _kalman_records()
    ctx = _kalman_ctx()
    monkeypatch.setattr(timing, "trace_records",
                        lambda: [Bare(r) for r in (recs[0], recs[4])])
    assert _reader(name)(ctx) is None
    recs[2].filtered = recs[2].gated = 0
    for r in recs[1:4]:
        r.name = "other"
    monkeypatch.setattr(timing, "trace_records", lambda: list(recs))
    assert _reader(name)(ctx) is None
