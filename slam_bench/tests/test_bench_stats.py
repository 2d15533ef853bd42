"""The benchmark's arithmetic on synthetic inputs: the rate over whole
passes, the p95 and its sample count, the device's busy and idle time from
intervals, the CFAR bytes bound, and the trace reduction on synthetic
profiler events."""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slam_bench.harness import stats, trace  # noqa: E402


def test_rate_over_whole_passes():
    # three passes of a 480 s survey in 60 s of wall time
    assert stats.rate(3 * 480.0, 60.0) == pytest.approx(24.0)
    with pytest.raises(ValueError):
        stats.rate(480.0, 0.0)


def test_percentile_and_count_beyond():
    xs = list(range(1, 201))  # 200 samples, 1..200
    assert stats.percentile(xs, 95) == pytest.approx(190.05)
    assert stats.beyond(xs, 95) == 10
    assert stats.median([3, 1, 2]) == 2
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_and_idle():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.idle_gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.idle_share(4.0, 10.0) == pytest.approx(0.6)
    assert stats.idle_gaps([], 0, 1) == [(0, 1)]


def test_cfar_bytes_and_roofline():
    # chip_smoke.py's arithmetic at (128, 512, 256): 67.1 MB read, 16.8 MB
    # of mask written
    b = stats.cfar_bytes((128, 512, 256))
    assert b == 128 * 512 * 256 * 5
    assert round(4 * 128 * 512 * 256 / 1e6, 1) == 67.1
    assert stats.cfar_bytes((1, 2, 3), with_threshold=True) == 6 * 9
    # the bound's own time reads 100%
    t = b / stats.HBM_BYTES_PER_S
    assert stats.roofline_percent(b, t) == pytest.approx(100.0)
    assert stats.roofline_percent(b, 2 * t) == pytest.approx(50.0)


class Event:
    """A kineto event as torch builds without ``activity_type`` give it."""

    def __init__(self, name, dev, start, end, corr=0, annotation=False):
        self._v = (name, dev, start, end, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reduce():
    ms = 1_000_000
    events = [
        Event("cudaLaunchKernel", "CPU", 1 * ms, 1 * ms + 10, corr=1),
        Event("cudaLaunchKernel", "CPU", 5 * ms, 5 * ms + 10, corr=2),
        Event("cudaLaunchKernel", "CPU", 8 * ms, 8 * ms + 10, corr=3),
        Event("sum_kernel", "CUDA", 2 * ms, 3 * ms, corr=1),
        Event("step_kernel", "CUDA", 6 * ms, 7 * ms, corr=2),
        Event("step_kernel", "CUDA", 8 * ms, 8 * ms + ms // 2, corr=3),
        Event("Memcpy HtoD", "CUDA", 9 * ms, 9 * ms + ms // 2, corr=9),
        Event("gpu span", "CUDA", 0, 10 * ms, annotation=True),
        Event("aten::add", "CPU", 4 * ms, 4 * ms + 5),
    ]
    spans = {"trace": [(0, 10 * ms)], "cfar": [(0, 4 * ms)],
             "step": [(4 * ms, 9 * ms)]}
    tr = trace.reduce(events, spans, labels=("cfar", "step"))
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.003)
    assert tr.total_launches == 3 and tr.kernels == 3
    assert tr.launches == {"trace": 3, "cfar": 1, "step": 2}
    assert tr.device_s["cfar"] == pytest.approx(0.001)
    assert tr.device_s["step"] == pytest.approx(0.0015)
    assert tr.device_ops[0] == ("step_kernel", pytest.approx(0.0015))
    gaps = dict(tr.idle_gaps)
    # a gap goes to the span that holds its midpoint
    assert gaps["cfar"] == pytest.approx(0.002)  # 0-2 ms
    assert gaps["step"] == pytest.approx(0.0045)  # 3-6, 7-8, 8.5-9 ms
    assert gaps["host"] == pytest.approx(0.0005)  # 9.5-10 ms


def test_span_records_only_while_traced():
    with trace.span("x"):
        pass
    rec = trace.Recorder()
    trace.Recorder.active = rec
    try:
        with trace.span("x"):
            pass
    finally:
        trace.Recorder.active = None
    assert len(rec.spans["x"]) == 1


def test_metric_readers_on_a_synthetic_run():
    sys.path.insert(0, os.path.join(ROOT, "slam_bench"))
    import run as bench_run

    window = types.SimpleNamespace(
        passes=2, survey_s=960.0, wall_s=48.0, pass_s=[24.0, 24.0],
        layers={"dr_gate": [0.1, 0.3], "tick": [0.001, 0.002, 0.003],
                "node_features": [0.004, 0.005, 0.006]},
        latency_s=[0.1] * 19 + [1.0])
    tr = types.SimpleNamespace(
        busy_s=1.0, window_s=10.0, launches={"slam_scan": 730, "step": 90},
        spans={"step": [(0, 1)] * 3}, device_s={"cfar": 0.001})
    ctx = types.SimpleNamespace(window=window, setup_s=30.0, trace=tr,
                                traced={"keyframes": 73},
                                cfar_calls=[((128, 512, 256), False)],
                                memory_peak_bytes=2_784_048_128)
    assert bench_run.reader("replay_rate")(ctx) == pytest.approx(20.0)
    assert bench_run.reader("replay_rate.replay")(ctx) == pytest.approx(20.0)
    assert bench_run.reader("memory_peak_bytes")(ctx) == 2_784_048_128
    assert bench_run.reader("keyframe_p95_ms")(ctx) == pytest.approx(145.0)
    assert bench_run.reader("stage_s.odometry")(ctx) == pytest.approx(0.2)
    assert bench_run.reader("stage_s.refine")(ctx) is None
    assert bench_run.reader("launches_per_kf.replay")(ctx) == 10
    assert bench_run.reader("device_idle.replay")(ctx) == pytest.approx(0.9)
    assert bench_run.reader("device_idle.online")(ctx) == pytest.approx(0.9)
    assert bench_run.reader("cfar_roofline")(ctx) == pytest.approx(
        100 * 128 * 512 * 256 * 5 / 3.35e12 / 0.001)
    assert bench_run.reader("tick_ms.online")(ctx) == pytest.approx(2.0)
    assert bench_run.reader("features_ms.online")(ctx) == pytest.approx(5.0)
    assert bench_run.reader("launches_per_kf.online")(ctx) == 30
    ctx.trace = None
    ctx.memory_peak_bytes = 0  # a run on the CPU reads no device peak
    assert bench_run.reader("memory_peak_bytes")(ctx) is None
    assert bench_run.reader("launches_per_kf.replay")(ctx) is None
    assert bench_run.reader("device_idle.online")(ctx) is None
