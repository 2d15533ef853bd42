"""The live nodes as a closed loop, one survey a pass: every DR tick
through ``estimators.dead_reckoning_step`` (its pose read back, as the node
publishes it), every ping gated as it arrives by
``slam.core.select_keyframes`` on the newest keyframe and the ping, and
each keyframe, once its second neighbour's tick is in, through
``FeatureExtractor.extract_batch_conf`` on the three pings, ``corroborate``
and one ``slam.core.keyframe_step`` (its pose read back).

The traffic file gives ``warmup_survey_s``, ``check_steps`` (how many SLAM
steps, drawn from the seed, the check follows) and ``trace_keyframes`` (how
many keyframes of a pass the traced stretch covers).

``compare`` holds the last pass to the reference: the DR node at every
tick, the live gate on the program's tick poses, the feature node at every
keyframe on the program's poses, and the first SLAM step and the drawn
ones, each from the program's carry before it. ``control`` runs the
reference's nodes in the program's place.
"""

from __future__ import annotations

import time
import types
from typing import NamedTuple

import numpy as np
import torch

from slam_bench.harness import check, configs, trace
from slam_bench.harness.common import (
    CfarCalls,
    Window,
    host,
    patched,
    sample_steps,
    sync,
    to_host,
)
from slam_bench.harness.trace import span
from slam_bench.reference import io as reference_io
from slam_bench.reference import stages


class Inputs(NamedTuple):
    ticks: tuple  # DR tick columns on the device
    tick_idx: np.ndarray  # (pings,) paired tick
    candidate: np.ndarray  # (pings,) bool
    ping_time: np.ndarray  # (pings,) float32
    images: np.ndarray  # (pings, R, C) float32, host


def inputs(bag, skip: int, dev, io) -> Inputs:
    """A survey as the live nodes see it: the DR ticks (``io`` is the
    port's or the reference's ``io`` package) and each ping's pairing."""
    bundle = io.build_dr_ticks(io.SensorStreams(
        imu_time=bag.imu_time, imu_rpy=bag.imu_rpy, dvl_time=bag.dvl_time,
        dvl_vel=bag.dvl_vel, depth_time=bag.depth_time, depth=bag.depth), dev)
    tick_idx, ok = io.match_pings_to_ticks(bag.ping_time, bundle.tick_time)
    n = len(bag.ping_time)
    return Inputs(tuple(bundle.ticks), tick_idx,
                  ok & (np.arange(n) % skip == 0),
                  np.asarray(bag.ping_time, np.float32), bag.ping_images)


class Nodes:
    """The live nodes on one package (the port's or the reference's
    modules, in ``m``); ``run_pass`` drives one survey."""

    def __init__(self, m, built, geometry, dev):
        self.m, self.b, self.dev = m, built, dev
        self.extractor = m.FeatureExtractor(built.features, geometry, dev)

    def run_pass(self, inp: Inputs, record=None, stop_after=None, times=None):
        """One pass. ``record`` keeps every keyframe step (before, frame,
        after) by its number; ``times`` collects host seconds by layer and
        the keyframe latencies; ``stop_after`` ends the pass after that many
        keyframes. Returns (tick poses (T, 6), keyframe pings, features)."""
        m, b, dev = self.m, self.b, self.dev
        fc = b.features
        T = inp.ticks[0].shape[0]
        n = len(inp.ping_time)
        state = m.dead_reckoning_init(dev)
        carry = m.slam_init(b.dims, dev)
        poses = np.zeros((T, 6), np.float32)
        kf, feats, pending = [], [], []
        last = None
        p_next = 0
        true_ = torch.ones(2, dtype=torch.bool)

        def clock(name, t0):
            if times is not None:
                times[name].append(time.perf_counter() - t0)

        for i in range(T):
            t0 = time.perf_counter()
            with span("tick"):
                state, pose = m.dead_reckoning_step(
                    state, tuple(c[i] for c in inp.ticks), b.dr)
                poses[i] = host(pose)
            clock("tick", t0)
            while p_next < n and inp.tick_idx[p_next] <= i:
                p, p_next = p_next, p_next + 1
                if not inp.candidate[p]:
                    continue
                if last is None:
                    passed = True
                else:
                    with span("gate"):
                        pr = torch.as_tensor(poses[inp.tick_idx[[last, p]]])
                        passed = bool(m.select_keyframes(
                            torch.as_tensor(inp.ping_time[[last, p]]),
                            m.pose3_to_pose2(pr), true_, b.params)[1])
                if passed:
                    last = p
                    pending.append(p)
            while pending and (inp.tick_idx[min(pending[0] + 1, n - 1)] <= i
                               or i == T - 1):
                p = pending.pop(0)
                t_in = time.perf_counter()
                idx = [max(p - 1, 0), p, min(p + 1, n - 1)]
                with span("features"):
                    imgs = torch.as_tensor(inp.images[idx]).to(dev)
                    pts, masks, conf = self.extractor.extract_batch_conf(imgs)
                    dr3 = torch.as_tensor(poses[inp.tick_idx[idx]]).to(dev)
                    dr2 = m.pose3_to_pose2(dr3)
                    mask = masks[1:2]
                    if fc.corroborate:
                        mask = m.corroborate(
                            pts[1:2], masks[1:2], dr2[1:2],
                            [(pts[0:1], masks[0:1], dr2[0:1]),
                             (pts[2:3], masks[2:3], dr2[2:3])],
                            fc.corroborate_rho, fc.corroborate_both)
                    sync(dev)
                clock("node_features", t_in)
                frame = m.KeyframeInput(
                    time=torch.tensor(inp.ping_time[p], device=dev),
                    dr_pose3=dr3[1], points=pts[1], pmask=mask[0], valid=True,
                    conf=conf[1])
                before = carry
                t1 = time.perf_counter()
                with span("step"):
                    carry, _ = m.keyframe_step(carry, frame, b.params, b.dims)
                    host(carry.poses[carry.num_kf - 1])
                clock("step", t1)
                if times is not None:
                    times["latency"].append(time.perf_counter() - t_in)
                kf.append(p)
                feats.append(frame)
                if record is not None:
                    record[len(kf) - 1] = (before, frame, carry)
                if stop_after is not None and len(kf) >= stop_after:
                    return poses, kf, feats
        return poses, kf, feats


def port_modules():
    """The port's public entry points the live nodes call."""
    from sonar_slam_torch import estimators, geometry, slam

    return types.SimpleNamespace(
        dead_reckoning_init=estimators.dead_reckoning_init,
        dead_reckoning_step=estimators.dead_reckoning_step,
        slam_init=slam.slam_init, keyframe_step=slam.keyframe_step,
        select_keyframes=slam.select_keyframes, KeyframeInput=slam.KeyframeInput,
        FeatureExtractor=slam.FeatureExtractor, corroborate=slam.corroborate,
        pose3_to_pose2=geometry.pose3_to_pose2)


class Driver:
    labels = ("cfar", "features", "step", "gate", "tick")

    def __init__(self, cfg: dict, traffic: dict, bag, dev: torch.device,
                 seed: int):
        from sonar_slam_torch import io

        self.cfg, self.traffic, self.dev, self.seed = cfg, traffic, dev, seed
        bag = configs.with_geometry(bag, configs.port_types())
        self.built = configs.build(cfg, configs.port_types(), dev)
        self.nodes = Nodes(port_modules(), self.built, bag.geometry, dev)
        self.inputs = inputs(bag, self.built.features.skip, dev, io)
        self.warm_inputs = inputs(
            configs.prefix(bag, traffic["warmup_survey_s"]),
            self.built.features.skip, dev, io)
        self.survey_s = float(cfg["sim"]["duration"])
        self.last = None
        self.cfar = None

    def warmup(self):
        self.nodes.run_pass(self.warm_inputs)
        sync(self.dev)

    def window(self, seconds: float) -> Window:
        times = {k: [] for k in ("tick", "node_features", "step", "latency")}
        pass_s = []
        t0 = time.perf_counter()
        while True:
            self.last = None
            steps = {}
            p0 = time.perf_counter()
            poses, kf, feats = self.nodes.run_pass(self.inputs, steps,
                                                   times=times)
            pass_s.append(time.perf_counter() - p0)
            self.last = (poses, kf, feats, steps)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        latency = times.pop("latency")
        return Window(len(pass_s), len(pass_s) * self.survey_s, wall, pass_s,
                      times, latency)

    def traced(self, chrome_trace=None):
        from sonar_slam_torch.slam import frontend

        n = int(self.traffic["trace_keyframes"])
        self.cfar = CfarCalls(frontend.cfar_detect)
        with patched([(frontend, "cfar_detect", self.cfar)]):
            (_, kf, _), tr, reduce_s = trace.capture(
                lambda: self.nodes.run_pass(self.inputs, stop_after=n),
                self.labels, chrome_trace)
        return tr, reduce_s, {"keyframes": len(kf)}

    def outputs(self) -> dict:
        out = outputs(*self.last, self.traffic, self.seed)
        self.last = None
        return out


def outputs(poses, kf, feats, steps, traffic: dict, seed: int) -> dict:
    """A pass's outputs as host arrays: the tick poses, the keyframe pings,
    every keyframe's features, and the sampled SLAM steps."""
    return dict(
        tick_poses=poses, kf_pings=np.asarray(kf, np.int64),
        points=np.stack([host(f.points) for f in feats]),
        pmasks=np.stack([host(f.pmask) for f in feats]),
        conf=np.stack([host(f.conf) for f in feats]),
        steps=sample_steps(steps, traffic["check_steps"], seed))


def compare(prog: dict, bag, cfg: dict, traffic: dict, dev) -> dict:
    """The live nodes' outputs against the reference."""
    b = configs.build(cfg, configs.reference_types(), dev)
    bag = configs.with_geometry(bag, configs.reference_types())
    out = {}
    bundle = stages.dr_bundle(bag, dev)
    out["tick_gap_m"] = check.max_abs(
        prog["tick_poses"][:, :3], stages.dr_steps(bundle.ticks, b.dr, dev)[:, :3])
    tick_idx, cand = stages.ping_pairing(bag, bundle.tick_time,
                                         b.features.skip)
    ping_time = np.asarray(bag.ping_time, np.float32)
    kf_ref = stages.live_gate(ping_time, tick_idx, cand, prog["tick_poses"],
                              b.params)
    kf = prog["kf_pings"]
    out["keyframe_diff"] = check.sym_diff(kf, kf_ref)

    ext = stages.FeatureExtractor(b.features, bag.geometry, dev)
    n = len(ping_time)
    ref = [[], [], []]
    for p in kf:
        idx = [max(p - 1, 0), p, min(p + 1, n - 1)]
        for acc, x in zip(ref, stages.keyframe_features(
                ext, bag.ping_images[idx], prog["tick_poses"][tick_idx[idx]],
                b.features, dev)):
            acc.append(x)
    out.update(check.features(prog["points"], prog["pmasks"], prog["conf"],
                              *(np.stack(r) for r in ref)))
    init = to_host(stages.slam_init(b.dims, dev))
    out.update(check.steps(prog["steps"], init, b, dev))
    return out


def control(bag, cfg: dict, traffic: dict, dev, seed: int) -> dict:
    """The reference's nodes in the program's place (in whatever precision
    the caller set), their outputs keyed as the driver's."""
    b = configs.build(cfg, configs.reference_types(), dev)
    rbag = configs.with_geometry(bag, configs.reference_types())
    nodes = Nodes(stages.modules(), b, rbag.geometry, dev)
    inp = inputs(rbag, b.features.skip, dev, reference_io)
    steps = {}
    poses, kf, feats = nodes.run_pass(inp, steps)
    return outputs(poses, kf, feats, steps, traffic, seed)
