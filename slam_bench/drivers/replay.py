"""Whole offline replays back to back: ``pipeline.replay``, then
``pipeline.occupancy_map``, one survey a pass.

The traffic file gives ``warmup_survey_s`` (the survey's first seconds the
warm-up replays) and ``check_steps`` (how many SLAM steps, drawn from the
seed, the check follows). Every pass records its SLAM steps by wrapping
``slam.core.keyframe_step``, which ``slam_scan`` calls by its module name.

``compare`` holds the last pass to the reference stage by stage, each stage
on what the program's previous stage handed on: the odometry from the raw
streams; the keyframe gate on the program's odometry; the features of its
keyframes; the first SLAM step and the drawn ones, each from the program's
carry before it; the refinement of the program's scanned carry; the map of
its final carry. ``control`` runs the reference in the program's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from slam_bench.harness import check, configs, trace
from slam_bench.harness.common import (
    CfarCalls,
    Steps,
    Window,
    host,
    patched,
    sample_steps,
    spanned,
    sync,
    to_host,
)
from slam_bench.harness.trace import span
from slam_bench.reference import stages


class Driver:
    labels = ("cfar", "features", "odometry", "gate", "slam_scan", "refine",
              "mapping")

    def __init__(self, cfg: dict, traffic: dict, bag, dev: torch.device,
                 seed: int):
        from sonar_slam_torch import pipeline
        from sonar_slam_torch.slam import core

        self.pipeline, self.core = pipeline, core
        self.cfg, self.traffic, self.dev, self.seed = cfg, traffic, dev, seed
        self.bag = configs.with_geometry(bag, configs.port_types())
        self.built = configs.build(cfg, configs.port_types(), dev)
        self.survey_s = float(cfg["sim"]["duration"])
        self.last = None
        self.cfar = None

    def one_pass(self, bag):
        b = self.built
        steps = Steps(self.core.keyframe_step)
        with patched([(self.core, "keyframe_step", steps)]):
            res = self.pipeline.replay(
                bag, b.features, b.params, b.dims, self.dev, dr_config=b.dr,
                frontend=self.cfg["frontend"], refine_params=b.refine_params)
        t0 = time.perf_counter()
        with span("mapping"):
            grid, _ = self.pipeline.occupancy_map(res.carry, bag.geometry,
                                                  b.dims.max_keyframes)
            grid = host(grid)
        return res, grid, steps.steps, time.perf_counter() - t0

    def warmup(self):
        self.one_pass(configs.prefix(self.bag, self.traffic["warmup_survey_s"]))
        sync(self.dev)

    def window(self, seconds: float) -> Window:
        layers = {k: [] for k in ("dr_gate", "features", "slam_scan", "refine",
                                  "mapping")}
        pass_s = []
        t0 = time.perf_counter()
        while True:
            # The previous pass's results are freed before the next pass, so
            # the window's memory peak is one pass's, however many it runs.
            self.last = res = grid = steps = None
            p0 = time.perf_counter()
            res, grid, steps, mapping_s = self.one_pass(self.bag)
            pass_s.append(time.perf_counter() - p0)
            for k in layers:
                if k == "mapping":
                    layers[k].append(mapping_s)
                elif k in res.stage_s:
                    layers[k].append(res.stage_s[k])
            self.last = (res, grid, steps)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return Window(len(pass_s), len(pass_s) * self.survey_s, wall, pass_s,
                      layers, [])

    def traced(self, chrome_trace=None):
        from sonar_slam_torch.slam import frontend

        p = self.pipeline
        self.cfar = CfarCalls(frontend.cfar_detect)
        ext = frontend.FeatureExtractor
        with patched([
                (p, "odometry", spanned("odometry", p.odometry)),
                (p, "select_keyframes", spanned("gate", p.select_keyframes)),
                (ext, "extract_batch_conf",
                 spanned("features", ext.extract_batch_conf)),
                (p, "corroborate", spanned("features", p.corroborate)),
                (frontend, "cfar_detect", self.cfar),
                (p, "slam_scan", spanned("slam_scan", p.slam_scan)),
                (p, "refine_loops", spanned("refine", p.refine_loops))]):
            (res, _, _, _), tr, reduce_s = trace.capture(
                lambda: self.one_pass(self.bag), self.labels, chrome_trace)
        return tr, reduce_s, {"keyframes": res.num_keyframes}

    def outputs(self) -> dict:
        """The last pass's results as host arrays; frees the program's
        state."""
        res, grid, steps = self.last
        self.last = None
        return outputs(res.dr_poses_at_ticks, res.keyframe_ping_idx, steps,
                       res.carry, grid, self.traffic, self.seed)


def outputs(dr_ticks, kf_idx, steps: dict, final, grid, traffic: dict,
            seed: int) -> dict:
    """A pass's outputs as host arrays: the odometry at the ticks, the
    keyframe pings, the sampled SLAM steps, the scanned carry (the last
    step's), the final carry's trajectory, loops, features and poses, and
    the map."""
    nl = min(final.num_loops, final.loops_i.shape[0])
    nk = final.num_kf
    return dict(
        dr_ticks=np.asarray(dr_ticks), kf_idx=np.asarray(kf_idx),
        steps=sample_steps(steps, traffic["check_steps"], seed),
        scanned=to_host(steps[len(steps) - 1][2]) if steps else None,
        points=host(final.points), pmasks=host(final.pmasks),
        pconf=host(final.pconf), trajectory=host(final.poses[:nk]),
        loops=np.stack([host(final.loops_i[:nl]), host(final.loops_j[:nl])],
                       1),
        poses=host(final.poses), num_kf=nk, grid=np.asarray(grid))


def compare(prog: dict, bag, cfg: dict, traffic: dict, dev) -> dict:
    """The replay's outputs against the reference, stage by stage."""
    b = configs.build(cfg, configs.reference_types(), dev)
    bag = configs.with_geometry(bag, configs.reference_types())
    K = b.dims.max_keyframes
    out = {}
    tick_time, dr3, basis = stages.odometry(bag, b.dims, b.dr, dev,
                                            cfg["frontend"])
    out["odom_gap_m"] = check.max_abs(prog["dr_ticks"][:, :3],
                                      stages.host(dr3)[:, :3])

    prog_dr3 = torch.as_tensor(prog["dr_ticks"]).to(dev)
    tick_idx, cand = stages.ping_pairing(bag, tick_time, b.features.skip)
    kf_ref, ping_dr2 = stages.gate(bag, prog_dr3, tick_idx, cand, b.params, dev)
    kf = prog["kf_idx"]
    out["keyframe_diff"] = check.sym_diff(kf, kf_ref)

    nk = len(kf)
    pts, masks, conf = stages.features(bag, kf, ping_dr2, b.features, K, dev)
    out.update(check.features(prog["points"][:nk], prog["pmasks"][:nk],
                              prog["pconf"][:nk], stages.host(pts)[:nk],
                              stages.host(masks)[:nk], stages.host(conf)[:nk]))
    del pts, masks, conf

    kf_basis = stages.keyframe_basis(basis, kf, tick_idx, K, dev)
    init = to_host(stages.init_carry(b.dims, kf_basis, dev))
    out.update(check.steps(prog["steps"], init, b, dev))

    if prog["scanned"] is None:
        return dict(out, pose_gap_m=math.inf, loop_diff=math.inf,
                    map_cell_diff=math.inf)
    carry = stages.carry(prog["scanned"], dev)
    if b.dims.refine_iters > 0:
        carry = stages.refine_loops(carry, b.params, b.refine_params, b.dims,
                                    kf_basis)
    nl = min(carry.num_loops, carry.loops_i.shape[0])
    out["pose_gap_m"] = check.max_abs(
        prog["trajectory"][:, :2], stages.host(carry.poses[:carry.num_kf, :2]))
    out["loop_diff"] = check.sym_diff(
        prog["loops"], np.stack([stages.host(carry.loops_i[:nl]),
                                 stages.host(carry.loops_j[:nl])], 1))
    del carry

    def t(a):
        return torch.as_tensor(a).to(dev)

    grid = stages.occupancy(t(prog["points"]), t(prog["pmasks"]),
                            t(prog["poses"]), prog["num_kf"], bag.geometry, K,
                            dev)
    out["map_cell_diff"] = int(np.sum(stages.host(grid) != prog["grid"]))
    return out


def control(bag, cfg: dict, traffic: dict, dev, seed: int) -> dict:
    """The reference in the program's place (in whatever precision the
    caller set): a whole replay and its map, its outputs keyed as the
    driver's."""
    from slam_bench.reference.slam import core

    b = configs.build(cfg, configs.reference_types(), dev)
    rbag = configs.with_geometry(bag, configs.reference_types())
    steps = Steps(core.keyframe_step)
    with patched([(core, "keyframe_step", steps)]):
        r = stages.replay(rbag, b, dev, cfg["frontend"])
    return outputs(r["dr_ticks"], r["kf_idx"], steps.steps, r["carry"],
                   r["grid"], traffic, seed)
