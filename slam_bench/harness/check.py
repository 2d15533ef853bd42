"""What decides ``correct``: the program's outputs held to the plain
reference (``slam_bench/reference``), stage by stage, by the comparison of
the cell's driver (``compare`` in ``slam_bench/drivers/<driver>.py``).

Each stage of the reference runs on what the program's previous stage
handed on, so a rounding difference in one stage is not carried, amplified,
into the next (the production path is ill-conditioned: a 1e-6 m move of
every odometry pose moves keyframe poses by centimetres and flips loops).
The SLAM scan is followed one step at a time from the program's own
carries, and the start (the initial carry) is checked by itself.

Every number has a limit in ``slam_bench/limits/<cell>.json``; a run is
correct when each number is finite and at most its limit. This module
holds the comparisons the drivers share, the precision each side runs in,
and the judgement.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_bench.reference import precision, stages
from slam_bench.reference.slam import core as reference_core

from .common import patched, to_host


def max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def sym_diff(a, b) -> int:
    sa = {tuple(np.atleast_1d(x).tolist()) for x in a}
    sb = {tuple(np.atleast_1d(x).tolist()) for x in b}
    return len(sa ^ sb)


def features(prog_pts, prog_mask, prog_conf, pts, mask, conf) -> dict:
    both = prog_mask & mask
    gap = (float(np.max(np.abs(prog_pts[both] - pts[both])))
           if both.any() else 0.0)
    cgap = (float(np.max(np.abs(prog_conf[both] - conf[both])))
            if both.any() else 0.0)
    return {"feature_mask_diff": int(np.sum(prog_mask != mask)),
            "feature_gap_m": gap, "conf_gap": cgap}


def _fields_differ(carry: dict, ref: dict) -> int:
    """Fields of a carry (nested) that differ from the reference's."""
    n = 0
    for k, v in ref.items():
        if isinstance(v, dict):
            n += _fields_differ(carry[k], v)
        elif not np.array_equal(np.asarray(carry[k]), np.asarray(v)):
            n += 1
    return n


def steps(sampled: dict, init: dict, built, dev) -> dict:
    """SLAM steps followed from the program's carries: ``sampled`` maps a
    step's number to (carry before, frame, carry after) as host arrays.
    ``init_diff``: fields of step 0's carry before that differ from the
    reference's initial carry ``init``; ``step_pose_gap_m``: the widest gap
    of a pose the reference's step gives from the program's;
    ``step_decision_diff``: steps whose keyframe count, loop set or SSM
    slots differ."""
    out = {"init_diff": (_fields_differ(sampled[0][0], init) if 0 in sampled
                         else math.inf)}
    gap, decisions = 0.0, 0
    for key, (before, frame, after) in sorted(sampled.items()):
        got = to_host(stages.step(before, frame, built, dev))
        k = key + 1
        gap = max(gap, max_abs(after["poses"][:k, :2], got["poses"][:k, :2]))
        nl = min(after["num_loops"], after["loops_i"].shape[0])
        same = (after["num_kf"] == got["num_kf"]
                and after["num_loops"] == got["num_loops"]
                and np.array_equal(after["loops_i"][:nl], got["loops_i"][:nl])
                and np.array_equal(after["loops_j"][:nl], got["loops_j"][:nl])
                and np.array_equal(after["ssm_slot"], got["ssm_slot"]))
        decisions += int(not same)
    out["step_pose_gap_m"] = gap
    out["step_decision_diff"] = decisions
    out["steps_checked"] = len(sampled)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]) over the limits' names."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        rows.append((name, v, limit))
        ok = ok and math.isfinite(v) and v <= limit
    return ok, rows


def run_reference(driver, prog: dict, bag, cfg: dict, traffic: dict,
                  dev) -> dict:
    """``driver``'s comparison in float32 (TF32 off)."""
    precision.use("float32")
    return driver.compare(prog, bag, cfg, traffic, dev)


def control_outputs(driver, bag, cfg: dict, traffic: dict, dev,
                    seed: int) -> dict:
    """The control: the reference in the program's place, in the nearest
    precision below the configuration's float32 (TF32)."""
    precision.use("tf32")
    try:
        return driver.control(bag, cfg, traffic, dev, seed)
    finally:
        precision.use("float32")


def _moved(carry):
    """``carry`` with its poses (the carry's and the graph's) moved up by
    one unit in the last place."""
    def up(x):
        return torch.nextafter(x, torch.full_like(x, math.inf))

    graph = carry.graph._replace(poses=up(carry.graph.poses))
    return carry._replace(poses=up(carry.poses), graph=graph)


def _one_ulp_step(fn):
    def step(carry, frame, params, dims):
        return fn(_moved(carry), frame, params, dims)
    return step


def _one_ulp_refine(fn):
    def refine(carry, *args, **kwargs):
        return fn(_moved(carry), *args, **kwargs)
    return refine


def witness_outputs(driver, bag, cfg: dict, traffic: dict, dev,
                    seed: int) -> dict:
    """A sound-rounding witness: the reference in the program's place in
    float32, each SLAM step and the refinement computed from a carry whose
    poses are moved by one ulp (what a sound reordering of the previous
    stage's float32 sums could hand on), and recorded against the carry
    unmoved."""
    precision.use("float32")
    step = _one_ulp_step(reference_core.keyframe_step)
    with patched([(reference_core, "keyframe_step", step),
                  (stages, "keyframe_step", step),
                  (stages, "refine_loops",
                   _one_ulp_refine(stages.refine_loops))]):
        return driver.control(bag, cfg, traffic, dev, seed)
