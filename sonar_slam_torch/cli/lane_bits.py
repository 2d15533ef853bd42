"""Where the lane-batched scan parts from its lone scans, bit by bit.

Runs ``cli.sweep``'s survey under its lane grid through the lane-batched
scan (``slam/lanes.py``), or with ``--robots R`` the two-robot demo's
basin surveyed by R robots (``cli.two_robot_demo.robot_inputs``: each
robot its own keyframe stream, a lane of ``parallel.multi_robot_scan``'s
batched scan), and, for a few checked lanes, compares on the same inputs:

* each keyframe step: the lone ``slam.core.keyframe_step`` run from the
  checked lane's own batched carry, against that lane of the batched step
  (the carry's fields, exactly);
* each call the batched step makes to a lane-batched function: the lone
  function on the checked lane's slice of the same arguments, against that
  lane of the batched result.

A lane whose every call matches its lone call ends bit for bit with its
lone scan. Prints a log line for each step that parts and, as the last
line, one JSON object: for each function, its calls and, for each checked
lane, the calls that did not match and the largest difference. Steps are
keyframe slots for the sweep; for robots, step j is each robot's j-th
keyframe (a robot whose stream has ended steps no more).

``--production-icp`` runs the sweep with bench.py's production ICP
(point to line, ``cli.error_budget.icp_prod``); ``--max-points``,
``--target-capacity`` and ``--nssm-starts`` replace those SlamDims fields
(``max_points`` 130, or ``target_capacity`` 4096 with 30 starts, put ICP's
sums outside ``lone_sums.lone_sum``'s modeled order).

Usage:
  python -m sonar_slam_torch.cli.lane_bits [--lanes 64] [--check 0,7,63]
      [--duration 90] [--production-icp] [--max-points N]
      [--target-capacity N] [--nssm-starts N] [--cpu]
  python -m sonar_slam_torch.cli.lane_bits --robots 2 --check 0,1 [...]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import device_from_args


def _leaves(x):
    """The tensors of a result (a tensor, or a tuple of them / of None)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _diff(a, b) -> float:
    """0.0 where two tensors are equal bit for bit (NaN equal to NaN), else
    the largest absolute difference (inf for a shape or NaN mismatch)."""
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool or not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float(
            (a.long() - b.long()).abs().max())
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    d = (a - b).abs()[~same]
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")


def lane_carry(carry, i: int):
    """Lane ``i`` of a lane-batched SlamCarry as the lone carry it stands
    for (the host counts back as ints; per-lane frame fields sliced)."""
    from ..graph.factor_graph import GraphState

    if carry.points.ndim == 4:
        carry = carry._replace(**{f: getattr(carry, f)[i] for f in (
            "times", "dr_poses3", "dr_poses", "points", "pmasks", "pconf",
            "dr_basis")})
    return carry._replace(
        poses=carry.poses[i], covs=carry.covs[i],
        graph=GraphState(*(x[i] for x in carry.graph)),
        ssm_slot=carry.ssm_slot[i], q_source=carry.q_source[i],
        q_target=carry.q_target[i], q_tf=carry.q_tf[i], q_cov=carry.q_cov[i],
        q_inserted=carry.q_inserted[i], q_used=carry.q_used[i],
        q_head=int(carry.q_head[i]), loops_i=carry.loops_i[i],
        loops_j=carry.loops_j[i], loops_tf=carry.loops_tf[i],
        loops_slot=carry.loops_slot[i], num_loops=int(carry.num_loops[i]))


def _carry_diffs(lone, batched) -> dict:
    out = {}
    for name, a, b in zip(lone._fields, lone, batched):
        if name == "graph":
            for gname, ga, gb in zip(a._fields, a, b):
                d = _diff(torch.as_tensor(ga), torch.as_tensor(gb))
                if d:
                    out["graph." + gname] = d
        elif a is not None:
            d = _diff(torch.as_tensor(a), torch.as_tensor(b))
            if d:
                out[name] = d
    return out


def _sl(x, i, lane_ndim):
    """Lane i of an argument: sliced when it has its per-lane rank."""
    if isinstance(x, torch.Tensor) and x.ndim == lane_ndim:
        return x[i]
    return x


def _adapters():
    """(module, name, lone call (i, args, kwargs) -> lone result, lane
    slice of the batched result) for each lane-batched function that
    ``slam/lanes.py`` calls."""
    from ..cloud import count_overlap, nn_match, voxel_downsample
    from ..cloud.icp import icp, icp_multistart
    from ..graph import factor_graph as fg
    from ..graph import pcm
    from ..parallel.sweep import lane_params
    from ..slam import core, lanes, scan_matching as sm

    def f(x, i):
        return float(x[i])

    def gi(i, a, k):
        return sm.global_initialize(
            _sl(a[0], i, 3), _sl(a[1], i, 2), a[2][i], a[3][i], a[4][i],
            a[5][i], a[6][i], a[7][i], f(a[8], i), a[9])

    def w(x, i):
        return None if x is None else x[i]

    def ms(i, a, k):  # (src, smask, tgt, tmask, guesses, gmask, cfg, sw, tw)
        return icp_multistart(
            _sl(a[0], i, 3), _sl(a[1], i, 2), a[2][i], a[3][i], a[4][i],
            a[5][i], a[6], w(a[7], i), w(a[8], i))

    def one(i, a, k):  # (src, smask, tgt, tmask, guess, cfg, sw, tw)
        if k.get("lone_rows") != 1:
            return None
        return icp(
            _sl(a[0], i, 3), _sl(a[1], i, 2), _sl(a[2], i, 3), _sl(a[3], i, 2),
            a[4][i], a[5], w(a[6], i), w(a[7], i))

    def owm(i, a, k):
        g = fg.GraphState(*(x[i] for x in a[0]))
        if len(a) > 3 and a[3] is not None and not bool(a[3][i]):
            return None
        st, cov = fg.optimize_with_marginal(g, a[1], a[2])
        return st.poses, st.log_scale, cov

    def owm_lane(res, i):
        st, cov = res
        return st.poses[i], st.log_scale[i], cov[i]

    def asm(i, a, k):  # (state, config, lanes)
        if len(a) < 3 or a[2] is None or i not in a[2]:
            return None
        return fg._assemble_normal_equations(
            fg.GraphState(*(x[i] for x in a[0])), a[1],
            need_b=a[3] if len(a) > 3 else k.get("need_b", True))

    def opt(i, a, k):  # (states, config, active, lane_calls)
        active = a[2] if len(a) > 2 else k.get("active")
        if not k.get("lane_calls") or (active is not None
                                       and not bool(active[i])):
            return None
        return fg.optimize(fg.GraphState(*(x[i] for x in a[0])), a[1])

    def pick(res, i):
        return [t[i] for t in _leaves(res)]

    return [
        (lanes, "global_initialize_lanes", gi, pick),
        (lanes, "icp_multistart_lanes", ms, pick),
        (lanes, "icp_pairs", one, pick),
        (lanes, "estimate_pose_covariance_lanes",
         lambda i, a, k: sm.estimate_pose_covariance(a[0][i], a[1][i]), pick),
        (lanes, "localize_covariance_lanes",
         lambda i, a, k: sm.localize_covariance(a[0][i], a[1][i]), pick),
        (lanes, "apply_covariance_floor",
         lambda i, a, k: sm.apply_covariance_floor(a[0][i], a[1][i]), pick),
        (lanes, "_mean_censi_lanes",
         lambda i, a, k: core._mean_censi(type(a[0])(*(x[i] for x in a[0]))),
         pick),
        (lanes, "conf_weight_lanes",
         lambda i, a, k: core.conf_weight(_sl(a[0], i, 2),
                                          lane_params(a[1], i)), pick),
        (lanes, "count_overlap",
         lambda i, a, k: count_overlap(a[0][i], _sl(a[1], i, 2), a[2][i],
                                       a[3][i], f(a[4], i)), pick),
        (lanes, "nn_match",
         lambda i, a, k: nn_match(a[0][i], a[1][i], a[2][i], _sl(a[3], i, 2),
                                  f(a[4], i)), pick),
        (lanes, "voxel_downsample",
         lambda i, a, k: voxel_downsample(a[0][i], a[1][i], a[2], a[3]), pick),
        (lanes, "pcm_select",
         lambda i, a, k: pcm.pcm_select(*(x[i] for x in a[:5]), **k), pick),
        (lanes, "optimize_with_marginal_lanes", owm, owm_lane),
        (fg, "_assemble_normal_equations", asm, pick),
        (fg, "optimize_batch", opt, pick),
    ]


class _Hooks:
    """Wraps each lane-batched function so that every call is also made
    lone for the checked lanes and compared. ``at`` maps each checked lane
    stepping to its position in the batch (the lanes stepping may be
    fewer than all: robots whose streams have ended)."""

    def __init__(self, check):
        self.check = check
        self.table = {}
        self.step = -1
        self.saved = []
        self.at = {i: i for i in check}

    def install(self):
        for mod, name, lone, pick in _adapters():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn, lone, pick))

    def remove(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _wrap(self, name, fn, lone, pick):
        row = self.table.setdefault(
            name, {"calls": 0, "first_step": None,
                   **{str(i): [0, 0.0] for i in self.check}})

        def wrapped(*a, **k):
            res = fn(*a, **k)
            row["calls"] += 1
            for lane, i in self.at.items():
                ref = lone(i, a, k)
                if ref is None:
                    continue
                got = pick(res, i)
                d = max((_diff(x, y) for x, y in zip(_leaves(ref), got)),
                        default=0.0)
                if len(_leaves(ref)) != len(got):
                    d = float("inf")
                if d:
                    row[str(lane)][0] += 1
                    row[str(lane)][1] = max(row[str(lane)][1], d)
                    if row["first_step"] is None:
                        row["first_step"] = self.step
            return res

        return wrapped


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.lane_bits",
        description="Compare the lane-batched sweep with lone scans, step by "
                    "step and call by call.")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--robots", type=int, default=0,
                    help="compare R robot lanes (the two-robot demo's basin, "
                         "each robot's own stream) instead of the sweep's")
    ap.add_argument("--check", default="0,7,63")
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--production-icp", action="store_true",
                    help="bench.py's production ICP (point to line)")
    ap.add_argument("--max-points", type=int,
                    help="SlamDims.max_points (points a keyframe)")
    ap.add_argument("--target-capacity", type=int,
                    help="SlamDims.target_capacity (points a target)")
    ap.add_argument("--nssm-starts", type=int,
                    help="SlamDims.nssm_cov_samples (loop-search ICP starts)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def _inputs(args, device, over):
    """(SlamDims, stacked params, the scan's KeyframeInput, lanes): the
    sweep's shared stream under its grid, or R robots' streams under the
    demo's params."""
    from ..parallel import stack_params
    from .sweep import sweep_inputs

    if args.robots:
        from .two_robot_demo import robot_inputs

        _, dims, params, _, frames = robot_inputs(device, args.duration,
                                                  args.robots, **over)
        return dims, stack_params([params] * args.robots), frames, args.robots
    _, dims, _, stacked, frames, _ = sweep_inputs(device, args.lanes,
                                                  args.duration, **over)
    return dims, stacked, frames, args.lanes


def _lone_frame(frame, pos: int):
    """The frame of the lane at position ``pos`` among the lanes stepping
    (the step's frame where the lanes share it)."""
    if frame.points.ndim == 2:
        return frame
    return frame._replace(**{f: None if getattr(frame, f) is None
                             else getattr(frame, f)[pos]
                             for f in ("time", "dr_pose3", "points", "pmask",
                                       "conf")})


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "lane_bits")
    check = [int(x) for x in args.check.split(",")]

    from ..parallel.sweep import lane_params
    from ..precision import pin_fp32
    from ..slam import core, lanes
    from .error_budget import icp_prod

    pin_fp32()
    over = {k: v for k, v in (("max_points", args.max_points),
                              ("target_capacity", args.target_capacity),
                              ("nssm_cov_samples", args.nssm_starts))
            if v is not None}
    if args.production_icp:
        over["icp"] = icp_prod()
    dims, stacked, frames, B = _inputs(args, device, over)
    hooks = _Hooks(check)
    carry = lanes.slam_init_lanes(dims, B, device,
                                  per_lane_frames=frames.points.ndim == 4)
    steps = {}
    hooks.install()
    try:
        for j, (active, at, frame) in enumerate(lanes.scan_steps(frames, B)):
            hooks.step = j if args.robots else at[0]
            hooks.at = {b: active.index(b) for b in check if b in active}
            lone = {b: core.keyframe_step(
                lane_carry(carry, b), _lone_frame(frame, p),
                lane_params(stacked, b), dims)[0]
                for b, p in hooks.at.items()}
            carry, _ = lanes.step_lanes(carry, frame, stacked, dims, active)
            for b in lone:
                d = _carry_diffs(lone[b], lane_carry(carry, b))
                if d:
                    steps.setdefault(str(b), {})[hooks.step] = d
                    print(f"step {hooks.step} lane {b}: " + ", ".join(
                        f"{n} {v:.3g}" for n, v in d.items()), file=sys.stderr)
    finally:
        hooks.remove()
    out = {"lanes": B, "robots": args.robots, "check": check,
           "dims": {k: (v._asdict() if k == "icp" else v)
                    for k, v in over.items()},
           "steps_parted": steps, "calls": hooks.table}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
