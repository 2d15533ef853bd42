"""bench.py's reference-faithful parity lanes on the port.

Counterpart of bench.py's parity block (bench.py:693-790): the reference's
own semantics on the same survey as the production stack.

* CFAR with the strict edge and no temporal corroboration gate
  (``faithful_feature_config``);
* icp.yaml's ICP, the default ``ICPConfig``: point to point, a 3 m outlier
  radius, trim 0.8, up to 40 trips; 30 NSSM covariance starts, whose MCD
  mean is the loop transform; NSSM at every keyframe; no windowed targets,
  pair refinement, re-initialization, DR aggregation, odometry fusion, scale
  calibration or refinement (``faithful_dims``, ``faithful_params``);
* the faithful covariance floor ``icp_odom_sigmas`` [0.2, 0.2, 0.02] (small
  configuration [0.3, 0.3, 0.03]).

``run_parity_lanes`` runs three lanes and returns bench.py's ``parity``
dict with ``odometry_max_dev_m`` added:

* the full faithful lane, twice: ``compile_s`` is the first (cold) run's
  wall time and ``wall_s`` the second's, as bench.py takes them;
* the SSM-only lane (``nssm_enable`` off, bench.py:765-768);
* odometry mode (``ssm_enable`` and ``nssm_enable`` off,
  ``tests/test_parity.py``'s third mode): every factor is the dead-reckoning
  delta, so the graph must reproduce dead reckoning.

The odometry: bench.py takes each lane's keyframes and DR poses from its
production stage 1 (bench.py:442-454), which at the full configuration is
the full-DR lane of the scan that also integrates the two DVL basis lanes
and at the small one plain dead reckoning. ``pipeline.replay`` with the
faithful dims runs plain dead reckoning. The two give the same poses, and
so the same keyframes, bit for bit: on the card at the full survey's 2,400
ticks (``chip_smoke.py`` phase 16 checks it on every run; not at every
length: at the small survey's 450 ticks they part by 1.9e-6 m, where
bench.py runs plain dead reckoning), and on the CPU, which adds each row
in order, at any length. The faithful params carry the production
keyframe gate's thresholds.

It runs on the CUDA card unless ``--cpu`` is given; without a card it exits
with an error rather than run on the CPU. ``main`` returns the lanes for
in-process callers.

Usage: python -m sonar_slam_torch.cli.parity_lane [--small] [--seed N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from . import device_from_args, sync


class ParityRun(NamedTuple):
    """What ``run_parity_lanes`` computed."""

    parity: dict  # bench.py's ``parity`` keys and ``odometry_max_dev_m``
    lanes: dict  # lane name -> pipeline.ReplayResult ("faithful" is the warm run)
    cold: object  # the faithful lane's first (cold) ReplayResult
    launches: dict  # lane name -> CFAR launches by kernel during that lane


LANES = ("faithful", "ssm_only", "odometry")


def faithful_dims(dims):
    """bench.py's ``pdims`` (bench.py:702-708) from the production dims."""
    from ..cloud import ICPConfig
    from ..slam import SlamDims

    return SlamDims(
        max_keyframes=dims.max_keyframes, max_points=dims.max_points,
        target_capacity=dims.target_capacity, nssm_cov_samples=30,
        ssm_sobol=64, nssm_sobol=dims.nssm_sobol, max_loops=dims.max_loops,
        gn_iters=3, icp=ICPConfig())


def faithful_params(dims, full: bool, device):
    """bench.py's ``pparams`` (bench.py:709-720) for the faithful ``dims``:
    slam.yaml's defaults with the production keyframe gate, SSM and NSSM
    point minimums and odometry sigmas, and the faithful covariance floor."""
    from ..slam import SlamParams
    from .error_budget import bench_params, setups

    prod = bench_params(dims, setups(full)[2], full, device)
    return SlamParams.default(dims, device)._replace(
        keyframe_translation=prod.keyframe_translation,
        ssm_min_points=prod.ssm_min_points,
        nssm_min_points=prod.nssm_min_points,
        odom_sigmas=prod.odom_sigmas,
        icp_odom_sigmas=torch.tensor(
            [0.2, 0.2, 0.02] if full else [0.3, 0.3, 0.03],
            dtype=torch.float32, device=device))


def faithful_feature_config(fc):
    """The reference's front end: the strict CFAR edge and no temporal
    corroboration gate (bench.py:733-738)."""
    return fc._replace(cfar_edge="strict", corroborate=False)


def lane_params(params, lane: str):
    """The faithful params of ``lane`` (one of ``LANES``)."""
    if lane == "ssm_only":
        return params._replace(nssm_enable=False)
    if lane == "odometry":
        return params._replace(ssm_enable=False, nssm_enable=False)
    return params


def truth_at_keyframes(res, bag) -> np.ndarray:
    return bag.true_pose_at_ping[res.keyframe_ping_idx][: res.num_keyframes]


def loop_errors(res, bag) -> np.ndarray:
    """Translation error (m) of each accepted loop's measurement against the
    true relative pose (``tests/test_parity.py``'s ``loop_errs``)."""
    from ..geometry import se2_between

    truth = torch.as_tensor(np.asarray(truth_at_keyframes(res, bag), np.float32))
    nl = min(res.carry.num_loops, res.carry.loops_i.shape[0])
    li = res.carry.loops_i[:nl].cpu()
    lj = res.carry.loops_j[:nl].cpu()
    z = res.carry.loops_tf[:nl].cpu()
    return torch.linalg.vector_norm(
        z[:, :2] - se2_between(truth[li], truth[lj])[:, :2], dim=-1).numpy()


def _launch_counts() -> dict:
    from ..kernels.cfar_cuda import cfar_detect

    return dict(cfar_detect.kernel_launches)


def run_parity_lanes(bag, full: bool, device) -> ParityRun:
    """The faithful lanes of bench.py on ``bag`` at the full (``full``) or
    small configuration. ``xrealtime`` is the configuration's survey length
    over ``wall_s``, as bench.py takes it."""
    from ..pipeline import ate_heading_deg, ate_rmse, replay
    from ..slam import FeatureConfig
    from .error_budget import setups

    dev = torch.device(device)
    sim, dims, _ = setups(full)
    pdims = faithful_dims(dims)
    pparams = faithful_params(pdims, full, dev)
    fc = faithful_feature_config(FeatureConfig(max_points=dims.max_points))

    def lane(name):
        before = _launch_counts()
        t0 = time.perf_counter()
        res = replay(bag, fc, lane_params(pparams, name), pdims, dev)
        sync(dev)
        wall = time.perf_counter() - t0
        after = _launch_counts()
        return res, wall, {k: after[k] - before.get(k, 0) for k in after}

    cold, compile_s, cold_launches = lane("faithful")
    lanes, launches = {}, {"faithful_cold": cold_launches}
    walls = {}
    for name in LANES:
        lanes[name], walls[name], launches[name] = lane(name)

    def ate(name):
        res = lanes[name]
        truth = truth_at_keyframes(res, bag)
        return ate_rmse(res.trajectory, truth), ate_heading_deg(res.trajectory, truth)

    p_ate, p_hdg = ate("faithful")
    s_ate, s_hdg = ate("ssm_only")
    odo = lanes["odometry"]
    pwall = walls["faithful"]
    parity = {
        "ate_m": round(p_ate, 4),
        "ate_heading_deg": round(p_hdg, 4),
        "loops": int(lanes["faithful"].carry.num_loops),
        "ssm_only_ate_m": round(s_ate, 4),
        "ssm_only_heading_deg": round(s_hdg, 4),
        "xrealtime": round(sim.duration / pwall, 1),
        "wall_s": round(pwall, 3),
        "compile_s": round(compile_s, 1),
        "odometry_max_dev_m": float(np.abs(
            odo.trajectory[:, :2] - odo.dr_trajectory[:, :2]).max()),
    }
    return ParityRun(parity=parity, lanes=lanes, cold=cold, launches=launches)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sonar_slam_torch.cli.parity_lane",
        description="bench.py's reference-faithful parity lanes (faithful, "
                    "SSM-only, odometry mode) on a CUDA card (or the CPU); "
                    "prints bench.py's parity dict as one JSON line.")
    ap.add_argument("--small", action="store_true",
                    help="bench.py --small's configuration (90 s survey)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the CUDA card)")
    return ap


def main(argv=None) -> ParityRun:
    args = _parser().parse_args(argv)
    device = device_from_args(args.cpu, "parity-lane replay")

    from ..io.simulate import simulate_bag
    from .error_budget import setups

    sim = replace(setups(not args.small)[0], seed=args.seed)
    run = run_parity_lanes(simulate_bag(sim), not args.small, device)
    print(json.dumps(run.parity), flush=True)
    return run


if __name__ == "__main__":
    main()
