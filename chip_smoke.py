"""Drive the PyTorch port (sonar_slam_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits non-zero without printing the result line:

1. device: a CUDA card is required (there is no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the CFAR kernel (kernels/csrc/cfar.cu) with nvcc;
3. kernel against plain version: the CUDA kernel and its plain PyTorch
   version on the same simulated full-geometry pings, (128, 512, 256) SOCA
   with edge extension and the intensity gate at 65, plus CA, GOCA and the
   strict edge at a small shape. The masks must agree exactly and the
   threshold maps to 1e-6 relative; times by CUDA events after warm-up;
4. slice: ``pipeline.replay`` at bench.py's full configuration (480 s survey
   at 5 Hz, 2,400 pings of 512 x 256, 128 keyframe slots, refinement off),
   seed 0, with the CFAR launch counter reset just before. Checks a finite
   trajectory, the keyframe and loop counts, ATE within the bands below,
   and at least 3 CFAR launches;
5. reference: the small configuration (bench.py --small, refinement off) on
   the card, twice, stage by stage against the port on the CPU and as a
   whole against the JAX package's results for the same input
   (tests/golden/small_norefine_traj.npz); see ``check_small``.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The full-config slice (seed 0, refinement off). No JAX result of this
# configuration with refinement off is recorded, and the full size is not run
# on a host CPU, so the expected values are the port's own on an H100 80GB
# HBM3 (700 W), the same in each of six runs in three processes: 73
# keyframes, 7 loops, ATE 0.0606 m / 0.146 deg. The bands are two-sided, so
# a fault that moves the trajectory either way fails. For scale, the JAX
# package with refinement on records 3.33 cm / 0.147 deg (BENCH_r05.json).
FULL_KEYFRAMES = 73
FULL_LOOPS = 7
FULL_ATE_M, FULL_ATE_BAND_M = 0.0606, 0.015
FULL_ATE_DEG, FULL_ATE_BAND_DEG = 0.146, 0.1
# small-config checks (see check_small): stage outputs on the card against
# the CPU, and the card's trajectory against a JAX result, within
# SCAN_ATOL_M; the card's ATE within SMALL_ATE_BAND_M of the JAX result's,
# either way
SCAN_ATOL_M = 1e-3
SMALL_ATE_BAND_M = 0.02


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def full_config(seed: int = 0):
    """bench.py's full configuration with refinement off (bench.py
    --no-refine), in the port's types; bench.py's refine_* options do
    nothing with refinement off and have no counterpart here."""
    from sonar_slam_torch.cloud import ICPConfig
    from sonar_slam_torch.io.simulate import SimConfig
    from sonar_slam_torch.slam import FeatureConfig, SlamDims, SlamParams

    icp_prod = ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                         min_diff_trans=1e-2, point_to_line=True,
                         outlier_max_dist=0.5)
    sim = SimConfig(duration=480.0, speed=0.5, sonar_rate=5.0, num_ranges=512,
                    num_bearings=256, loop_radius=18.0, imu_rate=50.0,
                    seed=seed)
    dims = SlamDims(
        max_keyframes=128, max_points=256, target_capacity=1024,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=512, max_loops=128,
        gn_iters=3, icp=icp_prod, nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25, nssm_reinit_after_select=True,
        aggregate_with_dr=True, aggregate_with_dr_basis=True,
        estimate_dvl_scale=True, dvl_scale_prior_sigma=0.05)
    params = _params(dims, kf_translation=3.0, nssm_min_points=50,
                     nssm_every=5, icp_floor=(0.2, 0.2, 0.1))
    return sim, dims, params, FeatureConfig(max_points=dims.max_points,
                                            corroborate=True)


def small_config(seed: int = 0):
    """bench.py --small with refinement off."""
    from sonar_slam_torch.cloud import ICPConfig
    from sonar_slam_torch.io.simulate import SimConfig
    from sonar_slam_torch.slam import FeatureConfig, SlamDims

    icp_prod = ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                         min_diff_trans=1e-2, point_to_line=True,
                         outlier_max_dist=0.5)
    sim = SimConfig(duration=90.0, speed=0.5, sonar_rate=1.0, num_ranges=192,
                    num_bearings=96, loop_radius=10.0, imu_rate=20.0,
                    seed=seed)
    dims = SlamDims(
        max_keyframes=32, max_points=128, target_capacity=512,
        nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128, max_loops=32,
        gn_iters=3, icp=icp_prod, nssm_target_window=2, nssm_pair_refine=True,
        pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
        pair_refine_min_inliers=25)
    params = _params(dims, kf_translation=2.0, nssm_min_points=20,
                     nssm_every=1, icp_floor=(0.3, 0.3, 0.1))
    return sim, dims, params, FeatureConfig(max_points=dims.max_points,
                                            corroborate=False)


def _params(dims, kf_translation, nssm_min_points, nssm_every, icp_floor):
    """bench.py's SlamParams overrides; the device is set by ``on``."""
    import torch
    from sonar_slam_torch.slam import SlamParams

    def build(device):
        return SlamParams.default(dims, device)._replace(
            keyframe_translation=kf_translation, ssm_min_points=20,
            nssm_min_points=nssm_min_points, fuse_odometry=True,
            use_best_start_tf=True, nssm_every=nssm_every,
            odom_sigmas=torch.tensor([0.05, 0.05, 0.01], device=device),
            icp_odom_sigmas=torch.tensor(icp_floor, device=device))

    return build


def check_kernel(imgs):
    """Kernel against plain version; returns the kernel table entry."""
    import torch
    from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_plain
    from sonar_slam_torch.kernels.cfar_factors import (
        threshold_factor_ca, threshold_factor_goca, threshold_factor_soca)

    t, g, gate = 20, 5, 65.0
    tau = threshold_factor_soca(40, 0.1)
    det_k, thr_k = cfar_detect(imgs, t, g, tau, "SOCA", gate, "extend",
                               with_threshold=True)
    det_p, thr_p = cfar_plain(imgs, t, g, tau, "SOCA", gate, "extend")
    torch.cuda.synchronize()
    mismatch = int((det_k != det_p).sum())
    thr_err = float((thr_k - thr_p).abs().max())
    thr_rel = thr_err / max(float(thr_p.abs().max()), 1e-30)
    bitwise = bool(torch.equal(thr_k, thr_p))
    log(f"cfar SOCA extend {tuple(imgs.shape)}: mask mismatches {mismatch} "
        f"of {det_p.numel()}, detections {int(det_p.sum())}, threshold max "
        f"abs err {thr_err} (bitwise equal: {bitwise})")
    if mismatch != 0 or thr_rel > 1e-6:
        raise RuntimeError("CFAR kernel disagrees with its plain version")

    small = imgs[:4, :96, :40].contiguous()
    for mode, tau_m in (("CA", threshold_factor_ca(40, 0.1)),
                        ("GOCA", threshold_factor_goca(40, 0.1)),
                        ("SOCA", tau)):
        for edge in ("strict", "extend"):
            dk, tk = cfar_detect(small, t, g, tau_m, mode, gate, edge,
                                 with_threshold=True)
            dp, tp = cfar_plain(small, t, g, tau_m, mode, gate, edge)
            mm = int((dk != dp).sum())
            err = float((tk - tp).abs().max())
            log(f"cfar {mode} {edge} {tuple(small.shape)}: mismatches {mm}, "
                f"threshold max abs err {err}")
            if mm != 0 or err > 1e-6 * max(float(tp.abs().max()), 1.0):
                raise RuntimeError(f"CFAR {mode}/{edge} kernel disagrees")

    def kern():
        cfar_detect(imgs, t, g, tau, "SOCA", gate, "extend")

    def plain():
        cfar_plain(imgs, t, g, tau, "SOCA", gate, "extend")

    # plain, kernel, kernel, plain on the same card
    p1 = cuda_time_ms(plain)
    k1 = cuda_time_ms(kern)
    k2 = cuda_time_ms(kern)
    p2 = cuda_time_ms(plain)
    log(f"cfar SOCA extend (128, 512, 256) ms: kernel {k1} {k2}, plain {p1} {p2}")
    return {"name": "cfar_sum_kernel (CA/SOCA/GOCA, fused intensity gate)",
            "route": "cuda",
            "source": "sonar_slam_torch/kernels/csrc/cfar.cu",
            "replaces": "sonar_slam_tpu/kernels/cfar_pallas.py:32",
            "launches": 0, "max_abs_err": thr_err,
            "ms": min(k1, k2), "plain_ms": min(p1, p2)}


def check_small(dev):
    """bench.py --small (refinement off) on the card, checked by stage.

    The first loop of this survey (keyframe 8 against keyframe 0) is
    ill-conditioned: all 12 starts of its multi-start ICP end with the same
    25 inliers, spread over 2.3 m, and the first start's solution can move
    by 0.78 m when the inputs move by a few microns. The JAX package itself,
    fed the port's dead-reckoning poses (at most 1.7e-5 m from its own),
    ends up 0.17 m from its own result. The golden file holds both JAX
    results (``trajectory`` and ``trajectory_port_dr``).

    So the card's whole replay must give the JAX keyframes and loop count,
    a trajectory within SCAN_ATOL_M of one of the two JAX results and an ATE
    within SMALL_ATE_BAND_M of the JAX result's, either way. Each stage is
    held tightly to the port's CPU run on the same inputs (the feature
    clouds, and the SLAM scan fed the CPU's feature clouds). A second replay
    on the card, after the allocator's free memory is filled with NaN, must
    repeat the first bit for bit.
    """
    import numpy as np
    import torch
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay
    from sonar_slam_torch.slam import KeyframeInput, slam_scan

    sim, dims, params_on, fcfg = small_config(seed=0)
    bag = simulate_bag(sim)
    ref = np.load(os.path.join(HERE, "tests", "golden", "small_norefine_traj.npz"))
    cpu = replay(bag, fcfg, params_on("cpu"), dims, "cpu")
    gpu = replay(bag, fcfg, params_on(dev), dims, dev)
    torch.full((1 << 28,), float("nan"), device=dev)  # freed, stays cached
    again = replay(bag, fcfg, params_on(dev), dims, dev)
    log(f"small config on the card, second run after a NaN fill: trajectory "
        f"max abs diff {float(np.abs(again.trajectory - gpu.trajectory).max())} m")
    if not np.array_equal(again.trajectory, gpu.trajectory):
        raise RuntimeError("small-config replay on the card does not repeat")
    nk = gpu.num_keyframes
    truth = bag.true_pose_at_ping[ref["keyframe_ping_idx"]]
    if not (np.array_equal(gpu.keyframe_ping_idx, ref["keyframe_ping_idx"])
            and np.array_equal(cpu.keyframe_ping_idx, ref["keyframe_ping_idx"])):
        raise RuntimeError("small config: keyframes differ from the JAX result")

    c, g = cpu.carry, gpu.carry
    mask_mm = int((c.pmasks != g.pmasks.cpu()).sum())
    pts_err = float((c.points - g.points.cpu()).abs().max())
    conf_err = float((c.pconf - g.pconf.cpu()).abs().max())
    log(f"small config features, card vs CPU: mask mismatches {mask_mm}, "
        f"points max abs diff {pts_err} m, conf max abs diff {conf_err}")
    if mask_mm or pts_err > 1e-4 or conf_err > 0:
        raise RuntimeError("feature clouds on the card differ from the CPU's")

    K = dims.max_keyframes
    frames = KeyframeInput(
        time=c.times.to(dev), dr_pose3=c.dr_poses3.to(dev),
        points=c.points.to(dev), pmask=c.pmasks.to(dev),
        valid=torch.arange(K, device=dev) < nk, conf=c.pconf.to(dev))
    scan, _ = slam_scan(frames, params_on(dev), dims)
    scan_err = float((scan.poses[:nk].cpu() - c.poses[:nk]).abs().max())
    log(f"small config SLAM scan on the CPU's clouds, card vs CPU: pose max "
        f"abs diff {scan_err} m, loops {scan.num_loops} vs {c.num_loops}")
    if scan_err > SCAN_ATOL_M or scan.num_loops != c.num_loops:
        raise RuntimeError("SLAM scan on the card differs from the CPU's")

    jax_err = float(np.abs(cpu.trajectory - ref["trajectory"]).max())
    ates = [(ate_rmse(r, truth), ate_heading_deg(r, truth))
            for r in (ref["trajectory"], cpu.trajectory, gpu.trajectory)]
    card_errs = [float(np.abs(gpu.trajectory - ref[k]).max())
                 for k in ("trajectory", "trajectory_port_dr")]
    log(f"small config vs JAX: trajectory max abs diff CPU port {jax_err} m, "
        f"card {card_errs[0]} m (to the JAX result on the port's odometry "
        f"{card_errs[1]} m); first loop (keyframe 8 to 0) CPU "
        f"{c.loops_tf[0].tolist()} card {g.loops_tf[0].tolist()}; loops JAX "
        f"{int(ref['num_loops'])} CPU {c.num_loops} card {g.num_loops}; ATE "
        f"m/deg JAX {ates[0]} CPU {ates[1]} card {ates[2]}")
    if (jax_err > SCAN_ATOL_M or min(card_errs) > SCAN_ATOL_M
            or g.num_loops != int(ref["num_loops"])
            or abs(ates[2][0] - ates[0][0]) > SMALL_ATE_BAND_M):
        raise RuntimeError("small-config replay disagrees with the JAX result")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    if not os.path.isdir(os.path.join(HERE, "sonar_slam_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np

    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.kernels import cfar_cuda
    from sonar_slam_torch.pipeline import ate_heading_deg, ate_rmse, replay

    # 1) device
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2) build
    t0 = time.perf_counter()
    lib = cfar_cuda.build()
    log(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s")

    # 3) kernel against plain version, on simulated full-geometry pings
    sim, dims, params_on, fcfg = full_config(seed=0)
    t0 = time.perf_counter()
    bag = simulate_bag(sim)
    log(f"simulated {len(bag.ping_time)} pings {bag.ping_images.shape[1:]} "
        f"in {time.perf_counter() - t0:.1f} s")
    imgs = torch.as_tensor(bag.ping_images[:128], device=dev).contiguous()
    entry = check_kernel(imgs)
    del imgs

    # 4) the slice: full-config replay on the card
    params = params_on(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cfar_cuda.cfar_detect.launches = 0
    t0 = time.perf_counter()
    res = replay(bag, fcfg, params, dims, dev)
    wall = time.perf_counter() - t0
    launches = cfar_cuda.cfar_detect.launches
    peak = torch.cuda.max_memory_allocated(dev)
    truth = bag.true_pose_at_ping[res.keyframe_ping_idx]
    ate = ate_rmse(res.trajectory, truth)
    ate_deg = ate_heading_deg(res.trajectory, truth)
    dr_ate = ate_rmse(res.dr_trajectory, truth)
    log(f"replay: {res.num_keyframes} keyframes, {res.carry.num_loops} loops, "
        f"ATE {ate:.4f} m / {ate_deg:.3f} deg (DR {dr_ate:.4f} m), wall "
        f"{wall:.2f} s, stages s {json.dumps(res.stage_s)}, peak memory "
        f"{peak / 2**20:.1f} MiB, CFAR launches {launches}")
    if not np.isfinite(res.trajectory).all() or res.num_keyframes < 2:
        raise RuntimeError("replay trajectory not finite")
    if launches < 3:
        raise RuntimeError(f"replay made {launches} CFAR launches, expected >= 3")
    if (res.num_keyframes, res.carry.num_loops) != (FULL_KEYFRAMES, FULL_LOOPS):
        raise RuntimeError(f"{res.num_keyframes} keyframes and "
                           f"{res.carry.num_loops} loops, expected "
                           f"{FULL_KEYFRAMES} and {FULL_LOOPS}")
    if not (abs(ate - FULL_ATE_M) <= FULL_ATE_BAND_M
            and abs(ate_deg - FULL_ATE_DEG) <= FULL_ATE_BAND_DEG):
        raise RuntimeError(
            f"ATE {ate} m / {ate_deg} deg outside {FULL_ATE_M} +- "
            f"{FULL_ATE_BAND_M} m / {FULL_ATE_DEG} +- {FULL_ATE_BAND_DEG} deg")
    entry["launches"] = launches
    del bag, res

    # 5) small configuration: the card against the port on the CPU (which
    # the CPU tests hold to the JAX package) and against the JAX result
    check_small(dev)

    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
