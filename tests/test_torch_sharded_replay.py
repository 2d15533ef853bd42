"""``cli.sharded_replay --cpu --max-keyframes 64 --capacity-check --duration
60`` against ``scripts/sharded_replay.py --devices 2 --max-keyframes 64
--duration 60``, both in subprocesses (about 60 s for the JAX script, which
shards the refinement over a 2-device CPU mesh, and 40 s for the port).

The port runs in one process here (tests/test_torch_mesh.py holds the
sharded refinement to the one-process one); its ``--capacity-check`` holds
the replay at capacity 64 to the same replay at capacity 128. The JAX
package's own gap between the two
capacities (``pipeline.replay`` at K = 64 and K = 128, ``mesh=None``, on this
survey) is 3.0e-6 m, with the same keyframes and loops; the port's is 0 on
one thread and 9.5e-7 m on four (a 40 s survey). The CLI's
``CAPACITY_ATOL_M`` of 1e-4 m, the tolerance of tests/test_torch_slam.py,
is 33 times the JAX gap.

Both give 13 keyframes, 4 loops and an ATE of 4.96 cm: the test requires the
same keyframes and loops, the ATE within 0.05 cm (the printed 0.01 cm), and
the port's check to pass within ``CAPACITY_ATOL_M``.

``PYTHONPATH=. python tests/test_torch_sharded_replay.py cuda`` replays the
60, 75 and 90 s surveys at capacities 128, 256, 1024 and 128 again on the
card and prints each against the first (``cpu`` runs it on the CPU;
``jax`` measures the JAX package's K = 64 / K = 128 gap quoted above). On
an H100 the capacity changes the Gauss-Newton system's summation order: at
60 s K = 1024 lies 1.9e-6 m from K = 128, at 75 s K = 256 lies 5.3e-3 m
away, and at 90 s K = 1024 closes 9 loops where K = 128 closes 8 (each
capacity repeats bit for bit). The survey's loops are ill-conditioned
(ROADMAP queue 3), so chip_smoke.py runs the check on the 60 s survey.
"""

import os
import re
import subprocess
import sys

from sonar_slam_torch.cli.sharded_replay import CAPACITY_ATOL_M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--max-keyframes", "64", "--duration", "60"]


def _line(out):
    m = re.search(r"(\d+) real keyframes, loops (\d+), ATE ([\d.]+) cm", out)
    return int(m.group(1)), int(m.group(2)), float(m.group(3))


def test_cli_sharded_replay_against_the_script():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sharded_replay.py"),
             "--devices", "2"] + FLAGS, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env),
        subprocess.Popen(
            [sys.executable, "-m", "sonar_slam_torch.cli.sharded_replay",
             "--cpu", "--capacity-check"] + FLAGS, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(env, OMP_NUM_THREADS="1")),
    ]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    ref, port = outs[0][0], outs[1][0]
    (nk, loops, ate), (nk_p, loops_p, ate_p) = _line(ref), _line(port)
    assert (nk_p, loops_p) == (nk, loops)
    assert nk >= 10 and loops >= 1
    assert abs(ate_p - ate) <= 0.05
    m = re.search(r"capacity check against K-capacity 128: (\d+) keyframes, "
                  r"loops (\d+),.* max \|dpose\| = ([\d.e+-]+)", port)
    assert (int(m.group(1)), int(m.group(2))) == (nk, loops)
    assert float(m.group(3)) <= CAPACITY_ATOL_M
    assert "capacity check PASSED" in port


def _capacity_probe(device):
    import numpy as np
    import torch

    from sonar_slam_torch.cli import sharded_replay as s
    from sonar_slam_torch.cli.sweep import sim_config
    from sonar_slam_torch.io.simulate import simulate_bag

    dev = torch.device(device)
    if dev.type == "cuda":
        from sonar_slam_torch.kernels import cfar_cuda

        cfar_cuda.build()
    for duration in (60.0, 75.0, 90.0):
        bag = simulate_bag(sim_config(duration))
        first = None
        for K in (128, 256, 1024, 128):
            r = s._run(bag, K, dev)
            first = first or r
            a, b = r.result, first.result
            same = (np.array_equal(a.keyframe_ping_idx, b.keyframe_ping_idx)
                    and a.carry.num_loops == b.carry.num_loops)
            d = (np.abs(a.trajectory - b.trajectory).max() if same
                 else float("inf"))
            print(f"{duration:.0f} s, K {K}: {a.num_keyframes} keyframes, "
                  f"{a.carry.num_loops} loops, ATE {r.ate_m:.5f} m, wall "
                  f"{r.wall_s:.2f} s, peak {r.peak_mib} MiB; against K 128: "
                  f"same keyframes and loops {same}, max |dpose| {d:.3e}",
                  flush=True)


def _jax_capacity_gap():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sonar_slam_tpu.cloud import ICPConfig
    from sonar_slam_tpu.io.simulate import SimConfig, simulate_bag
    from sonar_slam_tpu.pipeline import replay
    from sonar_slam_tpu.slam import FeatureConfig, SlamDims, SlamParams

    jax.config.update("jax_platforms", "cpu")
    bag = simulate_bag(SimConfig(duration=60.0, speed=0.5, sonar_rate=1.0,
                                 num_ranges=192, num_bearings=96,
                                 loop_radius=10.0, imu_rate=20.0))
    out = {}
    for K in (64, 128):
        dims = SlamDims(
            max_keyframes=K, max_points=128, target_capacity=512,
            nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128, max_loops=32,
            gn_iters=3, icp=ICPConfig(max_iterations=12, min_diff_rot=1e-3,
                                      min_diff_trans=1e-2, point_to_line=True,
                                      outlier_max_dist=0.5),
            nssm_target_window=2, nssm_pair_refine=True,
            pair_refine_max_dt=0.35, pair_refine_max_dr=0.07,
            pair_refine_min_inliers=25, refine_iters=2, refine_sweep=True,
            refine_chain=True)
        params = SlamParams.default(dims)._replace(
            keyframe_translation=jnp.float32(2.0),
            ssm_min_points=jnp.asarray(20, jnp.int32),
            nssm_min_points=jnp.asarray(20, jnp.int32),
            fuse_odometry=jnp.asarray(True), use_best_start_tf=jnp.asarray(True),
            odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
            icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.1], jnp.float32))
        out[K] = replay(bag, FeatureConfig(max_points=128), params, dims,
                        mesh=None)
        print(f"JAX K {K}: {out[K].num_keyframes} keyframes, "
              f"{int(out[K].carry.num_loops)} loops", flush=True)
    print("JAX K 64 against K 128: same keyframes",
          np.array_equal(out[64].keyframe_ping_idx, out[128].keyframe_ping_idx),
          "max |dpose|", np.abs(out[64].trajectory - out[128].trajectory).max())


if __name__ == "__main__":
    if sys.argv[1:] == ["jax"]:
        _jax_capacity_gap()
    else:
        _capacity_probe(sys.argv[1] if len(sys.argv) > 1 else "cpu")
