"""``parallel/sweep.py``, ``parallel/keyframe_shard.py`` and ``cli.sweep``:
the port against the JAX package.

* Sweeps, at ``tests/test_parallel.py``'s dimensions: the JAX package
  ``vmap``s its scan over the lanes (on the 8-device CPU mesh for the
  ``vary`` case); the port runs them as one lane-batched scan
  (``slam/lanes.py``), whose lanes at these dimensions equal each other
  and a lone ``slam_scan`` bit for bit on the CPU too; its plain version
  ``sweep_scan_loop`` loops ``slam_scan`` over the lanes. Each port lane is within 1e-4 m / rad of
  its JAX lane on poses (the tolerance of tests/test_torch_slam.py), with
  the same keyframe and loop counts. tests/test_torch_sweep_lanes.py holds
  the batched scan to the loop on lanes that close loops.
* The keyframe axis: the NSSM gate's mask and counts and the target choice
  equal the JAX package's (on the 8-device mesh) and the port's own gate
  chain; the global transform is bit-equal to the keyframe-batched
  ``se2_transform_points`` of ``slam/core.py``'s NSSM, within one ulp of a
  call per keyframe, and within 1e-5 m of JAX (measured 1.9e-6 m).
* ``cli.sweep --simulate --lanes 4 --duration 45 --cpu`` against
  ``scripts/sweep.py`` with the same flags, both in subprocesses started when
  the module starts (about 100 s for the JAX script, 25 s for the port): the
  same keyframes (10), loops per lane (2 each) and best lane, and the best
  and median ATE within 5e-3 m. Measured: 0.0294 m against the script's
  0.0275 m. The survey's loops are ill-conditioned in the reference
  algorithm: on the same keyframe inputs the JAX package's own lane ends at
  0.0275 m with the 4 lanes vmapped and at 0.0311 m alone under ``jit``
  (0.0266 m on the port's inputs), and the port (0.0294 m on both packages'
  inputs) lies between. At 60 s a 1e-6 m/s change to the DVL moves the JAX
  lane from 2 loops and 0.0385 m to 0 loops and 0.0509 m, the port's two
  outcomes on the two packages' inputs.
  ``PYTHONPATH=.:tests python tests/test_torch_parallel.py`` prints these.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.parallel import make_config_mesh
from sonar_slam_tpu.parallel import keyframe_shard as jks
from sonar_slam_tpu.parallel import sweep as jsweep
from sonar_slam_tpu.slam import KeyframeInput as JKI
from sonar_slam_tpu.slam import SlamDims as JDims
from sonar_slam_tpu.slam import SlamParams as JParams

from sonar_slam_torch.convert import dims_from_reference, params_from_reference
from sonar_slam_torch.geometry import se2_inverse, se2_transform_points
from sonar_slam_torch.parallel import keyframe_shard as tks
from sonar_slam_torch.parallel import stack_params, sweep_scan
from sonar_slam_torch.parallel.sweep import lane_params, sweep_scan_loop, vary
from sonar_slam_torch.slam import KeyframeInput, slam_scan
from sonar_slam_torch.slam.scan_matching import max_eig_2x2

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_FLAGS = ["--simulate", "--lanes", "4", "--duration", "45", "--cpu"]

JDIMS = JDims(
    max_keyframes=8, max_points=32, target_capacity=64,
    nssm_min_st_sep=4, nssm_source_frames=2, ssm_target_frames=2,
    nssm_cov_samples=4, ssm_sobol=16, nssm_sobol=16, max_loops=4,
    gn_iters=2, pcm_queue_slots=3, icp=JICP(max_iterations=6),
)
DIMS = dims_from_reference(JDIMS)


@pytest.fixture(scope="module", autouse=True)
def cli_procs():
    """Both sweep CLIs, started in subprocesses when the module starts, so
    that they run beside the in-process tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "sweep.py")]
            + SWEEP_FLAGS, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env),
        "port": subprocess.Popen(
            [sys.executable, "-m", "sonar_slam_torch.cli.sweep"] + SWEEP_FLAGS,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=dict(env, OMP_NUM_THREADS="1")),
    }
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _frames(n=6, seed=17):
    """tests/test_parallel.py's keyframe stream, from a fresh generator."""
    rng = np.random.default_rng(seed)
    K, N = JDIMS.max_keyframes, JDIMS.max_points
    pts = rng.uniform(0, 15, size=(K, N, 2)).astype(np.float32)
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = np.arange(K) * 1.5
    valid = np.arange(K) < n
    return dict(time=(np.arange(K) * 2.0).astype(np.float32), dr_pose3=dr,
                points=pts, pmask=np.ones((K, N), bool) & valid[:, None],
                valid=valid)


def _jax_frames(f):
    return JKI(**{k: jnp.asarray(v) for k, v in f.items()})


def _port_frames(f):
    return KeyframeInput(**{k: torch.as_tensor(v) for k, v in f.items()})


def _jax_params():
    return JParams.default(JDIMS)._replace(
        keyframe_translation=jnp.float32(1.0),
        ssm_min_points=jnp.asarray(5, jnp.int32),
        nssm_min_points=jnp.asarray(5, jnp.int32),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params):
    return params_from_reference(_np(params), "cpu")


def _assert_bit_equal(a, b):
    """Equal structure, and every leaf equal bit for bit with its dtype (a
    host int against an int64 0-d tensor)."""
    if isinstance(a, tuple):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            _assert_bit_equal(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype and torch.equal(x, y)


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else
                        None if x is None else x[i] for x in tree))


def _against_jax(carry, jcarry):
    """Each port lane within 1e-4 of its JAX lane on poses, with the same
    keyframe and loop counts."""
    np.testing.assert_array_equal(carry.num_kf.numpy(), np.asarray(jcarry.num_kf))
    np.testing.assert_array_equal(carry.num_loops.numpy(),
                                  np.asarray(jcarry.num_loops))
    np.testing.assert_allclose(carry.poses.numpy(), np.asarray(jcarry.poses),
                               atol=1e-4)


def test_sweep_identical_lanes_deterministic():
    f = _frames()
    jp = _jax_params()
    jcarry, _ = jsweep.sweep_scan(_jax_frames(f), jsweep.stack_params([jp] * 3),
                                  JDIMS)
    p = _port(jp)
    frames = _port_frames(f)
    carry, outputs = sweep_scan(frames, stack_params([p, p, p]), DIMS)
    assert carry.poses.shape[0] == 3 and carry.num_kf.shape == (3,)
    c1, o1 = slam_scan(frames, p, DIMS)
    assert c1.num_kf == 6
    for i in range(3):
        _assert_bit_equal(_lane(carry, i), c1)
        _assert_bit_equal(_lane(outputs, i), o1)
    _against_jax(carry, jcarry)


def test_sweep_vary_lanes_against_the_mesh():
    f = _frames()
    jlanes = jsweep.vary(_jax_params(),
                         point_noise=[0.3, 0.4, 0.5, 0.6, 0.3, 0.4, 0.5, 0.6])
    jcarry, _ = jsweep.sweep_scan(_jax_frames(f), jsweep.stack_params(jlanes),
                                  JDIMS, mesh=make_config_mesh(8))
    lanes = vary(_port(_jax_params()),
                 point_noise=[0.3, 0.4, 0.5, 0.6, 0.3, 0.4, 0.5, 0.6])
    for lane, jlane in zip(lanes, jlanes):  # vary casts as the JAX one does
        _assert_bit_equal(lane, _port(jlane))
    stacked = stack_params(lanes)
    for i, lane in enumerate(lanes):
        _assert_bit_equal(lane_params(stacked, i), lane)
    carry, _ = sweep_scan(_port_frames(f), stacked, DIMS)
    assert carry.poses.shape[0] == 8
    # identical configs in different lanes agree bit for bit
    for i in range(4):
        _assert_bit_equal(_lane(carry, i), _lane(carry, i + 4))
    _against_jax(carry, jcarry)


def test_sweep_scan_loop():
    """The plain version: each lane a lone ``slam_scan``, stacked by
    ``stack_lanes``; bit for bit the batched ``sweep_scan``."""
    frames = _port_frames(_frames())
    lanes = vary(_port(_jax_params()), point_noise=[0.3, 0.6],
                 ssm_max_translation=[2.0, 3.0])
    stacked = stack_params(lanes)
    carry, outputs = sweep_scan_loop(frames, stacked, DIMS)
    assert carry.poses.shape[0] == 2 and carry.num_kf.tolist() == [6, 6]
    _assert_bit_equal(_lane(carry, 1), slam_scan(frames, lanes[1], DIMS)[0])
    _assert_bit_equal((carry, outputs), sweep_scan(frames, stacked, DIMS))


def test_vary_validates_lengths():
    p = _port(_jax_params())
    with pytest.raises(ValueError):
        vary(p, point_noise=[0.3], ssm_max_translation=[1.0, 2.0])


@pytest.fixture(scope="module")
def kf_case():
    """tests/test_parallel.py's keyframe-axis case (K 16, N 32, W 3)."""
    K, N, W = 16, 32, 3
    r = np.random.default_rng(3)
    points = r.uniform(0, 20, size=(K, N, 2)).astype(np.float32)
    pmasks = r.random((K, N)) > 0.2
    poses = np.stack([np.linspace(0, 30, K), np.linspace(0, 5, K),
                      np.linspace(0, 1.2, K)], -1).astype(np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32)[None] * np.float32(1e-3),
                   (K, 1, 1))
    return dict(points=points, pmasks=pmasks, poses=poses,
                tgt_ok=np.arange(K) < 10, src_poses=poses[-W:],
                src_covs=covs[-W:], src_ok=np.array([True, True, False]),
                max_range=30.0, half_ap=float(np.radians(65.0)))


_GATE_ARGS = ("points", "pmasks", "poses", "tgt_ok", "src_poses", "src_covs",
              "src_ok")


def test_keyframe_axis_transform(kf_case):
    points, poses = (torch.as_tensor(kf_case[k]) for k in ("points", "poses"))
    g = tks.transform_clouds_sharded(points, poses)
    # bit for bit the keyframe-batched call slam/core.py's NSSM makes
    assert torch.equal(g, se2_transform_points(points, poses))
    # one call a keyframe rounds its rotation and product otherwise: within
    # one float32 ulp of these 30 m coordinates (measured 1.9e-6 m)
    per_kf = torch.stack([se2_transform_points(points[k], poses[k])
                          for k in range(points.shape[0])])
    np.testing.assert_allclose(g.numpy(), per_kf.numpy(), rtol=0, atol=4e-6)
    gj = jks.transform_clouds_sharded(
        jnp.asarray(kf_case["points"]), jnp.asarray(kf_case["poses"]),
        make_config_mesh(8, axis="kf"))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5)


def _port_gate_chain(c):
    """The gate chain written out with the port's ops, as
    tests/test_parallel.py's ref_frame_sel writes it with JAX's."""
    t = {k: torch.as_tensor(c[k]) for k in _GATE_ARGS}
    K, N = t["pmasks"].shape
    g = torch.stack([se2_transform_points(t["points"][k], t["poses"][k])
                     for k in range(K)]).reshape(-1, 2)
    sels = []
    for w in range(t["src_poses"].shape[0]):
        pose, cov = t["src_poses"][w], t["src_covs"][w]
        tstd = torch.sqrt(max_eig_2x2(cov[:2, :2]))
        rstd = torch.sqrt(cov[2, 2])
        local = se2_transform_points(g, se2_inverse(pose))
        rng_ = torch.linalg.vector_norm(local, dim=-1)
        brg = torch.atan2(local[:, 1], local[:, 0])
        sels.append((rng_ < tstd * 5.0 + c["max_range"])
                    & (torch.abs(brg) < rstd * 5.0 + c["half_ap"])
                    & t["src_ok"][w])
    sel = (torch.any(torch.stack(sels), dim=0).reshape(K, N) & t["pmasks"]
           & t["tgt_ok"][:, None])
    return sel, torch.sum(sel, dim=1)


def test_keyframe_axis_gate_and_target(kf_case):
    c = kf_case
    args = [torch.as_tensor(c[k]) for k in _GATE_ARGS]
    sel, counts, best, have = tks.nssm_target_select_sharded(
        *args, c["max_range"], c["half_ap"])
    sel2, counts2 = tks.nssm_gate_sharded(*args, c["max_range"], c["half_ap"])
    assert torch.equal(sel, sel2) and torch.equal(counts, counts2)

    mesh = make_config_mesh(8, axis="kf")
    jargs = [jnp.asarray(c[k]) for k in _GATE_ARGS]
    jsel, jcounts, jbest, jhave = jks.nssm_target_select_sharded(
        *jargs, mesh, c["max_range"], c["half_ap"])
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(best) == int(jbest) and bool(have) == bool(jhave)

    ref_sel, ref_counts = _port_gate_chain(c)
    assert torch.equal(sel, ref_sel) and torch.equal(counts, ref_counts)
    ok = ref_counts > 10
    assert bool(have) == bool(ok.any())
    assert int(best) == int(np.argmax(np.where(ok, ref_counts, -1)))
    # the case exercises both sides of the gate
    assert 0 < int(sel.sum()) < int(torch.as_tensor(c["pmasks"]).sum())


def _report(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out[out.index("{"):])


def test_cli_sweep_against_the_script(cli_procs):
    port, ref = _report(cli_procs["port"]), _report(cli_procs["jax"])
    assert sorted(port) == sorted(ref)
    assert port["devices"] == 1 and port["lanes"] == 4
    for key in ("keyframes", "loops_per_lane", "best_lane", "best_config",
                "lanes"):
        assert port[key] == ref[key], key
    assert sum(port["loops_per_lane"]) > 0
    assert abs(port["best_ate_m"] - ref["best_ate_m"]) <= 5e-3
    assert abs(port["median_ate_m"] - ref["median_ate_m"]) <= 5e-3


def _sweep_probe(duration):
    """The sweep CLI's lane 0 on the ``duration`` survey: its ATE and loops
    under the JAX package (the script's 4 vmapped lanes; the lane alone under
    jit; with the DVL moved by 1e-6 m/s; on the port's inputs) and under the
    port (on the JAX inputs and on its own)."""
    from sonar_slam_tpu.io.simulate import SimConfig, simulate_bag
    from sonar_slam_tpu.pipeline import ate_rmse
    from sonar_slam_tpu.slam.core import slam_scan as jscan

    from sonar_slam_torch.cli import sweep as sweep_cli
    from sonar_slam_torch.io.simulate import simulate_bag as t_simulate
    from sonar_slam_torch.slam import FeatureConfig
    from test_torch_multi_robot import jax_frames

    bag = simulate_bag(SimConfig(duration=duration, speed=0.5, sonar_rate=1.0,
                                 num_ranges=192, num_bearings=96,
                                 loop_radius=10.0, imu_rate=20.0))
    jdims = JDims(max_keyframes=32, max_points=128, target_capacity=512,
                  nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                  max_loops=16, gn_iters=3,
                  icp=JICP(min_diff_rot=1e-3, min_diff_trans=1e-2))
    base = JParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(2.0),
        ssm_min_points=jnp.asarray(20, jnp.int32),
        nssm_min_points=jnp.asarray(20, jnp.int32))
    lanes = [base._replace(point_noise=jnp.float32(0.3),
                           icp_odom_sigmas=base.icp_odom_sigmas * 0.5,
                           ssm_max_rotation=jnp.float32(np.radians(r)))
             for r in (20, 30, 45, 60)]
    jf, kf_idx = jax_frames(bag, base, jdims)
    nk = len(kf_idx)
    truth = bag.true_pose_at_ping[kf_idx]

    def show(name, poses, loops):
        poses = np.asarray(poses)[:nk]
        print(f"{duration:.0f} s, {name}: {int(loops)} loops, ATE "
              f"{ate_rmse(poses, truth):.5f} m", flush=True)
        return poses

    lone = jax.jit(lambda f: jscan(f, lanes[0], jdims))
    c = _np(jsweep.sweep_scan(jf, jsweep.stack_params(lanes), jdims)[0])
    show("JAX, the script's 4 lanes vmapped, lane 0", c.poses[0], c.num_loops[0])
    c = _np(lone(jf)[0])
    ref = show("JAX, lane 0 alone (jit)", c.poses, c.num_loops)
    moved, _ = jax_frames(bag._replace(dvl_vel=bag.dvl_vel + np.float32(1e-6)),
                          base, jdims)
    c = _np(lone(moved)[0])
    p = show("JAX, DVL + 1e-6 m/s", c.poses, c.num_loops)
    print(f"  moved {np.abs(p - ref).max():.2e} m")
    tp, tdims = _port(lanes[0]), dims_from_reference(jdims)
    c, _ = slam_scan(_port_frames({k: np.asarray(v) for k, v
                                   in jf._asdict().items() if v is not None}),
                     tp, tdims)
    show("port on the JAX inputs", c.poses, c.num_loops)
    tf, _ = sweep_cli.build_frames(
        t_simulate(sweep_cli.sim_config(duration)), _port(base), tdims,
        FeatureConfig(max_points=128), "cpu")
    c, _ = slam_scan(tf, tp, tdims)
    show("port on its own inputs", c.poses, c.num_loops)
    c = _np(lone(JKI(*(None if x is None else jnp.asarray(x.numpy()) for x in tf)))[0])
    show("JAX on the port's inputs", c.poses, c.num_loops)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_parallel.py
    jax.config.update("jax_platforms", "cpu")
    for d in (45.0, 60.0):
        _sweep_probe(d)
