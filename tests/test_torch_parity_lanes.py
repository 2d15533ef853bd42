"""bench.py's reference-faithful parity lanes (bench.py:693-790) on the port
(``cli/parity_lane.py``) against the JAX package on the CPU.

The configuration is bench.py --small's, uncut: the 90 s survey at 1 Hz,
192 x 96 pings, 32 keyframe slots, seed 0 (19 keyframes). The faithful
lanes run strict-edge SOCA without the corroboration gate, icp.yaml's
point-to-point ICP (3 m outlier radius, trim 0.8, up to 40 trips), 30 NSSM
starts whose MCD mean is the loop transform and NSSM at every keyframe
(``tests/test_parity.py``'s ``TestParityCollapse``, slow-marked there).

The port runs once, through ``cli.parity_lane``'s ``main(["--small",
"--cpu"])`` in process (the faithful lane cold and warm, SSM-only, odometry
mode); its printed line must carry bench.py's ``parity`` keys and
``odometry_max_dev_m``; without a card and without ``--cpu`` it exits 1. The JAX lanes take about 70 s more on the CPU, so
the port is held to a golden of their results,
tests/golden/parity_lanes_small.npz (``python tests/test_torch_parity_lanes.py``
rewrites it, about 90 s). The strict-edge frames are recomputed with the
JAX package on every run.

* Configuration: ``faithful_dims``, ``faithful_params`` and
  ``faithful_feature_config`` equal bench.py's ``pdims``, ``pparams`` and
  parity extractor config built from the JAX package's production setup,
  small and full.
* Frames: the strict-edge, ungated features of the 19 keyframe pings equal
  the JAX ``FeatureExtractor``'s (its XLA path on the CPU): the detections
  agree except at pixels within a relative 1e-5 of their threshold
  (tests/test_torch_cfar.py's pin for the sum path against prefix sums;
  none on this survey), the cloud masks and counts are equal and the
  points within 1e-4 m (tests/test_torch_frontend.py's pin); no detection
  in the 25 border rows at each end.
* Odometry mode: within 1e-3 m of the port's own dead-reckoning keyframe
  poses (measured 4.8e-6 m) and within 5e-4 m / rad of the JAX lane
  (measured 1.7e-5 m: the two packages' dead reckoning); no loop; the same
  keyframes.
* SSM-only: the same keyframes, no loop, poses within ``SSM_ONLY_TOL``
  (1e-4 m / rad; measured 4.3e-6 m) of the JAX lane; both packages in
  ``test_parity.py``'s band: ATE above dead reckoning's and within
  0.15-2.0 m (0.9426 m in both).
* The full faithful lane: the same keyframes; the step outputs through the
  first NSSM attempt (steps 0-7) within ``FIRST_STEPS_TOL`` (1e-4 m / rad;
  measured 2.9e-6 m) of the JAX lane's, and the same NSSM statuses and
  loop flags through the first accepted loop (step 9); then in both packages
  ``test_parity.py``'s directional guards: ATE above dead reckoning's and
  within 0.25-10 m, at least one accepted loop, a largest loop error over
  0.30 m. The production lane (bench.py --small, refinement on) on the same
  survey stays under 0.10 m and under 1.5x dead reckoning's ATE.

The tolerances rest on the probe (``PYTHONPATH=.:tests JAX_PLATFORMS=cpu
python tests/test_torch_parity_lanes.py probe``, about 6 minutes), which
moves every dead-reckoning keyframe pose by 1e-6 m along +-x and +-y and
replays each package's own lane on its own clouds. The SSM-only lane
moves by at most 1.1e-5 m (JAX) and 7.2e-6 m (the port), the faithful
lane's steps 0-7 by at most 2.4e-6 m and 4.8e-6 m, and no move changes a
loop flag through the first loop; 1e-4 m is nine times the largest of
these moves and over twenty times the measured gaps, which carry the
packages' 1.7e-5 m odometry gap. Past its first loops the faithful lane
is chaotic in both: one
of the four moves takes the JAX lane from 7 loops and 0.519 m ATE to 9
loops and 0.598 m (poses move up to 0.43 m), and the port's own lane moves
up to 0.99 m. The port's lane (9 loops, 0.600 m) and the JAX lane (7
loops, 0.519 m) differ by less than that, so only the directional guards
hold there.

About 85 s on one core: the port's four lanes (two faithful runs of about
23 s each), its production lane (about 25 s) and the JAX frames. The
front end's CFAR calls are counted as the card counts its launches: one
a lane.
"""

import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import error_budget as jeb  # noqa: E402  (scripts/error_budget.py)
import sonar_slam_tpu.io.simulate as jsim  # noqa: E402
import sonar_slam_tpu.pipeline as jpipe  # noqa: E402
import sonar_slam_tpu.slam.core as jcore  # noqa: E402
from sonar_slam_tpu.cloud import ICPConfig as JICP  # noqa: E402
from sonar_slam_tpu.geometry import se2_between as jbetween  # noqa: E402
from sonar_slam_tpu.slam.frontend import FeatureConfig as JFC  # noqa: E402
from sonar_slam_tpu.slam.frontend import FeatureExtractor as JFX  # noqa: E402

import sonar_slam_torch.io.simulate as tsim  # noqa: E402
import sonar_slam_torch.slam.core as tcore  # noqa: E402
import sonar_slam_torch.slam.frontend as tfrontend  # noqa: E402
from sonar_slam_torch.kernels import cfar_cuda  # noqa: E402
from sonar_slam_torch.cli import error_budget as teb  # noqa: E402
from sonar_slam_torch.cli import parity_lane  # noqa: E402
from sonar_slam_torch.convert import (  # noqa: E402
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
)
from sonar_slam_torch.kernels.cfar_cuda import cfar_plain  # noqa: E402
from sonar_slam_torch.kernels.cfar_factors import threshold_factor_soca  # noqa: E402
from sonar_slam_torch.pipeline import ate_rmse, replay  # noqa: E402
from sonar_slam_torch.slam import FeatureConfig, FeatureExtractor  # noqa: E402

torch.set_num_threads(1)
GOLDEN = os.path.join(REPO, "tests", "golden", "parity_lanes_small.npz")
LANES = parity_lane.LANES
BENCH_PARITY_KEYS = {"ate_m", "ate_heading_deg", "loops", "ssm_only_ate_m",
                     "ssm_only_heading_deg", "xrealtime", "wall_s", "compile_s"}
SSM_ONLY_TOL = 1e-4
FIRST_STEPS_TOL = 1e-4
ODOMETRY_DR_TOL_M = 1e-3
ODOMETRY_JAX_TOL = 5e-4
# glibc's mallopt: keep freed blocks in the heap (no mmap, no trim), as the
# other files' subprocesses do with MALLOC_MMAP_MAX_=0 and
# MALLOC_TRIM_THRESHOLD_; it halves the faithful lane's time (page faults on
# the ICP temporaries)
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4


def jax_faithful_config(full: bool):
    """bench.py's parity lane configuration in the JAX package's types
    (bench.py:702-738), built from its production setup as bench.py builds
    it: (SimConfig, pdims, pparams, FeatureConfig)."""
    sim, dims, kf_t = jeb.setups(full)
    params = jeb.bench_params(dims, kf_t, full=full)
    pdims = jcore.SlamDims(
        max_keyframes=dims.max_keyframes, max_points=dims.max_points,
        target_capacity=dims.target_capacity, nssm_cov_samples=30,
        ssm_sobol=64, nssm_sobol=dims.nssm_sobol, max_loops=dims.max_loops,
        gn_iters=3, icp=JICP())
    pparams = jcore.SlamParams.default(pdims)._replace(
        keyframe_translation=jnp.float32(kf_t),
        ssm_min_points=params.ssm_min_points,
        nssm_min_points=params.nssm_min_points,
        odom_sigmas=params.odom_sigmas,
        icp_odom_sigmas=jnp.asarray(
            [0.2, 0.2, 0.02] if full else [0.3, 0.3, 0.03], jnp.float32))
    fc = JFC(max_points=dims.max_points, corroborate=full)._replace(
        cfar_edge="strict", corroborate=False)
    return sim, pdims, pparams, fc


def jax_lane_params(pparams, lane: str):
    if lane == "ssm_only":
        return pparams._replace(nssm_enable=jnp.asarray(False))
    if lane == "odometry":
        return pparams._replace(ssm_enable=jnp.asarray(False),
                                nssm_enable=jnp.asarray(False))
    return pparams


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_loop_errors(res, truth) -> np.ndarray:
    """tests/test_parity.py's ``loop_errs`` of a JAX replay."""
    nl = min(int(res.carry.num_loops), len(res.carry.loops_i))
    errs = []
    for i, j, z in zip(np.asarray(res.carry.loops_i)[:nl],
                       np.asarray(res.carry.loops_j)[:nl],
                       np.asarray(res.carry.loops_tf)[:nl]):
        zt = np.asarray(jbetween(jnp.asarray(truth[i]), jnp.asarray(truth[j])))
        errs.append(float(np.linalg.norm(z[:2] - zt[:2])))
    return np.asarray(errs, np.float64)


def jax_lanes() -> dict:
    """The golden file's contents: each JAX lane's replay on the CPU."""
    sim, pdims, pparams, fc = jax_faithful_config(False)
    bag = jsim.simulate_bag(sim)
    out = {}
    for lane in LANES:
        res = jpipe.replay(bag, fc, jax_lane_params(pparams, lane), pdims)
        nk = res.num_keyframes
        truth = bag.true_pose_at_ping[res.keyframe_ping_idx][:nk]
        out.update({
            f"{lane}_keyframe_ping_idx": np.asarray(res.keyframe_ping_idx),
            f"{lane}_trajectory": np.asarray(res.trajectory),
            f"{lane}_dr_trajectory": np.asarray(res.dr_trajectory),
            f"{lane}_step_poses": np.asarray(res.outputs.pose)[:nk],
            f"{lane}_nssm_status": np.asarray(res.outputs.nssm_status)[:nk],
            f"{lane}_loop_added": np.asarray(res.outputs.loop_added)[:nk],
            f"{lane}_num_loops": np.int64(res.carry.num_loops),
            f"{lane}_loop_errs": jax_loop_errors(res, truth),
            f"{lane}_ate": np.float64(ate_rmse(res.trajectory, truth)),
            f"{lane}_dr_ate": np.float64(ate_rmse(res.dr_trajectory, truth)),
        })
    return out


def _mallopt(option: int, value: int):
    try:
        ctypes.CDLL("libc.so.6").mallopt(option, value)
    except OSError:  # not glibc: keep its defaults
        pass


@pytest.fixture(scope="module", autouse=True)
def _heap():
    _mallopt(M_MMAP_MAX, 0)
    _mallopt(M_TRIM_THRESHOLD, 1 << 30)
    yield
    _mallopt(M_MMAP_MAX, 65536)  # glibc's defaults
    _mallopt(M_TRIM_THRESHOLD, 128 * 1024)


@pytest.fixture(scope="module")
def port():
    """The port's CLI in process (``main(["--small", "--cpu"])``): its
    printed line, its ParityRun, and the survey's truth. The front end's
    CFAR calls, which launch no kernel on the CPU, are counted as the card
    counts its sum-kernel launches."""
    counts = cfar_cuda.cfar_detect.kernel_launches
    saved = dict(counts)

    def counted(*args, **kwargs):
        counts["sum"] += 1
        return cfar_cuda.cfar_detect(*args, **kwargs)

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(tfrontend, "cfar_detect", counted)
        run = parity_lane.main(["--small", "--cpu"])
    counts.update(saved)
    bag = tsim.simulate_bag(teb.setups(False)[0])
    return buf.getvalue().strip().splitlines(), run, bag


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _truth(res, bag):
    return parity_lane.truth_at_keyframes(res, bag)


def assert_params_equal(got, want):
    """Two port NamedTuples of numbers and tensors, field for field."""
    assert type(got) is type(want)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert type(a) is type(b) and a == b, name


@pytest.mark.parametrize("full", [False, True], ids=["small", "full"])
def test_faithful_config_matches_bench(full):
    _, jdims, jparams, jfc = jax_faithful_config(full)
    _, dims, _ = teb.setups(full)
    pdims = parity_lane.faithful_dims(dims)
    assert pdims == dims_from_reference(jdims)
    assert_params_equal(parity_lane.faithful_params(pdims, full, "cpu"),
                        params_from_reference(_np(jparams), "cpu"))
    fc = FeatureConfig(max_points=dims.max_points, corroborate=full)
    assert (parity_lane.faithful_feature_config(fc)
            == feature_config_from_reference(jfc))


def test_faithful_dims_match_test_parity():
    """tests/test_parity.py's ``par_dims`` is the small faithful config."""
    par_dims = jcore.SlamDims(
        max_keyframes=32, max_points=128, target_capacity=512,
        nssm_cov_samples=30, ssm_sobol=64, nssm_sobol=128, max_loops=32,
        gn_iters=3, icp=JICP())
    assert (parity_lane.faithful_dims(teb.setups(False)[1])
            == dims_from_reference(par_dims))


def test_strict_frames_match_jax(port, golden):
    _, run, bag = port
    kf = run.lanes["faithful"].keyframe_ping_idx
    np.testing.assert_array_equal(kf, golden["faithful_keyframe_ping_idx"])
    imgs = np.asarray(bag.ping_images[kf], np.float32)
    jbag = jsim.simulate_bag(jax_faithful_config(False)[0])
    np.testing.assert_array_equal(imgs, jbag.ping_images[kf])
    jfc = jax_faithful_config(False)[3]
    fc = feature_config_from_reference(jfc)
    jx = JFX(jfc, jbag.geometry)
    tx = FeatureExtractor(fc, bag.geometry, "cpu")
    jdet = np.stack([np.asarray(jx.detections(jnp.asarray(im))) for im in imgs])
    tdet = tx.detections(torch.as_tensor(imgs)).numpy()
    t, g = fc.ntc // 2, fc.ngc // 2
    _, thr = cfar_plain(torch.as_tensor(imgs), t, g,
                        threshold_factor_soca(fc.ntc, fc.pfa), "SOCA", None,
                        "strict")
    thr = thr.numpy()
    near = np.abs(imgs - thr) <= 1e-5 * np.abs(thr)
    assert not (tdet != jdet)[~near].any()
    assert tdet.any() and not tdet[:, : t + g].any() and not tdet[:, -(t + g):].any()
    jp, jm, jc = (np.asarray(a) for a in jx.extract_batch_conf(jnp.asarray(imgs)))
    tp, tm, tc = (a.numpy() for a in tx.extract_batch_conf(torch.as_tensor(imgs)))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    # the lane's clouds are these
    nk = run.lanes["faithful"].num_keyframes
    np.testing.assert_array_equal(
        run.lanes["faithful"].carry.pmasks[:nk].numpy(), tm)


def test_cli_prints_bench_parity_keys(port):
    lines, run, _ = port
    printed = json.loads(lines[-1])
    assert set(printed) == BENCH_PARITY_KEYS | {"odometry_max_dev_m"}
    assert printed == run.parity
    assert all(np.isfinite(v) for v in printed.values())
    assert printed["compile_s"] > 0 and printed["wall_s"] > 0
    assert printed["xrealtime"] == round(90.0 / run.parity["wall_s"], 1)


def test_cli_without_card_exits_1():
    """Without a card and without ``--cpu`` the CLI exits 1 and runs
    nothing on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "sonar_slam_torch.cli.parity_lane", "--small"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""


def test_each_lane_makes_one_cfar_call(port):
    _, run, _ = port
    assert run.launches == {name: {"sum": 1, "os_mask": 0, "os_select": 0}
                            for name in ("faithful_cold", *LANES)}


def test_faithful_cold_and_warm_runs_equal(port):
    _, run, _ = port
    for a, b in zip(run.cold.carry, run.lanes["faithful"].carry):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    np.testing.assert_array_equal(run.cold.trajectory,
                                  run.lanes["faithful"].trajectory)


def test_odometry_mode_reproduces_dead_reckoning(port, golden):
    _, run, bag = port
    res = run.lanes["odometry"]
    np.testing.assert_array_equal(res.keyframe_ping_idx,
                                  golden["odometry_keyframe_ping_idx"])
    dev = np.abs(res.trajectory[:, :2] - res.dr_trajectory[:, :2]).max()
    assert dev < ODOMETRY_DR_TOL_M
    assert run.parity["odometry_max_dev_m"] == float(dev)
    assert res.carry.num_loops == 0 == int(golden["odometry_num_loops"])
    np.testing.assert_allclose(res.trajectory, golden["odometry_trajectory"],
                               rtol=0, atol=ODOMETRY_JAX_TOL)
    truth = _truth(res, bag)
    assert abs(ate_rmse(res.trajectory, truth)
               - ate_rmse(res.dr_trajectory, truth)) < 1e-3


def test_ssm_only_lane_matches_jax_and_band(port, golden):
    _, run, bag = port
    res = run.lanes["ssm_only"]
    np.testing.assert_array_equal(res.keyframe_ping_idx,
                                  golden["ssm_only_keyframe_ping_idx"])
    assert res.carry.num_loops == 0 == int(golden["ssm_only_num_loops"])
    np.testing.assert_allclose(res.trajectory, golden["ssm_only_trajectory"],
                               rtol=0, atol=SSM_ONLY_TOL)
    truth = _truth(res, bag)
    for ate, dr_ate in ((ate_rmse(res.trajectory, truth),
                         ate_rmse(res.dr_trajectory, truth)),
                        (golden["ssm_only_ate"], golden["ssm_only_dr_ate"])):
        assert 0.15 < ate < 2.0 and ate > dr_ate, (ate, dr_ate)
    assert run.parity["ssm_only_ate_m"] == round(
        ate_rmse(res.trajectory, truth), 4)


def test_faithful_lane_first_steps_match_jax(port, golden):
    _, run, _ = port
    res = run.lanes["faithful"]
    np.testing.assert_array_equal(res.keyframe_ping_idx,
                                  golden["faithful_keyframe_ping_idx"])
    attempt = parity_lane.faithful_dims(teb.setups(False)[1]).nssm_min_st_sep - 1
    np.testing.assert_allclose(res.outputs.pose[:attempt + 1].numpy(),
                               golden["faithful_step_poses"][:attempt + 1],
                               rtol=0, atol=FIRST_STEPS_TOL)
    added = golden["faithful_loop_added"]
    n = int(np.argmax(added)) + 1
    assert added[n - 1] and n > attempt
    np.testing.assert_array_equal(res.outputs.nssm_status[:n].numpy(),
                                  golden["faithful_nssm_status"][:n])
    np.testing.assert_array_equal(res.outputs.loop_added[:n].numpy(),
                                  added[:n])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_faithful_lane_directional_guards(port, golden, package):
    """tests/test_parity.py's guards: worse than dead reckoning, at least one
    accepted loop, and accepted loops with errors over 0.30 m."""
    _, run, bag = port
    if package == "port":
        res = run.lanes["faithful"]
        truth = _truth(res, bag)
        ate, dr_ate = (ate_rmse(res.trajectory, truth),
                       ate_rmse(res.dr_trajectory, truth))
        errs = parity_lane.loop_errors(res, bag)
        assert run.parity["loops"] == res.carry.num_loops == len(errs)
    else:
        ate, dr_ate = golden["faithful_ate"], golden["faithful_dr_ate"]
        errs = golden["faithful_loop_errs"]
    assert ate > dr_ate, (ate, dr_ate)
    assert 0.25 < ate < 10.0, ate
    assert len(errs) >= 1
    assert errs.max() > 0.30, errs


def test_production_lane_stays_centimetric(port):
    """bench.py --small's production lane (refinement on) on the same
    survey: under 0.10 m and under 1.5x dead reckoning's ATE, its loops
    centimetric."""
    _, _, bag = port
    _, dims, kf_t = teb.setups(False)
    res = replay(bag, FeatureConfig(max_points=dims.max_points),
                 teb.bench_params(dims, kf_t, False, "cpu"), dims, "cpu",
                 refine_params=teb.bench_rparams(False, "cpu"))
    truth = _truth(res, bag)
    ate = ate_rmse(res.trajectory, truth)
    assert ate < 0.10 and ate < 1.5 * ate_rmse(res.dr_trajectory, truth), ate
    errs = parity_lane.loop_errors(res, bag)
    if len(errs):
        assert np.median(errs) < 0.10, errs


def probe():
    """Each package's own lanes with every dead-reckoning keyframe pose
    moved by 1e-6 m along +-x and +-y, on its own clouds: how far the
    trajectory and the step outputs through the first loop move."""
    sim, pdims, pparams, jfc = jax_faithful_config(False)
    jbag = jsim.simulate_bag(sim)
    tbag = tsim.simulate_bag(teb.setups(False)[0])
    dims = parity_lane.faithful_dims(teb.setups(False)[1])
    params = parity_lane.faithful_params(dims, False, "cpu")
    fc = feature_config_from_reference(jfc)
    for lane in ("ssm_only", "faithful"):
        jres = jpipe.replay(jbag, jfc, jax_lane_params(pparams, lane), pdims)
        tres = replay(tbag, fc, parity_lane.lane_params(params, lane), dims,
                      "cpu")
        nk = jres.num_keyframes
        n = dims.nssm_min_st_sep  # the steps through the first NSSM attempt
        truth = jbag.true_pose_at_ping[jres.keyframe_ping_idx][:nk]
        print(f"{lane}: JAX {int(jres.carry.num_loops)} loops, ATE "
              f"{ate_rmse(jres.trajectory, truth):.4f} m; port "
              f"{tres.carry.num_loops} loops, ATE "
              f"{ate_rmse(tres.trajectory, truth):.4f} m; trajectories "
              f"{np.abs(jres.trajectory - tres.trajectory).max():.3g} apart, "
              f"steps 0-{n - 1} "
              f"{np.abs(np.asarray(jres.outputs.pose)[:n] - tres.outputs.pose[:n].numpy()).max():.3g}")
        for sign in (1, -1):
            for axis in (0, 1):
                move = np.zeros(6, np.float32)
                move[axis] = sign * 1e-6
                jc = jres.carry
                jcarry, jout = jcore.slam_scan(jcore.KeyframeInput(
                    time=jc.times, dr_pose3=jc.dr_poses3 + move,
                    points=jc.points, pmask=jc.pmasks,
                    valid=jnp.arange(pdims.max_keyframes) < nk, conf=jc.pconf),
                    jax_lane_params(pparams, lane), pdims, None)
                tc = tres.carry
                tcarry, tout = tcore.slam_scan(tcore.KeyframeInput(
                    time=tc.times, dr_pose3=tc.dr_poses3 + torch.as_tensor(move),
                    points=tc.points, pmask=tc.pmasks,
                    valid=torch.arange(dims.max_keyframes) < nk, conf=tc.pconf),
                    parity_lane.lane_params(params, lane), dims)
                jp = np.asarray(jcarry.poses)[:nk]
                tp = tcarry.poses[:nk].numpy()
                flags = [np.array_equal(np.asarray(o.loop_added)[:f],
                                        np.asarray(r.outputs.loop_added)[:f])
                         for o, r in ((jout, jres), (tout, tres))
                         for f in [int(np.argmax(np.asarray(
                             r.outputs.loop_added)[:nk])) + 1]]
                print(f"  move {'+-'[sign < 0]}{'xy'[axis]}: JAX "
                      f"{int(jcarry.num_loops)} loops, ATE "
                      f"{ate_rmse(jp, truth):.4f} m, poses move "
                      f"{np.abs(jp - jres.trajectory).max():.3g}, steps 0-{n - 1} "
                      f"{np.abs(np.asarray(jout.pose)[:n] - np.asarray(jres.outputs.pose)[:n]).max():.3g}; "
                      f"port {tcarry.num_loops} loops, ATE "
                      f"{ate_rmse(tp, truth):.4f} m, poses move "
                      f"{np.abs(tp - tres.trajectory).max():.3g}, steps "
                      f"{np.abs(tout.pose[:n].numpy() - tres.outputs.pose[:n].numpy()).max():.3g}; "
                      f"loop flags through the first loop unchanged (JAX, "
                      f"port): {flags}", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_parity_lanes.py [probe]
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["probe"]:
        probe()
    else:
        out = jax_lanes()
        np.savez(GOLDEN, **out)
        print(f"wrote {GOLDEN}: " + ", ".join(
            f"{lane} {int(out[f'{lane}_num_loops'])} loops ATE "
            f"{float(out[f'{lane}_ate']):.4f} m" for lane in LANES))
