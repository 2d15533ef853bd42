"""``parallel/multi_robot.py`` and ``cli.two_robot_demo``: the port against
the JAX package.

* ``exchange_keyframes`` + ``merge_interrobot_factors``: the case of
  ``tests/test_parallel.py`` (four robots seeing one structure), the JAX
  side on a 4-device mesh: the same ``ok`` and overlaps, transforms within
  1e-4 m / rad.
* The three cases of ``tests/test_multi_robot_merge.py``: merged graphs and
  optimized poses within 1e-4 of the JAX package's, the same PCM accept mask
  and clique size, and the ``ValueError``.
* ``multi_robot_scan`` on two small keyframe streams against the JAX one on
  a 2-device mesh (poses within 1e-4, the same keyframe and loop counts);
  each robot equal bit for bit to a lone ``slam_scan``.
* ``propose_interrobot_loops`` on a 3 x 3 candidate set cut from one
  structured scene: the same ``ok`` and overlaps, transforms within 1e-4
  where ``ok``.
* ``cli.two_robot_demo --duration 75 --cpu`` against
  ``scripts/two_robot_demo.py --duration 75``, both in subprocesses started
  when the module starts (about 80 s for the JAX script, 30 s for the
  port): the same keyframes, loops, proposal count, PCM accept count and
  clique size, and the merged ATE within 1e-2 m. Measured: 6.92 cm against
  JAX's 7.30 cm. The gap is robot A's NSSM at keyframe 9: given the JAX
  carry and frames, the port's 12 multi-start ICP results agree with the
  JAX package's within 3e-6 m but for start 3, which lands 7.6e-3 m away,
  and the JAX package's own ICP moves that start by the same 7.6e-3 m when
  its guess moves by 1e-6 (4 of the 6 axis directions): a correspondence on
  the trim boundary. (A 1e-6 m/s change to the DVL moves the JAX robot by
  only 3.5e-5 m: it does not reach that boundary.) At the script's default
  90 s, robot A's ATE on the same JAX inputs is 0.1078 m under ``jit`` and
  0.0585 m under ``shard_map`` in the JAX package itself, and 0.0562 m in
  the port; the port's CLI on the CPU lands on 0.1078 m (4 of 5 PCM
  accepts against the script's 5), on an H100 on the script's outcome (5 of
  5, merged ATE 5.68 cm against 5.61 cm).

``PYTHONPATH=.:tests python tests/test_torch_multi_robot.py [75|90]`` prints
these probes (robot A's per-keyframe trace, each NSSM's multi-start ICP in
both packages, the JAX ICP's moves under 1e-6 guess changes, and the scan's
ATE under jit, shard_map, the moved DVL and the port).
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sonar_slam_tpu.cloud import ICPConfig as JICP
from sonar_slam_tpu.geometry import se2_between as j_between
from sonar_slam_tpu.geometry import se2_compose as j_compose
from sonar_slam_tpu.geometry import se2_inverse as j_inverse
from sonar_slam_tpu.geometry import se2_transform_points as j_transform
from sonar_slam_tpu.graph import factor_graph as jfg
from sonar_slam_tpu.parallel import make_config_mesh
from sonar_slam_tpu.parallel import multi_robot as jmr
from sonar_slam_tpu.slam import KeyframeInput as JKI
from sonar_slam_tpu.slam import SlamDims as JDims
from sonar_slam_tpu.slam import SlamParams as JParams
from sonar_slam_tpu.slam.scan_matching import sobol_unit_samples

from sonar_slam_torch.cloud import ICPConfig
from sonar_slam_torch.convert import (
    dims_from_reference,
    graph_from_reference,
    params_from_reference,
    summary_from_reference,
)
from sonar_slam_torch.graph import GraphConfig, optimize
from sonar_slam_torch.parallel import exchange_keyframes, merge_interrobot_factors
from sonar_slam_torch.parallel import multi_robot as tmr
from sonar_slam_torch.slam import KeyframeInput, slam_scan

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_FLAGS = ["--duration", "75"]


@pytest.fixture(scope="module", autouse=True)
def cli_procs():
    """Both two-robot CLIs, started in subprocesses when the module starts,
    so that they run beside the in-process tests."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "two_robot_demo.py")]
            + DEMO_FLAGS, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env),
        "port": subprocess.Popen(
            [sys.executable, "-m", "sonar_slam_torch.cli.two_robot_demo",
             "--cpu"] + DEMO_FLAGS, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(env, OMP_NUM_THREADS="1")),
    }
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ----------------------------------------------------------------------
# exchange + merge_interrobot_factors (tests/test_parallel.py:95-134)
# ----------------------------------------------------------------------


def test_multi_robot_exchange_and_merge():
    n, N = 4, 64
    rng = np.random.default_rng(17)
    base = rng.uniform(0, 10, size=(N, 2)).astype(np.float32)
    poses = np.array([[0, 0, 0], [1.0, 0.5, 0.1], [8.0, -2.0, 0.4],
                      [0.2, 0.1, 0.0]], np.float32)
    clouds = np.stack([np.asarray(j_transform(jnp.asarray(base),
                                              j_inverse(jnp.asarray(p))))
                       for p in poses])
    jsum = jmr.KeyframeSummary(
        robot_id=jnp.arange(n, dtype=jnp.int32), key=jnp.zeros((n,), jnp.int32),
        pose=jnp.asarray(poses),
        cov=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (n, 1, 1)),
        points=jnp.asarray(clouds), pmask=jnp.ones((n, N), bool))
    jg = jmr.exchange_keyframes(jsum, make_config_mesh(n, axis="robot"))
    jtfs, jok, jov = jmr.merge_interrobot_factors(
        jax.tree.map(lambda x: x[0], jsum), jg, min_overlap=30)

    summary = summary_from_reference(_np(jsum), "cpu")
    gathered = exchange_keyframes(summary)
    assert gathered is summary and gathered.pose.shape == (n, 3)
    own = tmr.KeyframeSummary(*(x[0] for x in summary))
    tfs, ok, ov = merge_interrobot_factors(own, gathered, min_overlap=30)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    np.testing.assert_allclose(tfs.numpy(), np.asarray(jtfs), atol=1e-4)
    ok = ok.numpy()
    assert not ok[0] and ok[1] and ok[3]
    expect = np.asarray(j_between(jnp.asarray(poses[0]), jnp.asarray(poses[1])))
    np.testing.assert_allclose(tfs[1].numpy(), expect, atol=0.05)


# ----------------------------------------------------------------------
# the merge cases of tests/test_multi_robot_merge.py
# ----------------------------------------------------------------------


def _chain_graph(true_poses, sigmas, prior=True):
    """A JAX odometry-chain graph over the given poses."""
    n = len(true_poses)
    cfg = jfg.GraphConfig(max_poses=n, max_factors=2 * n + 4, gn_iters=8)
    g = jfg.graph_init(cfg)
    if prior:
        g = jfg.add_prior(g, true_poses[0],
                          jfg.sigmas_to_sqrt_info([0.01, 0.01, 0.001]))
    for k in range(n):
        g = jfg.set_pose_estimate(g, k, true_poses[k])
    for k in range(n - 1):
        z = j_between(jnp.asarray(true_poses[k]), jnp.asarray(true_poses[k + 1]))
        g = jfg.add_between(g, k, k + 1, z, jfg.sigmas_to_sqrt_info(sigmas))
    return g


def _true_trajs():
    ta = np.stack([np.linspace(0, 8, 6), np.zeros(6), np.zeros(6)],
                  -1).astype(np.float32)
    tb = np.stack([np.linspace(0, 8, 6), np.full(6, 2.0),
                   np.full(6, 0.1)], -1).astype(np.float32)
    return ta, tb


def _port_cfg(cfg):
    return GraphConfig(**cfg._asdict())


def test_merge_recovers_cross_robot_geometry():
    ta, tb = _true_trajs()
    ga = _chain_graph(ta, [0.05, 0.05, 0.01])
    gb = _chain_graph(tb, [0.05, 0.05, 0.01], prior=False)
    t_off = jnp.asarray([3.0, -1.0, 0.3], jnp.float32)
    for k in range(6):
        gb = jfg.set_pose_estimate(gb, k, j_compose(t_off, jnp.asarray(tb[k])))
    qa = np.array([1, 4], np.int32)
    qb = np.array([1, 4], np.int32)
    tfs = jnp.stack([j_between(jnp.asarray(ta[1]), jnp.asarray(tb[1])),
                     j_between(jnp.asarray(ta[4]), jnp.asarray(tb[4]))])
    covs = jnp.tile(jnp.diag(jnp.asarray([0.05, 0.05, 0.01]) ** 2)[None],
                    (2, 1, 1))
    accept = jnp.asarray([True, True])
    cfg = jfg.GraphConfig(max_poses=12, max_factors=32, gn_iters=10)
    jm = jmr.merge_pose_graphs(ga, 6, gb, 6, qa, qb, tfs, covs, accept, cfg)
    jopt = jfg.optimize(jm, cfg)

    tm = tmr.merge_pose_graphs(
        graph_from_reference(_np(ga), "cpu"), 6,
        graph_from_reference(_np(gb), "cpu"), 6, qa, qb, np.asarray(tfs),
        np.asarray(covs), np.asarray(accept), _port_cfg(cfg))
    ref = graph_from_reference(_np(jm), "cpu")
    for name in ("f_i", "f_j", "f_robust", "f_scaled", "num_factors",
                 "num_poses"):
        assert torch.equal(getattr(tm, name), getattr(ref, name)), name
    for name in ("poses", "prior_pose", "prior_sqrt_info", "f_z", "f_sqrt_info"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   getattr(ref, name).numpy(), atol=1e-4,
                                   err_msg=name)
    poses = optimize(tm, _port_cfg(cfg)).poses.numpy()
    np.testing.assert_allclose(poses, np.asarray(jopt.poses), atol=1e-4)
    # A unchanged (anchored), B pulled into A's frame at the true geometry
    np.testing.assert_allclose(poses[:6], ta, atol=1e-3)
    np.testing.assert_allclose(poses[6:12], tb, atol=2e-2)


def test_pcm_rejects_inconsistent_interrobot_proposal():
    ta, tb = _true_trajs()
    good1 = j_between(jnp.asarray(ta[1]), jnp.asarray(tb[1]))
    good2 = j_between(jnp.asarray(ta[4]), jnp.asarray(tb[4]))
    bad = j_between(jnp.asarray(ta[2]), jnp.asarray(tb[2])) + jnp.asarray(
        [1.5, -1.0, 0.4])
    tfs = jnp.stack([good1, bad, good2])
    covs = jnp.tile(jnp.diag(jnp.asarray([0.05, 0.05, 0.01]) ** 2)[None],
                    (3, 1, 1))
    args = (ta[[1, 2, 4]], tb[[1, 2, 4]], tfs, covs, np.ones(3, bool))
    jaccept, jsize = jmr.vet_interrobot_loops(*(jnp.asarray(a) for a in args),
                                              min_pcm=2)
    accept, size = tmr.vet_interrobot_loops(*(_t(a) for a in args), min_pcm=2)
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jaccept))
    assert int(size) == int(jsize) == 2
    assert accept.tolist() == [True, False, True]


def test_merge_requires_accepted_loop():
    ta, tb = _true_trajs()
    ga = graph_from_reference(_np(_chain_graph(ta, [0.05, 0.05, 0.01])), "cpu")
    gb = graph_from_reference(
        _np(_chain_graph(tb, [0.05, 0.05, 0.01], prior=False)), "cpu")
    with pytest.raises(ValueError):
        tmr.merge_pose_graphs(ga, 6, gb, 6, np.array([1]), np.array([1]),
                              torch.zeros((1, 3)), torch.eye(3)[None],
                              torch.tensor([False]),
                              GraphConfig(max_poses=12, max_factors=32))


# ----------------------------------------------------------------------
# multi_robot_scan and propose_interrobot_loops
# ----------------------------------------------------------------------

JDIMS = JDims(
    max_keyframes=8, max_points=32, target_capacity=64,
    nssm_min_st_sep=4, nssm_source_frames=2, ssm_target_frames=2,
    nssm_cov_samples=4, ssm_sobol=16, nssm_sobol=16, max_loops=4,
    gn_iters=2, pcm_queue_slots=3, icp=JICP(max_iterations=6),
)


def _frames(seed, n):
    """tests/test_parallel.py's kind of keyframe stream."""
    rng = np.random.default_rng(seed)
    K, N = JDIMS.max_keyframes, JDIMS.max_points
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = np.arange(K) * 1.5
    valid = np.arange(K) < n
    return dict(time=(np.arange(K) * 2.0).astype(np.float32), dr_pose3=dr,
                points=rng.uniform(0, 15, size=(K, N, 2)).astype(np.float32),
                pmask=np.ones((K, N), bool) & valid[:, None], valid=valid)


def test_multi_robot_scan_against_the_mesh():
    fs = [_frames(17, 6), _frames(18, 5)]
    stacked = {k: np.stack([f[k] for f in fs]) for k in fs[0]}
    jp = JParams.default(JDIMS)._replace(
        keyframe_translation=jnp.float32(1.0),
        ssm_min_points=jnp.asarray(5, jnp.int32),
        nssm_min_points=jnp.asarray(5, jnp.int32))
    jc, _ = jmr.multi_robot_scan(
        JKI(**{k: jnp.asarray(v) for k, v in stacked.items()}), jp, JDIMS,
        make_config_mesh(2, axis="robot"))
    p = params_from_reference(_np(jp), "cpu")
    dims = dims_from_reference(JDIMS)
    carries, outputs = tmr.multi_robot_scan(
        KeyframeInput(**{k: _t(v) for k, v in stacked.items()}), p, dims)
    np.testing.assert_array_equal(carries.num_kf.numpy(), [6, 5])
    np.testing.assert_array_equal(carries.num_kf.numpy(), np.asarray(jc.num_kf))
    np.testing.assert_array_equal(carries.num_loops.numpy(),
                                  np.asarray(jc.num_loops))
    np.testing.assert_allclose(carries.poses.numpy(), np.asarray(jc.poses),
                               atol=1e-4)
    for r, f in enumerate(fs):
        c1, o1 = slam_scan(KeyframeInput(**{k: _t(v) for k, v in f.items()}),
                           p, dims)
        assert torch.equal(carries.poses[r], c1.poses)
        assert torch.equal(carries.graph.f_z[r], c1.graph.f_z)
        assert torch.equal(outputs.pose[r], o1.pose)


def _scene_summary(rng, world, poses, pose_error, robot, N=96):
    """Candidate summaries of keyframes at ``poses`` seeing ``world``: the
    points within 12 m in each keyframe's frame, with 2 cm noise, padded to
    N; the summary pose is the true pose composed with ``pose_error``."""
    P = len(poses)
    pts = np.zeros((P, N, 2), np.float32)
    msk = np.zeros((P, N), bool)
    for i, p in enumerate(poses):
        local = np.asarray(j_transform(jnp.asarray(world),
                                       j_inverse(jnp.asarray(p))))
        near = local[np.linalg.norm(local, axis=1) < 12.0][:N]
        pts[i, :len(near)] = near + rng.normal(scale=0.02, size=near.shape)
        msk[i, :len(near)] = True
    est = np.stack([np.asarray(j_compose(jnp.asarray(p), jnp.asarray(pose_error)))
                    for p in poses]).astype(np.float32)
    return jmr.KeyframeSummary(
        robot_id=jnp.full((P,), robot, jnp.int32),
        key=jnp.arange(P, dtype=jnp.int32), pose=jnp.asarray(est),
        cov=jnp.tile(jnp.eye(3, dtype=jnp.float32)[None] * 0.01, (P, 1, 1)),
        points=jnp.asarray(pts), pmask=jnp.asarray(msk))


def test_propose_interrobot_loops_3x3():
    rng = np.random.default_rng(5)
    # a walled basin with two inner walls, sampled every 0.25 m
    segs = [((-10, -10), (10, -10)), ((10, -10), (10, 10)),
            ((10, 10), (-10, 10)), ((-10, 10), (-10, -10)),
            ((-4, -10), (-4, 2)), ((3, 4), (10, 4))]
    world = np.concatenate([
        np.linspace(a, b, int(np.hypot(b[0] - a[0], b[1] - a[1]) / 0.25))
        for a, b in segs]).astype(np.float32)
    a_poses = np.array([[0, -6, 0], [4, -6, 0.5], [6, 0, 1.5]], np.float32)
    b_poses = np.array([[0.6, -5.5, 0.1], [5, 1, 1.4], [-7, 7, -2.0]],
                       np.float32)
    own = _scene_summary(rng, world, a_poses, [0, 0, 0], 0)
    other = _scene_summary(rng, world, b_poses, [0.4, -0.3, 0.05], 1)
    sobol = sobol_unit_samples(64)
    bounds = np.array([2.0, 2.0, 0.4], np.float32)
    kw = dict(point_noise=0.5, min_overlap=30)
    jicp = JICP(min_diff_rot=1e-3, min_diff_trans=1e-2, point_to_line=True,
                outlier_max_dist=0.75)
    jtf, jok, jov = jmr.propose_interrobot_loops(
        own, other, jnp.asarray(sobol), jnp.asarray(bounds), icp_config=jicp,
        **kw)
    tf, ok, ov = tmr.propose_interrobot_loops(
        summary_from_reference(_np(own), "cpu"),
        summary_from_reference(_np(other), "cpu"), _t(sobol), _t(bounds),
        icp_config=ICPConfig(**jicp._asdict()), **kw)
    assert tf.shape == (3, 3, 3) and ok.shape == ov.shape == (3, 3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    okn = ok.numpy()
    assert 0 < okn.sum() < okn.size
    np.testing.assert_allclose(tf.numpy()[okn], np.asarray(jtf)[okn], atol=1e-4)


# ----------------------------------------------------------------------
# the CLI against the script
# ----------------------------------------------------------------------


def _summary(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    nums = {}
    m = re.search(r"keyframes=\[(\d+), (\d+)\], loops=\[(\d+), (\d+)\]", out)
    nums["keyframes"], nums["loops"] = m.groups()[:2], m.groups()[2:]
    nums["proposals"] = re.search(r"proposals: (\d+)/64", out).group(1)
    m = re.search(r"PCM: accepted (\d+)/(\d+) proposals \(clique size (\d+)\)",
                  out)
    nums["pcm"] = m.groups()
    nums["ate_cm"] = float(re.search(r"joint-aligned ATE ([\d.]+) cm",
                                     out).group(1))
    nums["lines"] = [ln.split()[0] for ln in out.splitlines()]
    return nums


def test_cli_two_robot_demo_against_the_script(cli_procs):
    port, ref = _summary(cli_procs["port"]), _summary(cli_procs["jax"])
    assert port["lines"] == ref["lines"]
    for key in ("keyframes", "loops", "proposals", "pcm"):
        assert port[key] == ref[key], key
    assert int(port["proposals"]) > 0 and int(port["pcm"][0]) > 0
    assert abs(port["ate_cm"] - ref["ate_cm"]) <= 1.0


# ----------------------------------------------------------------------
# probes of the gaps quoted above (run as a script, not collected)
# ----------------------------------------------------------------------


def jax_frames(bag, params, dims):
    """The JAX scripts' keyframe inputs (scripts/two_robot_demo.py and
    scripts/sweep.py build them alike): (KeyframeInput, keyframe pings)."""
    from sonar_slam_tpu.estimators import DRConfig, dead_reckoning_scan
    from sonar_slam_tpu.geometry import pose3_to_pose2
    from sonar_slam_tpu.io.dataset import (SensorStreams, build_dr_ticks,
                                           match_pings_to_ticks)
    from sonar_slam_tpu.slam import FeatureConfig, FeatureExtractor
    from sonar_slam_tpu.slam.core import select_keyframes

    bundle = build_dr_ticks(SensorStreams(
        bag.imu_time, bag.imu_rpy, bag.dvl_time, bag.dvl_vel, bag.depth_time,
        bag.depth))
    tick_idx, sync_ok = match_pings_to_ticks(bag.ping_time, bundle.tick_time)
    _, dr3 = dead_reckoning_scan(bundle.ticks, DRConfig(roll_offset=0.0))
    ping_dr3 = dr3[tick_idx]
    kf = np.asarray(select_keyframes(jnp.asarray(bag.ping_time),
                                     pose3_to_pose2(ping_dr3),
                                     jnp.asarray(sync_ok), params))
    K = dims.max_keyframes
    kf_idx = np.nonzero(kf)[0][:K]
    valid = np.arange(K) < len(kf_idx)
    sel = np.concatenate([kf_idx, np.zeros(K - len(kf_idx), np.int64)])
    pts, masks = FeatureExtractor(FeatureConfig(max_points=dims.max_points),
                                  bag.geometry).extract_batch(
        jnp.asarray(bag.ping_images[sel]))
    return JKI(time=jnp.asarray(bag.ping_time[sel], jnp.float32),
               dr_pose3=ping_dr3[sel], points=pts,
               pmask=masks & jnp.asarray(valid)[:, None],
               valid=jnp.asarray(valid)), kf_idx


def port_frame(jf, k):
    """Keyframe k of a JAX KeyframeInput as the port's single frame."""
    from sonar_slam_torch.slam import core as tcore

    return tcore.KeyframeInput(
        time=_t(jf.time[k]), dr_pose3=_t(jf.dr_pose3[k]),
        points=_t(jf.points[k]), pmask=_t(jf.pmask[k]), valid=True,
        conf=None if jf.conf is None else _t(jf.conf[k]))


def step_trace(jf, jparams, jdims, basis=None):
    """The port's ``keyframe_step`` from the JAX carry after k keyframes,
    against the JAX carry after k + 1, for every k: prints the largest pose
    gap and the loop counts. Returns (the JAX carries, the first k whose gap
    passes 1e-4 m or None)."""
    from sonar_slam_tpu.slam.core import slam_scan as jscan

    from sonar_slam_torch.convert import carry_from_reference
    from sonar_slam_torch.slam import core as tcore

    run = jax.jit(lambda f: jscan(f, jparams, jdims, basis))
    n = int(np.asarray(jf.valid).sum())
    carries = [_np(run(jf._replace(valid=jnp.arange(jdims.max_keyframes) < k)))
               for k in range(n + 1)]
    p, d = params_from_reference(_np(jparams), "cpu"), dims_from_reference(jdims)
    first = None
    for k in range(n):
        c, _ = tcore.keyframe_step(carry_from_reference(carries[k][0], "cpu"),
                                   port_frame(jf, k), p, d)
        ref = carries[k + 1][0]
        gap = np.abs(c.poses.numpy() - ref.poses).max()
        if first is None and gap > 1e-4:
            first = k
        print(f"keyframe {k}: max |dpose| {gap:.2e}, loops {c.num_loops} / "
              f"JAX {int(ref.num_loops)}", flush=True)
    return carries, first


def multistart_gap(jf, jparams, jdims, carries, k):
    """At keyframe k's NSSM: the port's multi-start ICP inputs (from the JAX
    carry) through both packages' ``icp_multistart``, each start's gap, and
    the JAX package's own move of each parting start under a 1e-6 change to
    its guess along each axis."""
    import sonar_slam_tpu.cloud as jcl

    from sonar_slam_torch.convert import carry_from_reference
    from sonar_slam_torch.slam import core as tcore

    seen = []
    orig = tcore.icp_multistart

    def spy(*a, **kw):
        seen.append(a)
        return orig(*a, **kw)

    tcore.icp_multistart = spy
    try:
        tcore.keyframe_step(carry_from_reference(carries[k][0], "cpu"),
                            port_frame(jf, k),
                            params_from_reference(_np(jparams), "cpu"),
                            dims_from_reference(jdims))
    finally:
        tcore.icp_multistart = orig
    a = seen[-1]
    J = [None if x is None else jnp.asarray(x.numpy()) for x in a[:6] + a[7:]]
    t_res = orig(*a)
    j_res = jcl.icp_multistart(*J[:6], jdims.icp, *J[6:])
    gaps = np.abs(np.asarray(j_res.pose) - t_res.pose.numpy()).max(axis=1)
    print(f"keyframe {k}: {len(gaps)} starts, per-start gap {np.round(gaps, 7)}")
    from sonar_slam_tpu.slam.scan_matching import estimate_pose_covariance

    mu_j = np.asarray(estimate_pose_covariance(j_res.pose, j_res.ok)[0])
    mu_t = np.asarray(estimate_pose_covariance(
        jnp.asarray(t_res.pose.numpy()), jnp.asarray(t_res.ok.numpy()))[0])
    print(f"  JAX robust mean of the JAX starts and of the port's starts: "
          f"{np.abs(mu_j - mu_t).max():.2e} apart")
    for s in np.nonzero(gaps > 1e-4)[0]:
        base = jcl.icp(J[0], J[1], J[2], J[3], J[4][s], jdims.icp, *J[6:])
        moves = []
        for e in np.concatenate([np.eye(3), -np.eye(3)]) * 1e-6:
            r = jcl.icp(J[0], J[1], J[2], J[3],
                        J[4][s] + jnp.asarray(e, jnp.float32), jdims.icp,
                        *J[6:])
            moves.append(float(np.abs(np.asarray(r.pose)
                                      - np.asarray(base.pose)).max()))
        print(f"  start {s}: JAX moves {np.round(moves, 7)} under 1e-6 guess "
              "changes (+x, +y, +theta, -x, -y, -theta)", flush=True)


def _robot_a_probe(duration):
    """Robot A of the two-robot demo: the per-keyframe trace, the parting
    NSSM keyframes' multi-start ICP, and the whole scan's ATE under JAX
    (jit and shard_map), JAX with the DVL moved by 1e-6 m/s, and the port."""
    from sonar_slam_tpu.io.simulate import SimConfig, simulate_bag
    from sonar_slam_tpu.pipeline import ate_rmse
    from sonar_slam_tpu.slam.core import slam_scan as jscan

    sim = SimConfig(duration=duration, speed=0.5, sonar_rate=1.0,
                    num_ranges=192, num_bearings=96, loop_radius=10.0,
                    imu_rate=20.0, world_seed=42, seed=1, phase=0.0)
    bag = simulate_bag(sim)
    jdims = JDims(max_keyframes=32, max_points=128, target_capacity=512,
                  nssm_cov_samples=12, ssm_sobol=64, nssm_sobol=128,
                  max_loops=16, gn_iters=3,
                  icp=JICP(min_diff_rot=1e-3, min_diff_trans=1e-2))
    jp = JParams.default(jdims)._replace(
        keyframe_translation=jnp.float32(2.0),
        ssm_min_points=jnp.asarray(20, jnp.int32),
        nssm_min_points=jnp.asarray(20, jnp.int32),
        fuse_odometry=jnp.asarray(True),
        odom_sigmas=jnp.asarray([0.05, 0.05, 0.01], jnp.float32),
        icp_odom_sigmas=jnp.asarray([0.3, 0.3, 0.03], jnp.float32))
    jf, kf_idx = jax_frames(bag, jp, jdims)
    truth = bag.true_pose_at_ping[kf_idx]
    carries, _ = step_trace(jf, jp, jdims)
    nk = len(kf_idx)

    def ate(poses):
        return ate_rmse(np.asarray(poses)[:nk], truth[:nk])

    jit = _np(jax.jit(lambda f: jscan(f, jp, jdims))(jf)[0])
    sm = _np(jmr.multi_robot_scan(jax.tree.map(lambda x: jnp.stack([x, x]), jf),
                                  jp, jdims,
                                  make_config_mesh(2, axis="robot"))[0])
    moved, _ = jax_frames(bag._replace(dvl_vel=bag.dvl_vel + np.float32(1e-6)),
                          jp, jdims)
    dvl = _np(jax.jit(lambda f: jscan(f, jp, jdims))(moved)[0])
    port, _ = slam_scan(KeyframeInput(*(_t(x) for x in jf[:5])),
                        params_from_reference(_np(jp), "cpu"),
                        dims_from_reference(jdims))
    print(f"robot A, {duration:.0f} s: ATE JAX jit {ate(jit.poses):.5f}, JAX "
          f"shard_map {ate(sm.poses[0]):.5f}, JAX DVL + 1e-6 m/s "
          f"{ate(dvl.poses):.5f} (moved {np.abs(dvl.poses - jit.poses)[:nk].max():.2e} m), "
          f"port {ate(port.poses):.5f}")
    for k in range(nk):
        if int(carries[k + 1][0].num_loops) > int(carries[k][0].num_loops):
            multistart_gap(jf, jp, jdims, carries, k)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_multi_robot.py [duration]
    jax.config.update("jax_platforms", "cpu")
    _robot_a_probe(float(sys.argv[1]) if len(sys.argv) > 1 else 75.0)
