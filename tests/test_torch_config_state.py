"""The YAML loaders, the state export and the utilities: the port against the
JAX package.

The cases of ``tests/test_config_state.py``, on the port, and beside them:

* the port's YAML reader gives ``yaml.safe_load``'s value for each of the
  seven files and for a set of documents covering the subset it reads;
* each loader gives the JAX loader's values field by field (tensors equal to
  the JAX arrays bit for bit), and ``KalmanConfig.default`` equals
  ``load_kalman_config()``;
* ``get_states`` with the covariances refreshed equals the JAX export within
  float32 rounding (the marginals come from one factorization here and one
  per key there).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

import sonar_slam_tpu.io.config as jcfg
import sonar_slam_tpu.io.state as jstate
import sonar_slam_tpu.slam.core as jcore
from sonar_slam_torch.estimators import KalmanConfig
from sonar_slam_torch.io.config import (
    default_path,
    load_dead_reckoning_config,
    load_feature_config,
    load_gyro_config,
    load_icp_config,
    load_kalman_config,
    load_mapping_config,
    load_slam_config,
    load_yaml,
    parse_yaml,
)
from sonar_slam_torch.io.state import STATE_DTYPE, get_states
from sonar_slam_torch.slam.core import SlamDims, SlamParams, slam_init
from sonar_slam_torch.utils import CodeTimer, Streams, timing_report

torch.set_num_threads(1)
CONFIGS = ("dead_reckoning.yaml", "feature.yaml", "gyro.yaml", "icp.yaml",
           "kalman.yaml", "mapping.yaml", "slam.yaml")


def _same(port, ref, name=""):
    """A port value against the JAX one: tensors bit for bit, the rest equal."""
    if isinstance(port, torch.Tensor):
        ref = np.asarray(ref)
        assert port.dtype == torch.float32 and ref.dtype == np.float32, name
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=name)
    elif hasattr(port, "_fields"):
        for f in port._fields:
            _same(getattr(port, f), getattr(ref, f), f"{name}.{f}")
    else:
        assert port == ref or (np.asarray(port) == np.asarray(ref)).all(), name


# ---- the cases of tests/test_config_state.py ----


def test_deg_substitution(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: deg(30)\nnested:\n  b: deg(-90)\nlist: [deg(45), 1.5]\n")
    raw = load_yaml(str(p))
    np.testing.assert_allclose(raw["a"], np.radians(30))
    np.testing.assert_allclose(raw["nested"]["b"], np.radians(-90))
    np.testing.assert_allclose(raw["list"][0], np.radians(45))
    assert raw["list"][1] == 1.5
    assert raw == jcfg.load_yaml(str(p))


def test_icp_config_parses_reference_schema():
    cfg = load_icp_config()
    assert cfg.knn_max_dist == 10.0
    assert cfg.outlier_max_dist == 3.0
    assert cfg.trim_ratio == 0.8
    assert cfg.max_iterations == 40
    assert cfg.min_diff_rot == 0.01
    assert cfg.min_diff_trans == 0.1
    assert cfg.smooth_length == 4
    assert cfg._asdict() == jcfg.load_icp_config()._asdict()


def test_feature_config_defaults():
    cfg = load_feature_config()
    assert (cfg.ntc, cfg.ngc, cfg.pfa, cfg.rank, cfg.alg) == (40, 10, 0.1, 10, "SOCA")
    assert cfg.threshold == 65.0
    assert cfg._asdict() == jcfg.load_feature_config()._asdict()


def test_slam_config_defaults():
    params, dims, icp_path = load_slam_config(device="cpu")
    np.testing.assert_allclose(float(params.keyframe_rotation), np.radians(30))
    np.testing.assert_allclose(params.odom_sigmas.numpy(), [0.2, 0.2, 0.02])
    assert dims.nssm_min_st_sep == 8
    assert dims.nssm_cov_samples == 30
    assert dims.pcm_queue_slots == 6
    assert dims.icp.max_iterations == 40  # pulled through $(find ...) icp.yaml
    assert int(params.min_pcm) == 2
    assert icp_path == default_path("icp.yaml")

    # against the JAX loader, field by field
    jparams, jdims, _ = jcfg.load_slam_config()
    for f in dataclasses.fields(SlamDims):
        want = getattr(jdims, f.name)
        got = getattr(dims, f.name)
        if f.name == "icp":
            assert got._asdict() == want._asdict(), f.name
        else:
            assert got == (tuple(want) if isinstance(want, list) else want), f.name
    for name in SlamParams._fields:
        got, want = getattr(params, name), np.asarray(getattr(jparams, name))
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            assert got == want.item() and type(got)(want) == got, name


def test_dr_gyro_kalman_mapping_configs():
    dr, mount, ver = load_dead_reckoning_config()
    assert dr.dvl_max_velocity == 0.5
    np.testing.assert_allclose(mount, [-np.pi / 2, 0, 0], atol=1e-6)
    jdr, jmount, jver = jcfg.load_dead_reckoning_config()
    assert (dr.dvl_max_velocity, dr.use_gyro, dr.roll_offset) == (
        jdr.dvl_max_velocity, jdr.use_gyro, jdr.roll_offset)
    np.testing.assert_array_equal(mount, jmount)
    assert ver == jver == 1
    g = load_gyro_config(device="cpu")
    assert g.offset_matrix.shape == (3, 3)
    _same(g, jcfg.load_gyro_config(), "gyro")
    k = load_kalman_config(device="cpu")
    assert k.A_imu.shape == (12, 12)
    np.testing.assert_allclose(float(k.A_imu[0, 6]), 0.005, rtol=1e-6)
    _same(k, jcfg.load_kalman_config(), "kalman")
    m = load_mapping_config()
    assert (m.rows, m.cols) == (1000, 1000)
    assert m.hit_prob == 0.8
    assert dataclasses.asdict(m) == dataclasses.asdict(jcfg.load_mapping_config())


def test_get_states_layout():
    dims = SlamDims(max_keyframes=8, max_points=16, target_capacity=32,
                    max_loops=4, pcm_queue_slots=3)
    carry = slam_init(dims, "cpu")
    times = carry.times.clone()
    times[:2] = torch.tensor([100.0, 101.5])
    poses = carry.poses.clone()
    poses[:2] = torch.tensor([[0, 0, 0], [1, 0, 0.1]])
    dr3 = carry.dr_poses3.clone()
    dr3[1] = torch.tensor([1, 0, 2.0, 0, 0, 0.1])
    carry = carry._replace(num_kf=2, times=times, poses=poses, dr_poses3=dr3)
    st = get_states(carry, dims, refresh_covs=False)
    assert st.dtype == STATE_DTYPE == jstate.STATE_DTYPE
    assert len(st) == 2
    np.testing.assert_allclose(st[1]["time"], 1.5, atol=1e-6)
    np.testing.assert_allclose(st[1]["pose"], [1, 0, 0.1], atol=1e-6)
    np.testing.assert_allclose(st[1]["dr_pose3"][2], 2.0)


def test_checkpoint_roundtrip(tmp_path):
    from sonar_slam_torch.io.state import load_checkpoint, save_checkpoint

    dims = SlamDims(max_keyframes=8, max_points=16, target_capacity=32,
                    max_loops=4, pcm_queue_slots=3)
    carry = slam_init(dims, "cpu")
    poses = carry.poses.clone()
    poses[0] = torch.tensor([1.0, 2.0, 0.3])
    carry = carry._replace(num_kf=3, poses=poses)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, carry)
    restored = load_checkpoint(path, slam_init(dims, "cpu"))
    assert restored.num_kf == 3 and type(restored.num_kf) is int
    np.testing.assert_allclose(restored.poses[0].numpy(), [1.0, 2.0, 0.3])
    # whole tree equality, the graph's fields included
    for name in carry._fields:
        a, b = getattr(carry, name), getattr(restored, name)
        for x, y in (zip(a, b) if name == "graph" else [(a, b)]):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), name
            else:
                assert x == y, name


def test_code_timer_accumulates():
    with CodeTimer("test span", silent=True, sync="cpu") as span:
        _ = sum(range(1000))
    rep = timing_report()
    assert "test span" in rep
    assert rep["test span"][1] >= 1
    assert span.took >= 0


def test_streams_registry():
    assert Streams.SONAR_FEATURES != Streams.SLAM_CLOUD


# ---- the YAML reader and the loaders against the JAX package ----


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_reader_matches_pyyaml(name):
    with open(default_path(name)) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)
    raw = load_yaml(default_path(name))
    ref = jcfg.load_yaml(jcfg.default_path(name))
    if name == "slam.yaml":  # $(find pkg) names each package's own copy
        assert raw.pop("icp_config") == default_path("icp.yaml")
        ref.pop("icp_config")
    assert raw == ref


YAML_CASES = {
    "scalars": ("a: 1e-5\nb: 1.0e-5\nc: .5\nd: -.inf\ne: 010\nf: 0x1F\n"
                "g: 'it''s'\nh: \"a\\tb\"\ni: ~\nj:\nk: yes\nl: Off\nm: 1_000\n"
                "n: +3\no: a:b\np: http://x.y/z # comment\nq: True\nr: 0.\n"
                "s: 9.0e-05\nt: -0\nu: null\n"),
    "flow": "a: [1, [2, 3], {k: v, m: [1, 2]}, 'x, y']\nb: {}\nc: []\n"
            "d: {x: 0.0, y: 0.0, z: 45.0}\n",
    "block": ("- a: 1\n  b: 2\n- c:\n    - 1\n    - 2\n-\n  d: 3\n"
              "- - 1\n  - 2\n- - - 3\n    - 4\n  - 5\n"),
    "key-level sequence": "a:\n- x: 1\n  y:\n  - 2\n- z\nb: c\n",
    "anchors": "v:\n- &id001 [0]\n- *id001\nw: &w {a: 1}\nx: *w\n",
    "folded plain": "key: value with spaces\nmulti: first\n  second line\n",
    "comments": "# head\na: 1  # one\n\n  # indented comment\nb: '#not'\n",
}


@pytest.mark.parametrize("name", sorted(YAML_CASES))
def test_yaml_reader_subset(name):
    text = YAML_CASES[name]
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: |\n  x\n", "a: !!str 1\n",
                                  "a: 1\n---\nb: 2\n"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_kalman_default_is_the_yaml():
    _same(KalmanConfig.default("cpu"), load_kalman_config(device="cpu"),
          "kalman")


def test_get_states_refreshed_covariances_match_jax():
    """A small scan's carry exported by both packages: the keyframes'
    marginals from one factorization against the JAX vmap of one per key."""
    from sonar_slam_torch.convert import carry_from_reference

    jdims = jcore.SlamDims(max_keyframes=8, max_points=16, target_capacity=32,
                           max_loops=4, pcm_queue_slots=3)
    jcarry = jcore.slam_init(jdims)
    from sonar_slam_tpu.graph.factor_graph import (add_between, add_prior,
                                                   set_pose_estimate)
    g = jcarry.graph
    sq = jnp.diag(jnp.asarray([10.0, 10.0, 100.0]))
    g = add_prior(g, jnp.zeros(3), sq)
    rng = np.random.default_rng(0)
    poses = np.cumsum(rng.normal(0, 0.5, (4, 3)), 0).astype(np.float32)
    poses[0] = 0
    for k in range(1, 4):
        z = np.asarray(poses[k] - poses[k - 1], np.float32)
        g = add_between(g, k - 1, k, jnp.asarray(z), sq * (1.0 + 0.1 * k))
    for k in range(4):
        g = set_pose_estimate(g, k, jnp.asarray(poses[k]))
    jcarry = jcarry._replace(
        graph=g, num_kf=jnp.asarray(4, jnp.int32),
        poses=jcarry.poses.at[:4].set(jnp.asarray(poses)),
        times=jcarry.times.at[:4].set(jnp.asarray([1.0, 2.0, 3.5, 4.0])))
    ref = jstate.get_states(jcarry, jdims)
    tcarry = carry_from_reference(
        {k: np.asarray(v) if k != "graph" else {
            f: np.asarray(x) for f, x in v._asdict().items()}
         for k, v in jcarry._asdict().items()}, "cpu")
    from sonar_slam_torch.convert import dims_from_reference

    got = get_states(tcarry, dims_from_reference(jdims))
    for name in STATE_DTYPE.names:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-5, atol=1e-7,
                                   err_msg=name)
