"""``python -m sonar_slam_torch.cli.replay --cpu`` against the JAX package's
``scripts/replay.py --cpu`` on the same small bundle, with
``--max-keyframes 32 --intensity --save-submaps`` and the default YAML
configuration.

The bundle is a 40 s survey of 96 x 48 pings around a 2.5 m loop (seed 2):
13 keyframes and 4 loops in both packages. Its loops are ill-conditioned in
the reference algorithm: adding 1e-6 m/s to every DVL sample (1.5e-5 m of
odometry) moves the JAX CLI's own trajectory by 2.6e-3 m, and lands it within
1.8e-4 m of the port's. So:

* keyframe times, loop pairs, the feature masks and the submap log-odds are
  equal (the clouds within 4e-6 m);
* trajectory and ``states`` poses within 5e-3 m (measured 2.6e-3 m), the
  odometry within 1e-5 m, the refreshed covariances within 1e-5;
* the maps, built through the two trajectories, differ in the cells the
  2.6 mm moves: at most 2% of the observed cells of ``occ`` and
  ``intensity`` (measured 368 of 30,444 and 450 of 37,699, 1.2%);
* the port's mapping stage fed the JAX CLI's own carry and trajectory gives
  the JAX ``occupancy.npz`` exactly, ``occ`` and ``intensity``; its grid
  built keyframe by keyframe gives the method-1 map of a full repaint but
  for at most 0.2% of the observed cells (measured none here; 6 cells of
  31,136 on a 192 x 96 survey, ``test_torch_occupancy.py``'s kind of case).

Where the two part first: given the JAX scan's carry after each keyframe,
the port's next step lands within 3.1e-6 m of the JAX one up to keyframe 10,
the first with a loop, where it parts by 8.9e-4 m. The suspect was a tie in
the sequential match's Sobol costs; there is none to pin: at keyframe 10 the
SSM's 65 costs are equal in both packages (the best, -69, tied two ways,
and both take the first, sample 0), and the NSSM's 513 costs are equal but
for two samples a count apart (points on the ``point_noise`` gate), with
one best sample, the same in both (277). The step parts in the NSSM's 30
multi-start ICP runs: 26 agree within 3e-6 m, 4 part by 3.2e-3 to 3.0e-2
m, and the JAX package's own ICP moves three of those (starts 8, 20 and 25)
by 3.2e-3 to 5.4e-3 m when their guesses move by 1e-6 (correspondences on
the trim boundary). ``PYTHONPATH=.:tests python tests/test_torch_cli.py``
prints this trace.

Both CLIs run at once in subprocesses (about 75-120 s of wall time); the port's
keeps freed memory in glibc's heap (``MALLOC_MMAP_MAX_=0``), which halves its
time on the CPU, where the scan's 256 MB temporaries are otherwise mapped
and faulted in anew on every call.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sonar_slam_torch.cli.replay import load_npz_bag
from sonar_slam_torch.cli.simulate_bag import write_bundle
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag
from sonar_slam_torch.io.state import (
    STATE_DTYPE,
    load_checkpoint,
    load_reference_checkpoint,
)
from sonar_slam_torch.mapping import (
    MappingConfig,
    SubmapModel,
    add_keyframe,
    intensity_grid,
    mapping_init,
    occupancy_grid_method1,
    render_global_logodds,
    submap_intensity,
)
from sonar_slam_torch.slam.core import slam_init

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = SimConfig(duration=40.0, speed=0.5, sonar_rate=1.0, num_ranges=96,
                num_bearings=48, loop_radius=2.5, imu_rate=20.0, seed=2)
FLAGS = ["--cpu", "--max-keyframes", "32", "--intensity", "--save-submaps"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    bundle = str(root / "survey.npz")
    write_bundle(bundle, simulate_bag(SIM))
    jax_out, port_out = str(root / "jax"), str(root / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "replay.py"),
             "--file", bundle, "--out", jax_out] + FLAGS,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env),
        subprocess.Popen(
            [sys.executable, "-m", "sonar_slam_torch.cli.replay",
             "--file", bundle, "--out", port_out] + FLAGS,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=dict(env, OMP_NUM_THREADS="1", MALLOC_MMAP_MAX_="0",
                     MALLOC_TRIM_THRESHOLD_=str(1 << 36))),
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return dict(bundle=bundle, jax=jax_out, port=port_out, logs=logs)


def _load(d, name):
    return np.load(os.path.join(d, name))


def test_same_files_and_keys(runs):
    names = sorted(os.path.basename(p) for p in glob.glob(runs["jax"] + "/*"))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(runs["port"] + "/*"))
    assert names == ["occupancy.npz", "slam_carry.npz", "step-12-submaps.npz",
                     "trajectory.npz"]
    for name in names[:1] + names[2:]:
        a, b = _load(runs["jax"], name), _load(runs["port"], name)
        assert sorted(a.files) == sorted(b.files), name
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
    # the summary line, as the JAX CLI logs it
    summary = [ln for ln in runs["logs"][1].splitlines() if "keyframes," in ln]
    assert summary and "13 keyframes, 4 loops" in summary[0]
    assert any("stages s" in ln for ln in runs["logs"][1].splitlines())


def test_keyframes_loops_trajectory_and_states(runs):
    a, b = _load(runs["jax"], "trajectory.npz"), _load(runs["port"], "trajectory.npz")
    np.testing.assert_array_equal(b["keyframe_times"], a["keyframe_times"])
    assert len(b["keyframe_times"]) == 13
    np.testing.assert_array_equal(b["loops_i"], a["loops_i"])
    np.testing.assert_array_equal(b["loops_j"], a["loops_j"])
    assert len(b["loops_j"]) == 4
    np.testing.assert_allclose(b["trajectory"], a["trajectory"], atol=5e-3)
    np.testing.assert_allclose(b["dr_trajectory"], a["dr_trajectory"], atol=1e-5)
    s, t = b["states"], a["states"]
    assert s.dtype == t.dtype == STATE_DTYPE
    np.testing.assert_array_equal(s["time"], t["time"])
    np.testing.assert_allclose(s["pose"], t["pose"], atol=5e-3)
    np.testing.assert_allclose(s["dr_pose3"], t["dr_pose3"], atol=1e-5)
    np.testing.assert_allclose(s["cov"], t["cov"], atol=1e-5)


def test_maps(runs):
    a, b = _load(runs["jax"], "occupancy.npz"), _load(runs["port"], "occupancy.npz")
    for key in ("occ", "intensity"):
        observed = (a[key] != (50 if key == "occ" else -1)).sum()
        differ = (a[key] != b[key]).sum()
        assert differ <= 0.02 * observed, (key, differ, observed)
    sa = _load(runs["jax"], "step-12-submaps.npz")
    sb = _load(runs["port"], "step-12-submaps.npz")
    np.testing.assert_array_equal(sb["logodds"], sa["logodds"])
    np.testing.assert_array_equal(sb["cell_xy"], sa["cell_xy"])
    np.testing.assert_array_equal(sb["map_size"], sa["map_size"])
    np.testing.assert_allclose(sb["poses"], sa["poses"], atol=5e-3)


def test_mapping_stage_on_the_jax_result(runs):
    """The port's add_keyframe, method 1 and intensity grid over the JAX
    CLI's own carry and trajectory give the JAX CLI's maps exactly."""
    carry = load_reference_checkpoint(
        os.path.join(runs["jax"], "slam_carry.npz"), "cpu")
    traj = _load(runs["jax"], "trajectory.npz")
    bag = load_npz_bag(runs["bundle"], 0.0, 0.0)
    ping_idx = np.searchsorted(bag.ping_time, traj["keyframe_times"])
    cfg = MappingConfig(max_keyframes=32)
    model = SubmapModel(cfg, bag.geometry, "cpu")
    st = mapping_init(cfg, model)
    kf_int = torch.zeros((32, model.sonar_xy.shape[0]))
    for k in range(len(ping_idx)):
        st = add_keyframe(st, k, traj["trajectory"][k], carry.points[k],
                          carry.pmasks[k], model)
        kf_int[k] = submap_intensity(torch.as_tensor(bag.ping_images[ping_idx[k]]),
                                     model)
    want = _load(runs["jax"], "occupancy.npz")
    np.testing.assert_array_equal(occupancy_grid_method1(st, model).numpy(),
                                  want["occ"])
    np.testing.assert_array_equal(intensity_grid(st, model, kf_int).numpy(),
                                  want["intensity"])
    # the grid built keyframe by keyframe against a full repaint: the cells
    # a point on a rounding boundary moves (each keyframe's are divided
    # exactly in the one, by the reciprocal in the other)
    full = occupancy_grid_method1(
        st._replace(grid=render_global_logodds(st, model)), model).numpy()
    observed = (want["occ"] != 50).sum()
    assert (full != want["occ"]).sum() <= 0.002 * observed


def test_carry_checkpoint_reloads(runs):
    from sonar_slam_torch.io.config import load_slam_config

    _, dims, _ = load_slam_config(dims_overrides={"max_keyframes": 32},
                                  device="cpu")
    carry = load_checkpoint(os.path.join(runs["port"], "slam_carry.npz"),
                            slam_init(dims, "cpu"))
    traj = _load(runs["port"], "trajectory.npz")
    assert carry.num_kf == 13 and carry.num_loops == 4
    np.testing.assert_array_equal(carry.poses[:13].numpy(), traj["trajectory"])
    ref = load_reference_checkpoint(os.path.join(runs["jax"], "slam_carry.npz"),
                                    "cpu")
    np.testing.assert_array_equal(carry.pmasks.numpy(), ref.pmasks.numpy())
    # sub-bin peak refinement rounds differently (within 4e-6 m)
    np.testing.assert_allclose(carry.points.numpy(), ref.points.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("module", ["replay", "convert_bag", "simulate_bag",
                                    "sweep", "two_robot_demo",
                                    "sharded_replay"])
def test_help(module):
    r = subprocess.run([sys.executable, "-m", f"sonar_slam_torch.cli.{module}",
                        "--help"], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0 and "usage" in r.stdout, r.stderr


def test_replay_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    r = subprocess.run([sys.executable, "-m", "sonar_slam_torch.cli.replay",
                        "--simulate", "--duration", "5", "--out",
                        str(tmp_path / "out")],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("module", ["sweep", "two_robot_demo",
                                    "sharded_replay"])
def test_parallel_clis_refuse_to_run_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    r = subprocess.run([sys.executable, "-m", f"sonar_slam_torch.cli.{module}",
                        "--duration", "5"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr


def _first_parting_keyframe_probe(path):
    """Where the two CLIs part on this survey: the JAX scan's carry after
    every keyframe against the port's step from it, then at the first
    keyframe that parts by more than 1e-4 m, each Sobol search's cost vector
    in both packages on the port's inputs (differing samples, the best cost,
    its ties, the chosen sample) and the multi-start ICP's starts."""
    import jax
    import jax.numpy as jnp
    import sonar_slam_tpu.pipeline as jpipe
    import sonar_slam_tpu.slam.scan_matching as jsm
    from sonar_slam_tpu.io.config import load_feature_config, load_slam_config

    from sonar_slam_torch.convert import (carry_from_reference,
                                          dims_from_reference,
                                          params_from_reference)
    from sonar_slam_torch.slam import core as tcore
    from sonar_slam_torch.slam import scan_matching as tsm
    from test_torch_multi_robot import multistart_gap, port_frame, step_trace

    jax.config.update("jax_platforms", "cpu")
    write_bundle(path, simulate_bag(SIM))
    bag = load_npz_bag(path, 0.0, 0.0)
    params, dims, _ = load_slam_config(dims_overrides={"max_keyframes": 32})
    seen = {}
    orig = jpipe.slam_scan

    def spy(frames, p, d, basis=None):
        seen["args"] = (frames, basis)
        return orig(frames, p, d, basis)

    jpipe.slam_scan = spy
    jpipe.replay(bag, load_feature_config(max_points=dims.max_points), params,
                 dims)
    jf, basis = seen["args"]
    carries, k = step_trace(jf, params, dims, basis)
    calls = []
    orig_gi = tcore.global_initialize

    def gi_spy(*a):
        calls.append(a)
        return orig_gi(*a)

    tcore.global_initialize = gi_spy
    try:
        tcore.keyframe_step(
            carry_from_reference(carries[k][0], "cpu"), port_frame(jf, k),
            params_from_reference(jax.tree.map(np.asarray, params), "cpu"),
            dims_from_reference(dims))
    finally:
        tcore.global_initialize = orig_gi
    for name, a in zip(("SSM", "NSSM"), calls):
        deltas = torch.cat([torch.zeros(1, 3), (2 * a[7] - 1) * a[6][None]])
        tc, _ = tsm.match_count_costs(*a[:6], deltas, a[8])
        jc, _ = jsm.match_count_costs(
            *(jnp.asarray(x.numpy()) for x in a[:6]), jnp.asarray(deltas.numpy()),
            jnp.asarray(a[8], jnp.float32))
        tc, jc = tc.numpy(), np.asarray(jc)
        diff = np.nonzero(tc != jc)[0]
        print(f"keyframe {k} {name}: {len(tc)} samples, {len(diff)} costs "
              f"differ ({[(int(i), float(tc[i]), float(jc[i])) for i in diff]}), "
              f"best {tc.min()} / JAX {jc.min()}, tied {(tc == tc.min()).sum()} "
              f"/ {(jc == jc.min()).sum()}, chosen sample "
              f"{int(np.argsort(tc, kind='stable')[0])} / "
              f"{int(np.argsort(jc, kind='stable')[0])}", flush=True)
    multistart_gap(jf, params, dims, carries, k)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_cli.py
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _first_parting_keyframe_probe(os.path.join(tmp, "survey.npz"))
