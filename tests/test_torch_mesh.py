"""The device axis (``parallel/mesh.py``): SPMD ranks on the CPU, gloo.

One module-scoped ``spawn`` of two CPU ranks runs every case of
:func:`rank_cases` and returns rank 0's results; a second spawn of four
ranks runs only the cheap collectives. The tests below assert on those
results, one case each. Every rank builds its inputs itself from a seed (no
JAX in a rank: this module imports JAX only inside tests and fixtures), but
the ``SlamParams`` and the refinement's carries, which the caller builds
once and passes to the ranks (a rank so never imports SciPy's Sobol
sequence).

* Collectives, at two and four ranks: ``gather(shard(x))`` gives back
  ``x`` leaf for leaf (float, int64, bool and ``None`` leaves);
  ``exchange_keyframes`` of each rank's robots gives the whole table,
  equal to the JAX package's ``exchange_keyframes`` on its 8-device CPU
  mesh (tests/test_parallel.py's 4-robot case).
* The keyframe axis (tests/test_parallel.py's K 16, N 32, W 3 case): the
  three sharded functions and ``kf_sharding`` equal the port's unsharded
  calls exactly (the per-keyframe arithmetic is the same), and the JAX mesh
  functions as tests/test_torch_parallel.py holds the unsharded ones (the
  gate's mask, counts and target exactly, the transform within 1e-5 m).
* Scans, against the port's own one-process call on the same inputs (the
  existing files hold that call to JAX): ``sweep_scan`` over 8 lanes
  ``vary(point_noise=[0.3, 0.4, 0.5, 0.6] * 2)`` and ``multi_robot_scan``
  over two robots, each rank scanning its block; poses within 1e-6 m / rad,
  other floats within 1e-4 relative, integer and bool leaves equal (on the
  CPU a lane's rounding follows its position among the lanes,
  tests/test_torch_sweep_lanes.py); the sweep's lanes 0/4 and 1/5 (equal
  parameters on different ranks) within 1e-5 as tests/test_parallel.py
  asks.
* ``refine_loops`` on tests/test_torch_refine.py's corridor case (the
  carry built by the JAX package's tests/test_refine.py and converted),
  with the sweep alone (as tests/test_refine.py's mesh test) and with every
  pass: within 1e-5 m of the port's one-process call with the same loop
  count (the JAX script's bound), which tests/test_torch_refine_loops.py
  holds to JAX on this carry; the sweep alone is also held to the JAX
  package's ``refine_loops`` on a two-device mesh as that file holds the
  one-process calls to each other.
* Failures: every axis that the mesh size does not divide raises
  ValueError before any work (a mesh value of three ranks needs no
  process), as do a wrong axis name, the CLIs' ``--devices`` and
  ``cli.sharded_replay --check`` on one rank; a refinement fan-out whose
  lanes differ between ranks (by count, or by index at the same count)
  raises on every rank; a rank that raises makes ``spawn`` raise; a world
  that outlives its limit makes it raise TimeoutError. Every spawn has a
  time limit.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch.cloud import ICPConfig
from sonar_slam_torch.geometry import se2_inverse, se2_transform_points
from sonar_slam_torch.parallel import (exchange_keyframes, kf_sharding,
                                       make_config_mesh, stack_params,
                                       sweep_scan)
from sonar_slam_torch.parallel import keyframe_shard as tks
from sonar_slam_torch.parallel.mesh import Mesh, gather, shard, spawn
from sonar_slam_torch.parallel.multi_robot import (KeyframeSummary,
                                                   multi_robot_scan)
from sonar_slam_torch.parallel.sweep import vary
from sonar_slam_torch.pipeline import replay
from sonar_slam_torch.slam import (FeatureConfig, KeyframeInput, SlamDims,
                                   SlamParams, refine_loops)
from sonar_slam_torch.slam.refine import _lane_map

torch.set_num_threads(1)
SPAWN_TIMEOUT_S = 300.0

# tests/test_parallel.py's dimensions
DIMS = SlamDims(
    max_keyframes=8, max_points=32, target_capacity=64, nssm_min_st_sep=4,
    nssm_source_frames=2, ssm_target_frames=2, nssm_cov_samples=4,
    ssm_sobol=16, nssm_sobol=16, max_loops=4, gn_iters=2, pcm_queue_slots=3,
    icp=ICPConfig(max_iterations=6))
REFINE_PASSES = {
    "sweep": dict(refine_sweep=True),
    "every_pass": dict(refine_sweep=True, refine_chain=True,
                       refine_incremental=True, refine_final_sweep=True),
}
GATE_ARGS = ("points", "pmasks", "poses", "tgt_ok", "src_poses", "src_covs",
             "src_ok")


def to(tree, device):
    """Every tensor of a (Named)tuple tree on ``device``."""
    if isinstance(tree, tuple):
        return type(tree)(*(to(x, device) for x in tree))
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def stream(n=6, seed=17):
    """tests/test_parallel.py's keyframe stream (random clouds) from a fresh
    generator, as a KeyframeInput."""
    rng = np.random.default_rng(seed)
    K, N = DIMS.max_keyframes, DIMS.max_points
    pts = rng.uniform(0, 15, size=(K, N, 2)).astype(np.float32)
    dr = np.zeros((K, 6), np.float32)
    dr[:, 0] = np.arange(K) * 1.5
    valid = np.arange(K) < n
    return KeyframeInput(
        time=torch.as_tensor((np.arange(K) * 2.0).astype(np.float32)),
        dr_pose3=torch.as_tensor(dr), points=torch.as_tensor(pts),
        pmask=torch.as_tensor(np.ones((K, N), bool) & valid[:, None]),
        valid=torch.as_tensor(valid))


def base_params():
    """tests/test_parallel.py's small_params."""
    return SlamParams.default(DIMS, "cpu")._replace(
        keyframe_translation=1.0, ssm_min_points=5, nssm_min_points=5)


def sweep_lanes():
    return stack_params(vary(base_params(),
                             point_noise=[0.3, 0.4, 0.5, 0.6] * 2))


def robot_streams():
    """Two robots' streams (6 and 5 keyframes), stacked on the robot axis."""
    a, b = stream(6, 17), stream(5, 18)
    return KeyframeInput(*(None if x is None else torch.stack([x, y])
                           for x, y in zip(a, b)))


def summary_case(n=4, N=64):
    """tests/test_parallel.py's 4-robot exchange case: every robot sees the
    same structure from its own pose."""
    rng = np.random.default_rng(0)
    base = torch.as_tensor(rng.uniform(0, 10, size=(N, 2)).astype(np.float32))
    poses = torch.tensor([[0, 0, 0], [1.0, 0.5, 0.1], [8.0, -2.0, 0.4],
                          [0.2, 0.1, 0.0]], dtype=torch.float32)[:n]
    return KeyframeSummary(
        robot_id=torch.arange(n), key=torch.zeros(n, dtype=torch.int64),
        pose=poses, cov=torch.eye(3).expand(n, 3, 3).clone(),
        points=torch.stack([se2_transform_points(base, se2_inverse(p))
                            for p in poses]),
        pmask=torch.ones((n, N), dtype=torch.bool))


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


def kf_calls(c, mesh=None):
    """The three keyframe-axis functions on ``kf_case``'s arrays."""
    args = [torch.as_tensor(c[k]) for k in GATE_ARGS]
    gate = (c["max_range"], c["half_ap"])
    return {
        "transform": tks.transform_clouds_sharded(args[0], args[2], mesh),
        "gate": tks.nssm_gate_sharded(*args, *gate, mesh=mesh),
        "select": tks.nssm_target_select_sharded(*args, *gate, mesh=mesh),
    }


# ---------------------------------------------------------------------------
# the cases, run on every rank of a spawn


def _collectives(mesh):
    robot = make_config_mesh(axis="robot", cpu=True)
    frames = stream()
    try:
        make_config_mesh(mesh.size + 1, cpu=True)
        wrong_size = None
    except ValueError as e:
        wrong_size = str(e)
    return {"exchange": exchange_keyframes(shard(summary_case(), robot),
                                           robot),
            "frames": gather(shard(frames, mesh), mesh),
            "wrong_size": wrong_size}


def _lanes_disagree(mesh):
    """A refinement fan-out whose lanes agree, and two whose lanes differ on
    the last rank (one lane more; the same count, other indices): the
    lanes' doubled values, or the error raised."""
    last = int(mesh.rank == mesh.size - 1)
    out = {}
    for how, lanes in (("same", torch.arange(6)),
                       ("count", torch.arange(6 + last)),
                       ("index", torch.arange(6) + last)):
        try:
            out[how] = _lane_map(lambda k: (2 * k,), (lanes,), mesh)[0]
        except RuntimeError as e:
            out[how] = str(e)
    return out


def _keyframe_shard(mesh):
    kf = make_config_mesh(axis="kf", cpu=True)
    c = kf_case()
    out = kf_calls(c, kf)
    out["block"] = kf_sharding(kf)(torch.as_tensor(c["points"]))
    return out


def _sweep(mesh, inputs):
    lanes = stack_params(vary(inputs["params"],
                              point_noise=[0.3, 0.4, 0.5, 0.6] * 2))
    out = {"mesh": sweep_scan(stream(), lanes, DIMS, mesh)}
    if mesh.rank == 0:
        out["one"] = sweep_scan(stream(), lanes, DIMS)
    return out


def _robots(mesh, inputs):
    robot = make_config_mesh(axis="robot", cpu=True)
    params = inputs["params"]
    out = {"mesh": multi_robot_scan(robot_streams(), params, DIMS, robot)}
    if mesh.rank == 0:
        out["one"] = multi_robot_scan(robot_streams(), params, DIMS)
    return out


def _refine(passes):
    def run(mesh, inputs):
        carry, params, rp, dims = inputs[passes]
        out = {"mesh": refine_loops(carry, params, rp, dims, mesh=mesh)}
        if mesh.rank == 0:
            out["one"] = refine_loops(carry, params, rp, dims)
        return out
    return run


CASES = {"collectives": _collectives, "lanes_disagree": _lanes_disagree,
         "keyframe_shard": _keyframe_shard, "sweep": _sweep, "robots": _robots,
         **{f"refine_{p}": _refine(p) for p in REFINE_PASSES}}
CHEAP = ("collectives", "lanes_disagree", "keyframe_shard")


def rank_cases(mesh, names, inputs):
    """Every case of ``names`` on this rank (``inputs``: the params and the
    refinement cases); rank 0's results by name."""
    torch.set_num_threads(1)
    results = {name: (CASES[name](mesh) if name in CHEAP
                      else CASES[name](mesh, inputs)) for name in names}
    return results if mesh.rank == 0 else None


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 would sleep past the spawn's limit."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    sleep_forever(mesh)


def sleep_forever(mesh):
    import time

    time.sleep(3600)


@pytest.fixture(scope="module")
def refine_cases():
    """tests/test_torch_refine.py's corridor case for each set of passes:
    the JAX package's carry and parameters, and the port's converted."""
    from test_torch_refine import _case

    return {p: _case(**kw) for p, kw in REFINE_PASSES.items()}


@pytest.fixture(scope="module")
def ranks(refine_cases):
    """Rank 0's results at two ranks (every case) and at four (the cheap
    collectives)."""
    inputs = {"params": base_params(),
              **{p: tuple(c[k] for k in ("carry", "params", "rp", "dims"))
                 for p, c in refine_cases.items()}}
    return {2: spawn(rank_cases, 2, tuple(CASES), inputs, cpu=True,
                     timeout_s=SPAWN_TIMEOUT_S),
            4: spawn(rank_cases, 4, CHEAP, None, cpu=True,
                     timeout_s=SPAWN_TIMEOUT_S)}


POSE_LEAVES = ("poses", "pose")


def _assert_equal(a, b, path="x"):
    """Equal structure and every leaf equal with its dtype."""
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}.{i}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _assert_close(a, b, path="carry", pose_atol=1e-6):
    """Equal structure; integer and bool leaves equal; poses within
    ``pose_atol`` m / rad and other floats within 1e-4 relative."""
    if isinstance(a, tuple):
        assert type(a) is type(b), path
        for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            _assert_close(x, y, f"{path}.{name}", pose_atol)
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        assert x.dtype == y.dtype, path
        if not x.is_floating_point():
            assert torch.equal(x, y), path
        elif path.rsplit(".", 1)[-1] in POSE_LEAVES:
            torch.testing.assert_close(x, y, rtol=0.0, atol=pose_atol,
                                       msg=path)
        else:
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("d", [2, 4])
def test_gather_of_shards_is_the_whole(ranks, d):
    _assert_equal(ranks[d]["collectives"]["frames"], stream())


@pytest.mark.parametrize("d", [2, 4])
def test_make_config_mesh_refuses_another_size(ranks, d):
    msg = ranks[d]["collectives"]["wrong_size"]
    assert msg is not None and f"world of {d} ranks" in msg


@pytest.mark.parametrize("d", [2, 4])
def test_exchange_keyframes(ranks, d):
    import jax
    import jax.numpy as jnp
    from sonar_slam_tpu.parallel import make_config_mesh as jmesh
    from sonar_slam_tpu.parallel import multi_robot as jmr

    got = ranks[d]["collectives"]["exchange"]
    want = summary_case()
    _assert_equal(got, want)
    jsum = jmr.KeyframeSummary(*(jnp.asarray(x.numpy()) for x in want))
    jg = jmr.exchange_keyframes(jsum, jmesh(4, axis="robot"))
    for x, y in zip(got, jax.tree.leaves(jg)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("fn", ["transform", "gate", "select"])
@pytest.mark.parametrize("d", [2, 4])
def test_keyframe_shard(ranks, d, fn):
    """Exactly the unsharded port call; the JAX mesh function as
    tests/test_torch_parallel.py holds the unsharded call to it."""
    from sonar_slam_tpu.parallel import keyframe_shard as jks
    from sonar_slam_tpu.parallel import make_config_mesh as jmesh
    import jax.numpy as jnp

    got = ranks[d]["keyframe_shard"][fn]
    c = kf_case()
    _assert_equal(got, kf_calls(c)[fn])
    jmesh8 = jmesh(8, axis="kf")
    jargs = [jnp.asarray(c[k]) for k in GATE_ARGS]
    if fn == "transform":
        j = jks.transform_clouds_sharded(jargs[0], jargs[2], jmesh8)
        np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=1e-5)
        return
    call = (jks.nssm_gate_sharded if fn == "gate"
            else jks.nssm_target_select_sharded)
    j = call(*jargs, jmesh8, c["max_range"], c["half_ap"])
    for x, y in zip(got, j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("d", [2, 4])
def test_kf_sharding_cuts_this_ranks_block(ranks, d):
    points = torch.as_tensor(kf_case()["points"])
    assert torch.equal(ranks[d]["keyframe_shard"]["block"], points[:16 // d])


def test_sweep_scan_over_two_ranks(ranks):
    r = ranks[2]["sweep"]
    _assert_close(r["mesh"], r["one"], "sweep")
    poses = r["mesh"][0].poses.numpy()
    # equal parameters on different ranks (tests/test_parallel.py:84-86)
    np.testing.assert_allclose(poses[0], poses[4], atol=1e-5)
    np.testing.assert_allclose(poses[1], poses[5], atol=1e-5)


def test_multi_robot_scan_over_two_ranks(ranks):
    r = ranks[2]["robots"]
    _assert_close(r["mesh"], r["one"], "robots")
    assert r["one"][0].num_kf.tolist() == [6, 5]


@pytest.mark.parametrize("d", [2, 4])
def test_lanes_agreeing_over_the_ranks_map(ranks, d):
    assert torch.equal(ranks[d]["lanes_disagree"]["same"],
                       2 * torch.arange(6))


@pytest.mark.parametrize("how", ["count", "index"])
@pytest.mark.parametrize("d", [2, 4])
def test_lanes_that_differ_between_ranks_raise(ranks, d, how):
    """Rank 0 raises too (its lanes are the others'), so no rank waits in a
    gather of blocks registered against other lanes."""
    msg = ranks[d]["lanes_disagree"][how]
    assert isinstance(msg, str) and "lanes disagree" in msg


@pytest.mark.parametrize("passes", list(REFINE_PASSES))
def test_refine_loops_over_two_ranks(ranks, passes):
    """Within the JAX script's 1e-5 m of the one-process port on the same
    carry (which tests/test_torch_refine_loops.py holds to the JAX
    package's ``refine_loops`` for both sets of passes)."""
    r = ranks[2][f"refine_{passes}"]
    mesh, one = r["mesh"], r["one"]
    assert mesh.num_loops == one.num_loops and one.num_loops >= 1
    np.testing.assert_allclose(mesh.poses.numpy(), one.poses.numpy(),
                               rtol=0, atol=1e-5)


def test_refine_loops_over_two_ranks_against_jax_mesh(ranks, refine_cases):
    """The sweep alone over two ranks against the JAX package's
    ``refine_loops`` on a two-device mesh (its own mesh test's passes,
    tests/test_refine.py), at tests/test_torch_refine_loops.py's
    tolerances. One set of passes only: the JAX mesh program takes 50 s to
    compile on one core."""
    import sonar_slam_tpu.slam.refine as jref
    from sonar_slam_tpu.parallel import make_config_mesh as jmesh
    from test_torch_refine import ICP_ATOL, SCALE_ATOL, _assert_carry

    c = refine_cases["sweep"]
    j = jref.refine_loops(c["jcarry"], c["jparams"], c["jrp"], c["jdims"],
                          jmesh(2))
    _assert_carry(ranks[2]["refine_sweep"]["mesh"], j, ICP_ATOL, SCALE_ATOL)


# every check runs before any collective, so a mesh value of three ranks
# with no process group behind it is enough
THREE = Mesh(axis="config", size=3, rank=0, device=torch.device("cpu"),
             group=None)


@pytest.mark.parametrize("call", [
    "sweep_lanes", "sweep_axis", "robots", "kf_transform", "kf_gate",
    "kf_select", "refine_loops", "replay"])
def test_indivisible_or_misnamed_axis_raises(call):
    c = kf_case()
    args = [torch.as_tensor(c[k]) for k in GATE_ARGS]
    gate = (c["max_range"], c["half_ap"])
    kf = THREE._replace(axis="kf")
    calls = {
        "sweep_lanes": lambda: sweep_scan(stream(), sweep_lanes(), DIMS,
                                          THREE),
        "sweep_axis": lambda: sweep_scan(stream(), sweep_lanes(), DIMS,
                                         THREE._replace(size=2), axis="kf"),
        "robots": lambda: multi_robot_scan(robot_streams(), base_params(),
                                           DIMS, THREE),
        "kf_transform": lambda: tks.transform_clouds_sharded(args[0], args[2],
                                                             kf),
        "kf_gate": lambda: tks.nssm_gate_sharded(*args, *gate, mesh=kf),
        "kf_select": lambda: tks.nssm_target_select_sharded(*args, *gate,
                                                            mesh=kf),
        # max_loops 4: the checks come before the carry is read
        "refine_loops": lambda: refine_loops(None, None, None, DIMS,
                                             mesh=THREE),
        "replay": lambda: replay(None, FeatureConfig(), base_params(), DIMS,
                                 "cpu", mesh=THREE),
    }
    with pytest.raises(ValueError, match="divisible|axis"):
        calls[call]()


@pytest.mark.parametrize("cli, argv", [
    ("sweep", ["--simulate", "--lanes", "4", "--devices", "3"]),
    ("two_robot_demo", ["--devices", "3"]),
    ("sharded_replay", ["--max-keyframes", "64", "--devices", "3"]),
])
def test_cli_devices_must_divide(cli, argv):
    import importlib

    main = importlib.import_module(f"sonar_slam_torch.cli.{cli}").main
    with pytest.raises(ValueError):
        main(argv + ["--cpu"])


def test_cli_sharded_replay_check_needs_ranks():
    """``--check`` holds the sharded replay to the one-process one: on one
    rank it could not fail, so it is refused before any work."""
    from sonar_slam_torch.cli import sharded_replay

    with pytest.raises(ValueError, match="--devices"):
        sharded_replay.main(["--max-keyframes", "64", "--check", "--cpu"])


def test_a_failing_rank_makes_spawn_raise():
    """Rank 1's error, raised at once: rank 0 is stopped, not waited for."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        spawn(fail_on_rank_1, 2, cpu=True, timeout_s=SPAWN_TIMEOUT_S)


def test_a_hung_world_makes_spawn_raise():
    with pytest.raises(TimeoutError):
        spawn(sleep_forever, 2, cpu=True, timeout_s=3.0)


def test_make_config_mesh_outside_a_rank_raises():
    with pytest.raises(RuntimeError):
        make_config_mesh(cpu=True)
