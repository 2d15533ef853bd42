"""No module of sonar_slam_torch, and not chip_smoke.py, imports JAX or the
JAX package: a fresh interpreter with those imports blocked imports every
module of the port and chip_smoke.py. None of them loads PyYAML, matplotlib
or PIL either (the card's machine need not have them), and neither does a
whole run of ``cli.replay``, of ``cli.two_robot_demo`` (without
``--plot``), of ``cli.map_probe`` (which imports ``cli.error_budget``, the
configurations of every accuracy CLI) or of ``cli.parity_lane``'s lanes on
the CPU. Every subpackage of the
port exports every name that the JAX package's exports but the
``NOT_PORTED`` ones, and every public function or
class of a JAX module takes each of its parameters in the port's module of
the same name, but the few ``NOT_PORTED_PARAMS`` names with their
reasons."""

import importlib
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import sonar_slam_torch
names = ["sonar_slam_torch"] + [
    m.name for m in pkgutil.walk_packages(sonar_slam_torch.__path__,
                                          "sonar_slam_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
added = set(sys.modules) - before
assert not any(m.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu", "yaml",
                                    "matplotlib", "PIL")
               for m in added), sorted(added)
assert "jax" not in sys.modules or "jax" in before
print(" ".join(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 67
    for new in ("slam.refine", "mapping", "mapping.occupancy",
                "mapping.metrics", "estimators.gyro", "estimators.kalman",
                "slam.dual_sonar", "slam.services", "io.config", "io.state",
                "io.lz4", "io.rosbag", "utils", "utils.logging",
                "utils.streams", "utils.timing", "utils.viz",
                "cli", "cli.replay", "cli.convert_bag", "cli.simulate_bag",
                "parallel", "parallel.sweep", "parallel.keyframe_shard",
                "parallel.multi_robot", "cli.sweep", "cli.two_robot_demo",
                "cli.sharded_replay", "cli.error_budget", "cli.multi_seed",
                "cli.yscale_lane", "cli.accuracy_sweep", "cli.map_probe",
                "cli.frontier_coverage_probe", "cli.run_repeats",
                "cli.plot_runs", "cli.parity_lane", "io.lz4_lib"):
        assert "sonar_slam_torch." + new in names, new
    assert "sonar_slam_torch.parallel.mesh" in names


_LZ4_SCRIPT = r"""
import importlib.abc, sys
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from sonar_slam_torch.io import lz4, lz4_lib
lz4_lib._load()
raw = bytes(range(256)) * 64
assert lz4.decompress_frame(lz4.compress_frame(raw)) == raw
assert not any(m.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu")
               for m in sys.modules)
print("loaded", lz4_lib.build())
"""


def test_lz4_library_loads_without_jax():
    """Building, loading and calling the compiled LZ4 decoder imports no
    JAX and nothing of the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _LZ4_SCRIPT.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("loaded ")


_CLI_SCRIPT = r"""
import importlib.abc, os, sys
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from sonar_slam_torch.cli import replay, simulate_bag
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag as simulate

out = {out!r}
simulate_bag.write_bundle(os.path.join(out, "tiny.npz"), simulate(SimConfig(
    duration=10.0, speed=0.5, sonar_rate=1.0, num_ranges=64, num_bearings=32,
    loop_radius=2.5, imu_rate=10.0)))
run = replay.main(["--file", os.path.join(out, "tiny.npz"), "--cpu",
                   "--out", out, "--intensity", "--save-submaps"])
assert run.result.num_keyframes >= 2, run.result.num_keyframes
present = sorted(m for m in ("jax", "yaml", "matplotlib", "PIL")
                 if m in sys.modules)
print("present:", present)
"""


def test_cli_replay_loads_no_jax_yaml_matplotlib_or_pil(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_SCRIPT.format(root=ROOT, out=str(tmp_path))],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "present: []"
    for name in ("trajectory.npz", "slam_carry.npz", "occupancy.npz"):
        assert (tmp_path / name).exists(), name


_TWO_ROBOT_SCRIPT = r"""
import importlib.abc, sys
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from sonar_slam_torch.cli import two_robot_demo

run = two_robot_demo.main(["--cpu", "--duration", "75"])
assert run.accepted >= 1, run
present = sorted(m for m in ("jax", "yaml", "matplotlib", "PIL")
                 if m in sys.modules)
print("present:", present)
"""


def test_cli_two_robot_demo_loads_no_jax_yaml_matplotlib_or_pil():
    proc = subprocess.run(
        [sys.executable, "-c", _TWO_ROBOT_SCRIPT.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "present: []"


_MAP_PROBE_SCRIPT = r"""
import importlib.abc, sys
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu", "scripts",
                                  "bench", "error_budget"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from sonar_slam_torch.cli import map_probe

out = map_probe.main(["--cpu"]).report
assert out["n_cells"] > 0, out
present = sorted(m for m in ("jax", "yaml", "matplotlib", "PIL")
                 if m in sys.modules)
print("present:", present)
"""


def test_cli_map_probe_loads_no_jax_yaml_matplotlib_or_pil():
    proc = subprocess.run(
        [sys.executable, "-c", _MAP_PROBE_SCRIPT.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", MALLOC_MMAP_MAX_="0",
                 MALLOC_TRIM_THRESHOLD_="68719476736"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "present: []"


_PARITY_SCRIPT = r"""
import importlib.abc, json, sys
sys.path.insert(0, {root!r})

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu", "scripts",
                                  "bench", "error_budget"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from sonar_slam_torch.cli import parity_lane
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag

bag = simulate_bag(SimConfig(duration=20.0, speed=0.5, sonar_rate=1.0,
                             num_ranges=96, num_bearings=48, loop_radius=5.0,
                             imu_rate=10.0))
run = parity_lane.run_parity_lanes(bag, False, "cpu")
assert run.lanes["faithful"].num_keyframes >= 2, run.parity
print(json.dumps(sorted(run.parity)))
present = sorted(m for m in ("jax", "yaml", "matplotlib", "PIL")
                 if m in sys.modules)
print("present:", present)
"""


def test_cli_parity_lane_runs_without_jax():
    """``cli.parity_lane``'s three lanes (the faithful lane twice) on a
    20 s survey with JAX and the JAX package blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _PARITY_SCRIPT.format(root=ROOT)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "present: []"
    assert "odometry_max_dev_m" in lines[-2] and "ssm_only_ate_m" in lines[-2]


# Public names of the JAX package that the port does not export, each with
# its reason.
NOT_PORTED = {
    # times the reference's four SLAM blocks on synthetic clouds; the port
    # records the same computations as spans inside the real keyframe step
    # (utils/timing.py)
    "profile_slam_components",
}
SUBPACKAGES = ["cloud", "estimators", "geometry", "graph", "io", "kernels",
               "mapping", "parallel", "slam", "utils"]


def _exports(module) -> set:
    """The public names a package's ``__init__`` binds, submodules aside."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n != "annotations"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_every_name_of_the_jax_package(sub):
    want = _exports(importlib.import_module("sonar_slam_tpu." + sub))
    got = _exports(importlib.import_module("sonar_slam_torch." + sub))
    assert want - NOT_PORTED <= got, sorted(want - NOT_PORTED - got)


# Parameters of the JAX package's public functions and classes that the
# port's counterpart does not take, by (module, name), each with its reason.
NOT_PORTED_PARAMS = {
    # TPU-only: the scan's host chunk length (the port steps one keyframe a
    # call)
    ("slam.core", "SlamDims"): {"scan_chunk"},
    # TPU-only: Pallas or XLA CFAR (the port launches the CUDA kernel on a
    # card and its plain version on the CPU)
    ("slam.frontend", "FeatureExtractor"): {"use_pallas"},
    # keyframe gates and a warning period that nothing reads
    ("estimators.dead_reckoning", "DRConfig"): {
        "keyframe_duration", "keyframe_translation", "keyframe_rotation",
        "error_warn_secs"},
    # renamed ``keys``: the port takes several keys in one call
    ("graph.factor_graph", "marginal_covariance"): {"k"},
    ("slam.core", "scaled_dr_between"): {"key"},
}


def _jax_modules() -> list:
    """The JAX package's modules, from its files (nothing is imported),
    relative to the package ('' for the package itself)."""
    top = os.path.join(ROOT, "sonar_slam_tpu")
    names = []
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                parts = os.path.relpath(os.path.join(d, f[:-3]), top)
                parts = parts.split(os.sep)
                names.append(".".join(p for p in parts
                                      if p not in ("__init__", ".")))
    return sorted(names)


JAX_MODULES = _jax_modules()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_callables_take_the_jax_parameters(module):
    """Each public function and class defined in a JAX module, where the
    port's module of the same name defines it too, takes every parameter
    name of the JAX signature (the ``mesh`` and ``axis`` arguments
    included), but the ``NOT_PORTED_PARAMS`` ones, which it must lack."""
    import inspect

    suffix = "." + module if module else ""
    jmod = importlib.import_module("sonar_slam_tpu" + suffix)
    try:
        tmod = importlib.import_module("sonar_slam_torch" + suffix)
    except ModuleNotFoundError:
        # kernels.cfar_pallas: its kernels are kernels/cfar_cuda.py's;
        # utils.profile: see NOT_PORTED
        assert module in ("kernels.cfar_pallas", "utils.profile")
        return
    for name, fn in vars(jmod).items():
        if (name.startswith("_") or not callable(fn)
                or getattr(fn, "__module__", None) != jmod.__name__
                or not hasattr(tmod, name)):
            continue
        want = set(inspect.signature(fn).parameters)
        got = set(inspect.signature(getattr(tmod, name)).parameters)
        assert want - got == NOT_PORTED_PARAMS.get((module, name), set()), (
            name, sorted(want - got))
