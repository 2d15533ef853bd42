"""No module of sonar_slam_torch, and not chip_smoke.py, imports JAX or the
JAX package: a fresh interpreter with those imports blocked imports every
module of the port and chip_smoke.py. None of them loads PyYAML, matplotlib
or PIL either (the card's machine need not have them), and neither does a
whole run of ``cli.replay``, of ``cli.two_robot_demo`` (without
``--plot``) or of ``cli.map_probe`` (which imports ``cli.error_budget``, the
configurations of every accuracy CLI) on the CPU."""

import os
import subprocess
import sys

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
                "utils.streams", "utils.timing", "utils.profile", "utils.viz",
                "cli", "cli.replay", "cli.convert_bag", "cli.simulate_bag",
                "parallel", "parallel.sweep", "parallel.keyframe_shard",
                "parallel.multi_robot", "cli.sweep", "cli.two_robot_demo",
                "cli.sharded_replay", "cli.error_budget", "cli.multi_seed",
                "cli.yscale_lane", "cli.accuracy_sweep", "cli.map_probe",
                "cli.frontier_coverage_probe", "cli.run_repeats",
                "cli.plot_runs"):
        assert "sonar_slam_torch." + new in names, new


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
