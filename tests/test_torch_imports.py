"""No module of sonar_slam_torch, and not chip_smoke.py, imports JAX or the
JAX package: a fresh interpreter with those imports blocked imports every
module of the port and chip_smoke.py. None of them loads PyYAML either (the
card's machine need not have it)."""

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
assert not any(m.split(".")[0] in ("jax", "jaxlib", "sonar_slam_tpu", "yaml")
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
    assert len(names) >= 29
    for new in ("slam.refine", "mapping", "mapping.occupancy",
                "mapping.metrics", "estimators.gyro", "estimators.kalman",
                "slam.dual_sonar", "slam.services"):
        assert "sonar_slam_torch." + new in names, new
