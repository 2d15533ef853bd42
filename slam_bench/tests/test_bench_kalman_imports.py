"""The Kalman cell's plain reference loads nothing of the port or of JAX,
as ``test_bench_imports.py`` checks for the rest of the reference: the
front ends that ``stages.odometry`` finds by name, imported directly."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_bench_imports import JAX, PORT, top_levels_loaded  # noqa: E402


def test_reference_front_ends_load_nothing_of_the_port():
    loaded = top_levels_loaded(
        "import slam_bench.reference.estimators.kalman, "
        "slam_bench.reference.odometry.dr, "
        "slam_bench.reference.odometry.kalman")
    assert not (loaded & (JAX | {PORT}))
