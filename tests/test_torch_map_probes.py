"""``cli.map_probe`` and ``cli.frontier_coverage_probe`` against the JAX
package's ``scripts/map_probe.py`` and ``scripts/frontier_coverage_probe.py``
on the small configuration (seed 0).

The three JAX runs (the map probe, the coverage probe with SOCA and with
OS) start in subprocesses when the module starts (about 55, 11 and 11 s);
the port's run in process beside them (about 30, 5 and 5 s). On the CPU the
port's CFAR is its plain version, which gives the Pallas kernel's masks; the
JAX package on the CPU takes its XLA prefix-sum path, whose masks may differ
at pixels within a relative 1e-5 of their threshold (as
tests/test_torch_cfar.py measures).

* ``map_probe``: the same keys; the cell and truth counts within 1% (the map
  is drawn through the trajectory, which the survey's ill-conditioned
  loops may move by millimetres, tests/test_torch_error_budget.py);
  precision and recall within 0.01; each distance quantile and mean within
  0.05 m. Measured: every value equal.
* ``frontier_coverage_probe`` with SOCA and with OS: the same keys; the
  counts, ``alg``, ``pfa`` and the capacity share equal; each coverage
  within 0.002 and each median within 0.1 (m or degrees), or ``None`` in
  both (no scatterer missed: SOCA). Measured: every value equal.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sonar_slam_torch.cli import frontier_coverage_probe, map_probe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"map_probe": ["map_probe.py"],
        "coverage_SOCA": ["frontier_coverage_probe.py"],
        "coverage_OS": ["frontier_coverage_probe.py", "--alg", "OS"]}


@pytest.fixture(scope="module")
def jax_runs():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", args[0])] + args[1:],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in RUNS.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module", autouse=True)
def _start(jax_runs):
    return jax_runs


def _jax_report(jax_runs, name):
    stdout, stderr = jax_runs[name].communicate(timeout=600)
    assert jax_runs[name].returncode == 0, stderr
    return json.loads(stdout)


def _printed(capsys):
    return json.loads(capsys.readouterr().out)


def test_map_probe_matches_script(jax_runs, capsys):
    got = map_probe.main(["--cpu"]).report
    assert _printed(capsys) == json.loads(json.dumps(got))
    got = json.loads(json.dumps(got))  # integer quantile keys as printed
    want = _jax_report(jax_runs, "map_probe")
    assert sorted(got) == sorted(want)
    assert got["config"] == want["config"] == "small"
    for key in ("n_cells", "n_truth"):
        assert abs(got[key] - want[key]) <= 0.01 * want[key], key
    for key in ("precision@0.4", "recall@0.4", "recall@0.8",
                "feat_recall@0.4"):
        assert abs(got[key] - want[key]) <= 0.01, key
    for key in ("d_cell_mean_m", "d_truth_mean_m"):
        assert abs(got[key] - want[key]) <= 0.05, key
    for key in ("d_truth_q_m", "d_cell_q_m", "d_truth_feat_q_m"):
        assert sorted(got[key]) == sorted(want[key])
        for q in want[key]:
            assert abs(got[key][q] - want[key][q]) <= 0.05, (key, q)


@pytest.mark.parametrize("alg", ["SOCA", "OS"])
def test_frontier_coverage_probe_matches_script(jax_runs, capsys, alg):
    argv = ["--cpu"] + (["--alg", alg] if alg != "SOCA" else [])
    got = frontier_coverage_probe.main(argv).report
    assert _printed(capsys) == got
    want = _jax_report(jax_runs, f"coverage_{alg}")
    assert sorted(got) == sorted(want)
    for key in ("config", "max_points", "kf_count", "alg", "pfa",
                "mean_wedge_truth", "capacity_binding_frac"):
        assert got[key] == want[key], key
    assert abs(got["mean_occupied_vox"] - want["mean_occupied_vox"]) <= 0.5
    for key in ("coverage_A_raw", "coverage_B_voxel", "coverage_C_final"):
        assert abs(got[key] - want[key]) <= 0.002, key
    for key in ("miss_range_med_m", "hit_range_med_m", "miss_absbrg_med_deg",
                "hit_absbrg_med_deg"):
        # None where no scatterer was missed (or hit)
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            assert abs(got[key] - want[key]) <= 0.1, key
