"""``cli.run_repeats`` and ``cli.plot_runs`` against the JAX package's
``scripts/run_repeats.sh`` and ``scripts/plot_runs.py``.

* Two ``--cpu`` runs of ``cli.replay`` on a 20 s survey of 64 x 32 pings,
  each in its own subprocess, write ``trajectory.npz`` files equal bit for
  bit, array for array, and ``trajectory_spread`` over them is 0.0 (about
  30 s).
* As in the shell script, ``RUNS``, ``TIMEOUT`` and ``OUTDIR`` come from the
  environment with its defaults (10, 300, ``runs``), a run cut by the
  timeout does not stop the loop, and with no bag a survey is simulated into
  ``OUTDIR/survey.npz`` first.
* ``cli.plot_runs`` prints the line ``scripts/plot_runs.py`` (which imports
  no JAX; run in a subprocess) prints on the same run directories, for
  equal runs and for a run moved by 1.5e-3 m, and writes the overlay.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sonar_slam_torch.cli import plot_runs, run_repeats
from sonar_slam_torch.cli.simulate_bag import write_bundle
from sonar_slam_torch.io.simulate import SimConfig, simulate_bag

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = SimConfig(duration=20.0, speed=0.5, sonar_rate=1.0, num_ranges=64,
                 num_bearings=32, loop_radius=2.5, imu_rate=10.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two repeated runs of the tiny survey."""
    tmp = tmp_path_factory.mktemp("repeats")
    bag = str(tmp / "tiny.npz")
    write_bundle(bag, simulate_bag(TINY))
    outdir = str(tmp / "runs")
    env = dict(OMP_NUM_THREADS="1", MALLOC_MMAP_MAX_="0",
               MALLOC_TRIM_THRESHOLD_="68719476736")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        run = run_repeats.main([bag, "--runs", "2", "--outdir", outdir,
                                "--cpu"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return run, bag


def test_two_cpu_runs_equal_bit_for_bit(runs):
    run, _ = runs
    assert [(r[0], r[1], r[3]) for r in run.runs] == [("tiny", 1, 0),
                                                      ("tiny", 2, 0)]
    a, b = (np.load(os.path.join(r[2], "trajectory.npz")) for r in run.runs)
    assert sorted(a.files) == sorted(b.files)
    assert "trajectory" in a.files and len(a["trajectory"]) >= 2
    for name in a.files:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].tobytes() == b[name].tobytes(), name
    files = plot_runs.trajectory_files(run.outdir)
    assert len(files) == 2
    assert plot_runs.trajectory_spread(files) == 0.0


def test_environment_defaults(monkeypatch):
    for k in ("RUNS", "TIMEOUT", "OUTDIR"):
        monkeypatch.delenv(k, raising=False)
    args = run_repeats._parser().parse_args([])
    assert (args.runs, args.timeout, args.outdir, args.bags) == (10, 300.0,
                                                                 "runs", [])
    monkeypatch.setenv("RUNS", "3")
    monkeypatch.setenv("TIMEOUT", "12.5")
    monkeypatch.setenv("OUTDIR", "elsewhere")
    args = run_repeats._parser().parse_args(["a.npz", "b.npz"])
    assert (args.runs, args.timeout, args.outdir, args.bags) == (
        3, 12.5, "elsewhere", ["a.npz", "b.npz"])
    assert run_repeats._parser().parse_args(["--runs", "1"]).runs == 1


def test_timeout_does_not_stop_the_loop(runs, tmp_path):
    _, bag = runs
    run = run_repeats.main([bag, bag, "--runs", "2", "--timeout", "0.2",
                            "--outdir", str(tmp_path), "--cpu"])
    assert [r[3] for r in run.runs] == [None] * 4


def test_no_bag_simulates_a_survey(tmp_path, monkeypatch):
    """With no bag, OUTDIR/survey.npz is simulated first (``cli.simulate_bag``'s
    default survey, about 8 s); a file that is there is reused, as the shell
    script does."""
    monkeypatch.setenv("OUTDIR", str(tmp_path))
    survey = tmp_path / "survey.npz"
    run = run_repeats.main(["--runs", "1", "--timeout", "0.2", "--cpu"])
    assert [(r[0], r[1], r[3]) for r in run.runs] == [("survey", 1, None)]
    with np.load(survey) as d:
        assert d["ping_images"].shape == (479, 256, 128)
    stamp = survey.stat().st_mtime_ns
    run_repeats.main(["--runs", "1", "--timeout", "0.2", "--cpu"])
    assert survey.stat().st_mtime_ns == stamp


def _spread_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("max trajectory")]


def test_plot_runs_prints_the_script_lines(runs, tmp_path, capsys):
    run, _ = runs
    d = tmp_path / "runs"
    for name, r in zip(("a_run1", "a_run2"), run.runs):
        shutil.copytree(r[2], d / name)
    for moved in (False, True):
        if moved:
            src = np.load(d / "a_run1" / "trajectory.npz")
            arrays = {k: src[k] for k in src.files}
            arrays["trajectory"] = arrays["trajectory"] + np.float32(1.5e-3)
            os.makedirs(d / "a_run3")
            np.savez(d / "a_run3" / "trajectory.npz", **arrays)
        drawn = plot_runs.main([str(d), "--out", str(tmp_path / "port.pdf")])
        spread = drawn.spread
        assert drawn.out == str(tmp_path / "port.pdf")
        port = _spread_line(capsys.readouterr().out)
        script = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "plot_runs.py"),
             str(d), "--out", str(tmp_path / "script.pdf")],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert script.returncode == 0, script.stderr
        assert port == _spread_line(script.stdout) and len(port) == 1
        assert (spread > 1e-3) if moved else (spread == 0.0)
        assert (tmp_path / "port.pdf").stat().st_size > 0


def test_plot_runs_without_runs_exits(tmp_path):
    with pytest.raises(SystemExit, match="no trajectory.npz files"):
        plot_runs.main([str(tmp_path)])
