"""``cli.multi_seed`` and ``cli.yscale_lane`` against the JAX package's
``scripts/multi_seed.py`` and ``scripts/yscale_lane.py``.

Each JAX script runs in a subprocess started when the module starts (its
functions imported from ``scripts/``, nothing there edited), and so do the
port's two CLIs (``--cpu``, in one more, with freed memory kept in glibc's
heap as tests/test_torch_cli.py runs them): about 45, 80 and 65 s.

* ``multi_seed --seeds 1`` (the small production config, seed 0): the
  per-seed record's keyframes, loops, loop precision and recall, true DVL
  scale and estimated scale (1.0: the small config does not estimate it)
  equal the script's; ATE and heading within ``ATE_TOL_CM`` and
  ``HEADING_TOL_DEG``, DR ATE within 0.02 cm, the loop-error median within
  ``LOOP_ERR_TOL_CM``; the summary has the script's keys. Measured: the
  same 2.98 cm (this replay is error_budget's lane A).
* ``yscale_lane --seeds 1`` runs the full production configuration at full
  width (512 x 256 pings, 128 keyframe slots), whose 480 s survey is too
  long for the CPU: here both packages replay its first 60 s (300 pings,
  ``SimConfig.duration`` cut in both through ``setups``, nothing else
  changed). The record's keys, true scale and loops (none in 60 s) equal
  the script's; the estimated scale within ``SCALE_TOL`` and ATE within
  ``ATE_TOL_CM``. Measured: scale [1.01802, 0.99731] against the script's
  [1.01829, 0.99730], ATE 6.69 cm against 6.83 cm. This cut survey is
  ill-conditioned in the reference algorithm: with every DVL sample moved by
  +1e-6 m/s the JAX script gives the port's numbers to the printed digit
  (6.69 cm, [1.01802, 0.99731]), with -1e-6 m/s 3.36 cm and [1.01025,
  0.99882]. The tolerances hold the port to the unmoved result well inside
  that move. ``PYTHONPATH=.:tests python tests/test_torch_multi_seed.py``
  prints the three JAX runs.

Run on a card as ``PYTHONPATH=. python tests/test_torch_multi_seed.py
cuda``, the file prints the full production path's own sensitivity
instead: the replay of ``multi_seed --full`` (seed 0) with the odometry
moved by 1e-6 m (``_perturbation_probe``; it imports no JAX).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YSCALE_DURATION = 60.0
ATE_TOL_CM = 0.3
HEADING_TOL_DEG = 0.02
LOOP_ERR_TOL_CM = 0.3
DR_TOL_CM = 0.02
SCALE_TOL = 1e-3

_JAX_YSCALE = r"""
import sys
from dataclasses import replace
sys.path.insert(0, {scripts!r})
sys.path.insert(0, {repo!r})
import numpy as np
import error_budget
import yscale_lane

simulate = yscale_lane.simulate_bag
yscale_lane.simulate_bag = lambda cfg: (lambda b: b._replace(
    dvl_vel=b.dvl_vel + np.float32({dvl!r})))(simulate(cfg))

def setups(full):
    sim, dims, kf_t = error_budget.setups(full)
    return replace(sim, duration={duration!r}), dims, kf_t

yscale_lane.setups = setups
sys.argv = ["yscale_lane.py", "--seeds", "1", "--out", {out!r}]
yscale_lane.main()
"""


_PORT = r"""
import dataclasses, sys
sys.path.insert(0, {repo!r})
from sonar_slam_torch.cli import error_budget, multi_seed, yscale_lane

multi_seed.main(["--seeds", "1", "--cpu", "--out", {ms_out!r}])
orig = error_budget.setups

def setups(full):
    sim, dims, kf_t = orig(full)
    return dataclasses.replace(sim, duration={duration!r}), dims, kf_t

error_budget.setups = setups
run = yscale_lane.main(["--seeds", "1", "--cpu", "--out", {ys_out!r}])
print("yscale keyframes", run.results[0].num_keyframes)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both JAX scripts and the port's two CLIs, started in subprocesses when
    the module starts."""
    tmp = tmp_path_factory.mktemp("multi_seed")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    outs = {name: str(tmp / f"{name}.json") for name in
            ("multi_seed", "yscale", "port_multi_seed", "port_yscale")}
    procs = {
        "multi_seed": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "multi_seed.py"),
             "--seeds", "1", "--out", outs["multi_seed"]], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "yscale": subprocess.Popen(
            [sys.executable, "-c", _JAX_YSCALE.format(
                scripts=os.path.join(REPO, "scripts"), repo=REPO, dvl=0.0,
                duration=YSCALE_DURATION, out=outs["yscale"])],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT.format(
                repo=REPO, duration=YSCALE_DURATION,
                ms_out=outs["port_multi_seed"], ys_out=outs["port_yscale"])],
            cwd=REPO, env=dict(env, MALLOC_MMAP_MAX_="0",
                               MALLOC_TRIM_THRESHOLD_="68719476736"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    yield procs, outs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module", autouse=True)
def _start(runs):
    return runs


def _result(runs, proc, name):
    procs, outs = runs
    if procs[proc].returncode is None:
        procs[proc].stdout_text, stderr = procs[proc].communicate(timeout=900)
        assert procs[proc].returncode == 0, stderr
    with open(outs[name]) as f:
        return json.load(f)


def test_multi_seed_record_matches_script(runs):
    want = _result(runs, "multi_seed", "multi_seed")
    got = _result(runs, "port", "port_multi_seed")
    assert sorted(got) == sorted(want)
    assert (got["config"], got["seeds"]) == ("small", 1)
    g, w = got["per_seed"][0], want["per_seed"][0]
    assert sorted(g) == sorted(w)
    for key in ("seed", "keyframes", "loops", "precision", "recall",
                "est_dvl_scale_xy", "true_dvl_scale_xy"):
        assert g[key] == w[key], key
    assert abs(g["ate_cm"] - w["ate_cm"]) <= ATE_TOL_CM
    assert abs(g["dr_ate_cm"] - w["dr_ate_cm"]) <= DR_TOL_CM
    assert abs(g["heading_deg"] - w["heading_deg"]) <= HEADING_TOL_DEG
    assert abs(g["loop_err_median_cm"] - w["loop_err_median_cm"]) <= LOOP_ERR_TOL_CM
    # the printed lines: one record a seed, then the summary
    lines = runs[0]["port"].stdout_text.strip().splitlines()
    assert [json.loads(ln) for ln in lines[:2]] == [g, got]


def test_yscale_record_matches_script(runs):
    want = _result(runs, "yscale", "yscale")
    got = _result(runs, "port", "port_yscale")
    assert sorted(got) == sorted(want)
    assert (got["lane"], got["crab_deg"], got["seeds"]) == ("yscale", 20.0, 1)
    g, w = got["per_seed"][0], want["per_seed"][0]
    assert sorted(g) == sorted(w)
    for key in ("seed", "crab_deg", "true_scale_xy", "loops"):
        assert g[key] == w[key], key
    lines = runs[0]["port"].stdout_text.strip().splitlines()
    assert [json.loads(ln) for ln in lines[2:4]] == [g, got]
    assert int(lines[4].split()[-1]) > 2  # keyframes
    np.testing.assert_allclose(g["est_scale_xy"], w["est_scale_xy"], rtol=0,
                               atol=SCALE_TOL)
    assert abs(g["x_err_pct"] - w["x_err_pct"]) <= 100 * SCALE_TOL + 0.001
    assert abs(g["y_err_pct"] - w["y_err_pct"]) <= 100 * SCALE_TOL + 0.001
    assert abs(g["ate_cm"] - w["ate_cm"]) <= ATE_TOL_CM


@pytest.mark.parametrize("module", ["error_budget", "multi_seed", "yscale_lane",
                                    "accuracy_sweep", "map_probe",
                                    "frontier_coverage_probe", "run_repeats"])
def test_cli_refuses_to_run_without_a_card(module):
    """Without ``--cpu`` on a machine with no card, each CLI exits 1 and
    names ``--cpu`` (the CPU only when asked for)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    r = subprocess.run([sys.executable, "-m", f"sonar_slam_torch.cli.{module}"],
                       capture_output=True, text=True, cwd=REPO, timeout=120,
                       env=dict(os.environ, RUNS="0"))
    assert r.returncode == 1, r.stderr
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr


def _perturbation_probe(device):
    """The production path of ``cli.multi_seed --full`` (seed 0) with the
    odometry moved: every dead-reckoning pose by +-1e-6 m in x and y, or
    every DVL sample by +1e-6 m/s; then chip_smoke.py's OS path (phase 5,
    replay only) with the poses moved. Prints how far the poses, the ATE and
    the loop set move from the unmoved run, and a repeat of it. Full width:
    run it on a card (about 4 minutes on an H100)."""
    import dataclasses

    import chip_smoke
    import sonar_slam_torch.pipeline as pipe
    from sonar_slam_torch.cli.error_budget import (bench_params, bench_rparams,
                                                   setups)
    from sonar_slam_torch.io.simulate import simulate_bag
    from sonar_slam_torch.slam import FeatureConfig

    orig, move = pipe.odometry, {"dx": 0.0}

    def moved(*a, **kw):
        t, poses3, basis = orig(*a, **kw)
        if move["dx"]:
            poses3 = poses3.clone()
            poses3[:, :2] += move["dx"]
        return t, poses3, basis

    def run(bag, fc, params, dims, rp):
        res = pipe.replay(bag, fc, params, dims, device, refine_params=rp)
        nk = res.num_keyframes
        truth = bag.true_pose_at_ping[res.keyframe_ping_idx][:nk]
        nl = min(res.carry.num_loops, res.carry.loops_i.shape[0])
        loops = set(zip(res.carry.loops_i[:nl].tolist(),
                        res.carry.loops_j[:nl].tolist()))
        return nk, loops, pipe.ate_rmse(res.trajectory, truth), res.trajectory

    def report(name, base, got):
        n = min(len(base[3]), len(got[3]))
        print(f"{name}: {got[0]} keyframes, {len(got[1])} loops, ATE "
              f"{got[2] * 100:.3f} cm; against the unmoved run: poses up to "
              f"{np.abs(got[3][:n, :2] - base[3][:n, :2]).max():.4e} m, "
              f"ATE {(got[2] - base[2]) * 100:+.3f} cm, loops only there "
              f"{len(base[1] - got[1])}, only here {len(got[1] - base[1])}",
              flush=True)

    pipe.odometry = moved
    try:
        sim, dims, kf_t = setups(True)
        params = bench_params(dims, kf_t, True, device)
        rp = bench_rparams(True, device)
        fc = FeatureConfig(max_points=dims.max_points)
        bag = simulate_bag(dataclasses.replace(sim, seed=0))
        base = run(bag, fc, params, dims, rp)
        report("production path", base, base)
        report("the same again", base, run(bag, fc, params, dims, rp))
        for dx in (1e-6, -1e-6):
            move["dx"] = dx
            report(f"poses {dx:+g} m", base, run(bag, fc, params, dims, rp))
        move["dx"] = 0.0
        dvl = bag._replace(dvl_vel=bag.dvl_vel + np.float32(1e-6))
        report("DVL +1e-6 m/s", base, run(dvl, fc, params, dims, rp))
        _, odims, oparams, ofc, orp = chip_smoke.full_os_config(0)
        oparams, orp = oparams(device), orp(device)
        obase = run(bag, ofc, oparams, odims, orp)
        report("OS path", obase, obase)
        move["dx"] = 1e-6
        report("OS path, poses +1e-06 m", obase,
               run(bag, ofc, oparams, odims, orp))
    finally:
        pipe.odometry = orig


if __name__ == "__main__" and sys.argv[1:] == ["cuda"]:
    # PYTHONPATH=. python tests/test_torch_multi_seed.py cuda   (on a card)
    _perturbation_probe(torch.device("cuda", 0))
elif __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_multi_seed.py
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for dvl in (0.0, 1e-6, -1e-6):
            out = os.path.join(tmp, "yscale.json")
            subprocess.run([sys.executable, "-c", _JAX_YSCALE.format(
                scripts=os.path.join(REPO, "scripts"), repo=REPO, dvl=dvl,
                duration=YSCALE_DURATION, out=out)], cwd=REPO, check=True,
                capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
            with open(out) as f:
                rec = json.load(f)["per_seed"][0]
            print(f"JAX yscale_lane at {YSCALE_DURATION:g} s, DVL + {dvl:g} "
                  f"m/s: scale {rec['est_scale_xy']}, ATE {rec['ate_cm']} cm, "
                  f"{rec['loops']} loops")
