"""``cli.accuracy_sweep`` against the JAX package's
``scripts/accuracy_sweep.py``, whose functions are imported in process
(nothing there is edited).

* ``small_setup``, ``full_setup`` and every row of ``VARIANTS`` equal the
  script's field for field (one case a row).
* Two of the seven variants, ``baseline`` and ``fine`` (twice the points and
  the target capacity, the finest resolutions), on the small config, seed
  0: the port's ``main`` with ``VARIANTS`` cut to those two rows (``--cpu``,
  about 45 s) against the script's ``run_variant`` (about 75 s), both in
  subprocesses started when the module starts. Keyframes and
  loops equal; DR ATE within 0.02 cm (the dead reckoning's cumulative sums,
  tests/test_torch_estimators.py); ATE within ``ATE_TOL_CM``.

The ATE gaps (measured 0.33 cm for baseline, 0.35 cm for fine) are the
reference algorithm's own sensitivity, not a port fault: moving every DVL
sample by +-1e-6 m/s moves the JAX package's own baseline from 3.07 cm to
3.55 and 3.79 cm, and its fine variant from 6.97 cm to 17.38 and 5.68 cm,
with the same keyframes and loops. ``ATE_TOL_CM`` is the baseline's move;
the fine variant's own move is 14 times that, so its gap may grow past the
tolerance under a change that moves no result of the port's (trace it
with the probe before calling it a fault). ``PYTHONPATH=.:tests python
tests/test_torch_accuracy_sweep.py`` prints the probe.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import accuracy_sweep as jas  # noqa: E402  (scripts/accuracy_sweep.py)

from sonar_slam_torch.cli import accuracy_sweep as tas  # noqa: E402
from sonar_slam_torch.convert import dims_from_reference  # noqa: E402

torch.set_num_threads(1)
CHECKED = (0, 5)  # baseline, fine
ATE_TOL_CM = 0.75
DR_TOL_CM = 0.02
CPU_ENV = dict(OMP_NUM_THREADS="1", MALLOC_MMAP_MAX_="0",
               MALLOC_TRIM_THRESHOLD_="68719476736")

_JAX_VARIANTS = r"""
import json, sys
from dataclasses import replace
sys.path.insert(0, {scripts!r})
sys.path.insert(0, {repo!r})
import numpy as np
import accuracy_sweep as jas
from sonar_slam_tpu.io.simulate import simulate_bag

sim, dims, kf_t = jas.small_setup()
bag = simulate_bag(replace(sim, seed=0))
bag = bag._replace(dvl_vel=bag.dvl_vel + np.float32({dvl!r}))
out = {{}}
for i in {rows!r}:
    label, fr, sr, pn, sb, mp, cap = jas.VARIANTS[i]
    out[label] = jas.run_variant(
        bag, dims, kf_t, fr, sr, pn, sb,
        dims.max_points * mp if mp else None,
        dims.target_capacity * cap if cap else None)
print(json.dumps(out))
"""


def jax_variants_proc(dvl=0.0):
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_VARIANTS.format(
            scripts=os.path.join(REPO, "scripts"), repo=REPO, dvl=dvl,
            rows=CHECKED)],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu",
                           OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


_PORT_VARIANTS = r"""
import sys
sys.path.insert(0, {repo!r})
from sonar_slam_torch.cli import accuracy_sweep as tas
tas.VARIANTS = [tas.VARIANTS[i] for i in {rows!r}]
tas.main(["--cpu", "--out", {out!r}])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The script's two variants and the port's ``main`` on them, each in a
    subprocess started when the module starts (the port's with freed
    memory kept in glibc's heap, as tests/test_torch_cli.py runs it)."""
    out = str(tmp_path_factory.mktemp("accuracy_sweep") / "sweep.json")
    procs = {
        "jax": jax_variants_proc(),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT_VARIANTS.format(
                repo=REPO, rows=CHECKED, out=out)],
            cwd=REPO, env=dict(os.environ, **CPU_ENV),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    yield procs, out
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module", autouse=True)
def _start(runs):
    return runs


@pytest.mark.parametrize("name", ["small_setup", "full_setup"])
def test_setup_matches_script(name):
    jsim, jdims, jkf = getattr(jas, name)()
    sim, dims, kf = getattr(tas, name)()
    assert dataclasses.asdict(sim) == dataclasses.asdict(jsim)
    assert dims == dims_from_reference(jdims)
    assert kf == jkf


@pytest.mark.parametrize("row", range(7))
def test_variant_matches_script(row):
    assert len(tas.VARIANTS) == len(jas.VARIANTS) == 7
    got, want = tas.VARIANTS[row], jas.VARIANTS[row]
    assert got == want
    assert [type(x) for x in got] == [type(x) for x in want]


def test_two_variants_match_script(runs):
    procs, out = runs
    stdout, stderr = procs["jax"].communicate(timeout=900)
    assert procs["jax"].returncode == 0, stderr
    want = json.loads(stdout.strip().splitlines()[-1])
    stdout, stderr = procs["port"].communicate(timeout=900)
    assert procs["port"].returncode == 0, stderr
    with open(out) as f:
        results = json.load(f)
    # ranked by mean ATE, with the script's keys
    means = [r["mean_ate_cm"] for r in results]
    assert means == sorted(means)
    assert len(results) == len(CHECKED)
    for r in results:
        ate, dr_ate, nk, nl = want[r["label"]]
        assert sorted(r) == sorted(["label", "feat_res", "slam_res",
                                    "point_noise", "subbin", "ate_cm",
                                    "dr_ate_cm", "loops", "mean_ate_cm"])
        assert r["loops"] == [nl], r["label"]
        assert abs(r["dr_ate_cm"][0] - round(dr_ate * 100, 2)) <= DR_TOL_CM
        assert abs(r["ate_cm"][0] - round(ate * 100, 2)) <= ATE_TOL_CM, r["label"]
    # the printed lines: one a variant and seed, then the ranking
    lines = stdout.strip().splitlines()
    assert lines[-3] == "=== ranked ==="
    assert [ln.split(" cm  ")[1] for ln in lines[-2:]] == [
        r["label"] for r in results]
    for r in results:
        line = next(ln for ln in lines if ln.startswith(r["label"]))
        assert f"seed=0 ATE={r['ate_cm'][0]:6.2f} cm " in line
        assert f" kf={want[r['label']][2]} loops={r['loops'][0]} [" in line


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_accuracy_sweep.py
    for dvl in (0.0, 1e-6, -1e-6):
        p = jax_variants_proc(dvl)
        stdout, stderr = p.communicate()
        for label, (ate, dr_ate, nk, nl) in json.loads(
                stdout.strip().splitlines()[-1]).items():
            print(f"JAX {label}, DVL + {dvl:g} m/s: {nk} keyframes, {nl} "
                  f"loops, ATE {ate * 100:.3f} cm (DR {dr_ate * 100:.3f})")
    for label, fr, sr, pn, sb, mp, cap in (tas.VARIANTS[i] for i in CHECKED):
        from sonar_slam_torch.io.simulate import simulate_bag

        sim, dims, kf_t = tas.small_setup()
        ate, dr_ate, nk, nl = tas.run_variant(
            simulate_bag(dataclasses.replace(sim, seed=0)), dims, kf_t, fr,
            sr, pn, sb, "cpu", dims.max_points * mp if mp else None,
            dims.target_capacity * cap if cap else None)
        print(f"port {label}: {nk} keyframes, {nl} loops, ATE "
              f"{ate * 100:.3f} cm (DR {dr_ate * 100:.3f})")
