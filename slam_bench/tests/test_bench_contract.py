"""BENCHMARK.json against its character rules, and the harness finding a
cell by its files alone.

Run from the repository root: ``python -m pytest slam_bench/tests -q``.
"""

import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)
sys.path.insert(0, BENCH_DIR)

import run as bench_run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["command"]) <= 32
    assert all(one_line(w) for w in b["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for key in ("configs", "workloads"):
        ns = [x["name"] for x in b[key]]
        assert len(ns) == len(set(ns))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_cell_reports_what_it_must():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        cell = bench_run.Cell.find(b, w)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_cells_found_by_their_files():
    b = bench()
    for w in b["workloads"]:
        cell = bench_run.Cell.find(b, w["name"])
        mod = bench_run.driver_module(cell)
        assert all(callable(getattr(mod, f))
                   for f in ("Driver", "compare", "control"))
        assert cell.config["name"] == w["config"]
        assert cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench_run.reader(m["name"]))
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] and cfg["reduced"] == c["reduced"]


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        bench_run.Cell.find(bench(), "no_such.cell")


def test_missing_driver_or_metric_file_refused():
    cell = bench_run.Cell.find(bench(), "m750d_offline.replay")
    cell.traffic = dict(cell.traffic, driver="no_such_driver")
    with pytest.raises(SystemExit):
        bench_run.driver_module(cell)
    with pytest.raises(SystemExit):
        bench_run.reader("no_such_metric")


def test_reference_front_end_found_by_its_name():
    from slam_bench.reference import stages

    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            frontend = json.load(f)["frontend"]
        assert os.path.exists(os.path.join(
            BENCH_DIR, "reference", "odometry", frontend + ".py"))
    with pytest.raises(ModuleNotFoundError):
        stages.odometry(None, None, None, None, "no_such_frontend")


def test_no_card_exits_without_a_result():
    """On a machine without a CUDA card the command exits non-zero and its
    standard output holds no result line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "m750d_live.online", "--seed", "4294967301", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"metrics"' not in proc.stdout
