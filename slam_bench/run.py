#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--chrome-trace FILE]

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``slam_bench/configs/<config>.json``), a traffic mix
(``slam_bench/traffic/<traffic>.json``, data whose ``driver`` names the
module ``slam_bench/drivers/<driver>.py`` that drives the program, compares
its outputs with the reference and runs the control) and the limits its
check holds the outputs to (``slam_bench/limits/<cell>.json``). Each metric
is read by ``slam_bench/metrics/<metric>.py``. Each of these is found by its
name, so a new cell is new files and new entries. With ``--trace 0`` the last line of
standard output holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (from one traced stretch after the measured window).

The run simulates its seed's survey, warms up on a prefix of it (set-up
ends there), runs whole passes for ``--seconds``, reads the peak device
memory, frees the program's state and holds the last pass's outputs to the
plain reference (``slam_bench/reference``). It needs a CUDA card and never
falls back to the CPU.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sonar_slam_tpu")


def process_start() -> float:
    """The epoch time this process started (from /proc), or this module's
    import time where /proc has no record."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


class Cell(types.SimpleNamespace):
    """A workload of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and metrics."""

    @classmethod
    def find(cls, bench: dict, name: str) -> "Cell":
        """The cell ``name``, its files found by the names in ``bench``."""
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        spec = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[spec["config"]]
        end_to_end = [m for m in bench["end_to_end"]
                      if name in m.get("workloads", [name])]
        reported = {m["name"] for m in end_to_end}
        return cls(
            name=name, spec=spec, config=load_json(conf["file"]),
            traffic=load_json("slam_bench", "traffic", spec["traffic"] + ".json"),
            limits=load_json("slam_bench", "limits", name + ".json"),
            end_to_end=end_to_end,
            per_layer=[m for m in bench["per_layer"]
                       if name in m.get("workloads", [name])
                       and m["moves"] in reported])


def _load(kind: str, name: str):
    """``slam_bench/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return _load("metrics", metric).read


def driver_module(cell: Cell):
    """The module of the cell's driver, named by its traffic mix."""
    return _load("drivers", cell.traffic["driver"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(cell: Cell, seed: int, seconds: float, traced: bool, dev,
        t_start: float, chrome_trace: str | None = None, log=print) -> dict:
    """One run of ``cell`` on ``dev``: the result line's object, with the
    compared numbers under ``checks``."""
    import torch

    from slam_bench import simulate
    from slam_bench.harness import check, configs

    on_card = dev.type == "cuda"
    t0 = time.time()
    bag = simulate.simulate_bag(configs.sim_config(cell.config, seed))
    t1 = time.time()
    mod = driver_module(cell)
    driver = mod.Driver(cell.config, cell.traffic, bag, dev, seed)
    t2 = time.time()
    driver.warmup()
    setup_s = time.time() - t_start
    log(f"setup: {setup_s:.3f} s (before the survey {t0 - t_start:.3f} s, "
        f"simulation {t1 - t0:.3f} s, driver {t2 - t1:.3f} s, warm-up "
        f"{time.time() - t2:.3f} s)")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    window = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"window: {window.passes} passes, {window.wall_s:.3f} s, pass "
        f"seconds {[round(s, 3) for s in window.pass_s]}")
    tr = info = None
    if traced:
        t0 = time.time()
        tr, reduce_s, info = driver.traced(chrome_trace)
        log(f"trace: {time.time() - t0:.1f} s in all, window {tr.window_s:.3f}"
            f" s, busy {tr.busy_s:.4f} s, {tr.kernels} kernels, "
            f"{tr.total_launches} launches ({tr.matched:.4f} of device events "
            f"matched to one), reduced in {reduce_s:.1f} s; launches by span "
            f"{tr.launches}; device s by span {tr.device_s}")
    cfar_calls = driver.cfar.shapes if driver.cfar is not None else []
    prog = driver.outputs()
    del driver
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.time()
    numbers = check.run_reference(mod, prog, bag, cell.config, cell.traffic,
                                  dev)
    correct, rows = check.judge(numbers, cell.limits)
    log(f"reference check took {time.time() - t0:.1f} s; other readings "
        f"{ {k: v for k, v in numbers.items() if k not in cell.limits} }")

    ctx = types.SimpleNamespace(window=window, setup_s=setup_s, trace=tr,
                                traced=info, cfar_calls=cfar_calls,
                                memory_peak_bytes=peak)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if window.latency_s:
        from slam_bench.harness import stats

        log(f"keyframe latency p95 over {len(window.latency_s)} keyframes, "
            f"{stats.beyond(window.latency_s, 95)} beyond it")
    device = {"platform": "gpu" if on_card else dev.type,
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": cell.spec["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(rows),
           "failed": sum(1 for _, v, lim in rows
                         if not (math.isfinite(v) and v <= lim)),
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in tr.device_ops],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--chrome-trace", default=None,
                   help="also write the traced stretch as a chrome trace")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = Cell.find(load_json("BENCHMARK.json"), args.workload)
    import sonar_slam_torch.pipeline  # noqa: F401  (the program under test)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.spec["chips"]:
        log(f"{cell.name} needs {cell.spec['chips']} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    dev = torch.device("cuda:0")
    out = run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start,
              args.chrome_trace, log)
    log(f"card: {power_limit()}; torch {torch.__version__}")
    found = forbidden_modules()
    if found:
        log(f"loaded after the window: {', '.join(found)}; no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
