"""A small cell for the CPU tests: bench.py --small's survey and dims
(chip_smoke.py ``small_config``), at both drivers, with the limits of the
full cells."""

import copy
import json
import os
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def small_config(full: dict) -> dict:
    cfg = copy.deepcopy(full)
    cfg["sim"] = {"duration": 90.0, "speed": 0.5, "sonar_rate": 1.0,
                  "num_ranges": 192, "num_bearings": 96, "loop_radius": 10.0,
                  "imu_rate": 20.0}
    dims = {k: v for k, v in cfg["dims"].items()
            if not k.startswith(("aggregate", "estimate", "dvl_scale",
                                 "nssm_reinit"))}
    dims.update(max_keyframes=32, max_points=128, target_capacity=512,
                nssm_sobol=128, max_loops=32)
    cfg["dims"] = dims
    cfg["params"] = dict(cfg["params"], keyframe_translation=2.0,
                         nssm_min_points=20, nssm_every=1,
                         icp_odom_sigmas=[0.3, 0.3, 0.1])
    cfg["features"] = {"max_points": 128, "corroborate": True}
    return cfg


def small_cell(name: str, warmup_s: float = 40.0):
    """``name``'s cell of BENCHMARK.json on the small survey."""
    bench = load("BENCHMARK.json")
    spec = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    traffic = dict(load("slam_bench", "traffic", spec["traffic"] + ".json"),
                   warmup_survey_s=warmup_s)
    traffic["check_steps"] = 32  # every step of the small survey
    if "trace_keyframes" in traffic:
        traffic["trace_keyframes"] = 4
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return types.SimpleNamespace(
        name=name, spec=spec, config=small_config(load(conf["file"])),
        traffic=traffic, limits=load("slam_bench", "limits", name + ".json"),
        end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])
