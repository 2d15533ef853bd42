"""A configuration file (``slam_bench/configs/<name>.json``) as the objects
the program and the reference take.

The same data builds both sides: ``build(cfg, port_types(), device)`` gives
the port's ``SlamDims``, ``SlamParams``, ``FeatureConfig``,
``RefineParams`` and ``DRConfig``; ``build(cfg, reference_types(), device)``
the reference's copies of them.
"""

from __future__ import annotations

import dataclasses
import importlib
import types
from typing import NamedTuple

import numpy as np
import torch

from slam_bench import simulate


class Built(NamedTuple):
    dims: object
    params: object
    features: object
    refine_params: object | None
    dr: object


def _types(root: str) -> types.SimpleNamespace:
    cloud = importlib.import_module(f"{root}.cloud")
    slam = importlib.import_module(f"{root}.slam")
    est = importlib.import_module(f"{root}.estimators")
    return types.SimpleNamespace(
        ICPConfig=cloud.ICPConfig, SlamDims=slam.SlamDims,
        SlamParams=slam.SlamParams, FeatureConfig=slam.FeatureConfig,
        RefineParams=slam.RefineParams, DRConfig=est.DRConfig,
        SonarGeometry=slam.SonarGeometry)


def port_types() -> types.SimpleNamespace:
    return _types("sonar_slam_torch")


def reference_types() -> types.SimpleNamespace:
    return _types("slam_bench.reference")


def _f32(x):
    return float(np.float32(x)) if isinstance(x, float) else x


def _overrides(values: dict, device) -> dict:
    """Float scalars as float32 values, lists as float32 tensors."""
    return {k: (torch.tensor(v, dtype=torch.float32, device=device)
                if isinstance(v, list) else _f32(v)) for k, v in values.items()}


def build(cfg: dict, t: types.SimpleNamespace, device) -> Built:
    dims = dict(cfg["dims"])
    dims["icp"] = t.ICPConfig(**dims["icp"])
    dims = t.SlamDims(**dims)
    params = t.SlamParams.default(dims, device)._replace(
        **_overrides(cfg["params"], device))
    rp = cfg.get("refine_params")
    refine = (t.RefineParams.default(device)._replace(**_overrides(rp, device))
              if rp is not None else None)
    return Built(dims=dims, params=params,
                 features=t.FeatureConfig(**cfg["features"]),
                 refine_params=refine, dr=t.DRConfig(**cfg["dr"]))


def sim_config(cfg: dict, seed: int) -> simulate.SimConfig:
    """The survey of ``cfg`` with the run's seed: the site is the
    configuration's (``world_seed``), the noise the seed's."""
    return simulate.SimConfig(**cfg["sim"], seed=int(seed) % 2**64,
                              world_seed=cfg["world_seed"])


def with_geometry(bag, t: types.SimpleNamespace):
    """``bag`` with its sonar geometry as ``t``'s ``SonarGeometry``."""
    g = bag.geometry
    fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    return bag._replace(geometry=t.SonarGeometry(**fields))


def prefix(bag, seconds: float):
    """The first ``seconds`` of a survey: every stream cut at that time."""
    def cut(times, *arrays):
        n = int(np.searchsorted(times, seconds, side="right"))
        return [times[:n]] + [None if a is None else a[:n] for a in arrays]

    imu_time, imu_rpy = cut(bag.imu_time, bag.imu_rpy)
    dvl_time, dvl_vel = cut(bag.dvl_time, bag.dvl_vel)
    depth_time, depth = cut(bag.depth_time, bag.depth)
    ping_time, images, truth, vimgs = cut(bag.ping_time, bag.ping_images,
                                          bag.true_pose_at_ping,
                                          bag.vertical_images)
    gyro = ((None, None) if bag.gyro_time is None
            else tuple(cut(bag.gyro_time, bag.gyro_delta)))
    return bag._replace(
        imu_time=imu_time, imu_rpy=imu_rpy, dvl_time=dvl_time, dvl_vel=dvl_vel,
        depth_time=depth_time, depth=depth, ping_time=ping_time,
        ping_images=images, true_pose_at_ping=truth, vertical_images=vimgs,
        gyro_time=gyro[0], gyro_delta=gyro[1])
