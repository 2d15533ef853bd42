"""Conversion of the JAX package's configuration and state into the port's.

The system has no weights: its state is its configuration (``SlamDims``,
``SlamParams``, ``RefineParams``, ``FeatureConfig``, ``ICPConfig``,
``DRConfig``, ``GyroConfig``, ``KalmanConfig``) and, mid-run, a
``SlamCarry`` (with its ``GraphState``) or a multi-robot
``KeyframeSummary``. Each function here takes the JAX package's object with its
arrays already turned into numpy arrays (``np.asarray`` on every leaf) and
its other values as plain Python values, and returns the port's equivalent.
Nothing here imports JAX: the objects are read by field name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cloud import ICPConfig
from .estimators import DRConfig, GyroConfig, KalmanConfig
from .graph import GraphState
from .parallel.multi_robot import KeyframeSummary
from .slam.core import SlamCarry, SlamDims, SlamParams
from .slam.frontend import FeatureConfig
from .slam.refine import RefineParams

_INT_COUNTERS = ("num_kf", "q_head", "num_loops")


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return dict(obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dict(obj._asdict())


def icp_config_from_reference(cfg) -> ICPConfig:
    return ICPConfig(**_fields(cfg))


def feature_config_from_reference(cfg) -> FeatureConfig:
    return FeatureConfig(**_fields(cfg))


def dr_config_from_reference(cfg) -> DRConfig:
    src = _fields(cfg)
    return DRConfig(**{k: (bool(src[k]) if k == "use_gyro" else float(src[k]))
                       for k in DRConfig._fields})


def dims_from_reference(dims) -> SlamDims:
    """The port's ``SlamDims`` fields of ``dims``: every field but the TPU
    scan's ``scan_chunk``, which the port's scan has no use for."""
    src = _fields(dims)
    f = {k.name: src[k.name] for k in dataclasses.fields(SlamDims)}
    f["icp"] = icp_config_from_reference(f["icp"])
    f["refine_scale_anchor_sigma"] = tuple(f["refine_scale_anchor_sigma"])
    return SlamDims(**f)


def _scalar(v):
    """A numpy scalar as the Python value holding its exact value."""
    v = np.asarray(v)
    if v.dtype == np.bool_:
        return bool(v)
    if v.dtype.kind in "iu":
        return int(v)
    return float(np.float32(v))


def _leaves(cls, cfg, device):
    """Arrays become float32 tensors on ``device``, scalars the Python values
    holding their exact value (``_scalar``)."""
    src = _fields(cfg)
    out = {}
    for name in cls._fields:
        v = np.asarray(src[name])
        out[name] = (torch.as_tensor(v.astype(np.float32), device=device)
                     if v.ndim else _scalar(v))
    return cls(**out)


def refine_params_from_reference(rp, device) -> RefineParams:
    """A JAX ``RefineParams`` (numpy leaves) -> the port's: scalars become
    Python numbers and bools, vectors float32 tensors on ``device``."""
    return _leaves(RefineParams, rp, device)


def gyro_config_from_reference(cfg, device) -> GyroConfig:
    return _leaves(GyroConfig, cfg, device)


def kalman_config_from_reference(cfg, device) -> KalmanConfig:
    return _leaves(KalmanConfig, cfg, device)


def params_from_reference(params, device) -> SlamParams:
    """Scalars become Python numbers holding the exact float32 value, flags
    Python bools, vectors float32 tensors on ``device``."""
    src = _fields(params)
    out = {}
    for name, ann in SlamParams.__annotations__.items():
        ann = getattr(ann, "__forward_arg__", ann)
        v = np.asarray(src[name])
        if ann == "torch.Tensor":
            out[name] = torch.as_tensor(v.astype(np.float32), device=device)
        elif ann == "bool":
            out[name] = bool(v)
        elif ann == "int":
            out[name] = int(v)
        else:
            out[name] = float(np.float32(v))
    return SlamParams(**out)


def _tensor(v, device):
    a = np.array(v)  # a copy: a JAX array's numpy view is read-only
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def carry_from_reference(carry, device) -> SlamCarry:
    """A ``SlamCarry`` of numpy leaves -> the port's carry on ``device``."""
    src = _fields(carry)
    out = {}
    for name in SlamCarry._fields:
        if name in _INT_COUNTERS:
            out[name] = int(np.asarray(src[name]))
        elif name == "graph":
            out[name] = graph_from_reference(src[name], device)
        else:
            out[name] = _tensor(src[name], device)
    return SlamCarry(**out)


def graph_from_reference(graph, device) -> GraphState:
    """A ``GraphState`` of numpy leaves -> the port's on ``device`` (indices
    and counts int64, floats float32)."""
    g = _fields(graph)
    return GraphState(**{k: _tensor(g[k], device) for k in GraphState._fields})


def summary_from_reference(summary, device) -> KeyframeSummary:
    """A multi-robot ``KeyframeSummary`` of numpy leaves (any leading robot
    or candidate axes) -> the port's on ``device``."""
    s = _fields(summary)
    return KeyframeSummary(**{k: _tensor(s[k], device)
                              for k in KeyframeSummary._fields})
