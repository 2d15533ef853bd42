"""Hyperparameter sweeps: one keyframe stream replayed under many
``SlamParams`` lanes.

Counterpart of ``sonar_slam_tpu/parallel/sweep.py``, which ``vmap``s its
traced ``slam_scan`` over the lanes and may shard the lane axis over a
device mesh. Here ``sweep_scan`` runs every lane through each keyframe
step together, as one lane-batched scan on the frames' device
(``slam/lanes.py``): every ``SlamParams`` field is a (B, ...) tensor, the
state carries a leading lane axis, and the host reads only which lanes
are still going. Lane i is ``slam_scan`` of lane i's parameters alone: bit
for bit on a CUDA card, within rounding on the CPU (``slam/lanes.py``).
With a mesh (``make_config_mesh``, ``parallel/mesh.py``) each rank scans
its contiguous block of lanes so, and the results are all-gathered.
``sweep_scan_loop`` is the plain version, the lanes one after another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..slam.core import KeyframeInput, SlamDims, SlamParams, slam_scan
from ..slam.lanes import slam_scan_lanes
# make_config_mesh is defined with the rank machinery and exported from here,
# where the JAX package defines it
from .mesh import (Mesh, check_axis, check_divisible, gather,  # noqa: F401
                   make_config_mesh, shard)


def stack_lanes(trees: list, device):
    """Stack equal-structured results (NamedTuples of tensors, host ints and
    ``None``) on a new leading lane axis. Host ints become an int64 tensor
    (B,) on ``device``; a field that is ``None`` in every lane stays ``None``,
    and a lane whose field is ``None`` where another's is not gets zeros (as
    the JAX scan leaves an unused slot)."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(stack_lanes([t[f] for t in trees], device)
                             for f in range(len(first))))
    if isinstance(first, torch.Tensor) or first is None:
        ref = next((x for x in trees if x is not None), None)
        if ref is None:
            return None
        return torch.stack([torch.zeros_like(ref) if x is None else x
                            for x in trees])
    return torch.tensor(trees, dtype=torch.int64, device=device)


def _kind(name: str) -> str:
    """A ``SlamParams`` field's declared kind: "torch.Tensor", "bool",
    "int" or "float"."""
    ann = SlamParams.__annotations__[name]
    return getattr(ann, "__forward_arg__", ann)


_DTYPES = {"bool": torch.bool, "int": torch.int64, "float": torch.float32}


def _cast(name: str, current, value):
    """``value`` as field ``name`` holds it: a tensor of ``current``'s dtype
    and device, or a Python bool, int, or float holding a float32 value."""
    kind = _kind(name)
    if kind == "torch.Tensor":
        return torch.as_tensor(value, dtype=current.dtype, device=current.device)
    if kind == "float":
        return float(np.float32(value))
    return bool(value) if kind == "bool" else int(value)


def stack_params(params_list: list[SlamParams]) -> SlamParams:
    """Stack per-lane params along a leading axis (lane count =
    len(list)): every field becomes a tensor on the params' device, the
    scalars float32, int64 or bool by their declared kind."""
    device = params_list[0].prior_sigmas.device
    fields = {}
    for name in SlamParams._fields:
        vals = [getattr(p, name) for p in params_list]
        kind = _kind(name)
        fields[name] = (torch.stack(vals) if kind == "torch.Tensor" else
                        torch.tensor(vals, dtype=_DTYPES[kind], device=device))
    return SlamParams(**fields)


def lane_params(stacked: SlamParams, i: int) -> SlamParams:
    """Lane ``i`` of ``stack_params``' result, with the scalar fields back as
    Python values (exact float32 values), as ``SlamParams`` holds them."""
    convert = {"torch.Tensor": lambda x: x, "bool": bool, "int": int,
               "float": float}
    return SlamParams(**{name: convert[_kind(name)](getattr(stacked, name)[i])
                         for name in SlamParams._fields})


def sweep_scan(frames: KeyframeInput, stacked_params: SlamParams,
               dims: SlamDims, mesh: Mesh | None = None, axis: str = "config"):
    """Replay the same keyframe stream under B parameter lanes at once.

    frames: un-batched KeyframeInput (shared across lanes).
    stacked_params: SlamParams with leading lane axis B (``stack_params``).
    With ``mesh`` (whose axis is ``axis``; B divisible by its size) every
    rank passes the same frames and params, scans its contiguous block of
    B / size lanes, and the carry and outputs are all-gathered in lane
    order. Returns (carry, outputs) with every leaf stacked on a leading
    lane axis, as ``stack_lanes`` stacks the lanes' lone ``slam_scan``
    results."""
    if mesh is None:
        return slam_scan_lanes(frames, stacked_params, dims)
    check_axis(mesh, axis)
    check_divisible(stacked_params.prior_sigmas.shape[0], mesh.size,
                    "the sweep's lane count")
    return gather(slam_scan_lanes(frames, shard(stacked_params, mesh), dims),
                  mesh)


def sweep_scan_loop(frames: KeyframeInput, stacked_params: SlamParams,
                    dims: SlamDims):
    """The plain version of :func:`sweep_scan`: ``slam_scan`` of each lane's
    parameters, one lane after another, stacked by ``stack_lanes``."""
    B = stacked_params.prior_sigmas.shape[0]
    runs = [slam_scan(frames, lane_params(stacked_params, i), dims)
            for i in range(B)]
    dev = frames.points.device
    return (stack_lanes([r[0] for r in runs], dev),
            stack_lanes([r[1] for r in runs], dev))


def vary(params: SlamParams, **field_values) -> list[SlamParams]:
    """Cartesian-free helper: one lane per (field, value) override set.

    ``vary(p, point_noise=[0.3, 0.5], ssm_max_translation=[2.0, 3.0])``
    produces lanes for zipped overrides (lists must be equal length); each
    value takes the kind of the field it replaces."""
    lengths = {len(v) for v in field_values.values()}
    if len(lengths) != 1:
        raise ValueError("all override lists must have the same length")
    (n,) = lengths
    return [params._replace(**{k: _cast(k, getattr(params, k), v[i])
                               for k, v in field_values.items()})
            for i in range(n)]
