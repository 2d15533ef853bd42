"""State export and checkpoint / resume.

Counterpart of ``sonar_slam_tpu/io/state.py``:

* ``get_states`` gives the reference's structured state array (its
  ``SLAM.get_states``): per keyframe [time, pose2, dr_pose3, cov (3x3)],
  with the covariances refreshed from the smoother and rotated into the
  global frame. The refresh computes every keyframe's marginal in one batch
  through ``graph.marginal_covariance``, the keys sharing one factorization
  (the JAX version vmaps one marginal per key).
* ``save_checkpoint`` / ``load_checkpoint`` write and read any ``NamedTuple``
  tree of tensors and Python scalars (``SlamCarry`` with its nested graph,
  ``MappingState``), flattened by field name in field order. The carry holds
  tensors and integers only, so a checkpoint is exact: resuming the scan from
  one is bit for bit the same as never stopping.
* ``load_reference_checkpoint`` reads a ``SlamCarry`` checkpoint written by
  the JAX package's ``save_checkpoint`` (leaves numbered in its pytree order)
  into the port's carry through ``convert.carry_from_reference``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import marginal_covariance
from ..slam.core import SlamDims

STATE_DTYPE = np.dtype(
    [
        ("time", np.float64),
        ("pose", np.float32, 3),
        ("dr_pose3", np.float32, 6),
        ("cov", np.float32, 9),
    ]
)

# The JAX package's SlamCarry and GraphState fields in their pytree order:
# its checkpoints number their leaves in this order, the graph's fields in
# place of ``graph``.
REFERENCE_CARRY_FIELDS = (
    "times", "dr_poses3", "dr_poses", "poses", "covs", "points", "pmasks",
    "num_kf", "graph", "ssm_slot", "q_source", "q_target", "q_tf", "q_cov",
    "q_inserted", "q_used", "q_head", "loops_i", "loops_j", "loops_tf",
    "loops_slot", "num_loops", "dr_basis", "pconf")
REFERENCE_GRAPH_FIELDS = (
    "poses", "num_poses", "prior_pose", "prior_sqrt_info", "f_i", "f_j", "f_z",
    "f_sqrt_info", "f_robust", "f_scaled", "num_factors", "log_scale",
    "log_scale_anchor")


def _global_cov(cov: np.ndarray, theta: float) -> np.ndarray:
    """Rotate a local-frame covariance into the global frame."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]], np.float32)
    out = cov.copy()
    out[:2, :2] = R @ out[:2, :2] @ R.T
    out[:2, 2] = R @ out[:2, 2]
    out[2, :2] = out[2, :2] @ R.T
    return out


def get_states(carry, dims: SlamDims, refresh_covs: bool = True) -> np.ndarray:
    """The trajectory as the reference's structured array (``STATE_DTYPE``).

    With ``refresh_covs`` the marginal covariance of every keyframe is
    recomputed from the current linearization, all keys from one
    factorization."""
    nk = int(carry.num_kf)
    states = np.zeros(nk, STATE_DTYPE)
    if nk == 0:
        return states
    if refresh_covs:
        keys = torch.arange(nk, device=carry.poses.device)
        covs = marginal_covariance(carry.graph, keys, dims.graph_config())
    else:
        covs = carry.covs[:nk]
    covs = covs.detach().cpu().numpy()

    times = carry.times[:nk].detach().cpu().numpy().astype(np.float64)
    poses = carry.poses[:nk].detach().cpu().numpy()
    dr3 = carry.dr_poses3[:nk].detach().cpu().numpy()
    t0 = times[0]
    for k in range(nk):
        states[k]["time"] = times[k] - t0
        states[k]["pose"] = poses[k]
        states[k]["dr_pose3"] = dr3[k]
        states[k]["cov"] = _global_cov(covs[k], poses[k][2]).ravel()
    return states


# ----------------------------------------------------------------------
# checkpoint / resume
# ----------------------------------------------------------------------


def _flatten(tree, prefix: str = ""):
    """(field path, leaf) pairs of a NamedTuple tree, in field order."""
    for name, value in zip(tree._fields, tree):
        path = prefix + name
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def save_checkpoint(path: str, carry) -> None:
    """Write a NamedTuple tree of tensors and Python scalars (SlamCarry,
    MappingState, ...) to ``path`` (npz), one entry per leaf named by its
    field path (``graph.poses``). A field that is None is left out."""
    arrays = {}
    for name, leaf in _flatten(carry):
        if isinstance(leaf, torch.Tensor):
            arrays[name] = leaf.detach().cpu().numpy()
        elif leaf is not None:
            arrays[name] = np.asarray(leaf)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _restore(tree, data, prefix: str = ""):
    values = []
    for name, leaf in zip(tree._fields, tree):
        path = prefix + name
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            values.append(_restore(leaf, data, path + "."))
            continue
        if leaf is None:
            values.append(None)
            continue
        if path not in data:
            raise ValueError(f"checkpoint has no leaf {path!r}")
        arr = data[path]
        if isinstance(leaf, torch.Tensor):
            want = torch.empty((), dtype=leaf.dtype).numpy().dtype
            if arr.shape != tuple(leaf.shape) or arr.dtype != want:
                raise ValueError(
                    f"checkpoint leaf {path!r} is {arr.dtype}{list(arr.shape)}, "
                    f"the template's {want}{list(leaf.shape)}")
            values.append(torch.as_tensor(arr, device=leaf.device))
        else:
            if arr.shape != () or np.asarray(leaf).dtype.kind != arr.dtype.kind:
                raise ValueError(
                    f"checkpoint leaf {path!r} is {arr.dtype}{list(arr.shape)}, "
                    f"the template's a Python {type(leaf).__name__}")
            values.append(type(leaf)(arr.item()))
    return type(tree)(*values)


def load_checkpoint(path: str, template):
    """Read a tree written by ``save_checkpoint`` into the structure of
    ``template``: every leaf's shape and dtype are checked against the
    template's, and tensors are loaded onto the template leaf's device."""
    with np.load(path, allow_pickle=False) as data:
        return _restore(template, data)


def load_reference_checkpoint(path: str, device):
    """A ``SlamCarry`` checkpoint written by the JAX package's
    ``save_checkpoint`` -> the port's carry on ``device``. Its leaves are
    numbered in the JAX pytree order (``REFERENCE_CARRY_FIELDS``, the graph's
    fields in place of ``graph``)."""
    from ..convert import carry_from_reference

    names = []
    for name in REFERENCE_CARRY_FIELDS:
        if name == "graph":
            names += [("graph", g) for g in REFERENCE_GRAPH_FIELDS]
        else:
            names.append((name, None))
    with np.load(path, allow_pickle=False) as data:
        leaves = [k for k in data.files if k.startswith("leaf_")]
        if len(leaves) != len(names):
            raise ValueError(f"{path} holds {len(leaves)} leaves, a JAX "
                             f"SlamCarry has {len(names)}")
        fields: dict = {"graph": {}}
        for i, (name, sub) in enumerate(names):
            arr = data[f"leaf_{i}"]
            if sub is None:
                fields[name] = arr
            else:
                fields["graph"][sub] = arr
    return carry_from_reference(fields, device)
