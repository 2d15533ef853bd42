"""The keyframe-axis reductions of the NSSM target search, K-batched and
K-sharded.

Counterpart of ``sonar_slam_tpu/parallel/keyframe_shard.py``. The reference's
spatial-growth hot spots scan all past keyframes: the NSSM target search
gates every keyframe's cloud against the source window's fields of view, and
the graph update re-transforms every keyframe's points. Without a mesh each
function is that computation batched over all K keyframes on their device.
With a mesh (``parallel/mesh.py``; ``kf_sharding`` cuts the K axis) every
rank passes the whole arrays, computes its contiguous block of K / size
keyframes, and the per-keyframe results (the global clouds, ``sel`` and
``counts``) are all-gathered, as the JAX package's ``shard_map`` does. The
per-keyframe arithmetic is the same either way.

Numerics follow ``slam/core.py::_run_nssm``'s ``frame_sel`` chain.
"""

from __future__ import annotations

import torch

from ..geometry import se2_inverse, se2_transform_points
from ..slam.scan_matching import max_eig_2x2
from .mesh import Mesh, check_axis, check_divisible, gather, shard


def kf_sharding(mesh: Mesh, axis: str = "kf"):
    """The function that cuts a leading keyframe axis into this rank's
    contiguous block over ``axis`` (K divisible by the mesh size)."""
    check_axis(mesh, axis)
    return lambda x: shard(x, mesh)


def _k_map(fn, per_kf: tuple, mesh, axis):
    """``fn(*per_kf)``; with a mesh, on this rank's block of the keyframe
    axis of every tensor of ``per_kf``, its results gathered."""
    if mesh is None:
        return fn(*per_kf)
    check_divisible(per_kf[0].shape[0], mesh.size, "the keyframe count K")
    cut = kf_sharding(mesh, axis)
    return gather(fn(*(cut(x) for x in per_kf)), mesh)


def transform_clouds_sharded(points: torch.Tensor, poses: torch.Tensor,
                             mesh: Mesh | None = None,
                             axis: str = "kf") -> torch.Tensor:
    """Every keyframe's local cloud (K, N, 2) into the global frame through
    its pose (K, 3): the repaint/aggregation primitive; K-sharded over
    ``mesh``'s ``axis`` when given."""
    return _k_map(se2_transform_points, (points, poses), mesh, axis)


def nssm_gate_sharded(points, pmasks, poses, tgt_frames_ok, src_poses,
                      src_covs, src_ok, max_range: float,
                      half_aperture: float, mesh: Mesh | None = None,
                      axis: str = "kf"):
    """5-sigma FOV gating of every keyframe point against the source window.

    points (K, N, 2) local clouds, pmasks (K, N), poses (K, 3) current
    estimates, tgt_frames_ok (K,) candidate-frame mask, src_poses (W, 3)
    source-window poses, src_covs (W, 3, 3) their marginals, src_ok (W,)
    source-window validity. A point is selected iff it falls inside any
    valid source frame's covariance-padded FOV wedge and its frame is a
    candidate. With ``mesh`` the K axis is split over its ``axis`` and
    ``sel`` and ``counts`` are gathered. Returns (sel (K, N) bool, counts
    (K,) int64)."""
    return _k_map(
        lambda *k: _gate(*k, src_poses, src_covs, src_ok, max_range,
                         half_aperture),
        (points, pmasks, poses, tgt_frames_ok), mesh, axis)


def _gate(points, pmasks, poses, tgt_frames_ok, src_poses, src_covs, src_ok,
          max_range: float, half_aperture: float):
    """:func:`nssm_gate_sharded` on the keyframes given, on one device."""
    K, N = pmasks.shape
    flat = transform_clouds_sharded(points, poses).reshape(-1, 2)
    tstd = torch.sqrt(max_eig_2x2(src_covs[:, :2, :2]))
    rstd = torch.sqrt(src_covs[:, 2, 2])
    local = se2_transform_points(flat, se2_inverse(src_poses))  # (W, K*N, 2)
    rng = torch.linalg.vector_norm(local, dim=-1)
    brg = torch.atan2(local[..., 1], local[..., 0])
    inside = (rng < (tstd * 5.0 + max_range)[:, None]) & (
        torch.abs(brg) < (rstd * 5.0 + half_aperture)[:, None])
    sels = inside & src_ok[:, None]
    sel = torch.any(sels, dim=0).reshape(K, N) & pmasks & tgt_frames_ok[:, None]
    return sel, torch.sum(sel, dim=1)


def nssm_target_select_sharded(points, pmasks, poses, tgt_frames_ok,
                               src_poses, src_covs, src_ok, max_range: float,
                               half_aperture: float, min_counts: int = 10,
                               mesh: Mesh | None = None, axis: str = "kf"):
    """Gate (K-sharded over ``mesh`` when given), then pick the candidate
    frame with the most gated points (the first on a tie) from the gathered
    counts, on every rank. Returns (sel, counts, best, have)."""
    sel, counts = nssm_gate_sharded(points, pmasks, poses, tgt_frames_ok,
                                    src_poses, src_covs, src_ok, max_range,
                                    half_aperture, mesh, axis)
    counts_ok = counts > min_counts
    best = torch.argmax(torch.where(counts_ok, counts,
                                    torch.full_like(counts, -1)))
    return sel, counts, best, torch.any(counts_ok)
