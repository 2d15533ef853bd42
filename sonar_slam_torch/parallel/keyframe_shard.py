"""The keyframe-axis reductions of the NSSM target search, as K-batched ops.

Counterpart of ``sonar_slam_tpu/parallel/keyframe_shard.py``. The reference's
spatial-growth hot spots scan all past keyframes: the NSSM target search
gates every keyframe's cloud against the source window's fields of view, and
the graph update re-transforms every keyframe's points. The JAX package
shards those two reductions over a mesh axis with ``shard_map``. One card has
no mesh: here the K axis is not split, and each function is the same
computation batched over all K keyframes on their device. The names are
kept so that each finds its counterpart; the ``mesh`` and ``axis``
arguments and ``kf_sharding`` have none.

Numerics follow ``slam/core.py::_run_nssm``'s ``frame_sel`` chain.
"""

from __future__ import annotations

import torch

from ..geometry import se2_inverse, se2_transform_points
from ..slam.scan_matching import max_eig_2x2


def transform_clouds_sharded(points: torch.Tensor,
                             poses: torch.Tensor) -> torch.Tensor:
    """Every keyframe's local cloud (K, N, 2) into the global frame through
    its pose (K, 3): the repaint/aggregation primitive."""
    return se2_transform_points(points, poses)


def nssm_gate_sharded(points, pmasks, poses, tgt_frames_ok, src_poses,
                      src_covs, src_ok, max_range: float,
                      half_aperture: float):
    """5-sigma FOV gating of every keyframe point against the source window.

    points (K, N, 2) local clouds, pmasks (K, N), poses (K, 3) current
    estimates, tgt_frames_ok (K,) candidate-frame mask, src_poses (W, 3)
    source-window poses, src_covs (W, 3, 3) their marginals, src_ok (W,)
    source-window validity. A point is selected iff it falls inside any
    valid source frame's covariance-padded FOV wedge and its frame is a
    candidate. Returns (sel (K, N) bool, counts (K,) int64)."""
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
                               half_aperture: float, min_counts: int = 10):
    """Gate, then pick the candidate frame with the most gated points (the
    first on a tie). Returns (sel, counts, best, have)."""
    sel, counts = nssm_gate_sharded(points, pmasks, poses, tgt_frames_ok,
                                    src_poses, src_covs, src_ok, max_range,
                                    half_aperture)
    counts_ok = counts > min_counts
    best = torch.argmax(torch.where(counts_ok, counts,
                                    torch.full_like(counts, -1)))
    return sel, counts, best, torch.any(counts_ok)
