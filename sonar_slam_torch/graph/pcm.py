"""Pairwise Consistent Measurement (PCM) loop-closure vetting.

Counterpart of ``sonar_slam_tpu/graph/pcm.py``: loops a and b are consistent
when the cycle through them agrees with b's measurement under b's covariance
(Mahalanobis distance below chi2.ppf(0.99, 3)); the accepted loops are the
maximum clique, found by enumerating all 2^Q subsets of the small queue.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se2_between, se2_compose, se2_logmap
from ..utils.timing import host_read, to_device

CHI2_99_3DOF = 11.34


def pairwise_consistency_matrix(source_poses, target_poses, transforms, covs,
                                valid, chi2_gate: float = CHI2_99_3DOF):
    """(Q, Q) bool: [a, b] true iff loops a and b are pairwise consistent;
    (B, Q, Q) for B lanes' queues (every argument with a leading lane
    axis)."""
    Q = source_poses.shape[-2]
    pi = target_poses[..., :, None, :]  # a
    pj = target_poses[..., None, :, :]  # b
    pil = transforms[..., :, None, :]
    plk = se2_between(source_poses[..., :, None, :],
                      source_poses[..., None, :, :])
    pjk1 = transforms[..., None, :, :].expand(pil.shape[:-3] + (Q, Q, 3))
    pjk2 = se2_between(pj, se2_compose(se2_compose(pi, pil), plk))
    err = se2_logmap(se2_between(pjk1, pjk2))  # (..., Q, Q, 3)
    inv, _ = torch.linalg.inv_ex(covs)  # (..., Q, 3, 3), indexed by b
    eq = "abi,bij,abj->ab" if err.ndim == 3 else "zabi,zbij,zabj->zab"
    md = torch.einsum(eq, err, inv, err)
    mat = (md < chi2_gate) & valid[..., :, None] & valid[..., None, :]
    return mat & ~torch.eye(Q, dtype=torch.bool, device=mat.device)


def _subset_table(q: int) -> np.ndarray:
    return np.array(
        [[(s >> b) & 1 for b in range(q)] for s in range(2**q)], dtype=bool)


def max_clique_mask(consistency, valid, min_size: int):
    """Maximum clique by exhaustive subset scan; ties go to the lowest subset
    index. Returns (member mask (Q,), size); all False when the best clique
    is smaller than ``min_size``. Batched over leading dims (a sweep's
    lanes), which share the subset table."""
    Q = consistency.shape[-1]
    dev = consistency.device
    subsets = to_device(_subset_table(Q), dev)
    eye = torch.eye(Q, dtype=torch.bool, device=dev)
    pair_ok = (consistency[..., None, :, :]
               | ~(subsets[:, :, None] & subsets[:, None, :]) | eye)
    is_clique = pair_ok.flatten(-2).all(dim=-1) & (
        subsets <= valid[..., None, :]).all(dim=-1)
    sizes = subsets.sum(dim=1)
    score = torch.where(is_clique, sizes, torch.full_like(sizes, -1))
    best = torch.argmax(score, dim=-1)
    # one graph indexes by a device scalar, which the host reads
    at = host_read(int, best) if best.ndim == 0 else best
    best_size = sizes[at]
    ok = (torch.gather(score, -1, best[..., None])[..., 0] >= 0) & (
        best_size >= min_size)
    return (torch.where(ok[..., None], subsets[at],
                        torch.zeros_like(subsets[at])),
            torch.where(ok, best_size, torch.zeros_like(best_size)))


def pcm_select(source_poses, target_poses, transforms, covs, valid,
               min_pcm: int, chi2_gate: float = CHI2_99_3DOF):
    """Consistency matrix + max clique -> accepted-loop mask."""
    mat = pairwise_consistency_matrix(source_poses, target_poses, transforms,
                                      covs, valid, chi2_gate)
    return max_clique_mask(mat, valid, min_pcm)


def max_clique_host(adjacency: dict[int, set[int]]) -> list[int]:
    """Largest clique of a host-side graph of any size (``SLAM.find_cliques``
    of the reference, for queues beyond the subset scan): vertices listed in
    the order they were added, empty for an empty graph. A branch stops once
    it cannot beat the best clique found."""
    best: list[int] = []

    def expand(clique, candidates):
        nonlocal best
        if not candidates:
            if len(clique) > len(best):
                best = list(clique)
            return
        for v in list(candidates):
            expand(clique + [v], candidates & adjacency[v])
            candidates = candidates - {v}
            if len(clique) + len(candidates) <= len(best):
                return

    expand([], set(adjacency))
    return best
