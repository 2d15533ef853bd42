"""Trimmed point-to-point / point-to-line ICP on SE(2), batched over lanes.

Counterpart of ``sonar_slam_tpu/cloud/icp.py``. The JAX version runs a
``while_loop`` under ``vmap``: each lane iterates until its differential
checker fires, it starves of matches, or it reaches ``max_iterations``, and a
finished lane stays frozen while the others go on. Here the lanes are a
leading batch axis and the loop runs at most ``max_iterations`` trips; a lane
takes a trip's update only while ``~done & (iters < max_iterations)``. The
loop stops early once no lane is active, which costs one host sync per trip.

A lane is either one start against a shared source and target
(:func:`icp_multistart`, the multi-start search) or one registration of a
pair of its own (:func:`icp_pairs`, the refinement fan-outs: every lane
aligns a different source onto a different target). Lanes never interact,
so a batch gives each lane the result it would get alone: within rounding,
and on a card bit for bit with ``lone_rows`` (a sweep's lanes, whose sums
then add in a lone call's order and whose point-to-line solves are each
lane's own calls, ``lone_sums.py``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..geometry import se2_compose, se2_transform_points, wrap_angle
from ..lone_sums import each_lane, lone_operand, lone_sum
from ..utils.timing import host_read
from .knn import nn_match, sq32
from .normals import estimate_normals


class ICPConfig(NamedTuple):
    """Static ICP pipeline parameters (same fields and defaults as the JAX
    package's ``ICPConfig``)."""

    max_iterations: int = 40
    knn_max_dist: float = 10.0
    outlier_max_dist: float = 3.0
    trim_ratio: float = 0.8
    min_diff_rot: float = 0.01
    min_diff_trans: float = 0.1
    smooth_length: int = 4
    min_matched_points: int = 3
    point_to_line: bool = False
    normal_k: int = 8
    normal_radius: float = 2.0
    outlier_dist_decay: float = 1.0
    outlier_min_dist: float = 0.5


class ICPResult(NamedTuple):
    pose: torch.Tensor  # (..., 3) source->target SE(2) estimate
    ok: torch.Tensor  # bool: never starved of matches
    converged: torch.Tensor  # bool: differential checker fired
    iterations: torch.Tensor  # int: iterations applied
    inliers: torch.Tensor  # int: final match count
    info: torch.Tensor  # (..., 3, 3) J^T J at the solution
    mse: torch.Tensor  # mean squared inlier residual


def _plain_sum(x, dim):
    return torch.sum(x, dim=dim)


def _weighted_procrustes(src, dst, w, rsum=_plain_sum):
    """Closed-form weighted rigid alignment src->dst per lane: (G, 3).
    ``rsum`` takes the lanes' sums (``torch.sum``, or a lone call's order,
    :func:`_icp_lanes`)."""
    wsum = torch.clamp(rsum(w, -1), min=1e-9)
    pc = rsum(src * w[..., None], -2) / wsum[:, None]
    qc = rsum(dst * w[..., None], -2) / wsum[:, None]
    a = src - pc[:, None]
    b = dst - qc[:, None]
    sxx = rsum(w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]), -1)
    syx = rsum(w * (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), -1)
    theta = torch.atan2(syx, sxx)
    c, s = torch.cos(theta), torch.sin(theta)
    tx = qc[:, 0] - (c * pc[:, 0] - s * pc[:, 1])
    ty = qc[:, 1] - (s * pc[:, 0] + c * pc[:, 1])
    return torch.stack([tx, ty, theta], dim=-1)


def _p2l_solve(aw, a, r):
    """The point-to-line normal equations of G lanes, A = aw^T a and rhs =
    -aw^T r, solved with a ridge of 1e-5 * trace(A) anchoring directions
    the lines leave unobserved: (delta (G, 3), A (G, 3, 3))."""
    A = torch.matmul(aw.transpose(-1, -2), a)
    rhs = -torch.matmul(aw.transpose(-1, -2), r[..., None])[..., 0]
    ridge = 1e-5 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) + 1e-9
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    x, _ = torch.linalg.solve_ex(A + ridge[:, None, None] * eye, rhs)
    return x, A


def _weighted_p2l(src, dst, normals, w, rsum=_plain_sum, solve=_p2l_solve):
    """One linearized point-to-line update per lane. Returns (delta (G, 3),
    constraint weight (G,), A (G, 3, 3), mse (G,)). ``rsum`` takes the
    lanes' sums and ``solve`` their normal equations (:func:`_p2l_solve`,
    or each sweep lane's own call, :func:`_icp_lanes`)."""
    have_n = torch.sum(normals * normals, dim=-1) > 0.5
    wn = w * have_n.to(src.dtype)
    r = torch.sum(normals * (src - dst), dim=-1)
    jp = torch.stack([-src[..., 1], src[..., 0]], dim=-1)
    a = torch.stack(
        [normals[..., 0], normals[..., 1], torch.sum(normals * jp, dim=-1)],
        dim=-1,
    )  # (G, N, 3)
    x, A = solve(a * wn[..., None], a, r)
    x = torch.cat([x[:, :2], torch.clamp(x[:, 2:], -0.5, 0.5)], dim=-1)
    n_con = rsum(wn, -1)
    mse = rsum(wn * r * r, -1) / torch.clamp(n_con, min=1.0)
    return x, n_con, A, mse


def _p2p_info(moved, dst, w, rsum=_plain_sum):
    """J^T J and mean squared residual of the point-to-point objective."""
    r = dst - moved
    mx, my = moved[..., 0], moved[..., 1]
    sw = rsum(w, -1)
    z = torch.zeros_like(sw)
    a02 = rsum(w * -my, -1)
    a12 = rsum(w * mx, -1)
    a22 = rsum(w * (mx * mx + my * my), -1)
    info = torch.stack([
        torch.stack([sw, z, a02], -1),
        torch.stack([z, sw, a12], -1),
        torch.stack([a02, a12, a22], -1),
    ], -2)
    mse = rsum(w * torch.sum(r * r, dim=-1), -1) / torch.clamp(2.0 * sw, min=1.0)
    return info, mse


def censi_covariance(info: torch.Tensor, mse: torch.Tensor, pose: torch.Tensor,
                     ridge: float = 1e-6) -> torch.Tensor:
    """Registration covariance of the result pose from (J^T J, mse),
    batched over leading dims (Censi-style closed form)."""
    tr = torch.diagonal(info, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=info.dtype, device=info.device)
    A = info + (ridge * tr + 1e-12)[..., None, None] * eye
    inv, _ = torch.linalg.inv_ex(A)
    cov_delta = mse[..., None, None] * inv
    one, zero = torch.ones_like(pose[..., 0]), torch.zeros_like(pose[..., 0])
    G = torch.stack([
        torch.stack([one, zero, -pose[..., 1]], -1),
        torch.stack([zero, one, pose[..., 0]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return torch.matmul(torch.matmul(G, cov_delta), G.transpose(-1, -2))


def _each_sweep_lane_p2l(rows, stepping, aw, a, r):
    """:func:`_p2l_solve` of G = B * ``rows`` lanes as B sweep lanes' own
    calls on ``rows`` lanes each, for the sweep lanes listed in
    ``stepping`` (the others' results are zero)."""
    x, A = each_lane(
        lambda *t: _p2l_solve(*(lone_operand(u) for u in t)), stepping,
        *(t.unflatten(0, (-1, rows)) for t in (aw, a, r)))
    return x.flatten(0, 1), A.flatten(0, 1)


def _trim_threshold(d2, valid, ratio):
    """Per-lane squared-distance cutoff keeping ``ratio`` of the valid matches."""
    n = d2.shape[-1]
    d2_sorted = torch.sort(torch.where(valid, d2, torch.full_like(d2, float("inf"))),
                           dim=-1).values
    count = torch.sum(valid, dim=-1).to(d2.dtype)
    k = torch.clamp(torch.ceil(ratio * count).to(torch.int64) - 1, 0, n - 1)
    return torch.gather(d2_sorted, -1, k[:, None])[:, 0]


def _icp_lanes(source_points, source_mask, target_points, target_mask, guesses,
               cfg: ICPConfig, source_weights=None, target_weights=None,
               lone_rows=None):
    """ICP over G lanes. Source and target are shared ([N, 2] / [M, 2]) or
    per lane ([G, N, 2] / [G, M, 2]); masks and weights follow their cloud.
    ``lone_rows`` says that the G lanes are a sweep's lanes of that many
    each, whose sums are added as one lane's lone call of ``lone_rows``
    adds them (``lone_sums.lone_sum``) and whose point-to-line normal
    equations are solved by a call of each sweep lane's own
    (``lone_sums.each_lane``), for the sweep lanes still stepping."""
    dtype = source_points.dtype
    dev = source_points.device
    G = guesses.shape[0]
    M = target_points.shape[-2]
    per_lane = target_points.ndim == 3
    lanes = torch.arange(G, device=dev)[:, None]

    def take(table, idx):  # table rows idx (G, N), shared or per lane
        return table[lanes, idx] if per_lane else table[idx]

    rsum = _plain_sum if lone_rows is None else partial(lone_sum, rows=lone_rows)
    each_sweep_lane = cfg.point_to_line and lone_rows is not None
    solve = _p2l_solve

    if cfg.point_to_line:
        tgt_normals = estimate_normals(
            target_points, target_mask, cfg.normal_k, cfg.normal_radius)

    pose = guesses.to(dtype)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    ok = torch.ones(G, dtype=torch.bool, device=dev)
    iters = torch.zeros(G, dtype=torch.int64, device=dev)
    rot_hist = torch.full((G, cfg.smooth_length), 1e6, dtype=dtype, device=dev)
    trans_hist = rot_hist.clone()
    inliers = torch.zeros(G, dtype=torch.int64, device=dev)
    info = torch.zeros((G, 3, 3), dtype=dtype, device=dev)
    mse = torch.zeros(G, dtype=dtype, device=dev)

    for _ in range(cfg.max_iterations):
        active = (~done) & (iters < cfg.max_iterations)
        if each_sweep_lane:
            stepping = torch.nonzero(host_read(
                torch.Tensor.cpu, active.reshape(-1, lone_rows).any(1)))[:, 0].tolist()
            if not stepping:
                break
            solve = partial(_each_sweep_lane_p2l, lone_rows, stepping)
        elif not host_read(bool, active.any()):
            break
        moved = se2_transform_points(source_points, pose)  # (G, N, 2)
        idx, d2 = nn_match(target_points, target_mask, moved, source_mask,
                           cfg.knn_max_dist)
        if cfg.outlier_dist_decay < 1.0:
            decay = host_read(torch.tensor, cfg.outlier_dist_decay, dtype=dtype,
                              device=dev)
            gate = torch.clamp(cfg.outlier_max_dist * decay ** iters.to(dtype),
                               min=cfg.outlier_min_dist)
            gate2 = (gate * gate)[:, None]
        else:
            gate2 = sq32(cfg.outlier_max_dist)
        valid = (idx != -1) & (d2 <= gate2)
        thresh = _trim_threshold(d2, valid, cfg.trim_ratio)
        w = (valid & (d2 <= thresh[:, None])).to(dtype)
        n_match = torch.sum(w, dim=-1).to(torch.int64)
        enough = n_match >= cfg.min_matched_points

        safe_idx = torch.clamp(idx, 0, M - 1)
        matched = take(target_points, safe_idx)
        ws = w
        if source_weights is not None:
            ws = ws * source_weights.to(dtype)
        if target_weights is not None:
            ws = ws * take(target_weights.to(dtype), safe_idx)
        if cfg.point_to_line:
            delta_l, n_con, info_l, mse_l = _weighted_p2l(
                moved, matched, take(tgt_normals, safe_idx), ws, rsum, solve)
            delta_p = _weighted_procrustes(moved, matched, ws, rsum)
            info_p, mse_p = _p2p_info(moved, matched, ws, rsum)
            use_l = n_con >= 3
            delta = torch.where(use_l[:, None], delta_l, delta_p)
            new_info = torch.where(use_l[:, None, None], info_l, info_p)
            new_mse = torch.where(use_l, mse_l, mse_p)
        else:
            delta = _weighted_procrustes(moved, matched, ws, rsum)
            new_info, new_mse = _p2p_info(moved, matched, ws, rsum)
        new_pose = se2_compose(delta, pose)

        n_rot = torch.cat([torch.abs(wrap_angle(delta[:, 2]))[:, None],
                           rot_hist[:, :-1]], dim=1)
        n_trans = torch.cat([torch.linalg.vector_norm(delta[:, :2], dim=-1)[:, None],
                             trans_hist[:, :-1]], dim=1)
        conv = (torch.mean(n_rot, dim=1) < cfg.min_diff_rot) & (
            torch.mean(n_trans, dim=1) < cfg.min_diff_trans)
        if cfg.outlier_dist_decay < 1.0:
            conv = conv & (gate <= cfg.outlier_min_dist * 1.001)

        step_ok = ok & enough
        advance = (~done) & step_ok
        n_pose = torch.where(advance[:, None], new_pose, pose)
        n_iters = iters + advance.to(torch.int64)
        n_inl = torch.where(advance, n_match, inliers)
        n_info = torch.where(advance[:, None, None], new_info, info)
        n_mse = torch.where(advance, new_mse, mse)
        n_done = done | conv | ~step_ok
        n_ok = step_ok | n_done

        # freeze lanes whose loop condition was already false
        a1, a2, a3 = active, active[:, None], active[:, None, None]
        pose = torch.where(a2, n_pose, pose)
        done = torch.where(a1, n_done, done)
        ok = torch.where(a1, n_ok, ok)
        iters = torch.where(a1, n_iters, iters)
        rot_hist = torch.where(a2, n_rot, rot_hist)
        trans_hist = torch.where(a2, n_trans, trans_hist)
        inliers = torch.where(a1, n_inl, inliers)
        info = torch.where(a3, n_info, info)
        mse = torch.where(a1, n_mse, mse)

    converged = (torch.mean(rot_hist, dim=1) < cfg.min_diff_rot) & (
        torch.mean(trans_hist, dim=1) < cfg.min_diff_trans)
    return ICPResult(pose=pose, ok=inliers >= cfg.min_matched_points,
                     converged=converged, iterations=iters, inliers=inliers,
                     info=info, mse=mse)


def icp(source_points, source_mask, target_points, target_mask, guess,
        config: ICPConfig = ICPConfig(), source_weights=None,
        target_weights=None) -> ICPResult:
    """Align source onto target from one SE(2) guess (3,). ``source_weights``
    / ``target_weights`` scale each correspondence's solve weight; gating
    stays binary."""
    res = _icp_lanes(source_points, source_mask, target_points, target_mask,
                     guess[None], config, source_weights, target_weights)
    return ICPResult(*(f[0] for f in res))


def icp_multistart(source_points, source_mask, target_points, target_mask,
                   guesses, guess_mask, config: ICPConfig = ICPConfig(),
                   source_weights=None, target_weights=None) -> ICPResult:
    """ICP over G starts (G, 3) at once; ``ok`` is masked by ``guess_mask``."""
    res = _icp_lanes(source_points, source_mask, target_points, target_mask,
                     guesses, config, source_weights, target_weights)
    return res._replace(ok=res.ok & guess_mask)


def icp_pairs(source_points, source_mask, target_points, target_mask, guesses,
              config: ICPConfig = ICPConfig(), source_weights=None,
              target_weights=None, lone_rows=None) -> ICPResult:
    """L independent registrations at once: lane l aligns source_points[l]
    ([L, N, 2]) onto target_points[l] ([L, M, 2]) from guesses[l] ([L, 3]);
    weights are [L, N] / [L, M]. Lane l's result equals
    ``icp(source_points[l], ..., guesses[l])``; bit for bit on a CUDA card
    with ``lone_rows`` 1 (:func:`_icp_lanes`)."""
    return _icp_lanes(source_points, source_mask, target_points, target_mask,
                      guesses, config, source_weights, target_weights,
                      lone_rows)


def icp_multistart_lanes(source_points, source_mask, target_points,
                         target_mask, guesses, guess_mask,
                         config: ICPConfig = ICPConfig(), source_weights=None,
                         target_weights=None) -> ICPResult:
    """:func:`icp_multistart` over B sweep lanes at once: lane b runs its G
    starts ``guesses[b]`` (B, G, 3) from the source (shared [N, 2] or its
    own [B, N, 2]) onto its own target [B, M, 2]; weights are [B, N] /
    [B, M]. Returns the ICPResult with fields (B, G, ...); lane b equals
    ``icp_multistart`` on lane b's operands (the B * G starts are the lanes
    of one :func:`_icp_lanes` call, summed as lone calls of G starts)."""
    B, G = guesses.shape[:2]

    def per_start(x):
        return None if x is None else x.repeat_interleave(G, dim=0)

    shared = source_points.ndim == 2
    res = _icp_lanes(
        source_points if shared else per_start(source_points),
        source_mask if shared else per_start(source_mask),
        per_start(target_points), per_start(target_mask),
        guesses.reshape(B * G, 3), config, per_start(source_weights),
        per_start(target_weights), lone_rows=G)
    res = ICPResult(*(f.reshape((B, G) + f.shape[1:]) for f in res))
    return res._replace(ok=res.ok & guess_mask)
