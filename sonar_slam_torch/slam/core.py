"""The SLAM core: ``carry, outputs = keyframe_step(carry, frame, ...)``.

Counterpart of ``sonar_slam_tpu/slam/core.py``. Each keyframe runs sequential
scan matching (SSM) against the last few keyframes (or falls back to the
dead-reckoning odometry), a Gauss-Newton update with the new keyframe's
marginal covariance, and on every ``nssm_every``-th keyframe the
non-sequential loop search (NSSM) with PCM vetting and a second update when a
loop lands.

What differs from the JAX version, and why:

* ``slam_scan`` is a Python loop over the valid keyframes, not a
  ``while_loop`` over chunks of padded slots.
* The two ``lax.cond`` branches that skip most of the work are host
  branches: whether NSSM runs at all is known on the host (it depends on the
  keyframe count and the cadence), and whether its loop reaches PCM is one
  host read of ``nssm_ok``. PCM's insertions need one more read (the mask of
  loops to insert). So an NSSM keyframe adds two host syncs, a plain keyframe
  none, besides the early-exit checks inside ICP and Gauss-Newton.
* Counters the host can know stay host integers (``num_kf``, ``q_head``,
  ``num_loops``); ``graph.num_factors`` depends on device decisions and stays
  a tensor.
* Scalar parameters are Python numbers (exact float32 values), flags Python
  bools; vectors are tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..cloud import (
    ICPConfig,
    VoxelGridSpec,
    count_overlap,
    icp,
    icp_multistart,
    nn_match,
    voxel_downsample,
    voxel_downsample_with_conf,
)
from ..cloud.icp import censi_covariance
from ..geometry import (
    pose3_to_pose2,
    se2_between,
    se2_compose,
    se2_inverse,
    se2_transform_points,
    wrap_angle,
)
from ..graph.factor_graph import (
    GraphConfig,
    GraphState,
    add_between,
    add_prior,
    cov_to_sqrt_info,
    graph_init,
    optimize_with_marginal,
    set_pose_estimate,
    sigmas_to_sqrt_info,
)
from ..graph.pcm import pcm_select
from ..precision import pin_fp32
from ..utils.timing import CodeTimer, host_read, to_device
from .scan_matching import (
    apply_covariance_floor,
    estimate_pose_covariance,
    global_initialize,
    localize_covariance,
    max_eig_2x2,
    sobol_unit_samples,
)

STATUS_SUCCESS = 0
STATUS_NOT_ENOUGH_POINTS = 1
STATUS_LARGE_TRANSFORMATION = 2
STATUS_NOT_ENOUGH_OVERLAP = 3
STATUS_NOT_CONVERGED = 4
STATUS_INITIALIZATION_FAILURE = 5
STATUS_NAMES = [
    "Success",
    "Not enough points",
    "Large transformation",
    "Not enough overlap",
    "Not converged",
    "Initialization failure",
]


@dataclass(frozen=True)
class SlamDims:
    """Static capacities and structural options: the fields of the JAX
    package's ``SlamDims``, with the same names and defaults (see there for
    what each one does), except the TPU scan's ``scan_chunk``. The
    ``refine_*`` fields configure ``slam/refine.py::refine_loops``."""

    max_keyframes: int = 128
    max_points: int = 256
    target_capacity: int = 1024
    ssm_target_frames: int = 3
    nssm_source_frames: int = 5
    nssm_min_st_sep: int = 8
    ssm_cov_samples: int = 0
    nssm_cov_samples: int = 30
    ssm_sobol: int = 64
    nssm_sobol: int = 512
    pcm_queue_slots: int = 6
    max_loops: int = 32
    gn_iters: int = 4
    icp: ICPConfig = ICPConfig()
    max_range: float = 30.0
    half_aperture: float = float(np.radians(65.0))
    nssm_target_window: int = 0
    nssm_pair_refine: bool = False
    pair_refine_max_dt: float = 0.2
    pair_refine_max_dr: float = 0.04
    pair_refine_min_inliers: int = 30
    nssm_reinit_after_select: bool = False
    aggregate_with_dr: bool = False
    aggregate_with_dr_basis: bool = False
    estimate_dvl_scale: bool = False
    dvl_scale_prior_sigma: float = 0.05
    dvl_scale_prior_sigma_y: float = 0.01
    refine_iters: int = 0
    refine_target_window: int = 2
    refine_sweep_topk: int = 1
    refine_sweep_budget: int = 0
    refine_scale_from_chain: bool = False
    refine_scale_anchor_sigma: tuple = (0.005, 0.01)
    refine_scale_basis: bool = False
    refine_incremental: bool = False
    refine_sweep: bool = False
    refine_chain: bool = False
    refine_final_sweep: bool = False
    aggregation_extent: float = 2.0
    point_resolution: float = 0.5

    def graph_config(self) -> GraphConfig:
        return GraphConfig(
            max_poses=self.max_keyframes,
            max_factors=3 * self.max_keyframes + self.max_loops + 4,
            gn_iters=self.gn_iters,
            estimate_scale=self.estimate_dvl_scale,
            scale_prior_sigma=(self.dvl_scale_prior_sigma,
                               self.dvl_scale_prior_sigma_y),
        )

    def agg_spec(self) -> VoxelGridSpec:
        half = self.aggregation_extent * self.max_range
        res = self.point_resolution
        n = int(np.ceil(2 * half / res)) + 1
        return VoxelGridSpec(x0=-half, y0=-half, resolution=res, nx=n, ny=n)


class SlamParams(NamedTuple):
    """Numeric parameters (slam.yaml): Python numbers for scalars, Python
    bools for flags, tensors for vectors."""

    keyframe_duration: float
    keyframe_translation: float
    keyframe_rotation: float
    prior_sigmas: torch.Tensor  # (3,)
    odom_sigmas: torch.Tensor  # (3,)
    icp_odom_sigmas: torch.Tensor  # (3,)
    point_resolution: float
    point_noise: float
    ssm_enable: bool
    ssm_min_points: int
    ssm_max_translation: float
    ssm_max_rotation: float
    nssm_enable: bool
    nssm_min_points: int
    nssm_max_translation: float
    nssm_max_rotation: float
    min_pcm: int
    pcm_queue_size: int
    nssm_every: int
    robust_ssm: bool
    fuse_odometry: bool
    use_censi_cov: bool
    use_best_start_tf: bool
    conf_ref: float
    conf_power: float
    ssm_sobol_pts: torch.Tensor  # (S1, 3)
    nssm_sobol_pts: torch.Tensor  # (S2, 3)

    @staticmethod
    def default(dims: SlamDims, device) -> "SlamParams":
        """slam.yaml defaults (float32 values, as the JAX package holds them)."""

        def f(x):
            return float(np.float32(x))

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return SlamParams(
            keyframe_duration=f(1.0), keyframe_translation=f(3.0),
            keyframe_rotation=f(np.radians(30)),
            prior_sigmas=vec([0.1, 0.1, 0.01]),
            odom_sigmas=vec([0.2, 0.2, 0.02]),
            icp_odom_sigmas=vec([0.1, 0.1, 0.01]),
            point_resolution=f(0.5), point_noise=f(0.5), ssm_enable=True,
            ssm_min_points=50, ssm_max_translation=f(3.0),
            ssm_max_rotation=f(np.radians(30)), nssm_enable=True,
            nssm_min_points=50, nssm_max_translation=f(10.0),
            nssm_max_rotation=f(np.radians(60)), min_pcm=2, pcm_queue_size=5,
            nssm_every=1, robust_ssm=False, fuse_odometry=False,
            use_censi_cov=False, use_best_start_tf=False, conf_ref=f(4.0),
            conf_power=f(0.0),
            ssm_sobol_pts=torch.as_tensor(sobol_unit_samples(dims.ssm_sobol),
                                          device=device),
            nssm_sobol_pts=torch.as_tensor(sobol_unit_samples(dims.nssm_sobol),
                                           device=device),
        )


class SlamCarry(NamedTuple):
    """The whole smoother state."""

    times: torch.Tensor  # (K,)
    dr_poses3: torch.Tensor  # (K, 6)
    dr_poses: torch.Tensor  # (K, 3)
    poses: torch.Tensor  # (K, 3) optimized
    covs: torch.Tensor  # (K, 3, 3)
    points: torch.Tensor  # (K, N, 2)
    pmasks: torch.Tensor  # (K, N)
    num_kf: int
    graph: GraphState
    ssm_slot: torch.Tensor  # (K,) int64, -1 when SSM failed
    q_source: torch.Tensor  # (Q,) PCM ring buffer
    q_target: torch.Tensor
    q_tf: torch.Tensor  # (Q, 3)
    q_cov: torch.Tensor  # (Q, 3, 3)
    q_inserted: torch.Tensor  # (Q,) bool
    q_used: torch.Tensor  # (Q,) bool
    q_head: int
    loops_i: torch.Tensor  # (L,) target keys
    loops_j: torch.Tensor  # (L,) source keys
    loops_tf: torch.Tensor  # (L, 3)
    loops_slot: torch.Tensor  # (L,) factor index
    num_loops: int
    dr_basis: torch.Tensor  # (K, 2, 2)
    pconf: torch.Tensor  # (K, N)


class StepOutputs(NamedTuple):
    pose: torch.Tensor
    cov: torch.Tensor
    ssm_status: torch.Tensor
    ssm_used_icp: torch.Tensor
    nssm_status: torch.Tensor
    nssm_target: torch.Tensor
    loop_added: torch.Tensor
    ssm_overlap: torch.Tensor
    nssm_overlap: torch.Tensor


class KeyframeInput(NamedTuple):
    time: torch.Tensor  # scalar
    dr_pose3: torch.Tensor  # (6,)
    points: torch.Tensor  # (N, 2)
    pmask: torch.Tensor  # (N,)
    valid: bool | torch.Tensor
    conf: torch.Tensor | None = None  # (N,)


def slam_init(dims: SlamDims, device) -> SlamCarry:
    K, N, Q, L = (dims.max_keyframes, dims.max_points, dims.pcm_queue_slots,
                  dims.max_loops)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(3, device=device)
    return SlamCarry(
        times=z(K), dr_poses3=z(K, 6), dr_poses=z(K, 3), poses=z(K, 3),
        covs=(eye[None] * 1e-4).repeat(K, 1, 1), points=z(K, N, 2),
        pmasks=z(K, N, dtype=torch.bool), num_kf=0,
        graph=graph_init(dims.graph_config(), device),
        ssm_slot=torch.full((K,), -1, dtype=torch.int64, device=device),
        q_source=z(Q, dtype=torch.int64), q_target=z(Q, dtype=torch.int64),
        q_tf=z(Q, 3), q_cov=eye[None].repeat(Q, 1, 1),
        q_inserted=z(Q, dtype=torch.bool), q_used=z(Q, dtype=torch.bool),
        q_head=0, loops_i=z(L, dtype=torch.int64),
        loops_j=z(L, dtype=torch.int64), loops_tf=z(L, 3),
        loops_slot=z(L, dtype=torch.int64), num_loops=0, dr_basis=z(K, 2, 2),
        pconf=z(K, N),
    )


# ----------------------------------------------------------------------
# keyframe selection pre-pass
# ----------------------------------------------------------------------


def select_keyframes(times: torch.Tensor, dr_poses: torch.Tensor,
                     candidate: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """Sequential keyframe gate: the first candidate, then every candidate
    more than ``keyframe_duration`` after the last keyframe that moved beyond
    the translation or rotation threshold. A host loop in float32 with one
    trip per keyframe: each trip gates all later pings against the newest
    keyframe at once and jumps to the first that passes. Returns a (T,) bool
    mask on the input's device."""
    t = host_read(torch.Tensor.cpu, times.detach()).to(torch.float32)
    p = host_read(torch.Tensor.cpu, dr_poses.detach()).to(torch.float32)
    ok = host_read(torch.Tensor.cpu, candidate.detach()).to(torch.bool)
    mask = torch.zeros(len(t), dtype=torch.bool)
    first = torch.nonzero(ok)
    i = int(first[0]) if len(first) else None
    while i is not None:
        mask[i] = True
        d = se2_between(p[i], p[i + 1:])
        moved = ((torch.linalg.vector_norm(d[:, :2], dim=-1)
                  > params.keyframe_translation)
                 | (torch.abs(d[:, 2]) > params.keyframe_rotation))
        passed = ok[i + 1:] & ((t[i + 1:] - t[i]) > params.keyframe_duration) & moved
        nxt = torch.nonzero(passed)
        i = i + 1 + int(nxt[0]) if len(nxt) else None
    return mask.to(times.device)


# ----------------------------------------------------------------------
# submap aggregation helpers
# ----------------------------------------------------------------------


def conf_weight(conf: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """Detection-count confidence -> correspondence weight
    ``clip(conf / conf_ref, 0, 1) ** conf_power`` (exactly 1 for power 0)."""
    base = torch.clamp(conf / max(params.conf_ref, 1e-6), 0.0, 1.0)
    return base ** params.conf_power


def scaled_dr_between(carry: SlamCarry, ref_key, keys, s: torch.Tensor):
    """Relative DR poses ref -> keys with the exact per-axis DVL-scale
    correction from the basis integrals (valid through turns). ``ref_key``
    and ``keys`` broadcast against each other."""
    d = carry.dr_basis[keys] - carry.dr_basis[ref_key]  # (..., 2, 2)
    tw = s[0] * d[..., 0, :] + s[1] * d[..., 1, :]  # (..., 2)
    th = carry.dr_poses[ref_key, 2]
    c, sn = torch.cos(th), torch.sin(th)
    tb = torch.stack([c * tw[..., 0] + sn * tw[..., 1],
                      -sn * tw[..., 0] + c * tw[..., 1]], dim=-1)
    dth = wrap_angle(carry.dr_poses[keys, 2] - th)
    return torch.cat([tb, dth[..., None]], dim=-1)


def _aggregate_windows(carry: SlamCarry, ref_pose, first_key, window: int,
                       spec: VoxelGridSpec, capacity: int, ref_key,
                       use_dr_relatives: bool = False, use_basis: bool = False):
    """Downsampled union of keyframes first_key .. first_key+window-1 in
    ``ref_pose``'s frame (keys outside [0, num_kf) masked), for L windows at
    once: ``ref_pose`` (L, 3), ``first_key`` and ``ref_key`` (L,) tensors.
    With ``use_dr_relatives`` the within-window relatives come from dead
    reckoning corrected by the current DVL-scale estimate. Lane l's result
    equals the single window's (:func:`_aggregate_window`)."""
    dev = carry.points.device
    K = carry.points.shape[0]
    keys = first_key[:, None] + torch.arange(window, device=dev)  # (L, W)
    ok = (keys >= 0) & (keys < carry.num_kf)
    safe = torch.clamp(keys, 0, K - 1)
    pts = carry.points[safe]
    masks = carry.pmasks[safe] & ok[..., None]
    confs = carry.pconf[safe]
    if use_dr_relatives:
        safe_ref = torch.clamp(ref_key, 0, K - 1)[:, None]
        s = torch.exp(carry.graph.log_scale)
        if use_basis:
            rel = scaled_dr_between(carry, safe_ref, safe, s)
        else:
            scale = torch.cat([s, torch.ones(1, device=dev)])
            rel = se2_between(carry.dr_poses[safe_ref], carry.dr_poses[safe]) * scale
    else:
        rel = se2_between(ref_pose[:, None], carry.poses[safe])
    moved = se2_transform_points(pts, rel)  # (L, W, N, 2)
    L = moved.shape[0]
    return voxel_downsample_with_conf(moved.reshape(L, -1, 2),
                                      masks.reshape(L, -1),
                                      confs.reshape(L, -1), spec, capacity)


def _aggregate_window(carry: SlamCarry, ref_pose, first_key: int, window: int,
                      spec: VoxelGridSpec, capacity: int, ref_key: int,
                      use_dr_relatives: bool = False, use_basis: bool = False):
    """One window of :func:`_aggregate_windows`: (points, mask, conf)."""
    dev = carry.points.device

    def lane(v):
        return to_device(v, dev).reshape(1)

    out = _aggregate_windows(carry, ref_pose[None], lane(first_key), window,
                             spec, capacity, lane(ref_key), use_dr_relatives,
                             use_basis)
    return tuple(o[0] for o in out)


def _mean_censi(mres):
    covs = censi_covariance(mres.info, mres.mse, mres.pose)
    w = mres.ok.to(torch.float32)
    return torch.sum(covs * w[:, None, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)


def _best_start(mres):
    score = torch.where(mres.ok, mres.inliers, torch.full_like(mres.inliers, -1))
    b = host_read(int, torch.argmax(score))
    return mres.pose[b], score[b] >= 0


def _status(ok, checks):
    """Nested status select: ``checks`` is [(failed, status), ...] in
    priority order; the last status applies when nothing before it failed."""
    out = torch.full_like(ok, checks[-1][1], dtype=torch.int64)
    for failed, code in reversed(checks[:-1]):
        out = torch.where(failed, code, out)
    return torch.where(ok, STATUS_SUCCESS, out)


def _norm2(v):
    return torch.linalg.vector_norm(v[:2])


def _set(arr, idx, val):
    out = arr.clone()
    out[idx] = val
    return out


# ----------------------------------------------------------------------
# the keyframe step
# ----------------------------------------------------------------------


def _run_nssm(c: SlamCarry, params: SlamParams, dims: SlamDims,
              spec: VoxelGridSpec):
    """Non-sequential scan matching of the newest keyframe window against
    older keyframes: (ok as a host bool, status, src_key, target key,
    transform, cov, overlap)."""
    with CodeTimer("nssm.sampling", silent=True):
        dev = c.poses.device
        K, N, M = dims.max_keyframes, dims.max_points, dims.target_capacity
        src_key = c.num_kf - 1
        src_pose = c.poses[src_key]
        src_pts, src_mask, src_conf = _aggregate_window(
            c, src_pose, src_key - dims.nssm_source_frames + 1,
            dims.nssm_source_frames, spec, M, ref_key=src_key,
            use_dr_relatives=dims.aggregate_with_dr,
            use_basis=dims.aggregate_with_dr_basis)
        nsrc_w = conf_weight(src_conf, params)
        n_src = torch.sum(src_mask)

        limit = c.num_kf - dims.nssm_min_st_sep
        kf_idx = torch.arange(K, device=dev)
        global_pts = se2_transform_points(c.points, c.poses)  # (K, N, 2)
        flat_global = global_pts.reshape(-1, 2)
        gmask = c.pmasks & (kf_idx < limit)[:, None]

        # 5-sigma FOV gating against each source-window frame
        src_keys = src_key - torch.arange(dims.nssm_source_frames, device=dev)
        safe_src = torch.clamp(src_keys, 0, K - 1)
        cov_w = c.covs[safe_src]
        tstd_w = torch.sqrt(max_eig_2x2(cov_w[:, :2, :2]))
        rstd_w = torch.sqrt(cov_w[:, 2, 2])
        local = se2_transform_points(flat_global, se2_inverse(c.poses[safe_src]))
        rng = torch.linalg.vector_norm(local, dim=-1)
        brg = torch.atan2(local[..., 1], local[..., 0])
        sels = (rng < (tstd_w * 5.0 + dims.max_range)[:, None]) & (
            torch.abs(brg) < (rstd_w * 5.0 + dims.half_aperture)[:, None])
        sels = sels & (src_keys >= 0)[:, None]
        sel = torch.any(sels, dim=0).reshape(K, N) & gmask

        counts = torch.sum(sel, dim=1)
        counts_ok = counts > 10
        total_sel = torch.sum(counts)
        t1 = torch.argmax(torch.where(counts_ok, counts, torch.full_like(counts, -1)))
        have_target = (torch.any(counts_ok) & (total_sel >= params.nssm_min_points)
                       & (n_src >= params.nssm_min_points))

        tpose1 = c.poses[host_read(int, t1)]
        flat_sel = sel.reshape(-1)
        local1 = se2_transform_points(flat_global, se2_inverse(tpose1))
        tpts1, tmask1 = voxel_downsample(local1, flat_sel, spec, M)
        flat_conf = c.pconf.reshape(-1)

        cov_src = c.covs[src_key]
        tstd = torch.sqrt(max_eig_2x2(cov_src[:2, :2]))
        rstd = torch.sqrt(cov_src[2, 2])
        bounds = 5.0 * torch.stack([tstd, tstd, rstd])
        n_guess = max(dims.nssm_cov_samples, 1)
        gi = global_initialize(src_pts, src_mask, tpts1, tmask1, src_pose, tpose1,
                               bounds, params.nssm_sobol_pts, params.point_noise,
                               n_guess)

        # overlap-based target re-selection
        est_global = se2_transform_points(src_pts, se2_compose(src_pose, gi.best_delta))
        idx, _ = nn_match(flat_global, flat_sel, est_global, src_mask,
                          params.point_noise)
        matched = idx != -1
        matched_frame = torch.clamp(idx, 0, K * N - 1) // N
        counts2 = torch.zeros(K, dtype=torch.int64, device=dev).index_add_(
            0, matched_frame, matched.to(torch.int64))
        have_overlap = torch.sum(matched) > 0
        t2 = torch.argmax(counts2)
        t2_host = host_read(int, t2)
        tpose2 = c.poses[t2_host]

        cand = counts_ok
        if dims.nssm_target_window > 0:
            cand = cand & (torch.abs(kf_idx - t2) <= dims.nssm_target_window)
        if dims.aggregate_with_dr and dims.nssm_target_window > 0:
            if dims.aggregate_with_dr_basis:
                rel = scaled_dr_between(c, t2_host, kf_idx,
                                        torch.exp(c.graph.log_scale))
            else:
                rel = se2_between(c.dr_poses[t2_host], c.dr_poses)
        else:
            rel = se2_between(tpose2, c.poses)
        local2 = se2_transform_points(c.points, rel).reshape(-1, 2)
        mask2 = (c.pmasks & cand[:, None]).reshape(-1)
        tpts2, tmask2, tconf2 = voxel_downsample_with_conf(local2, mask2, flat_conf,
                                                           spec, M)
        ntgt_w = conf_weight(tconf2, params)

        if dims.nssm_reinit_after_select:
            gi = global_initialize(src_pts, src_mask, tpts2, tmask2, src_pose,
                                   tpose2, bounds, params.nssm_sobol_pts,
                                   params.point_noise, n_guess)
        guesses = gi.guesses_vs(tpose2)
    with CodeTimer("nssm.icp", silent=True):
        mres = icp_multistart(src_pts, src_mask, tpts2, tmask2, guesses,
                              gi.guess_mask, dims.icp, nsrc_w, ntgt_w)
        mu, scov, n_ok = estimate_pose_covariance(mres.pose, mres.ok)
        enough_samples = n_ok >= 5
        if params.use_best_start_tf:
            best_pose, best_ok = _best_start(mres)
            mu = torch.where(best_ok, best_pose, mu)

        if dims.nssm_pair_refine:
            rr = icp(c.points[src_key], c.pmasks[src_key], c.points[t2_host],
                     c.pmasks[t2_host], mu, dims.icp,
                     conf_weight(c.pconf[src_key], params),
                     conf_weight(c.pconf[t2_host], params))
            dtf = se2_between(mu, rr.pose)
            consistent = (rr.ok & (_norm2(dtf) <= dims.pair_refine_max_dt)
                          & (torch.abs(dtf[2]) <= dims.pair_refine_max_dr)
                          & (rr.inliers >= dims.pair_refine_min_inliers))
            mu = torch.where(consistent, rr.pose, mu)
        if params.use_censi_cov:
            scov = scov + _mean_censi(mres)
        lcov = localize_covariance(scov, mu)
        lcov, _ = apply_covariance_floor(lcov, params.icp_odom_sigmas)

        delta = se2_between(guesses[0], mu)
        small = (_norm2(delta) <= params.nssm_max_translation) & (
            torch.abs(delta[2]) <= params.nssm_max_rotation)
        overlap = count_overlap(se2_transform_points(src_pts, mu), src_mask, tpts2,
                                tmask2, params.point_noise)
        enough_ov = overlap >= params.nssm_min_points

        ok = have_target & have_overlap & enough_samples & small & enough_ov
        status = _status(ok, [
            (~have_target, STATUS_NOT_ENOUGH_POINTS),
            (~have_overlap | ~enough_ov, STATUS_NOT_ENOUGH_OVERLAP),
            (~enough_samples, STATUS_NOT_CONVERGED),
            (None, STATUS_LARGE_TRANSFORMATION),
        ])
        ok = host_read(bool, ok)
    return ok, status, src_key, t2, mu, lcov, overlap


def _with_loop(c: SlamCarry, params: SlamParams, dims: SlamDims,
               gcfg: GraphConfig, key: int, nsrc: int, ntgt, ntf, ncov):
    """Queue the new loop, run PCM over the queue window, insert the newly
    accepted loops and re-optimize when any was accepted. Returns (carry,
    loop_added)."""
    with CodeTimer("pcm", silent=True):
        Q = dims.pcm_queue_slots
        head = c.q_head
        c = c._replace(
            q_source=host_read(_set, c.q_source, head, nsrc),
            q_target=_set(c.q_target, head, ntgt),
            q_tf=_set(c.q_tf, head, ntf),
            q_cov=_set(c.q_cov, head, ncov),
            q_inserted=host_read(_set, c.q_inserted, head, False),
            q_used=host_read(_set, c.q_used, head, True),
            q_head=(head + 1) % Q,
        )
        in_window = (nsrc - c.q_source) <= params.pcm_queue_size
        q_valid = c.q_used & in_window
        sp = c.poses[c.q_source]
        tp = c.poses[c.q_target]
        tf_eff = torch.where(c.q_inserted[:, None], se2_between(tp, sp), c.q_tf)
        accept_mask, _ = pcm_select(sp, tp, tf_eff, c.q_cov, q_valid, min_pcm=0)
        accept_mask = accept_mask & (torch.sum(accept_mask) >= params.min_pcm)
        to_insert = host_read(torch.Tensor.cpu,
                              accept_mask & ~c.q_inserted).numpy()

        graph = c.graph
        loops_i, loops_j = c.loops_i, c.loops_j
        loops_tf, loops_slot = c.loops_tf, c.loops_slot
        q_inserted, num_loops = c.q_inserted, c.num_loops
        for qi in range(Q):
            # capacity gate: past max_loops further loops are dropped
            if not (to_insert[qi] and num_loops < dims.max_loops):
                continue
            slot = num_loops
            loops_slot = _set(loops_slot, slot, graph.num_factors)
            graph = add_between(graph, c.q_target[qi], c.q_source[qi], c.q_tf[qi],
                                cov_to_sqrt_info(c.q_cov[qi]))
            loops_i = _set(loops_i, slot, c.q_target[qi])
            loops_j = _set(loops_j, slot, c.q_source[qi])
            loops_tf = _set(loops_tf, slot, c.q_tf[qi])
            q_inserted = host_read(_set, q_inserted, qi, True)
            num_loops += 1
        c = c._replace(graph=graph, loops_i=loops_i, loops_j=loops_j,
                       loops_tf=loops_tf, loops_slot=loops_slot,
                       q_inserted=q_inserted, num_loops=num_loops)
        any_inserted = bool(to_insert.any())
    if any_inserted:
        with CodeTimer("graph", silent=True):
            g, cov = optimize_with_marginal(c.graph, key, gcfg)
            c = c._replace(graph=g, poses=g.poses, covs=_set(c.covs, key, cov))
    return c, any_inserted


def keyframe_step(carry: SlamCarry, frame: KeyframeInput, params: SlamParams,
                  dims: SlamDims):
    """Process one keyframe: SSM (or DR odometry) factor, graph update, NSSM
    loop search with PCM, second update on accepted loops. A frame whose
    ``valid`` is False leaves the carry unchanged (outputs are None). The
    step is the span ``keyframe_step``, its request the keyframe's index;
    its phases are the spans ``ssm.sampling``, ``ssm.icp``, ``graph``,
    ``nssm.sampling``, ``nssm.icp`` and ``pcm``."""
    if not bool(frame.valid):
        return carry, None
    with CodeTimer("keyframe_step", silent=True, request=carry.num_kf):
        return _keyframe_step(carry, frame, params, dims)


def _keyframe_step(carry: SlamCarry, frame: KeyframeInput, params: SlamParams,
                   dims: SlamDims):
    dev = carry.poses.device
    gcfg = dims.graph_config()
    spec = dims.agg_spec()
    key = carry.num_kf
    if key >= dims.max_keyframes:
        raise ValueError(f"keyframe capacity {dims.max_keyframes} exceeded")
    M = dims.target_capacity

    dr_pose2 = pose3_to_pose2(frame.dr_pose3)
    is_first = key == 0
    prev = max(key - 1, 0)
    dr_odom = se2_between(carry.dr_poses[prev], dr_pose2)
    init_pose = dr_pose2 if is_first else se2_compose(carry.poses[prev], dr_odom)

    n_source = torch.sum(frame.pmask)
    frame_conf = (frame.conf if frame.conf is not None
                  else torch.ones(frame.pmask.shape, device=dev))
    src_w = conf_weight(frame_conf, params)

    # ---------------- sequential scan matching ----------------
    with CodeTimer("ssm.sampling", silent=True):
        target_pose = carry.poses[prev]
        tgt_pts, tgt_mask, tgt_conf = _aggregate_window(
            carry, target_pose, prev - dims.ssm_target_frames + 1,
            dims.ssm_target_frames, spec, M, ref_key=prev,
            use_dr_relatives=dims.aggregate_with_dr,
            use_basis=dims.aggregate_with_dr_basis)
        tgt_w = conf_weight(tgt_conf, params)
        n_target = torch.sum(tgt_mask)
        ssm_eligible = ((not is_first) and params.ssm_enable) & (
            n_source >= params.ssm_min_points) & (n_target >= params.ssm_min_points)

        ginit = global_initialize(
            frame.points, frame.pmask, tgt_pts, tgt_mask, init_pose, target_pose,
            5.0 * params.odom_sigmas, params.ssm_sobol_pts, params.point_noise,
            max(dims.ssm_cov_samples, 1))
        guesses = ginit.guesses_vs(target_pose)

    with CodeTimer("ssm.icp", silent=True):
        if dims.ssm_cov_samples > 0:
            mres = icp_multistart(frame.points, frame.pmask, tgt_pts, tgt_mask,
                                  guesses, ginit.guess_mask, dims.icp, src_w, tgt_w)
            mu, scov, n_ok = estimate_pose_covariance(mres.pose, mres.ok)
            icp_ok = n_ok >= 5
            if params.use_best_start_tf:
                best_pose, best_ok = _best_start(mres)
                mu = torch.where(best_ok, best_pose, mu)
            if params.use_censi_cov:
                scov = scov + _mean_censi(mres)
            ssm_cov, _ = apply_covariance_floor(localize_covariance(scov, mu),
                                                params.icp_odom_sigmas)
            est_tf = mu
            sq_ssm = cov_to_sqrt_info(ssm_cov)
        else:
            sres = icp(frame.points, frame.pmask, tgt_pts, tgt_mask, guesses[0],
                       dims.icp, src_w, tgt_w)
            est_tf, icp_ok = sres.pose, sres.ok
            sq_ssm = sigmas_to_sqrt_info(params.icp_odom_sigmas)

        delta = se2_between(guesses[0], est_tf)
        small_delta = (_norm2(delta) <= params.ssm_max_translation) & (
            torch.abs(delta[2]) <= params.ssm_max_rotation)
        ssm_overlap = count_overlap(se2_transform_points(frame.points, est_tf),
                                    frame.pmask, tgt_pts, tgt_mask,
                                    params.point_noise)
        ssm_ok = ssm_eligible & icp_ok & small_delta & (
            ssm_overlap >= params.ssm_min_points)
        ssm_status = _status(ssm_ok, [
            (~ssm_eligible, STATUS_NOT_ENOUGH_POINTS),
            (~icp_ok, STATUS_NOT_CONVERGED),
            (~small_delta, STATUS_LARGE_TRANSFORMATION),
            (None, STATUS_NOT_ENOUGH_OVERLAP),
        ])

    # factor insertion: SSM between-factor or DR odometry fallback; prior on
    # the first keyframe
    graph = carry.graph
    if is_first:
        graph = add_prior(graph, init_pose, sigmas_to_sqrt_info(params.prior_sigmas))
    fslot_ssm = graph.num_factors
    if not is_first:
        z_factor = torch.where(ssm_ok, est_tf, dr_odom)
        sq = torch.where(ssm_ok, sq_ssm, sigmas_to_sqrt_info(params.odom_sigmas))
        graph = add_between(graph, prev, key, z_factor, sq,
                            robust=ssm_ok & params.robust_ssm, scaled=~ssm_ok)
        if params.fuse_odometry:
            graph = add_between(graph, prev, key, dr_odom,
                                sigmas_to_sqrt_info(params.odom_sigmas),
                                enabled=ssm_ok, scaled=True)
    value_pose = torch.where(ssm_ok, se2_compose(target_pose, est_tf), init_pose)
    graph = set_pose_estimate(graph, key, value_pose)
    ssm_inserted = ssm_ok & (not is_first)

    carry = carry._replace(
        times=_set(carry.times, key, frame.time),
        dr_poses3=_set(carry.dr_poses3, key, frame.dr_pose3),
        dr_poses=_set(carry.dr_poses, key, dr_pose2),
        points=_set(carry.points, key, frame.points),
        pmasks=_set(carry.pmasks, key, frame.pmask),
        pconf=_set(carry.pconf, key, frame_conf),
        num_kf=key + 1,
        ssm_slot=_set(carry.ssm_slot, key,
                      torch.where(ssm_inserted, fslot_ssm, -1)),
        graph=graph,
    )

    # ---------------- first graph update ----------------
    with CodeTimer("graph", silent=True):
        g, cov = optimize_with_marginal(carry.graph, key, gcfg)
    carry = carry._replace(graph=g, poses=g.poses, covs=_set(carry.covs, key, cov))

    # ---------------- non-sequential scan matching ----------------
    nssm_eligible = (params.nssm_enable and carry.num_kf >= dims.nssm_min_st_sep
                     and key % max(params.nssm_every, 1) == 0)
    loop_added = False
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    if nssm_eligible:
        nssm_ok, nssm_status, nsrc, ntgt, ntf, ncov, nssm_overlap = _run_nssm(
            carry, params, dims, spec)
        if nssm_ok:
            carry, loop_added = _with_loop(carry, params, dims, gcfg, key, nsrc,
                                           ntgt, ntf, ncov)
    else:
        nssm_status = torch.full((), STATUS_NOT_ENOUGH_POINTS, dtype=torch.int64,
                                 device=dev)
        ntgt = torch.full((), -1, dtype=torch.int64, device=dev)
        nssm_overlap = zero_i

    out = StepOutputs(
        pose=carry.poses[key], cov=carry.covs[key], ssm_status=ssm_status,
        ssm_used_icp=ssm_ok, nssm_status=nssm_status, nssm_target=ntgt,
        loop_added=host_read(torch.tensor, loop_added, device=dev),
        ssm_overlap=ssm_overlap, nssm_overlap=nssm_overlap,
    )
    return carry, out


def _init_carry(dims: SlamDims, dr_basis, device) -> SlamCarry:
    carry = slam_init(dims, device)
    if dr_basis is not None:
        carry = carry._replace(dr_basis=dr_basis.to(torch.float32))
    return carry


def _frame(frames: KeyframeInput, i: int, valid: bool) -> KeyframeInput:
    return KeyframeInput(
        time=frames.time[i], dr_pose3=frames.dr_pose3[i],
        points=frames.points[i], pmask=frames.pmask[i], valid=valid,
        conf=None if frames.conf is None else frames.conf[i])


def _stack_outputs(rows: dict, K: int, dev) -> StepOutputs:
    """StepOutputs stacked over the K slots from the valid slots' rows,
    zeros in the others."""

    def stack(field):
        ref = next(iter(rows.values()))[field] if rows else None
        if ref is None:
            return None
        out = torch.zeros((K,) + tuple(ref.shape), dtype=ref.dtype, device=dev)
        for i, row in rows.items():
            out[i] = row[field]
        return out

    return StepOutputs(*(stack(f) for f in range(len(StepOutputs._fields))))


def slam_scan(frames: KeyframeInput, params: SlamParams, dims: SlamDims,
              dr_basis=None):
    """Run the SLAM over stacked keyframe inputs (leading axis K): a loop
    over the valid slots. Returns (carry, StepOutputs stacked over K, zeros
    in invalid slots)."""
    pin_fp32()
    dev = frames.points.device
    carry = _init_carry(dims, dr_basis, dev)
    valid = np.asarray(torch.as_tensor(frames.valid).cpu())
    rows = {}
    for i in np.nonzero(valid)[0]:
        carry, rows[int(i)] = keyframe_step(carry, _frame(frames, i, True),
                                            params, dims)
    return carry, _stack_outputs(rows, frames.points.shape[0], dev)


def slam_scan_padded(frames: KeyframeInput, params: SlamParams,
                     dims: SlamDims, dr_basis=None):
    """The reference form of :func:`slam_scan`: every one of the K slots goes
    through ``keyframe_step``, an invalid one leaving the carry as it is.
    ``slam_scan`` is held to it bit for bit (tests/test_torch_node_api.py).
    Outputs are zeros in invalid slots, as ``slam_scan``'s."""
    pin_fp32()
    dev = frames.points.device
    K = frames.points.shape[0]
    carry = _init_carry(dims, dr_basis, dev)
    valid = np.asarray(torch.as_tensor(frames.valid).cpu())
    rows = {}
    for i in range(K):
        carry, out = keyframe_step(carry, _frame(frames, i, bool(valid[i])),
                                   params, dims)
        if out is not None:
            rows[i] = out
    return carry, _stack_outputs(rows, K, dev)
