"""The lane-batched SLAM scan: B lanes at once, each lane equal to
``slam_scan`` of its own keyframe stream and ``SlamParams``.

Counterpart of the JAX package's ``vmap`` of ``slam_scan`` (the sweep,
``sonar_slam_tpu/parallel/sweep.py``) and of its robot axis
(``multi_robot_scan``'s ``shard_map``, ``sonar_slam_tpu/parallel/
multi_robot.py``): every lane advances through each keyframe step together.
Everything that depends on the parameters (poses, covariances, the graph,
the PCM queue, the loop slots, statuses and outputs) carries a leading lane
axis B, and every ``SlamParams`` field is a (B, ...) tensor
(``parallel.stack_params``): flags and integers are per-lane masks and
values, never host branches.

The keyframe stream is either shared, KeyframeInput leaves (K, ...) (a
sweep), or each lane's own, leaves (B, K, ...) (robots). A shared stream
keeps the carry's frame fields (``times``, ``dr_poses3``, ``dr_poses``,
``points``, ``pmasks``, ``pconf``, ``dr_basis``) without a lane axis. Per
lane, they carry one, and the lanes' valid slots may differ: step j takes
each lane's j-th valid slot, as its lone scan does, and runs only the lanes
that have one (a lane whose stream has ended keeps its carry bit for bit,
as an invalid slot leaves a lone carry). Either way the step's key, and so
``num_kf``, is one host value for the lanes stepping.

Where ``keyframe_step`` branches on the host, this module computes and
selects per lane, as ``vmap`` turns ``lax.cond`` into a select:

* a side that no lane needs is skipped after one "any lane" read: the NSSM
  search on a keyframe where no lane is eligible, PCM when no lane's loop
  search succeeded, the second update when no lane inserted a loop;
* the ICP and Gauss-Newton loops run until every lane is done, a finished
  lane frozen (``cloud.icp._icp_lanes``, ``graph.optimize_batch``), one
  read a trip;
* PCM's insertions are per-lane slot assignments by a cumulative sum over
  the queue, in the queue's order, with each lane's ``max_loops`` gate.

No read is per lane; the only host loops over lanes issue each lane's
own library calls (below) and read nothing back. Each function here is
named after its single-lane form in ``slam/core.py`` with ``_lanes``
appended.

Bits. On a CUDA card a lane equals its lone scan bit for bit where every
op rounds it as its lone call does. Elementwise ops do. The float sums,
products and factorizations whose kernels follow the batch are made to:

* ICP's sums over a cloud (the point-to-point update and information,
  the point-to-line constraint weight and mean squared residual) are
  added in a lone call's order (``lone_sums.lone_sum``, through
  ``cloud.icp._icp_lanes``; at shapes outside its model, by each lane's
  own ``torch.sum``);
* the point-to-line update's products A = aw^T a, aw^T r and its 3 x 3
  solve are each lane's own cuBLAS and cuSOLVER calls on its starts
  (``cloud.icp._p2l_solve`` through ``lone_sums.each_lane``), for the
  lanes still stepping: a few launches a lane an ICP trip. The target
  normals (sums over ``normal_k`` terms, within one warp) and the
  pairwise distances (products over 2 terms) round alike in any batch;
* the normal equations' products and the Cholesky factorizations and
  solves of the Gauss-Newton steps and marginals are each lane's own
  cuBLAS and cuSOLVER calls (``lone_sums.each_lane``), as are
  the 3 x 3 Cholesky of a loop's or a scan match's covariance and the
  products of ``localize_covariance_lanes``: a few dozen launches a lane
  a keyframe step.

So no lane's bits depend on the lanes beside it, and the batch may shrink
as per-lane streams end.

On the CPU, MKL's ``mm`` and ATen's vectorized ``atan2`` round a lane in a
batch otherwise than alone, and a lane keeps to its lone scan within
rounding (``tests/test_torch_sweep_lanes.py`` names the ops; the linear
systems are built one lane a call there). ``cli.lane_bits`` finds where a
lane parts from its lone scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import (
    VoxelGridSpec,
    count_overlap,
    nn_match,
    voxel_downsample,
    voxel_downsample_with_conf,
)
from ..cloud.icp import censi_covariance, icp_multistart_lanes, icp_pairs
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
    add_between_lanes,
    add_prior_lanes,
    cov_to_sqrt_info,
    graph_init,
    optimize_with_marginal_lanes,
    set_pose_estimate_lanes,
)
from ..graph.pcm import pcm_select
from ..precision import pin_fp32
from .core import (
    STATUS_LARGE_TRANSFORMATION,
    STATUS_NOT_CONVERGED,
    STATUS_NOT_ENOUGH_OVERLAP,
    STATUS_NOT_ENOUGH_POINTS,
    KeyframeInput,
    SlamCarry,
    SlamDims,
    SlamParams,
    StepOutputs,
    _frame,
    _set,
    _status,
)
from .scan_matching import (
    apply_covariance_floor,
    estimate_pose_covariance_lanes,
    global_initialize_lanes,
    localize_covariance_lanes,
    max_eig_2x2,
)


def _pick(mask, a, b):
    """Per-lane select: ``a`` where the (B,) mask holds, else ``b`` (each a
    (B, ...) tensor or a value shared by the lanes)."""
    a = torch.as_tensor(a, device=mask.device)
    b = torch.as_tensor(b, device=mask.device)
    nd = max(a.ndim, b.ndim, 1)
    return torch.where(mask.reshape(mask.shape + (1,) * (nd - 1)), a, b)


def _set_col(arr, idx, val):
    """``arr[:, idx] = val`` on a copy (idx a host int)."""
    out = arr.clone()
    out[:, idx] = val
    return out


def _norm2(v):
    return torch.linalg.vector_norm(v[..., :2], dim=-1)


def conf_weight_lanes(conf: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """``core.conf_weight`` with per-lane ``conf_ref`` and ``conf_power``:
    conf shared (N,) or per lane (B, N) -> (B, N). A tensor power is
    ``pow`` where the lone call's float power may take one of torch's
    special forms (x * x for 2); exactly 1 for power 0 either way."""
    ref = torch.clamp(params.conf_ref, min=1e-6)
    base = torch.clamp(conf / ref[:, None], 0.0, 1.0)
    return torch.pow(base, params.conf_power[:, None])


def slam_init_lanes(dims: SlamDims, lanes: int, device,
                    per_lane_frames: bool = False) -> SlamCarry:
    """``core.slam_init`` for B lanes: the per-lane fields with a leading
    lane axis; ``num_kf`` a host int; ``q_head`` and ``num_loops`` (B,)
    tensors; the frame fields (``times``, ``dr_poses3``, ``dr_poses``,
    ``points``, ``pmasks``, ``pconf``, ``dr_basis``) shared, or with a lane
    axis too where ``per_lane_frames``."""
    K, N, Q, L = (dims.max_keyframes, dims.max_points, dims.pcm_queue_slots,
                  dims.max_loops)
    B = lanes
    F = (B,) if per_lane_frames else ()

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(3, device=device)
    g = graph_init(dims.graph_config(), device)
    graph = GraphState(*(x.expand((B,) + x.shape).clone() for x in g))
    return SlamCarry(
        times=z(*F, K), dr_poses3=z(*F, K, 6), dr_poses=z(*F, K, 3),
        poses=z(B, K, 3), covs=(eye * 1e-4).repeat(B, K, 1, 1),
        points=z(*F, K, N, 2), pmasks=z(*F, K, N, dtype=torch.bool), num_kf=0,
        graph=graph,
        ssm_slot=torch.full((B, K), -1, dtype=torch.int64, device=device),
        q_source=z(B, Q, dtype=torch.int64), q_target=z(B, Q, dtype=torch.int64),
        q_tf=z(B, Q, 3), q_cov=eye.repeat(B, Q, 1, 1),
        q_inserted=z(B, Q, dtype=torch.bool), q_used=z(B, Q, dtype=torch.bool),
        q_head=z(B, dtype=torch.int64), loops_i=z(B, L, dtype=torch.int64),
        loops_j=z(B, L, dtype=torch.int64), loops_tf=z(B, L, 3),
        loops_slot=z(B, L, dtype=torch.int64), num_loops=z(B, dtype=torch.int64),
        dr_basis=z(*F, K, 2, 2), pconf=z(*F, K, N),
    )


def _per_lane(carry: SlamCarry) -> bool:
    """Whether the carry's frame fields have a lane axis."""
    return carry.points.ndim == 4


def _keyed(carry: SlamCarry, field, keys):
    """Rows ``keys`` of a frame field, the same keys for every lane (a host
    int or a (W,) tensor): field[keys], or each lane's (B, ...)."""
    return field[:, keys] if _per_lane(carry) else field[keys]


def _lane_keyed(carry: SlamCarry, field, keys):
    """Row keys[b] of lane b of a frame field, keys (B,): (B, ...)."""
    if _per_lane(carry):
        return field[torch.arange(keys.shape[0], device=keys.device), keys]
    return field[keys]


def scaled_dr_between_lanes(carry: SlamCarry, ref_key, keys, s: torch.Tensor):
    """``core.scaled_dr_between`` with per-lane DVL scales s (B, 2), from
    ``ref_key`` (a host int, or (B,) keys) to keys (W,) the same for every
    lane: (B, W, 3)."""
    B = s.shape[0]
    ref = torch.as_tensor(ref_key, device=s.device).expand(B)
    d = (_keyed(carry, carry.dr_basis, keys).expand((B,) + (-1,) * 3)
         - _lane_keyed(carry, carry.dr_basis, ref)[:, None])  # (B, W, 2, 2)
    tw = (s[:, 0, None, None] * d[..., 0, :]
          + s[:, 1, None, None] * d[..., 1, :])
    th = _lane_keyed(carry, carry.dr_poses, ref)[:, 2, None]
    c, sn = torch.cos(th), torch.sin(th)
    tb = torch.stack([c * tw[..., 0] + sn * tw[..., 1],
                      -sn * tw[..., 0] + c * tw[..., 1]], dim=-1)
    dth = wrap_angle(_keyed(carry, carry.dr_poses, keys)[..., 2] - th)
    return torch.cat([tb, dth[..., None]], dim=-1)


def _aggregate_window_lanes(carry: SlamCarry, ref_pose, first_key: int,
                            window: int, spec: VoxelGridSpec, capacity: int,
                            ref_key: int, use_dr_relatives: bool = False,
                            use_basis: bool = False):
    """``core._aggregate_window`` for B lanes: the window's keys are the
    same for every lane (host ints), the reference pose (B, 3), the
    keyframe poses and, per lane, the frames are each lane's. Returns
    (points (B, capacity, 2), mask, conf)."""
    dev = carry.poses.device
    B = ref_pose.shape[0]
    K = carry.poses.shape[1]
    keys = first_key + torch.arange(window, device=dev)  # (W,)
    ok = (keys >= 0) & (keys < carry.num_kf)
    safe = torch.clamp(keys, 0, K - 1)
    pts = _keyed(carry, carry.points, safe)
    masks = _keyed(carry, carry.pmasks, safe) & ok[:, None]
    confs = _keyed(carry, carry.pconf, safe)
    if use_dr_relatives:
        safe_ref = min(max(ref_key, 0), K - 1)
        s = torch.exp(carry.graph.log_scale)  # (B, 2)
        if use_basis:
            # the lone window's relatives are a (1, W) lane of one window
            rel = scaled_dr_between_lanes(carry, safe_ref, safe, s)
        else:
            scale = torch.cat([s, torch.ones((B, 1), device=dev)], dim=1)
            ref_dr = _keyed(carry, carry.dr_poses, safe_ref)
            between = se2_between(ref_dr[..., None, :],
                                  _keyed(carry, carry.dr_poses, safe))
            rel = between.expand(B, -1, -1) * scale[:, None, :]
    else:
        rel = se2_between(ref_pose[:, None], carry.poses[:, safe])
    moved = se2_transform_points(pts, rel)  # (B, W, N, 2)
    W, N = masks.shape[-2:]
    return voxel_downsample_with_conf(
        moved.reshape(B, -1, 2), masks.reshape(-1, W * N).expand(B, -1),
        confs.reshape(-1, W * N).expand(B, -1), spec, capacity)


def _mean_censi_lanes(mres):
    covs = censi_covariance(mres.info, mres.mse, mres.pose)  # (B, G, 3, 3)
    w = mres.ok.to(torch.float32)
    return (torch.sum(covs * w[..., None, None], dim=1)
            / torch.clamp(torch.sum(w, dim=1), min=1.0)[:, None, None])


def _best_start_lanes(mres):
    score = torch.where(mres.ok, mres.inliers, torch.full_like(mres.inliers, -1))
    b = torch.argmax(score, dim=1)
    lanes = torch.arange(b.shape[0], device=b.device)
    return mres.pose[lanes, b], score[lanes, b] >= 0


def _run_nssm_lanes(c: SlamCarry, params: SlamParams, dims: SlamDims,
                    spec: VoxelGridSpec):
    """``core._run_nssm`` for B lanes: (ok, status, target key, transform,
    cov, overlap), each with a leading lane axis; the source key is the
    newest keyframe, the same for every lane."""
    dev = c.poses.device
    B = c.poses.shape[0]
    lanes = torch.arange(B, device=dev)
    K, N, M = dims.max_keyframes, dims.max_points, dims.target_capacity
    src_key = c.num_kf - 1
    src_pose = c.poses[:, src_key]
    src_pts, src_mask, src_conf = _aggregate_window_lanes(
        c, src_pose, src_key - dims.nssm_source_frames + 1,
        dims.nssm_source_frames, spec, M, ref_key=src_key,
        use_dr_relatives=dims.aggregate_with_dr,
        use_basis=dims.aggregate_with_dr_basis)
    nsrc_w = conf_weight_lanes(src_conf, params)
    n_src = torch.sum(src_mask, dim=-1)

    limit = c.num_kf - dims.nssm_min_st_sep
    kf_idx = torch.arange(K, device=dev)
    global_pts = se2_transform_points(c.points, c.poses)  # (B, K, N, 2)
    flat_global = global_pts.reshape(B, -1, 2)
    gmask = c.pmasks & (kf_idx < limit)[:, None]  # (K, N) or (B, K, N)

    # 5-sigma FOV gating against each source-window frame
    src_keys = src_key - torch.arange(dims.nssm_source_frames, device=dev)
    safe_src = torch.clamp(src_keys, 0, K - 1)
    cov_w = c.covs[:, safe_src]
    tstd_w = torch.sqrt(max_eig_2x2(cov_w[..., :2, :2]))
    rstd_w = torch.sqrt(cov_w[..., 2, 2])
    local = se2_transform_points(flat_global[:, None],
                                 se2_inverse(c.poses[:, safe_src]))
    rng = torch.linalg.vector_norm(local, dim=-1)
    brg = torch.atan2(local[..., 1], local[..., 0])
    sels = (rng < (tstd_w * 5.0 + dims.max_range)[..., None]) & (
        torch.abs(brg) < (rstd_w * 5.0 + dims.half_aperture)[..., None])
    sels = sels & (src_keys >= 0)[:, None]
    sel = torch.any(sels, dim=1).reshape(B, K, N) & gmask

    counts = torch.sum(sel, dim=2)
    counts_ok = counts > 10
    total_sel = torch.sum(counts, dim=1)
    t1 = torch.argmax(torch.where(counts_ok, counts, torch.full_like(counts, -1)),
                      dim=1)
    have_target = (torch.any(counts_ok, dim=1)
                   & (total_sel >= params.nssm_min_points)
                   & (n_src >= params.nssm_min_points))

    tpose1 = c.poses[lanes, t1]
    flat_sel = sel.reshape(B, -1)
    local1 = se2_transform_points(flat_global, se2_inverse(tpose1))
    tpts1, tmask1 = voxel_downsample(local1, flat_sel, spec, M)
    flat_conf = c.pconf.reshape(-1, K * N).expand(B, -1)

    cov_src = c.covs[:, src_key]
    tstd = torch.sqrt(max_eig_2x2(cov_src[:, :2, :2]))
    rstd = torch.sqrt(cov_src[:, 2, 2])
    bounds = 5.0 * torch.stack([tstd, tstd, rstd], dim=-1)
    n_guess = max(dims.nssm_cov_samples, 1)
    gi = global_initialize_lanes(src_pts, src_mask, tpts1, tmask1, src_pose,
                                 tpose1, bounds, params.nssm_sobol_pts,
                                 params.point_noise, n_guess)

    # overlap-based target re-selection
    est_global = se2_transform_points(
        src_pts, se2_compose(src_pose, gi.best_delta))
    idx, _ = nn_match(flat_global, flat_sel, est_global, src_mask,
                      params.point_noise)
    matched = idx != -1
    matched_frame = torch.clamp(idx, 0, K * N - 1) // N
    counts2 = torch.zeros((B, K), dtype=torch.int64, device=dev).scatter_add_(
        1, matched_frame, matched.to(torch.int64))
    have_overlap = torch.sum(matched, dim=1) > 0
    t2 = torch.argmax(counts2, dim=1)
    tpose2 = c.poses[lanes, t2]

    cand = counts_ok
    if dims.nssm_target_window > 0:
        cand = cand & (torch.abs(kf_idx - t2[:, None]) <= dims.nssm_target_window)
    if dims.aggregate_with_dr and dims.nssm_target_window > 0:
        if dims.aggregate_with_dr_basis:
            rel = scaled_dr_between_lanes(c, t2, kf_idx,
                                          torch.exp(c.graph.log_scale))
        else:
            rel = se2_between(_lane_keyed(c, c.dr_poses, t2)[:, None],
                              c.dr_poses)
    else:
        rel = se2_between(tpose2[:, None], c.poses)
    local2 = se2_transform_points(c.points, rel).reshape(B, -1, 2)
    mask2 = (c.pmasks & cand[..., None]).reshape(B, -1)
    tpts2, tmask2, tconf2 = voxel_downsample_with_conf(
        local2, mask2, flat_conf, spec, M)
    ntgt_w = conf_weight_lanes(tconf2, params)

    if dims.nssm_reinit_after_select:
        gi = global_initialize_lanes(src_pts, src_mask, tpts2, tmask2, src_pose,
                                     tpose2, bounds, params.nssm_sobol_pts,
                                     params.point_noise, n_guess)
    guesses = se2_between(tpose2[:, None], gi.guess_poses)
    mres = icp_multistart_lanes(src_pts, src_mask, tpts2, tmask2, guesses,
                                gi.guess_mask, dims.icp, nsrc_w, ntgt_w)
    mu, scov, n_ok = estimate_pose_covariance_lanes(mres.pose, mres.ok)
    enough_samples = n_ok >= 5
    best_pose, best_ok = _best_start_lanes(mres)
    mu = _pick(params.use_best_start_tf & best_ok, best_pose, mu)

    if dims.nssm_pair_refine:
        rr = icp_pairs(_keyed(c, c.points, src_key),
                       _keyed(c, c.pmasks, src_key),
                       _lane_keyed(c, c.points, t2), _lane_keyed(c, c.pmasks, t2),
                       mu, dims.icp,
                       conf_weight_lanes(_keyed(c, c.pconf, src_key), params),
                       conf_weight_lanes(_lane_keyed(c, c.pconf, t2), params),
                       lone_rows=1)
        dtf = se2_between(mu, rr.pose)
        consistent = (rr.ok & (_norm2(dtf) <= dims.pair_refine_max_dt)
                      & (torch.abs(dtf[:, 2]) <= dims.pair_refine_max_dr)
                      & (rr.inliers >= dims.pair_refine_min_inliers))
        mu = _pick(consistent, rr.pose, mu)
    scov = _pick(params.use_censi_cov, scov + _mean_censi_lanes(mres), scov)
    lcov = localize_covariance_lanes(scov, mu)
    lcov, _ = apply_covariance_floor(lcov, params.icp_odom_sigmas)

    delta = se2_between(guesses[:, 0], mu)
    small = (_norm2(delta) <= params.nssm_max_translation) & (
        torch.abs(delta[:, 2]) <= params.nssm_max_rotation)
    overlap = count_overlap(se2_transform_points(src_pts, mu), src_mask,
                            tpts2, tmask2, params.point_noise)
    enough_ov = overlap >= params.nssm_min_points

    ok = have_target & have_overlap & enough_samples & small & enough_ov
    status = _status(ok, [
        (~have_target, STATUS_NOT_ENOUGH_POINTS),
        (~have_overlap | ~enough_ov, STATUS_NOT_ENOUGH_OVERLAP),
        (~enough_samples, STATUS_NOT_CONVERGED),
        (None, STATUS_LARGE_TRANSFORMATION),
    ])
    return ok, status, t2, mu, lcov, overlap


def _with_loop_lanes(c: SlamCarry, params: SlamParams, dims: SlamDims,
                     gcfg: GraphConfig, key: int, run, ntgt, ntf, ncov):
    """``core._with_loop`` in the lanes where the (B,) mask ``run`` holds
    (their loop search succeeded); the other lanes keep their carry bit for
    bit. Each running lane queues its loop at its own head, PCM vets every
    lane's queue window, and the newly accepted loops are inserted in queue
    order at slots ``num_loops`` + (their rank among the lane's
    insertions), up to ``max_loops``. Returns (carry, loop_added (B,))."""
    dev = c.points.device
    B, Q = c.q_source.shape
    lanes = torch.arange(B, device=dev)
    head = c.q_head
    nsrc = key

    def queue(arr, val):
        cur = arr[lanes, head]
        val = torch.as_tensor(val, dtype=arr.dtype, device=dev).expand(cur.shape)
        out = arr.clone()
        out[lanes, head] = _pick(run, val, cur)
        return out

    c = c._replace(
        q_source=queue(c.q_source, nsrc), q_target=queue(c.q_target, ntgt),
        q_tf=queue(c.q_tf, ntf), q_cov=queue(c.q_cov, ncov),
        q_inserted=queue(c.q_inserted, False), q_used=queue(c.q_used, True),
        q_head=torch.where(run, (head + 1) % Q, head),
    )
    in_window = (nsrc - c.q_source) <= params.pcm_queue_size[:, None]
    q_valid = c.q_used & in_window
    sp = c.poses[lanes[:, None], c.q_source]
    tp = c.poses[lanes[:, None], c.q_target]
    tf_eff = torch.where(c.q_inserted[..., None], se2_between(tp, sp), c.q_tf)
    accept_mask, _ = pcm_select(sp, tp, tf_eff, c.q_cov, q_valid, min_pcm=0)
    accept_mask = accept_mask & (torch.sum(accept_mask, dim=1)
                                 >= params.min_pcm)[:, None]
    to_insert = accept_mask & ~c.q_inserted & run[:, None]

    # the lone form's host loop over qi, as one rank per lane: a loop is
    # inserted while the lane's count stays under max_loops
    rank = torch.cumsum(to_insert.to(torch.int64), dim=1) - 1
    inserted = to_insert & (c.num_loops[:, None] + rank < dims.max_loops)
    any_inserted = torch.any(to_insert, dim=1)
    # host read: which lanes insert which loops, and re-optimize
    host = torch.cat([inserted, any_inserted[:, None]], dim=1).cpu().numpy()
    graph = c.graph
    loops_i, loops_j = c.loops_i, c.loops_j
    loops_tf, loops_slot = c.loops_tf, c.loops_slot
    L = loops_i.shape[1]
    for qi in range(Q):
        ins = np.nonzero(host[:, qi])[0].tolist()
        if not ins:
            continue
        en = inserted[:, qi]
        slot = torch.where(en, c.num_loops + rank[:, qi],
                           torch.full_like(c.num_loops, L))  # L: dropped

        def put(arr, val):  # lanes not inserting write the spare column
            out = torch.cat([arr, arr[:, :1]], dim=1)
            out[lanes, slot] = val.to(arr.dtype)
            return out[:, :L]

        # each inserting lane's whitening from a 3 x 3 Cholesky of its own
        # (cuSOLVER rounds a batch otherwise than one matrix)
        sq = cov_to_sqrt_info(c.q_cov[:, qi], ins)
        loops_slot = put(loops_slot, graph.num_factors)
        graph = add_between_lanes(graph, c.q_target[:, qi], c.q_source[:, qi],
                                  c.q_tf[:, qi], sq, enabled=en)
        loops_i = put(loops_i, c.q_target[:, qi])
        loops_j = put(loops_j, c.q_source[:, qi])
        loops_tf = put(loops_tf, c.q_tf[:, qi])
    c = c._replace(graph=graph, loops_i=loops_i, loops_j=loops_j,
                   loops_tf=loops_tf, loops_slot=loops_slot,
                   q_inserted=c.q_inserted | inserted,
                   num_loops=c.num_loops + torch.sum(inserted, dim=1))
    if host[:, Q].any():
        g, cov = optimize_with_marginal_lanes(c.graph, key, gcfg, any_inserted)
        c = c._replace(graph=g, poses=g.poses,
                       covs=_set_col(c.covs, key,
                                     _pick(any_inserted, cov, c.covs[:, key])))
    return c, any_inserted


def keyframe_step_lanes(carry: SlamCarry, frame: KeyframeInput,
                        params: SlamParams, dims: SlamDims):
    """``core.keyframe_step`` for B lanes (``params`` stacked, the carry
    from :func:`slam_init_lanes`). The frame is shared (leaves (N, ...)) or
    each lane's (leaves (B, N, ...), a carry with per-lane frames, every
    lane's frame valid). An invalid shared frame leaves the carry unchanged
    (outputs are None)."""
    if not bool(frame.valid):
        return carry, None
    dev = carry.poses.device
    per_lane = _per_lane(carry)
    B = carry.poses.shape[0]
    gcfg = dims.graph_config()
    spec = dims.agg_spec()
    key = carry.num_kf
    if key >= dims.max_keyframes:
        raise ValueError(f"keyframe capacity {dims.max_keyframes} exceeded")
    M = dims.target_capacity

    dr_pose2 = pose3_to_pose2(frame.dr_pose3)
    is_first = key == 0
    prev = max(key - 1, 0)
    dr_odom = se2_between(_keyed(carry, carry.dr_poses, prev), dr_pose2)
    init_pose = (dr_pose2.expand(B, 3) if is_first else
                 se2_compose(carry.poses[:, prev], dr_odom))

    n_source = torch.sum(frame.pmask, dim=-1)
    frame_conf = (frame.conf if frame.conf is not None
                  else torch.ones(frame.pmask.shape, device=dev))
    src_w = conf_weight_lanes(frame_conf, params)

    # ---------------- sequential scan matching ----------------
    target_pose = carry.poses[:, prev]
    tgt_pts, tgt_mask, tgt_conf = _aggregate_window_lanes(
        carry, target_pose, prev - dims.ssm_target_frames + 1,
        dims.ssm_target_frames, spec, M, ref_key=prev,
        use_dr_relatives=dims.aggregate_with_dr,
        use_basis=dims.aggregate_with_dr_basis)
    tgt_w = conf_weight_lanes(tgt_conf, params)
    n_target = torch.sum(tgt_mask, dim=1)
    ssm_eligible = ((not is_first) & params.ssm_enable
                    & (n_source >= params.ssm_min_points)
                    & (n_target >= params.ssm_min_points))

    ginit = global_initialize_lanes(
        frame.points, frame.pmask, tgt_pts, tgt_mask, init_pose, target_pose,
        5.0 * params.odom_sigmas, params.ssm_sobol_pts, params.point_noise,
        max(dims.ssm_cov_samples, 1))
    guesses = se2_between(target_pose[:, None], ginit.guess_poses)

    if dims.ssm_cov_samples > 0:
        mres = icp_multistart_lanes(frame.points, frame.pmask, tgt_pts,
                                    tgt_mask, guesses, ginit.guess_mask,
                                    dims.icp, src_w, tgt_w)
        mu, scov, n_ok = estimate_pose_covariance_lanes(mres.pose, mres.ok)
        icp_ok = n_ok >= 5
        best_pose, best_ok = _best_start_lanes(mres)
        mu = _pick(params.use_best_start_tf & best_ok, best_pose, mu)
        scov = _pick(params.use_censi_cov, scov + _mean_censi_lanes(mres), scov)
        ssm_cov, _ = apply_covariance_floor(localize_covariance_lanes(scov, mu),
                                            params.icp_odom_sigmas)
        est_tf = mu
        sq_ssm = cov_to_sqrt_info(ssm_cov, list(range(B)))
    else:
        sres = icp_pairs(frame.points, frame.pmask, tgt_pts, tgt_mask,
                         guesses[:, 0], dims.icp, src_w, tgt_w, lone_rows=1)
        est_tf, icp_ok = sres.pose, sres.ok
        sq_ssm = torch.diag_embed(1.0 / params.icp_odom_sigmas)

    delta = se2_between(guesses[:, 0], est_tf)
    small_delta = (_norm2(delta) <= params.ssm_max_translation) & (
        torch.abs(delta[:, 2]) <= params.ssm_max_rotation)
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
    odom_sq = torch.diag_embed(1.0 / params.odom_sigmas)
    graph = carry.graph
    if is_first:
        graph = add_prior_lanes(graph, init_pose,
                                torch.diag_embed(1.0 / params.prior_sigmas))
    fslot_ssm = graph.num_factors
    if not is_first:
        z_factor = _pick(ssm_ok, est_tf, dr_odom)
        sq = _pick(ssm_ok, sq_ssm, odom_sq)
        graph = add_between_lanes(graph, prev, key, z_factor, sq,
                                  robust=ssm_ok & params.robust_ssm,
                                  scaled=~ssm_ok)
        graph = add_between_lanes(graph, prev, key, dr_odom, odom_sq,
                                  enabled=ssm_ok & params.fuse_odometry,
                                  scaled=True)
    value_pose = _pick(ssm_ok, se2_compose(target_pose, est_tf), init_pose)
    graph = set_pose_estimate_lanes(graph, key, value_pose)
    ssm_inserted = ssm_ok & (not is_first)

    put = _set_col if per_lane else _set
    carry = carry._replace(
        times=put(carry.times, key, frame.time),
        dr_poses3=put(carry.dr_poses3, key, frame.dr_pose3),
        dr_poses=put(carry.dr_poses, key, dr_pose2),
        points=put(carry.points, key, frame.points),
        pmasks=put(carry.pmasks, key, frame.pmask),
        pconf=put(carry.pconf, key, frame_conf),
        num_kf=key + 1,
        ssm_slot=_set_col(carry.ssm_slot, key,
                          torch.where(ssm_inserted, fslot_ssm, -1)),
        graph=graph,
    )

    # ---------------- first graph update ----------------
    g, cov = optimize_with_marginal_lanes(carry.graph, key, gcfg)
    carry = carry._replace(graph=g, poses=g.poses,
                           covs=_set_col(carry.covs, key, cov))

    # ---------------- non-sequential scan matching ----------------
    eligible = params.nssm_enable & (
        key % torch.clamp(params.nssm_every, min=1) == 0)
    loop_added = torch.zeros(B, dtype=torch.bool, device=dev)
    nssm_status = torch.full((B,), STATUS_NOT_ENOUGH_POINTS, dtype=torch.int64,
                             device=dev)
    ntgt = torch.full((B,), -1, dtype=torch.int64, device=dev)
    nssm_overlap = torch.zeros(B, dtype=torch.int64, device=dev)
    # host reads: does any lane search, does any lane's search succeed
    if carry.num_kf >= dims.nssm_min_st_sep and bool(eligible.any()):
        ok, status, t2, ntf, ncov, overlap = _run_nssm_lanes(carry, params,
                                                             dims, spec)
        nssm_status = torch.where(eligible, status, nssm_status)
        ntgt = torch.where(eligible, t2, ntgt)
        nssm_overlap = torch.where(eligible, overlap, nssm_overlap)
        run = eligible & ok
        if bool(run.any()):
            carry, loop_added = _with_loop_lanes(carry, params, dims, gcfg, key,
                                                 run, t2, ntf, ncov)

    out = StepOutputs(
        pose=carry.poses[:, key], cov=carry.covs[:, key], ssm_status=ssm_status,
        ssm_used_icp=ssm_ok, nssm_status=nssm_status, nssm_target=ntgt,
        loop_added=loop_added, ssm_overlap=ssm_overlap,
        nssm_overlap=nssm_overlap,
    )
    return carry, out


def _take_lanes(tree, idx):
    """Lanes ``idx`` (a (B',) tensor) of a per-lane carry or stacked params:
    every tensor's leading axis indexed, host values kept."""
    if isinstance(tree, tuple):
        return type(tree)(*(_take_lanes(x, idx) for x in tree))
    return tree[idx] if isinstance(tree, torch.Tensor) else tree


def _put_lanes(tree, idx, part):
    """``tree`` with lanes ``idx`` replaced by ``part`` (from
    :func:`_take_lanes`); a host value becomes the part's (the count of the
    lanes stepping)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_put_lanes(x, idx, y) for x, y in zip(tree, part)))
    if isinstance(tree, torch.Tensor):
        return tree.index_copy(0, idx, part)
    return part


def scan_steps(frames: KeyframeInput, lanes: int):
    """The scan's keyframe steps over stacked inputs, in order: for each,
    (the lanes stepping, each one's slot, the step's frame). A shared
    stream (leaves (K, ...)) steps every lane at each valid slot with the
    shared frame; per-lane streams (leaves (B, K, ...)) step, at step j,
    the lanes with a j-th valid slot, with those slots' frames (leaves
    (B', ...)). Valid slots are read once, on the host."""
    valid = np.asarray(torch.as_tensor(frames.valid).cpu())
    if valid.ndim == 1:
        for i in np.nonzero(valid)[0]:
            yield list(range(lanes)), [int(i)] * lanes, _frame(frames, i, True)
        return
    dev = frames.points.device
    slots = [np.nonzero(v)[0] for v in valid]
    for j in range(max((len(sl) for sl in slots), default=0)):
        active = [b for b in range(lanes) if len(slots[b]) > j]
        at = [int(slots[b][j]) for b in active]
        a = torch.as_tensor(active, device=dev)
        i = torch.as_tensor(at, device=dev)
        yield active, at, KeyframeInput(
            time=frames.time[a, i], dr_pose3=frames.dr_pose3[a, i],
            points=frames.points[a, i], pmask=frames.pmask[a, i], valid=True,
            conf=None if frames.conf is None else frames.conf[a, i])


def step_lanes(carry: SlamCarry, frame: KeyframeInput, params: SlamParams,
               dims: SlamDims, active: list):
    """:func:`keyframe_step_lanes` of the lanes ``active`` (a step of
    :func:`scan_steps`): on the whole batch where every lane steps, else on
    those lanes alone (a carry with per-lane frames), the others' carry
    kept bit for bit. Returns (carry, the stepping lanes' outputs)."""
    B = carry.poses.shape[0]
    if len(active) == B:
        return keyframe_step_lanes(carry, frame, params, dims)
    idx = torch.as_tensor(active, device=carry.poses.device)
    part, out = keyframe_step_lanes(_take_lanes(carry, idx), frame,
                                    _take_lanes(params, idx), dims)
    return _put_lanes(carry, idx, part), out


def lanes_to_carry(carry: SlamCarry, num_kf: list) -> SlamCarry:
    """The carry as ``parallel.stack_lanes`` stacks lone carries: shared
    frame fields repeated over the lanes, ``num_kf`` (each lane's keyframe
    count) an int64 (B,) tensor."""
    B = carry.poses.shape[0]
    dev = carry.poses.device
    counts = torch.tensor(num_kf, dtype=torch.int64, device=dev)
    if _per_lane(carry):
        return carry._replace(num_kf=counts)

    def lanes(x):
        return x.expand((B,) + x.shape).contiguous()

    return carry._replace(
        times=lanes(carry.times), dr_poses3=lanes(carry.dr_poses3),
        dr_poses=lanes(carry.dr_poses), points=lanes(carry.points),
        pmasks=lanes(carry.pmasks), pconf=lanes(carry.pconf),
        dr_basis=lanes(carry.dr_basis), num_kf=counts)


def slam_scan_lanes(frames: KeyframeInput, params: SlamParams, dims: SlamDims,
                    dr_basis=None):
    """Run the SLAM over stacked keyframe inputs under B stacked parameter
    lanes: the inputs' leading axis K shared by the lanes, or (B, K) each
    lane's own stream (``dr_basis`` then (B, K, 2, 2)). A loop over the
    steps of :func:`scan_steps`, each advancing every lane that has a
    frame. Returns (carry, StepOutputs) as ``parallel.stack_lanes`` stacks
    B lone ``slam_scan`` results: every leaf with a leading lane axis,
    outputs (B, K, ...) with zeros in each lane's invalid slots."""
    pin_fp32()
    dev = frames.points.device
    B = params.point_noise.shape[0]
    K = frames.points.shape[-3]
    carry = slam_init_lanes(dims, B, dev, per_lane_frames=frames.points.ndim == 4)
    if dr_basis is not None:
        carry = carry._replace(dr_basis=dr_basis.to(torch.float32))
    counts = [0] * B
    steps = []
    for active, at, frame in scan_steps(frames, B):
        carry, row = step_lanes(carry, frame, params, dims, active)
        steps.append((active, at, row))
        for b in active:
            counts[b] += 1
    fields = []
    for f in range(len(StepOutputs._fields)):
        ref = steps[0][2][f] if steps else None
        if ref is None:
            fields.append(None)
            continue
        out = torch.zeros((B, K) + tuple(ref.shape[1:]), dtype=ref.dtype,
                          device=dev)
        for active, at, row in steps:
            out[torch.as_tensor(active, device=dev),
                torch.as_tensor(at, device=dev)] = row[f]
        fields.append(out)
    return lanes_to_carry(carry, counts), StepOutputs(*fields)
