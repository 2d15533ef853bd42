"""Post-convergence loop re-registration, chain densification and the
proximity loop sweep.

Counterpart of ``sonar_slam_tpu/slam/refine.py`` (see there for why each
mechanism exists and what it was measured to buy). After the scan:

1. re-measure every logged loop from the converged poses (windowed submaps,
   then the single-frame consistency refinement) and replace its factor in
   place (:func:`_remeasure`, :func:`_remeasure_moved`);
2. re-register every consecutive keyframe pair, replacing the in-scan SSM
   factor or adding a chain factor where SSM fell back to odometry
   (:func:`_densify_chain`), optionally anchoring the DVL scale from the
   chain (:func:`_anchor_scale_from_chain`);
3. register each source keyframe against its most co-visible eligible
   target and insert the confident fits as new loops (:func:`_sweep`);
4. drop loops that disagree with the converged graph (:func:`_prune_loops`).

What differs from the JAX version, and why:

* Each fan-out (loops, chain pairs, sweep pairs) is one batch of
  independent registrations with a leading lane axis
  (``cloud.icp_pairs``, ``core._aggregate_windows``), as the JAX package
  ``vmap``s them. Only the lanes that can change the result go into the
  batch (valid loops, moved loops, chain pairs 1..num_kf-1, sweep pairs
  with a target); the others' results are discarded by the JAX version
  too, so the outcome is the same.
* The ``lax.scan`` inserts become a cumulative-sum slot assignment: the
  k-th enabled lane in lane order takes factor slot ``num_factors + k`` and
  loop slot ``num_loops + k``, with the same capacity cut.
* ``mode="drop"`` scatters write the dropped lanes to a spare row that is
  cut off after.
* The loop count is a host integer, so the sweep, the prune and the
  compaction each read one value back; the Gauss-Newton early exit reads
  one per iteration.
* With a mesh (``parallel/mesh.py``, the JAX version's ``shard_map`` in
  ``_lane_map``) each fan-out's live lanes are padded to a multiple of the
  mesh size with copies of lane 0; every rank registers its contiguous
  block of them against the carry it holds (every rank holds the same
  carry), and the per-lane (ok, z, cov) are all-gathered and cut back to
  the live lanes (:func:`_lane_map`). Each fan-out first all-gathers every
  rank's lane count and a checksum of its lane indices, and raises on every
  rank where they differ, so that ranks whose carries have parted fail
  instead of mixing blocks registered against different loops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..cloud.icp import censi_covariance, icp_pairs
from ..geometry import se2_between, se2_inverse, se2_transform_points
from ..graph.factor_graph import cov_to_sqrt_info, optimize
from ..parallel.mesh import Mesh, check_divisible, gather, shard
from ..precision import pin_fp32
from ..utils.timing import CodeTimer, host_read, to_device
from .core import SlamCarry, SlamDims, SlamParams, _aggregate_windows, conf_weight, scaled_dr_between
from .scan_matching import apply_covariance_floor, localize_covariance


class RefineParams(NamedTuple):
    """Numeric gates of the refinement passes (same fields and defaults as
    the JAX package's ``RefineParams``): Python numbers for scalars, a
    Python bool for ``robust``, float32 tensors for the sigma vectors."""

    max_dt: float
    max_dr: float
    min_inliers: int
    sweep_max_dt: float
    sweep_max_dr: float
    prox_radius: float
    floor_sigmas: torch.Tensor  # (3,)
    robust: bool
    move_gate_t: float
    move_gate_r: float
    chain_floor_sigmas: torch.Tensor  # (3,)
    scale_min_axis_disp: float
    sweep_min_covis: int
    sweep_min_inliers: int
    sweep_floor_sigmas: torch.Tensor  # (3,)
    sweep_cov_inlier_ref: float
    chain_dr_max_dt: float
    chain_dr_max_dr: float
    prune_max_dt: float
    prune_max_dr: float
    scale_max_rot: float
    scale_prior_sigma: torch.Tensor  # (2,)

    @staticmethod
    def default(device) -> "RefineParams":
        """The JAX defaults, as float32 values."""

        def f(x):
            return float(torch.tensor(x, dtype=torch.float32))

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return RefineParams(
            max_dt=f(0.6), max_dr=f(0.12), min_inliers=25,
            sweep_max_dt=f(0.5), sweep_max_dr=f(0.1), prox_radius=f(20.0),
            floor_sigmas=vec([0.05, 0.05, 0.01]), robust=True,
            move_gate_t=f(0.01), move_gate_r=f(0.002),
            chain_floor_sigmas=vec([0.05, 0.05, 0.01]),
            scale_min_axis_disp=f(0.5), sweep_min_covis=12,
            sweep_min_inliers=20, sweep_floor_sigmas=vec([0.1, 0.1, 0.02]),
            sweep_cov_inlier_ref=f(0.0), chain_dr_max_dt=f(0.12),
            chain_dr_max_dr=f(0.03), prune_max_dt=f(0.25),
            prune_max_dr=f(0.08), scale_max_rot=f(0.0),
            scale_prior_sigma=vec([0.05, 0.01]),
        )


def _norm2(v):
    return torch.linalg.vector_norm(v[..., :2], dim=-1)


def _finite(z, cov):
    return (torch.all(torch.isfinite(z), dim=-1)
            & torch.all(torch.isfinite(cov).flatten(-2), dim=-1))


def _drop_set(arr: torch.Tensor, idx, vals, use) -> torch.Tensor:
    """``arr.at[where(use, idx, len(arr))].set(vals, mode="drop")``: the
    lanes that are not used write a spare row that is cut off."""
    pad = torch.cat([arr, arr[:1]])
    safe = torch.where(use, idx, torch.full_like(idx, arr.shape[0]))
    pad[safe] = to_device(vals, arr.device, arr.dtype).expand(
        (safe.shape[0],) + arr.shape[1:])
    return pad[:-1]


def _set_factors(graph, slots, use, z, sq, robust: bool):
    """Replace the measurement, whitening and robust flag of factor
    ``slots[l]`` for every lane with ``use[l]``."""
    return graph._replace(
        f_z=_drop_set(graph.f_z, slots, z, use),
        f_sqrt_info=_drop_set(graph.f_sqrt_info, slots, sq, use),
        f_robust=_drop_set(graph.f_robust, slots, robust, use),
    )


def _append_factors(graph, en, i, j, z, sq, robust: bool):
    """Append a between factor i[l] -> j[l] for every lane with ``en[l]``, in
    lane order: the sequential ``add_between`` inserts of the JAX version as
    one scatter. Returns (graph, the rank of each lane among the enabled)."""
    rank = torch.cumsum(en.to(torch.int64), dim=0) - 1
    slot = graph.num_factors + rank
    F = graph.f_i.shape[0]
    put = en & (slot < F)  # add_between drops writes past the table
    n = en.shape[0]
    graph = graph._replace(
        f_i=_drop_set(graph.f_i, slot, i, put),
        f_j=_drop_set(graph.f_j, slot, j, put),
        f_z=_drop_set(graph.f_z, slot, z, put),
        f_sqrt_info=_drop_set(graph.f_sqrt_info, slot, sq, put),
        f_robust=_drop_set(graph.f_robust, slot,
                           torch.full((n,), robust, device=en.device), put),
        f_scaled=_drop_set(graph.f_scaled, slot,
                           torch.zeros(n, dtype=torch.bool, device=en.device),
                           put),
        num_factors=graph.num_factors + torch.sum(en.to(torch.int64)),
    )
    return graph, rank


def check_mesh_dims(dims: SlamDims, size: int) -> None:
    """Raise ValueError unless a mesh of ``size`` ranks divides the fan-outs'
    capacities (``max_loops``, ``max_keyframes``), as the JAX version
    requires."""
    check_divisible(dims.max_loops, size, "SlamDims.max_loops")
    check_divisible(dims.max_keyframes, size, "SlamDims.max_keyframes")


def _check_same_lanes(lanes: tuple, mesh: Mesh) -> None:
    """Raise RuntimeError on every rank unless all ranks hold the same lanes
    (the same count L and the same indices, compared by a checksum): each
    rank selects its fan-out's lanes from its own carry, and blocks
    registered against different lanes must never be gathered together."""
    h = torch.zeros((), dtype=torch.int64)
    for t, x in enumerate(lanes):
        v = x.detach().cpu().reshape(-1).to(torch.int64)
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64) * 2654435761
        h = h + torch.sum((v + 1) * (w + t))
    got = gather(torch.stack([torch.tensor(lanes[0].shape[0]), h])[None],
                 mesh)
    if not torch.equal(got, got[:1].expand_as(got)):
        raise RuntimeError(
            "the ranks' refinement lanes disagree (count, checksum by rank: "
            f"{got.tolist()}): every rank must hold the same carry")


def _lane_map(fn, lanes: tuple, mesh: Mesh | None):
    """``fn(*lanes)`` over the leading lane axis of the index tensors
    ``lanes``, returning a tuple of per-lane tensors. With ``mesh`` the
    ranks first check that they hold the same lanes
    (:func:`_check_same_lanes`), the L lanes are padded to the next multiple
    of its size with copies of lane 0, each rank runs ``fn`` on its
    contiguous block, and the results are gathered and cut back to L."""
    if mesh is None:
        return fn(*lanes)
    L = lanes[0].shape[0]
    _check_same_lanes(lanes, mesh)
    pad = -L % mesh.size
    lanes = tuple(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                  for x in lanes)
    return tuple(x[:L] for x in gather(fn(*shard(lanes, mesh)), mesh))


def _register_pair(carry: SlamCarry, i, j, params: SlamParams,
                   rp: RefineParams, dims: SlamDims):
    """Windowed re-registration of loops (i[l], j[l]) from the converged
    guess, then the single-frame consistency refinement; ``i`` (targets) and
    ``j`` (sources) are (L,) tensors. Returns (ok (L,), z (L, 3), cov
    (L, 3, 3)) in the scan's BetweenFactor convention."""
    spec = dims.agg_spec()
    M = dims.target_capacity
    K = carry.points.shape[0]
    si = torch.clamp(i, 0, K - 1)
    sj = torch.clamp(j, 0, K - 1)
    guess = se2_between(carry.poses[si], carry.poses[sj])

    # source submap: trailing window ending at j; target: centred on i
    src_pts, src_mask, src_conf = _aggregate_windows(
        carry, carry.poses[sj], sj - dims.nssm_source_frames + 1,
        dims.nssm_source_frames, spec, M, ref_key=sj,
        use_dr_relatives=dims.aggregate_with_dr,
        use_basis=dims.aggregate_with_dr_basis)
    tw = dims.refine_target_window
    tgt_pts, tgt_mask, tgt_conf = _aggregate_windows(
        carry, carry.poses[si], si - tw, 2 * tw + 1, spec, M, ref_key=si,
        use_dr_relatives=dims.aggregate_with_dr,
        use_basis=dims.aggregate_with_dr_basis)

    res = icp_pairs(src_pts, src_mask, tgt_pts, tgt_mask, guess, dims.icp,
                    conf_weight(src_conf, params), conf_weight(tgt_conf, params))
    d = se2_between(guess, res.pose)
    in_gate = (_norm2(d) <= rp.max_dt) & (torch.abs(d[:, 2]) <= rp.max_dr)
    z, info, mse = res.pose, res.info, res.mse

    rr = icp_pairs(carry.points[sj], carry.pmasks[sj], carry.points[si],
                   carry.pmasks[si], z, dims.icp,
                   conf_weight(carry.pconf[sj], params),
                   conf_weight(carry.pconf[si], params))
    dd = se2_between(z, rr.pose)
    pair_ok = (rr.ok & (_norm2(dd) <= dims.pair_refine_max_dt)
               & (torch.abs(dd[:, 2]) <= dims.pair_refine_max_dr)
               & (rr.inliers >= dims.pair_refine_min_inliers))
    z = torch.where(pair_ok[:, None], rr.pose, z)
    info = torch.where(pair_ok[:, None, None], rr.info, info)
    mse = torch.where(pair_ok, rr.mse, mse)

    ok = res.ok & in_gate & ((res.inliers >= rp.min_inliers) | pair_ok)
    cov = localize_covariance(censi_covariance(info, mse, z), z)
    cov, _ = apply_covariance_floor(cov, rp.floor_sigmas)
    # a non-finite measurement must never reach the factor table
    return ok & _finite(z, cov), z, cov


def _remeasure(carry: SlamCarry, params, rp, dims: SlamDims,
               mesh: Mesh | None = None) -> SlamCarry:
    """Re-register every logged loop; replace factor measurements in place."""
    nl = min(carry.num_loops, dims.max_loops)
    if nl == 0:
        return carry
    ok, z, cov = _lane_map(
        lambda i, j: _register_pair(carry, i, j, params, rp, dims),
        (carry.loops_i[:nl], carry.loops_j[:nl]), mesh)
    graph = _set_factors(carry.graph, carry.loops_slot[:nl], ok, z,
                         cov_to_sqrt_info(cov), rp.robust)
    loops_tf = carry.loops_tf.clone()
    loops_tf[:nl] = torch.where(ok[:, None], z, carry.loops_tf[:nl])
    return carry._replace(graph=graph, loops_tf=loops_tf)


def _loops_between(carry: SlamCarry) -> torch.Tensor:
    """(Lcap, 3) current relative pose of each logged loop's endpoints."""
    K = carry.points.shape[0]
    si = torch.clamp(carry.loops_i, 0, K - 1)
    sj = torch.clamp(carry.loops_j, 0, K - 1)
    return se2_between(carry.poses[si], carry.poses[sj])


def _remeasure_moved(carry: SlamCarry, reg_between: torch.Tensor, params, rp,
                     dims: SlamDims, mesh: Mesh | None = None):
    """Incremental re-measurement: re-register only the loops whose endpoint
    relative pose moved beyond the gate since their last registration, the
    ``max_loops // 2`` that moved most. Returns (carry, reg_between) with
    the snapshot refreshed for the lanes that re-registered."""
    Lcap = dims.max_loops
    B = max(1, Lcap // 2)
    dev = carry.poses.device
    valid = torch.arange(Lcap, device=dev) < min(carry.num_loops, Lcap)
    now = _loops_between(carry)
    d = se2_between(reg_between, now)
    dt = _norm2(d)
    dr = torch.abs(d[:, 2])
    moved = valid & ((dt > rp.move_gate_t) | (dr > rp.move_gate_r))
    # rank by movement (rotation priced at ~5 m/rad)
    score = torch.where(moved, dt + 5.0 * dr, torch.full_like(dt, -1.0))
    top, sel = torch.sort(score, descending=True, stable=True)
    # moved lanes score > 0 and lead the order; at most B of them register
    n_act = min(host_read(int, torch.sum(top[:B] > 0.0)), B)
    if n_act == 0:
        return carry, reg_between
    sel = sel[:n_act]
    ok, z, cov = _lane_map(
        lambda i, j: _register_pair(carry, i, j, params, rp, dims),
        (carry.loops_i[sel], carry.loops_j[sel]), mesh)
    graph = _set_factors(carry.graph, carry.loops_slot[sel], ok, z,
                         cov_to_sqrt_info(cov), rp.robust)
    loops_tf = _drop_set(carry.loops_tf, sel, z, ok)
    reg_between = _drop_set(reg_between, sel, now[sel], ok)
    return carry._replace(graph=graph, loops_tf=loops_tf), reg_between


def _covisibility(carry: SlamCarry, dims: SlamDims) -> torch.Tensor:
    """(K, K) mutual co-visibility counts under the current poses:
    ``C[a, b] = #points of frame b inside frame a's FOV wedge``, symmetrized
    by min."""
    K, N = carry.pmasks.shape
    flat = se2_transform_points(carry.points, carry.poses).reshape(-1, 2)
    local = se2_transform_points(flat, se2_inverse(carry.poses))  # (K, K*N, 2)
    rng = torch.linalg.vector_norm(local, dim=-1)
    brg = torch.atan2(local[..., 1], local[..., 0])
    infov = (rng < dims.max_range) & (torch.abs(brg) < dims.half_aperture)
    C = torch.sum(infov.reshape(K, K, N) & carry.pmasks[None], dim=-1)
    return torch.minimum(C, C.T)


def _densify_chain(carry: SlamCarry, params, rp, dims: SlamDims,
                   mesh: Mesh | None = None):
    """Re-register every consecutive keyframe pair from the converged poses;
    replace the in-scan SSM measurement where one exists, add a chain factor
    where SSM fell back to odometry. Returns (carry, ok (K,), z (K, 3));
    pairs that cannot be accepted (k = 0 and k >= num_kf) are not registered
    and read ok False, z 0."""
    K = dims.max_keyframes
    dev = carry.poses.device
    ok_all = torch.zeros(K, dtype=torch.bool, device=dev)
    z_all = torch.zeros((K, 3), device=dev)
    if carry.num_kf < 2:
        return carry, ok_all, z_all
    s = torch.exp(carry.graph.log_scale)

    def one(k):
        prev = k - 1
        guess = se2_between(carry.poses[prev], carry.poses[k])
        rr = icp_pairs(carry.points[k], carry.pmasks[k], carry.points[prev],
                       carry.pmasks[prev], guess, dims.icp,
                       conf_weight(carry.pconf[k], params),
                       conf_weight(carry.pconf[prev], params))
        dd = se2_between(guess, rr.pose)
        # cross-check against the scale-corrected raw DR delta over the
        # interval
        if dims.aggregate_with_dr_basis:
            zd = scaled_dr_between(carry, prev, k, s)
        else:
            zd = se2_between(carry.dr_poses[prev], carry.dr_poses[k])
            zd = torch.cat([zd[:, :2] * s, zd[:, 2:]], dim=-1)
        dr_dev_t = torch.linalg.vector_norm(rr.pose[:, :2] - zd[:, :2],
                                            dim=-1)
        dr_dev_r = torch.abs(torch.remainder(
            rr.pose[:, 2] - zd[:, 2] + math.pi, 2 * math.pi) - math.pi)
        dr_ok = ((dr_dev_t <= rp.chain_dr_max_dt)
                 & (dr_dev_r <= rp.chain_dr_max_dr))
        if rp.chain_dr_max_dt <= 0:
            dr_ok = torch.ones_like(dr_ok)
        ok = (rr.ok & dr_ok & (rr.inliers >= rp.min_inliers)
              & (_norm2(dd) <= dims.pair_refine_max_dt)
              & (torch.abs(dd[:, 2]) <= dims.pair_refine_max_dr))
        cov = localize_covariance(censi_covariance(rr.info, rr.mse, rr.pose),
                                  rr.pose)
        cov, _ = apply_covariance_floor(cov, rp.chain_floor_sigmas)
        return ok & _finite(rr.pose, cov), rr.pose, cov

    k = torch.arange(1, carry.num_kf, device=dev)
    ok, z, cov = _lane_map(one, (k,), mesh)
    sq = cov_to_sqrt_info(cov)

    # replace in place where an in-scan SSM factor exists, append otherwise
    ssm_slot = carry.ssm_slot[k]
    have_ssm = ssm_slot >= 0
    graph = _set_factors(carry.graph, ssm_slot, ok & have_ssm, z, sq,
                         rp.robust)
    graph, _ = _append_factors(graph, ok & ~have_ssm, k - 1, k, z, sq,
                               rp.robust)
    ok_all[1: carry.num_kf] = ok
    z_all[1: carry.num_kf] = torch.where(ok[:, None], z, torch.zeros_like(z))
    return carry._replace(graph=graph), ok_all, z_all


def solve_scale_from_basis(chain_ok, chain_z, basis, dr_heading, prior_sigma,
                           meas_sigma: float = 0.02, min_n: int = 8):
    """Joint per-axis DVL-scale correction from the refined chain and the DVL
    basis integrals: the 2x2 weighted least squares of ``z_k ~ cx * a_k +
    cy * b_k`` over the accepted intervals, with a Gaussian prior at 1 on
    each axis. Returns ``(log_correction (2,), enough (bool tensor))``."""
    K = chain_z.shape[0]
    idx = torch.arange(K, device=chain_z.device)
    prev = torch.clamp(idx - 1, min=0)
    d = basis[idx] - basis[prev]  # (K, 2 axis, 2 world)
    th = dr_heading[prev]
    c, s = torch.cos(th), torch.sin(th)

    def to_body(v):  # world -> interval-start body frame
        return torch.stack([c * v[..., 0] + s * v[..., 1],
                            -s * v[..., 0] + c * v[..., 1]], dim=-1)

    A = torch.stack([to_body(d[:, 0]), to_body(d[:, 1])], dim=-1)  # (K, 2, 2)
    z = chain_z[:, :2]
    w = (chain_ok.to(torch.float32) / (meas_sigma ** 2))[:, None, None]
    At = A.transpose(1, 2)
    M = torch.sum(w * torch.matmul(At, A), dim=0)
    v = torch.sum(torch.matmul(w * At, z[:, :, None]), dim=0)[:, 0]
    pw = 1.0 / torch.as_tensor(prior_sigma, dtype=torch.float32,
                               device=chain_z.device) ** 2
    M = M + torch.diag(pw)
    v = v + pw  # prior centre: correction 1 (nominal)
    # the solve checks for a singular M on the host
    sol = torch.clamp(host_read(torch.linalg.solve, M, v), 0.9, 1.1)
    return torch.log(sol), torch.sum(chain_ok) >= min_n


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: with an even count the two middle
    values are interpolated as ``lo * 0.5 + hi * 0.5`` (``torch.nanmedian``
    returns the lower one); NaN when every value is NaN."""
    v = torch.sort(x).values  # NaN sorts last
    n = torch.sum(~torch.isnan(x)).to(torch.float32)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi

    def at(i):
        i = torch.clamp(torch.minimum(i, n - 1.0), min=0.0).to(torch.int64)
        return v[i]

    return at(lo) * w_lo + at(hi) * w_hi


def _anchor_scale_from_chain(carry: SlamCarry, chain_ok, chain_z, rp,
                             dims: SlamDims, scale_basis=None) -> SlamCarry:
    """Measure the DVL scale correction directly from the accepted chain
    registrations: the basis solve when ``scale_basis`` is given, else the
    per-axis median log-ratio of chain to raw DR deltas (axes without enough
    samples keep the in-graph estimate). Writes ``log_scale_anchor`` and
    seeds ``log_scale``."""
    g = carry.graph
    if scale_basis is not None:
        anchor, enough = solve_scale_from_basis(
            chain_ok, chain_z, scale_basis, carry.dr_poses[:, 2],
            rp.scale_prior_sigma)
        anchor = torch.where(enough, anchor, g.log_scale)
        return carry._replace(graph=g._replace(log_scale_anchor=anchor,
                                               log_scale=anchor))

    K = dims.max_keyframes
    idx = torch.arange(K, device=chain_z.device)
    prev = torch.clamp(idx - 1, min=0)
    zd = se2_between(carry.dr_poses[prev], carry.dr_poses[idx])
    rot_ok = torch.abs(zd[:, 2]) <= rp.scale_max_rot
    if rp.scale_max_rot <= 0:
        rot_ok = torch.ones_like(rot_ok)

    def axis_anchor(a: int, min_n: int = 8):
        num, den = chain_z[:, a], zd[:, a]
        use = (chain_ok & rot_ok & (torch.abs(den) > rp.scale_min_axis_disp)
               & (num * den > 0))
        ratio = num / torch.where(use, den, torch.ones_like(den))
        lr = torch.log(torch.where(use, ratio, torch.ones_like(ratio)))
        med = _nanmedian(torch.where(use, lr, torch.full_like(lr, float("nan"))))
        enough = (torch.sum(use) >= min_n) & torch.isfinite(med)
        return torch.where(enough, med, g.log_scale[a])

    anchor = torch.stack([axis_anchor(0), axis_anchor(1)])
    return carry._replace(graph=g._replace(log_scale_anchor=anchor,
                                           log_scale=anchor))


def _sweep(carry: SlamCarry, params, rp, dims: SlamDims,
           mesh: Mesh | None = None) -> SlamCarry:
    """One single-frame registration per source keyframe against its most
    co-visible eligible targets; confident, consistent fits become new loop
    factors, appended in lane order up to ``max_loops``."""
    K = dims.max_keyframes
    dev = carry.poses.device
    idx = torch.arange(K, device=dev)
    pos = carry.poses[:, :2]
    d = torch.linalg.vector_norm(pos[:, None, :] - pos[None, :, :], dim=-1)

    # pair (i, j) already constrained by a logged loop?
    lvalid = torch.arange(dims.max_loops, device=dev) < carry.num_loops
    taken = torch.zeros((K, K), dtype=torch.int64, device=dev).index_put_(
        (carry.loops_i, carry.loops_j), lvalid.to(torch.int64),
        accumulate=True) > 0

    covis = _covisibility(carry, dims)
    eligible = ((idx[None, :] - idx[:, None] >= dims.nssm_min_st_sep)
                & (idx[None, :] < carry.num_kf) & (idx[:, None] < carry.num_kf)
                & ~taken & (d <= rp.prox_radius)
                & (covis >= rp.sweep_min_covis))
    score = torch.where(eligible, covis, torch.full_like(covis, -1))
    # top-k most co-visible targets per source j, ties toward the lower index
    topk = dims.refine_sweep_topk
    vals, tgts = torch.sort(score.T, dim=-1, descending=True, stable=True)
    vals, tgts = vals[:, :topk], tgts[:, :topk]
    src_of = torch.repeat_interleave(idx, topk)
    tgt_of = tgts.reshape(-1)
    has_tgt = (vals > 0).reshape(-1)
    B = dims.refine_sweep_budget
    if B and B < K * topk:
        bv, bidx = torch.sort(vals.reshape(-1), descending=True, stable=True)
        bv, bidx = bv[:B], bidx[:B]
        src_of, tgt_of, has_tgt = src_of[bidx], tgt_of[bidx], bv > 0

    # only lanes with a target can insert; keep them in lane order
    lanes = host_read(torch.nonzero, has_tgt).reshape(-1)
    if lanes.numel() == 0:
        return carry
    j, i = src_of[lanes], tgt_of[lanes]

    def one(j, i):
        guess = se2_between(carry.poses[i], carry.poses[j])
        rr = icp_pairs(carry.points[j], carry.pmasks[j], carry.points[i],
                       carry.pmasks[i], guess, dims.icp,
                       conf_weight(carry.pconf[j], params),
                       conf_weight(carry.pconf[i], params))
        dd = se2_between(guess, rr.pose)
        ok = (rr.ok & (rr.inliers >= rp.sweep_min_inliers)
              & (_norm2(dd) <= rp.sweep_max_dt)
              & (torch.abs(dd[:, 2]) <= rp.sweep_max_dr))
        cov = localize_covariance(censi_covariance(rr.info, rr.mse, rr.pose),
                                  rr.pose)
        cov, _ = apply_covariance_floor(cov, rp.sweep_floor_sigmas)
        if rp.sweep_cov_inlier_ref > 0:
            # inlier-count de-weighting of low-support fits
            s = torch.clamp(rp.sweep_cov_inlier_ref
                            / torch.clamp(rr.inliers, min=1), 1.0, 4.0)
            cov = cov * (s * s)[:, None, None]
        return ok & _finite(rr.pose, cov), rr.pose, cov

    ok, z, cov = _lane_map(one, (j, i), mesh)

    # the capacity cut: the first (max_loops - num_loops) accepted lanes
    rank = torch.cumsum(ok.to(torch.int64), dim=0) - 1
    en = ok & (carry.num_loops + rank < dims.max_loops)
    fslot0 = carry.graph.num_factors
    graph, rank = _append_factors(carry.graph, en, i, j, z,
                                  cov_to_sqrt_info(cov), rp.robust)
    slot = carry.num_loops + rank
    c = carry._replace(
        graph=graph,
        loops_i=_drop_set(carry.loops_i, slot, i, en),
        loops_j=_drop_set(carry.loops_j, slot, j, en),
        loops_tf=_drop_set(carry.loops_tf, slot, z, en),
        loops_slot=_drop_set(carry.loops_slot, slot, fslot0 + rank, en),
    )
    return c._replace(num_loops=carry.num_loops + host_read(int, torch.sum(en)))


def _prune_loops(carry: SlamCarry, rp, dims: SlamDims) -> SlamCarry:
    """Zero-weight and de-log loops that disagree with the converged graph
    by more than ``prune_max_dt`` / ``prune_max_dr`` (no-op when
    ``prune_max_dt <= 0``); the log is compacted with the keepers first, in
    their order."""
    if rp.prune_max_dt <= 0:
        return carry
    dev = carry.poses.device
    lvalid = torch.arange(dims.max_loops, device=dev) < carry.num_loops
    rel = se2_between(carry.poses[carry.loops_i], carry.poses[carry.loops_j])
    d = se2_between(carry.loops_tf, rel)
    bad = lvalid & ((_norm2(d) > rp.prune_max_dt)
                    | (torch.abs(d[:, 2]) > rp.prune_max_dr))
    g = carry.graph
    g = g._replace(f_sqrt_info=_drop_set(
        g.f_sqrt_info, carry.loops_slot, torch.zeros((3, 3), device=dev),
        bad & (carry.loops_slot >= 0)))
    keep = lvalid & ~bad
    order = torch.sort((~keep).to(torch.int64), stable=True).indices
    return carry._replace(
        graph=g, loops_i=carry.loops_i[order], loops_j=carry.loops_j[order],
        loops_tf=carry.loops_tf[order], loops_slot=carry.loops_slot[order],
        num_loops=host_read(int, torch.sum(keep)))


def refine_loops(carry: SlamCarry, params: SlamParams, rp: RefineParams,
                 dims: SlamDims, scale_basis=None,
                 mesh: Mesh | None = None) -> SlamCarry:
    """Iterated post-convergence refinement: re-measure -> optimize (-> chain
    -> optimize on the first pass) -> sweep -> optimize, ``dims.refine_iters``
    times, then prune -> optimize (and a final sweep and prune when
    ``dims.refine_final_sweep``). ``scale_basis`` (K, 2, 2) holds the DVL
    basis integrals at the keyframes. A no-op when ``refine_iters == 0``.

    With ``mesh`` (``parallel/mesh.py``; ``max_loops`` and ``max_keyframes``
    divisible by its size, as the JAX version requires) every rank calls
    this on the same carry, and each registration fan-out (the loops
    re-measured, the chain pairs, the sweep pairs) is split over the ranks.
    Only the live lanes register, as without a mesh: the L valid (or moved)
    loops, the num_kf - 1 chain pairs, the sweep pairs with a target. They
    are padded to the next multiple of the mesh size with copies of the
    first, each rank registers its contiguous block, and the per-lane
    (ok, z, cov) are gathered and cut back to L; every rank then holds the
    same refined carry. A fan-out whose lanes differ between ranks raises
    RuntimeError on every rank.

    Its phases are the spans ``refine.remeasure``, ``refine.chain`` (the
    chain and the scale anchor), ``refine.sweep``, ``refine.prune`` and
    ``refine.optimize`` (each Gauss-Newton solve)."""
    if mesh is not None:
        check_mesh_dims(dims, mesh.size)
    if dims.refine_iters <= 0:
        return carry
    pin_fp32()
    # more GN headroom than the in-scan updates, and a relaxed scale prior
    # until the chain anchor pins the scale (see the JAX version)
    gcfg = dims.graph_config()._replace(
        gn_iters=max(dims.gn_iters, 12), convergence_tol=1e-6,
        scale_prior_sigma=(max(dims.dvl_scale_prior_sigma, 0.25),
                           dims.dvl_scale_prior_sigma_y))
    gcfg_anchored = gcfg._replace(
        scale_prior_sigma=tuple(dims.refine_scale_anchor_sigma))
    cfg = gcfg

    def opt(c: SlamCarry) -> SlamCarry:
        with CodeTimer("refine.optimize", silent=True):
            g = optimize(c.graph, cfg)
        return c._replace(graph=g, poses=g.poses)

    def sweep(c: SlamCarry) -> SlamCarry:
        with CodeTimer("refine.sweep", silent=True):
            return _sweep(c, params, rp, dims, mesh)

    def prune(c: SlamCarry) -> SlamCarry:
        with CodeTimer("refine.prune", silent=True):
            return _prune_loops(c, rp, dims)

    # endpoint relative pose of each loop at its last registration
    reg_between = _loops_between(carry)
    for it in range(dims.refine_iters):
        with CodeTimer("refine.remeasure", silent=True):
            if it == 0 or not dims.refine_incremental:
                carry = _remeasure(carry, params, rp, dims, mesh)
                reg_between = _loops_between(carry)
            else:
                carry, reg_between = _remeasure_moved(
                    carry, reg_between, params, rp, dims, mesh)
        carry = opt(carry)
        if it == 0 and dims.refine_chain:
            with CodeTimer("refine.chain", silent=True):
                carry, ch_ok, ch_z = _densify_chain(carry, params, rp, dims,
                                                    mesh)
                if dims.refine_scale_from_chain and dims.estimate_dvl_scale:
                    carry = _anchor_scale_from_chain(carry, ch_ok, ch_z, rp,
                                                     dims, scale_basis)
                    cfg = gcfg_anchored
            carry = opt(carry)
        if dims.refine_sweep:
            n_before = carry.num_loops
            carry = opt(sweep(carry))
            if dims.refine_incremental and carry.num_loops > n_before:
                # the sweep's new lanes were registered at the current poses
                fresh = slice(n_before, carry.num_loops)
                reg_between = reg_between.clone()
                reg_between[fresh] = _loops_between(carry)[fresh]
    carry = opt(prune(carry))
    if dims.refine_final_sweep and dims.refine_sweep:
        carry = opt(sweep(carry))
        carry = opt(prune(carry))
    return carry
