"""Masked fixed-capacity SE(2) factor graph with Gauss-Newton solves.

Counterpart of ``sonar_slam_tpu/graph/factor_graph.py``: a prior on X(0),
between factors (diagonal, full-covariance or Cauchy-robust), optional
per-axis DVL log-scale variables, gtsam's residual conventions, and dense
normal equations solved by a Jacobi-scaled Cholesky.

* The Jacobians come from ``torch.func.jacfwd`` of the exact residual,
  batched over the factor table with ``torch.func.vmap``.
* The normal equations are assembled as ``A^T A`` of one dense stacked
  Jacobian (F*3, n) instead of the JAX package's scatter-adds: the same sums
  in another order, and deterministic on the card.
* A Cholesky that fails fills the factor with NaN, as ``jnp.linalg.cholesky``
  does; ``optimize`` then escalates the damping.
* The Gauss-Newton ``while_loop`` becomes at most ``gn_iters`` trips that
  stop once the step is below tolerance (one host sync per trip).
* On a CUDA card an unbatched graph's sweep and marginal run as captured
  CUDA graphs (:class:`_Replayed`): a configuration's first sweep and first
  marginal run op by op, then each is captured over static buffers and
  replayed, the same kernels on the same data, so the results keep their
  bits. The lane paths, ``vmap`` and the CPU run op by op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry import se2_between, se2_compose, se2_inverse, se2_logmap, se2_retract
from ..lone_sums import each_lane
from ..utils.timing import count_graph_run, host_read, to_device


class GraphConfig(NamedTuple):
    max_poses: int = 256
    max_factors: int = 1024
    gn_iters: int = 6
    damping: float = 1e-9
    convergence_tol: float = 1e-5
    step_clamp_t: float = 2.0
    step_clamp_r: float = 0.5
    estimate_scale: bool = False
    scale_prior_sigma: float | tuple = 0.05


class GraphState(NamedTuple):
    poses: torch.Tensor  # (K, 3)
    num_poses: torch.Tensor  # int64
    prior_pose: torch.Tensor  # (3,)
    prior_sqrt_info: torch.Tensor  # (3, 3)
    f_i: torch.Tensor  # (F,) int64
    f_j: torch.Tensor  # (F,) int64
    f_z: torch.Tensor  # (F, 3)
    f_sqrt_info: torch.Tensor  # (F, 3, 3)
    f_robust: torch.Tensor  # (F,) bool
    f_scaled: torch.Tensor  # (F,) bool
    num_factors: torch.Tensor  # int64
    log_scale: torch.Tensor  # (2,)
    log_scale_anchor: torch.Tensor  # (2,)


def cholesky_nan(m: torch.Tensor, lanes=None) -> torch.Tensor:
    """Lower Cholesky factor, all-NaN where ``m`` is not positive definite
    (``jnp.linalg.cholesky`` returns NaN there and callers rely on it).
    With ``lanes``, of B lanes' matrices, one factorization a listed lane
    (:func:`each_lane`)."""
    if lanes is None:
        L, info = torch.linalg.cholesky_ex(m)
    else:  # each lane's factor kept column-major, as cuSOLVER returns one
        Lt, info = each_lane(_transposed_cholesky, lanes, m)
        L = Lt.mT
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _transposed_cholesky(m):
    L, info = torch.linalg.cholesky_ex(m)
    return L.mT, info


def sigmas_to_sqrt_info(sigmas: torch.Tensor) -> torch.Tensor:
    """Diagonal noise model -> whitening matrix."""
    return torch.diag(1.0 / sigmas)


def cov_to_sqrt_info(cov: torch.Tensor, lanes=None) -> torch.Tensor:
    """Full covariance -> upper-triangular whitening R with R^T R = cov^-1
    (NaN when the information is not positive definite); with ``lanes``,
    of B lanes' covariances (B, 3, 3), the listed lanes' (the 3 x 3
    inverses batch as they are alone, the Cholesky factors do not)."""
    info, _ = torch.linalg.inv_ex(cov)
    info = 0.5 * (info + info.transpose(-1, -2))
    return cholesky_nan(info, lanes).transpose(-1, -2)


def graph_init(config: GraphConfig, device) -> GraphState:
    K, F = config.max_poses, config.max_factors

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GraphState(
        poses=z(K, 3), num_poses=z(dtype=torch.int64), prior_pose=z(3),
        prior_sqrt_info=z(3, 3), f_i=z(F, dtype=torch.int64),
        f_j=z(F, dtype=torch.int64), f_z=z(F, 3), f_sqrt_info=z(F, 3, 3),
        f_robust=z(F, dtype=torch.bool), f_scaled=z(F, dtype=torch.bool),
        num_factors=z(dtype=torch.int64), log_scale=z(2),
        log_scale_anchor=z(2),
    )


def set_pose_estimate(state: GraphState, k, pose) -> GraphState:
    """Insert/overwrite the initial value of key k (int or 0-d tensor)."""
    poses = state.poses.clone()
    poses[k] = pose
    return state._replace(
        poses=poses,
        num_poses=torch.clamp(state.num_poses, min=k + 1) if isinstance(k, int)
        else torch.maximum(state.num_poses, k + 1))


def add_prior(state: GraphState, pose, sqrt_info) -> GraphState:
    """Anchor X(0) and insert its value."""
    state = state._replace(prior_pose=pose.clone(), prior_sqrt_info=sqrt_info)
    return set_pose_estimate(state, 0, pose)


def add_between(state: GraphState, i, j, z, sqrt_info, robust=False,
                enabled=True, scaled=False) -> GraphState:
    """Append a between factor xi -> xj; a masked no-op when ``enabled`` is
    False (a bool or a 0-d bool tensor). The write goes to the last slot
    when disabled and leaves it unchanged."""
    dev = state.f_i.device
    F = state.f_i.shape[0]
    en = to_device(enabled, dev)
    slot = host_read(int, torch.where(en, state.num_factors,
                                      torch.full_like(state.num_factors, F - 1)))

    def put(arr, val):
        val = to_device(val, dev, arr.dtype)
        new = torch.where(en, val, arr[slot])
        out = arr.clone()
        out[slot] = new
        return out

    return state._replace(
        f_i=put(state.f_i, i), f_j=put(state.f_j, j), f_z=put(state.f_z, z),
        f_sqrt_info=put(state.f_sqrt_info, sqrt_info),
        f_robust=put(state.f_robust, robust),
        f_scaled=put(state.f_scaled, scaled),
        num_factors=state.num_factors + en.to(torch.int64),
    )


def _between_residual(xi, xj, z, sqrt_info):
    err = se2_logmap(se2_compose(se2_inverse(z), se2_between(xi, xj)))
    return torch.matmul(sqrt_info, err)


def _linearize(xi, xj, z, sqrt_info, robust, scaled, log_scale):
    """Whitened residual (3,) and Jacobian (3, 8) wrt (di, dj, dlog_scale),
    with gtsam's Cauchy(1) reweighting of robust factors."""

    def f(delta):
        di, dj, ds = delta[:3], delta[3:6], delta[6:8]
        s = torch.where(scaled, torch.exp(log_scale + ds), torch.ones_like(ds))
        z_eff = torch.stack([z[0] * s[0], z[1] * s[1], z[2]])
        return _between_residual(se2_retract(xi, di), se2_retract(xj, dj),
                                 z_eff, sqrt_info)

    zero = torch.zeros(8, dtype=xi.dtype, device=xi.device)
    r = f(zero)
    J = jacfwd(f)(zero)
    w = torch.where(robust, 1.0 / (1.0 + torch.sum(r * r)), torch.ones_like(r[0]))
    sw = torch.sqrt(w)
    return sw * r, sw * J


def _linear_system(state: GraphState, config: GraphConfig):
    """The whitened stacked Jacobian A (F*3, n) and residual r (F*3,) of the
    between factors, n = 3K (+2 with scale estimation, whose variables take
    the last two columns), and the prior's Jacobian J0 (3, 3) and residual
    r0 (3,)."""
    K = config.max_poses
    F = state.f_i.shape[0]
    dev = state.poses.device
    active = (torch.arange(F, device=dev) < state.num_factors).to(torch.float32)
    xi = state.poses[state.f_i]
    xj = state.poses[state.f_j]
    r, J = vmap(_linearize, in_dims=(0, 0, 0, 0, 0, 0, None))(
        xi, xj, state.f_z, state.f_sqrt_info, state.f_robust, state.f_scaled,
        state.log_scale)
    r = r * active[:, None]
    J = J * active[:, None, None]

    n = 3 * K + (2 if config.estimate_scale else 0)
    A = J.new_zeros((F, 3, n + 3))  # batched under a vmap over graphs
    ar = torch.arange(F, device=dev)
    cols = torch.arange(3, device=dev)
    ci = 3 * state.f_i[:, None] + cols  # (F, 3)
    cj = 3 * state.f_j[:, None] + cols
    A[ar[:, None, None], cols[None, :, None], ci[:, None, :]] = J[..., :3]
    A[ar[:, None, None], cols[None, :, None], cj[:, None, :]] += J[..., 3:6]
    if config.estimate_scale:
        A[:, :, 3 * K: 3 * K + 2] = J[..., 6:8]
    A = A[..., :n].reshape(F * 3, n)

    def fprior(d):
        return torch.matmul(state.prior_sqrt_info, se2_logmap(
            se2_compose(se2_inverse(state.prior_pose),
                        se2_retract(state.poses[0], d))))

    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    return A, r.reshape(F * 3), jacfwd(fprior)(z3), fprior(z3)


def _products(A, r, J0, r0):
    """The library products of one graph's normal equations: A^T A, A^T r,
    J0^T J0, J0^T r0 (the two of r None without r)."""
    if r is None:
        return torch.matmul(A.T, A), None, torch.matmul(J0.T, J0), None
    return (torch.matmul(A.T, A), torch.matmul(A.T, r), torch.matmul(J0.T, J0),
            torch.matmul(J0.T, r0))


_SCALE_WEIGHTS: dict = {}


def _scale_weights(config: GraphConfig, dev) -> torch.Tensor:
    """The scale prior's weights (1/sx², 1/sy²), float32 (2,) on ``dev``,
    made once per prior and device by fills on the device (no host copy)."""
    sp = config.scale_prior_sigma
    sx, sy = sp if isinstance(sp, (tuple, list)) else (sp, sp)
    key = (sx, sy, dev)
    w = _SCALE_WEIGHTS.get(key)
    if w is None:
        w = torch.empty(2, dtype=torch.float32, device=dev)
        w[0].fill_(1.0 / sx**2)
        w[1].fill_(1.0 / sy**2)
        _SCALE_WEIGHTS[key] = w
    return w


def _assemble_normal_equations(state: GraphState, config: GraphConfig,
                               lanes=None, need_b: bool = True):
    """H (n, n) and b (n,) at the current estimates, n = 3K (+2 with scale
    estimation, whose variables take the last two rows/columns); b None
    without ``need_b``. With ``lanes`` (a list of lane indices), ``state``
    holds B graphs (every field with a leading lane axis): H (B, n, n) and
    b (B, n), their linear systems batched and each listed lane's products
    its own calls (:func:`each_lane`; the other lanes' hold none)."""
    K = config.max_poses
    dev = state.poses.device
    if lanes is None:
        A, r, J0, r0 = _linear_system(state, config)
        H, b, JtJ, Jtr = _products(A, r if need_b else None, J0, r0)
    else:
        if state.poses.device.type == "cpu":
            A, r, J0, r0 = (torch.stack(x) for x in zip(*(
                _linear_system(GraphState(*(f[i] for f in state)), config)
                for i in range(state.poses.shape[0]))))
        else:
            A, r, J0, r0 = vmap(lambda st: _linear_system(st, config))(state)
        # each lane's J0 stored as jacfwd stores the lone one (transposed),
        # so that its products take the lone call's kernel
        J0 = J0.transpose(-1, -2).contiguous().transpose(-1, -2)
        if need_b:
            H, b, JtJ, Jtr = each_lane(_products, lanes, A, r, J0, r0)
        else:
            H, JtJ = each_lane(lambda a, j: _products(a, None, j, None)[::2],
                               lanes, A, J0)
            b = None

    if config.estimate_scale:
        w_s = _scale_weights(config, dev)
        s = torch.arange(3 * K, 3 * K + 2, device=dev)
        H[..., s, s] += w_s
        if b is not None:
            b[..., s] += w_s * (state.log_scale - state.log_scale_anchor)

    H[..., :3, :3] += JtJ
    if b is not None:
        b[..., :3] += Jtr

    valid = torch.repeat_interleave(
        torch.arange(K, device=dev) < state.num_poses[..., None], 3, dim=-1)
    if config.estimate_scale:
        valid = torch.cat([valid, torch.ones(valid.shape[:-1] + (2,),
                                             dtype=torch.bool, device=dev)],
                          dim=-1)
    H = H + torch.diag_embed(torch.where(valid, config.damping, 1.0).to(
        torch.float32))
    return H, b


def _scaled_cho_factor(H, lanes=None):
    """Jacobi-preconditioned Cholesky: H = D (L L^T) D, D = diag(sqrt(H_ii));
    with ``lanes``, of B lanes' H (B, n, n), one factorization a listed
    lane."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hs = H / (d[..., :, None] * d[..., None, :])
    return cholesky_nan(Hs, lanes), d


def _scaled_cho_solve(Lf, b, lanes=None):
    """Solve with :func:`_scaled_cho_factor`'s factor for b (n,) or (n, m)
    (a leading lane axis on both with ``lanes``, one solve a listed
    lane)."""
    L, d = Lf
    vec = b.ndim == d.ndim
    bb = (b / d)[..., None] if vec else b / d[..., None]
    if lanes is None:
        x = torch.cholesky_solve(bb, L)
    else:
        x = each_lane(lambda u, f: (torch.cholesky_solve(u, f),), lanes,
                      bb, L)[0]
    x = x / d[..., None]
    return x[..., 0] if vec else x


def _gn_step(state: GraphState, poses, log_scale, prev_delta, lam,
             config: GraphConfig, lanes=None):
    """One relinearized Gauss-Newton sweep from (poses, log_scale) with the
    adaptive Levenberg damping ``lam`` and the trust-region step clamp.
    Returns (poses, log_scale, max_delta, lam); ``max_delta`` is inf when
    the solve failed. With ``lanes`` every argument holds B graphs (a
    leading lane axis) and the listed lanes are stepped
    (:func:`_assemble_normal_equations`)."""
    K = config.max_poses
    dev = poses.device
    valid = (torch.arange(K, device=dev) < state.num_poses[..., None])[..., None]
    st = state._replace(poses=poses, log_scale=log_scale)
    H, b = _assemble_normal_equations(st, config, lanes)
    Hd = H + lam[..., None, None] * torch.diag_embed(
        torch.diagonal(H, dim1=-2, dim2=-1))
    delta = -_scaled_cho_solve(_scaled_cho_factor(Hd, lanes), b, lanes)
    finite = torch.all(torch.isfinite(delta), dim=-1)
    delta = torch.where(finite[..., None], delta, torch.zeros_like(delta))
    if config.estimate_scale:
        ds = delta[..., 3 * K: 3 * K + 2]
        delta = delta[..., : 3 * K]
    else:
        ds = torch.zeros(delta.shape[:-1] + (2,), device=dev)
    delta = delta.reshape(delta.shape[:-1] + (K, 3))
    vdelta = torch.where(valid, delta, torch.zeros_like(delta))
    if config.step_clamp_t > 0.0:
        big_t = torch.amax(torch.abs(vdelta[..., :2]), dim=(-2, -1))
        big_r = torch.amax(torch.abs(vdelta[..., 2]), dim=-1)
        shrink = torch.clamp(torch.minimum(
            config.step_clamp_t / torch.clamp(big_t, min=1e-12),
            config.step_clamp_r / torch.clamp(big_r, min=1e-12)), max=1.0)
        delta = delta * shrink[..., None, None]
        vdelta = vdelta * shrink[..., None, None]
        ds = ds * shrink[..., None]
    log_scale = log_scale + ds
    poses = torch.where(valid, se2_retract(poses, delta), poses)
    max_delta = torch.maximum(torch.amax(torch.abs(vdelta), dim=(-2, -1)),
                              torch.amax(torch.abs(ds), dim=-1))
    max_delta = torch.where(finite, max_delta,
                            torch.full_like(max_delta, float("inf")))
    grew = finite & (max_delta > prev_delta * 1.05)
    lam = torch.where(
        ~finite, torch.clamp(lam, min=1e-6) * 100.0,
        torch.where(grew, torch.clamp(torch.clamp(lam, min=1e-8) * 30.0,
                                      max=1.0), lam * 0.25))
    return poses, log_scale, max_delta, lam


def optimize(state: GraphState, config: GraphConfig) -> GraphState:
    """Up to ``config.gn_iters`` relinearized Gauss-Newton sweeps with the
    adaptive Levenberg damping and the trust-region step clamp of the JAX
    version; stops once the largest step component is below tolerance."""
    if _replayable(state):
        return _replayed(state, config).optimize(state, config)
    dev = state.poses.device
    poses, log_scale = state.poses, state.log_scale
    prev_delta = torch.full((), float("inf"), device=dev)
    lam = torch.zeros((), device=dev)
    for _ in range(config.gn_iters):
        poses, log_scale, prev_delta, lam = _gn_step(
            state, poses, log_scale, prev_delta, lam, config)
        count_graph_run(False)
        if not host_read(bool, prev_delta > config.convergence_tol):
            break
    return state._replace(poses=poses, log_scale=log_scale)


def _several(keys) -> bool:
    return isinstance(keys, torch.Tensor) and keys.ndim == 1


def _marginals(state: GraphState, k: torch.Tensor, config: GraphConfig,
               lanes=None) -> torch.Tensor:
    """(..., M, 3, 3) marginal covariances of the M keys ``k`` (an int64
    device tensor) from one factorization of H at ``state``."""
    K = config.max_poses
    H, _ = _assemble_normal_equations(state, config, lanes, need_b=False)
    Lf = _scaled_cho_factor(H, lanes)
    dev = H.device
    n = 3 * K + (2 if config.estimate_scale else 0)
    M = k.shape[0]
    rows = (3 * k[:, None] + torch.arange(3, device=dev)).reshape(-1)
    # unit columns: a 1 in row rows[c] of column c
    e = (torch.arange(n, device=dev)[:, None] == rows).to(torch.float32)
    e = e.expand(H.shape[:-2] + e.shape)
    cols = _scaled_cho_solve(Lf, e, lanes)  # (..., n, 3M)
    cov = cols[..., rows, :].reshape(cols.shape[:-2] + (M, 3, M, 3))
    return cov.diagonal(dim1=-4, dim2=-2).movedim(-1, -3)


def marginal_covariance(state: GraphState, keys, config: GraphConfig,
                        lanes=None):
    """Marginal covariance of pose ``keys`` (gtsam's ``marginalCovariance``):
    the (k, k) blocks of H⁻¹ at the current linearization, from one
    factorization. (3, 3) for one key (an int or a 0-d tensor), (M, 3, 3)
    for a 1-D tensor of M keys. With ``lanes``, of B graphs (the listed
    lanes' blocks; a leading lane axis on the result)."""
    if lanes is None and _replayable(state):
        rep = _replayed(state, config)
        rep.load(state)
        return rep.marginal(keys)
    dev = state.poses.device
    if isinstance(keys, int):
        k = torch.full((1,), keys, dtype=torch.int64, device=dev)
    else:
        k = to_device(keys, dev, torch.int64).reshape(-1)
    cov = _marginals(state, k, config, lanes)
    count_graph_run(False)
    return cov if _several(keys) else cov[..., 0, :, :]


def optimize_with_marginal(state: GraphState, k, config: GraphConfig):
    """``optimize`` plus the 3x3 marginal covariance of pose ``k`` from the
    final linearization."""
    if _replayable(state):
        rep = _replayed(state, config)
        return rep.optimize(state, config), rep.marginal(k)
    state = optimize(state, config)
    return state, marginal_covariance(state, k, config)


# ----------------------------------------------------------------------
# an unbatched graph on a card: the sweep and the marginal as captured
# CUDA graphs
# ----------------------------------------------------------------------

_REPLAYED: dict = {}


def _replayable(state: GraphState) -> bool:
    """A graph on a CUDA card, outside ``vmap`` (whose graphs are lanes)."""
    return (state.poses.is_cuda
            and not torch._C._are_functorch_transforms_active())


def _replayed(state: GraphState, config: GraphConfig) -> "_Replayed":
    """The :class:`_Replayed` of everything a sweep holds as a constant:
    K, F, ``estimate_scale``, ``scale_prior_sigma``, ``damping``, the step
    clamps and the device. ``gn_iters`` and ``convergence_tol`` stay on the
    host, so configurations that differ only there share the graphs."""
    sp = config.scale_prior_sigma
    key = (config.max_poses, state.f_i.shape[0], config.estimate_scale,
           tuple(sp) if isinstance(sp, list) else sp, config.damping,
           config.step_clamp_t, config.step_clamp_r, state.poses.device)
    rep = _REPLAYED.get(key)
    if rep is None:
        rep = _REPLAYED[key] = _Replayed(state, config)
    return rep


class _Replayed:
    """A configuration's Gauss-Newton sweep and marginals on one card, as
    CUDA graphs over static buffers: ``bufs`` holds a graph's state (its
    ``poses`` and ``log_scale`` the estimates the sweep steps), ``prev_delta``
    and ``lam`` the last step and the damping. A sweep writes its results
    back into them; the marginal of M keys reads its keys from ``keys[M]``
    and writes ``covs[M]``. A graph's first run is op by op (the result and
    the warm-up); it is then captured, and every later run replays it. The
    graphs share one memory pool and run one at a time, on the current
    stream; the results are cloned out before the next call."""

    def __init__(self, state: GraphState, config: GraphConfig):
        dev = state.poses.device
        self.config = config
        self.bufs = GraphState(*(torch.empty(x.shape, dtype=x.dtype, device=dev)
                                 for x in state))
        self.prev_delta = torch.empty((), device=dev)
        self.lam = torch.empty((), device=dev)
        self.keys: dict = {}
        self.covs: dict = {}
        self.graphs: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)

    def load(self, state: GraphState) -> None:
        for buf, x in zip(self.bufs, state):
            buf.copy_(x)

    def _run(self, name, body) -> None:
        """Replay the graph ``name``; on its first run, run ``body`` op by
        op and capture it."""
        graph = self.graphs.get(name)
        if graph is not None:
            graph.replay()
            count_graph_run(True)
            return
        body()
        count_graph_run(False)
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        cur.wait_stream(self.stream)
        # cuBLAS keeps a workspace a stream (32 MiB on an H100), the capture
        # stream's made during the capture in the graphs' pool: dropped, it
        # goes back to that pool, which only later captures draw on, instead
        # of staying allocated beside the current stream's
        torch._C._cuda_clearCublasWorkspaces()
        self.graphs[name] = graph

    def _sweep(self) -> None:
        b = self.bufs
        out = _gn_step(b, b.poses, b.log_scale, self.prev_delta, self.lam,
                       self.config)
        for buf, x in zip((b.poses, b.log_scale, self.prev_delta, self.lam), out):
            buf.copy_(x)

    def optimize(self, state: GraphState, config: GraphConfig) -> GraphState:
        """:func:`optimize` of ``state``, which stays loaded, with
        ``config``'s sweep count and tolerance."""
        self.load(state)
        self.prev_delta.fill_(float("inf"))
        self.lam.zero_()
        for _ in range(config.gn_iters):
            self._run("sweep", self._sweep)
            if not host_read(bool, self.prev_delta > config.convergence_tol):
                break
        return state._replace(poses=self.bufs.poses.clone(),
                              log_scale=self.bufs.log_scale.clone())

    def marginal(self, keys) -> torch.Tensor:
        """:func:`marginal_covariance` of the loaded state."""
        M = keys.numel() if _several(keys) else 1
        if M not in self.keys:
            dev = self.bufs.poses.device
            self.keys[M] = torch.empty(M, dtype=torch.int64, device=dev)
            self.covs[M] = torch.empty((M, 3, 3), device=dev)
        k = self.keys[M]
        if isinstance(keys, int):
            k.fill_(keys)
        else:
            k.copy_(to_device(keys, k.device, torch.int64).reshape(-1))

        def body():
            self.covs[M].copy_(_marginals(self.bufs, k, self.config))

        self._run(M, body)
        cov = self.covs[M].clone()
        return cov if _several(keys) else cov[0]


def optimize_batch(states: GraphState, config: GraphConfig, active=None,
                   lane_calls: bool = False) -> GraphState:
    """``optimize`` over a batch of graphs (every field with a leading batch
    axis), as the JAX package's vmap of its ``while_loop`` runs: a graph
    whose step fell below tolerance keeps its estimate while the others go
    on, up to ``config.gn_iters`` sweeps. A graph where the (B,) mask
    ``active`` is False is not stepped. With ``lane_calls`` (a sweep's
    lanes) each stepping graph's products and factorizations are calls of
    its own, as in its lone ``optimize`` (:func:`each_lane`); one host
    read a sweep either way."""
    B = states.poses.shape[0]
    dev = states.poses.device
    step = vmap(lambda st, p, s, d, lam: _gn_step(st, p, s, d, lam, config))
    poses, log_scale = states.poses, states.log_scale
    prev_delta = torch.full((B,), float("inf"), device=dev)
    if active is not None:
        prev_delta = torch.where(active, prev_delta, torch.zeros_like(prev_delta))
    lam = torch.zeros(B, device=dev)
    for _ in range(config.gn_iters):
        active = prev_delta > config.convergence_tol
        if lane_calls:
            lanes = torch.nonzero(host_read(torch.Tensor.cpu, active))[:, 0].tolist()
            if not lanes:
                break
            out = _gn_step(states, poses, log_scale, prev_delta, lam, config,
                           lanes)
        else:
            if not host_read(bool, active.any()):
                break
            out = step(states, poses, log_scale, prev_delta, lam)
        a = active[:, None, None]
        poses = torch.where(a, out[0], poses)
        log_scale = torch.where(a[:, 0], out[1], log_scale)
        prev_delta = torch.where(active, out[2], prev_delta)
        lam = torch.where(active, out[3], lam)
    return states._replace(poses=poses, log_scale=log_scale)


# ----------------------------------------------------------------------
# a sweep's lanes: every field of a GraphState with a leading axis of B
# lanes, each lane's results those of its lone graph
# ----------------------------------------------------------------------


def set_pose_estimate_lanes(state: GraphState, k: int, pose) -> GraphState:
    """:func:`set_pose_estimate` of key ``k`` (an int) in B lanes, pose (B,
    3)."""
    poses = state.poses.clone()
    poses[:, k] = pose
    return state._replace(poses=poses,
                          num_poses=torch.clamp(state.num_poses, min=k + 1))


def add_prior_lanes(state: GraphState, pose, sqrt_info) -> GraphState:
    """:func:`add_prior` in B lanes: pose (B, 3), sqrt_info (B, 3, 3)."""
    state = state._replace(prior_pose=pose.clone(), prior_sqrt_info=sqrt_info)
    return set_pose_estimate_lanes(state, 0, pose)


def add_between_lanes(state: GraphState, i, j, z, sqrt_info, robust=False,
                      enabled=True, scaled=False) -> GraphState:
    """:func:`add_between` in B lanes: each argument is a host value shared
    by the lanes or a tensor with a leading lane axis (``enabled`` a (B,)
    mask: a lane where it is False keeps its graph bit for bit)."""
    B, F = state.f_i.shape
    dev = state.f_i.device
    lanes = torch.arange(B, device=dev)
    en = torch.as_tensor(enabled, device=dev).expand(B)
    slot = torch.where(en, state.num_factors,
                       torch.full_like(state.num_factors, F - 1))

    def put(arr, val):
        cur = arr[lanes, slot]
        val = torch.as_tensor(val, dtype=arr.dtype, device=dev).expand(cur.shape)
        out = arr.clone()
        out[lanes, slot] = torch.where(
            en.reshape((B,) + (1,) * (cur.ndim - 1)), val, cur)
        return out

    return state._replace(
        f_i=put(state.f_i, i), f_j=put(state.f_j, j), f_z=put(state.f_z, z),
        f_sqrt_info=put(state.f_sqrt_info, sqrt_info),
        f_robust=put(state.f_robust, robust),
        f_scaled=put(state.f_scaled, scaled),
        num_factors=state.num_factors + en.to(torch.int64),
    )


def optimize_with_marginal_lanes(state: GraphState, k: int,
                                 config: GraphConfig, active=None):
    """:func:`optimize_with_marginal` in B lanes, each lane's bits those of
    its lone call (``optimize_batch`` with ``lane_calls``). With ``active``
    (B,), an inactive lane keeps its graph and its returned marginal is
    zero (the caller keeps the old one)."""
    state = optimize_batch(state, config, active, lane_calls=True)
    B = state.poses.shape[0]
    lanes = (list(range(B)) if active is None
             else torch.nonzero(host_read(torch.Tensor.cpu, active))[:, 0].tolist())
    return state, marginal_covariance(state, k, config, lanes)


class Smoother:
    """Host-side wrapper with ISAM2's shape (gtsam's ``ISAM2`` as the
    reference's SLAM node drives it): queue factors and values, ``update()``
    for new estimates, ``marginal_covariance(k)``. Poses, measurements,
    sigmas and covariances may be lists, arrays or tensors; they go to the
    smoother's device as float32."""

    def __init__(self, config: GraphConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.state = graph_init(config, self.device)

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    def add_prior(self, pose, sigmas):
        self.state = add_prior(self.state, self._t(pose),
                               sigmas_to_sqrt_info(self._t(sigmas)))

    def add_odometry(self, i, j, z, sigmas, robust=False):
        self.state = add_between(self.state, i, j, self._t(z),
                                 sigmas_to_sqrt_info(self._t(sigmas)), robust)

    def add_between_cov(self, i, j, z, cov, robust=False):
        self.state = add_between(self.state, i, j, self._t(z),
                                 cov_to_sqrt_info(self._t(cov)), robust)

    def insert(self, k, pose):
        self.state = set_pose_estimate(self.state, k, self._t(pose))

    def update(self) -> torch.Tensor:
        self.state = optimize(self.state, self.config)
        return self.state.poses

    def estimate(self, k=None) -> torch.Tensor:
        return self.state.poses if k is None else self.state.poses[k]

    def marginal_covariance(self, k) -> torch.Tensor:
        return marginal_covariance(self.state, k, self.config)
