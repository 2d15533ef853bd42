"""Factor graph and PCM: the port against the JAX package.

The port assembles the normal equations as A^T A of one stacked Jacobian
(from ``torch.func.jacfwd``) instead of scatter-adds, and solves with the
same Jacobi-scaled Cholesky; poses agree to 2e-5 m / rad and marginal
covariances to 1e-3 relative (1e-6 absolute on entries ~0.1) after a few
Gauss-Newton sweeps in float32.
A NaN factor makes the Cholesky fail in both; both recover by escalating
the damping (tests/test_graph.py::test_optimize_survives_nan_factor pins it
for JAX).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.graph as jgr
from sonar_slam_tpu.graph.factor_graph import optimize_with_marginal as j_owm
import sonar_slam_torch.graph as tgr

torch.set_num_threads(1)


def _build(mod, cfg, steps, loops, nan_factor=False, device=None):
    T = (lambda x: jnp.asarray(np.asarray(x, np.float32))) if mod is jgr else (
        lambda x: torch.as_tensor(np.asarray(x, np.float32)))
    g = mod.graph_init(cfg) if mod is jgr else mod.graph_init(cfg, "cpu")
    g = mod.add_prior(g, T([0.0, 0.0, 0.0]), mod.sigmas_to_sqrt_info(
        T([0.1, 0.1, 0.01])))
    pose = np.zeros(3, np.float32)
    for k, (z, noisy) in enumerate(steps, start=1):
        sq = mod.sigmas_to_sqrt_info(T([0.2, 0.2, 0.02]))
        g = mod.add_between(g, k - 1, k, T(z), sq, robust=bool(k % 3 == 0),
                            scaled=bool(k % 2 == 0))
        c, s = np.cos(pose[2]), np.sin(pose[2])
        pose = pose + np.array([c * noisy[0] - s * noisy[1],
                                s * noisy[0] + c * noisy[1], noisy[2]], np.float32)
        g = mod.set_pose_estimate(g, k, T(pose))
    for i, j, z, cov in loops:
        sq = mod.cov_to_sqrt_info(T(cov))
        if nan_factor:
            sq = sq * np.float32("nan")
            nan_factor = False
        g = mod.add_between(g, i, j, T(z), sq)
    return g


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(9):
        z = np.array([1.0, 0.1, 0.35], np.float32)
        steps.append((z, z + rng.normal(scale=[0.05, 0.05, 0.02]).astype(np.float32)))
    cov = np.diag([0.01, 0.02, 0.001]).astype(np.float32)
    cov[0, 1] = cov[1, 0] = 0.004
    loops = [(0, 8, np.array([1.2, 5.1, 2.8], np.float32), cov),
             (2, 9, np.array([2.0, 3.0, 2.45], np.float32), cov)]
    return steps, loops


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_optimize_with_marginal(problem, estimate_scale):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4,
              estimate_scale=estimate_scale, scale_prior_sigma=(0.05, 0.01))
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops)
    js, jcov = j_owm(jg, 9, jgr.GraphConfig(**kw))
    ts, tcov = tgr.optimize_with_marginal(tg, 9, tgr.GraphConfig(**kw))
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               atol=2e-6)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-3, atol=1e-6)
    assert int(ts.num_factors) == int(js.num_factors) == 11


def test_optimize_survives_nan_factor(problem):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4)
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops, nan_factor=True)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops, nan_factor=True)
    js = jgr.optimize(jg, jgr.GraphConfig(**kw))
    ts = tgr.optimize(tg, tgr.GraphConfig(**kw))
    assert np.isfinite(ts.poses.numpy()).all()
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)


def test_cov_to_sqrt_info_and_not_pd():
    cov = np.array([[0.02, 0.005, 0.0], [0.005, 0.03, 0.001],
                    [0.0, 0.001, 0.002]], np.float32)
    np.testing.assert_allclose(
        tgr.cov_to_sqrt_info(torch.as_tensor(cov)).numpy(),
        np.asarray(jgr.cov_to_sqrt_info(jnp.asarray(cov))), rtol=1e-4)
    bad = np.diag([1.0, -2.0, 1.0]).astype(np.float32)
    assert np.isnan(np.asarray(jgr.cov_to_sqrt_info(jnp.asarray(bad)))).any()
    assert torch.isnan(tgr.cov_to_sqrt_info(torch.as_tensor(bad))).any()


def test_add_between_disabled_is_noop(problem):
    steps, loops = problem
    cfg = tgr.GraphConfig(max_poses=12, max_factors=16)
    g = _build(tgr, cfg, steps, loops)
    g2 = tgr.add_between(g, 1, 2, torch.ones(3), torch.eye(3),
                         enabled=torch.tensor(False))
    for a, b in zip(g, g2):
        assert torch.equal(a, b)


def test_pcm_select():
    rng = np.random.default_rng(3)
    Q = 6
    tp = rng.normal(size=(Q, 3)).astype(np.float32)
    sp = rng.normal(size=(Q, 3)).astype(np.float32)
    import sonar_slam_tpu.geometry as jgeo

    tf = np.asarray(jgeo.se2_between(jnp.asarray(tp), jnp.asarray(sp)))
    tf = tf + rng.normal(scale=0.01, size=tf.shape).astype(np.float32)
    tf[4] += [1.0, -0.5, 0.3]  # inconsistent with the rest
    covs = np.tile(np.diag([0.01, 0.01, 0.001]).astype(np.float32), (Q, 1, 1))
    valid = np.array([True, True, True, True, True, False])
    for min_pcm in (2, 5):
        jm, js = jgr.pcm_select(*[jnp.asarray(x) for x in (sp, tp, tf, covs, valid)],
                                min_pcm)
        tm, ts = tgr.pcm_select(*[torch.as_tensor(x) for x in (sp, tp, tf, covs, valid)],
                                min_pcm)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(ts) == int(js)


def test_marginal_covariance_of_several_keys(problem):
    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=4, estimate_scale=True,
              scale_prior_sigma=(0.05, 0.01))
    jg = _build(jgr, jgr.GraphConfig(**kw), steps, loops)
    tg = _build(tgr, tgr.GraphConfig(**kw), steps, loops)
    keys = [0, 4, 9]
    got = tgr.marginal_covariance(tg, torch.tensor(keys), tgr.GraphConfig(**kw))
    assert got.shape == (3, 3, 3)
    for k, c in zip(keys, got):
        want = np.asarray(jgr.marginal_covariance(jg, k, jgr.GraphConfig(**kw)))
        np.testing.assert_allclose(c.numpy(), want, rtol=1e-3, atol=1e-6)
    one = tgr.marginal_covariance(tg, 4, tgr.GraphConfig(**kw))
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_optimize_batch_matches_vmapped_optimize(problem, estimate_scale):
    """A batch of graphs whose Gauss-Newton loops stop after different
    numbers of sweeps, against the JAX package's vmap of ``optimize``."""
    import jax

    steps, loops = problem
    kw = dict(max_poses=12, max_factors=16, gn_iters=5,
              estimate_scale=estimate_scale, scale_prior_sigma=(0.05, 0.01))
    rng = np.random.default_rng(1)
    jgs, tgs = [], []
    for b in range(3):
        st = [(z, noisy + rng.normal(scale=0.02 * b, size=3).astype(np.float32))
              for z, noisy in steps]
        jgs.append(_build(jgr, jgr.GraphConfig(**kw), st, loops))
        tgs.append(_build(tgr, tgr.GraphConfig(**kw), st, loops))
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jgs)
    js = jax.vmap(lambda g: jgr.optimize(g, jgr.GraphConfig(**kw)))(jb)
    tb = tgr.GraphState(*[torch.stack(x) for x in zip(*tgs)])
    ts = tgr.optimize_batch(tb, tgr.GraphConfig(**kw))
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses), atol=2e-5)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               atol=2e-6)
    for b in range(3):  # each lane as the unbatched optimize gives it
        one = tgr.optimize(tgs[b], tgr.GraphConfig(**kw))
        np.testing.assert_allclose(ts.poses[b].numpy(), one.poses.numpy(),
                                   atol=2e-6)


def _assert_cov_blocks(got, want):
    """Each 3x3 block within 1e-4 of its largest entry: the cross terms are
    1e-3 to 1e-2 of the diagonal and carry the float32 solve's rounding
    (measured 5.4e-5)."""
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * scale)


def test_services(problem):
    """predict_slam_update and query_pose_uncertainty on a carry holding the
    test graph, against the JAX services."""
    import jax

    import sonar_slam_tpu.slam.core as jcore
    from sonar_slam_tpu.cloud import ICPConfig
    from sonar_slam_tpu.slam.services import (
        predict_slam_update as j_predict, query_pose_uncertainty as j_query)
    from sonar_slam_torch.convert import carry_from_reference, dims_from_reference
    from sonar_slam_torch.slam.services import (
        predict_slam_update, query_pose_uncertainty)

    steps, loops = problem
    jdims = jcore.SlamDims(max_keyframes=14, max_loops=4, gn_iters=4,
                           icp=ICPConfig())
    jg = _build(jgr, jdims.graph_config(), steps, loops)
    jg = jgr.optimize(jg, jdims.graph_config())
    jcarry = jcore.slam_init(jdims)._replace(graph=jg, poses=jg.poses,
                                             num_kf=jnp.asarray(10, jnp.int32))
    carry = carry_from_reference(jax.tree_util.tree_map(np.asarray, jcarry), "cpu")
    dims = dims_from_reference(jdims)
    odom = np.asarray([[[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                       [[1.0, 0.0, 0.5], [1.0, 0.0, 0.5]],
                       [[0.5, 0.2, -0.3], [0.8, -0.1, 0.1]]], np.float32)
    sig = np.asarray([0.2, 0.2, 0.02], np.float32)
    jpred, jcov = j_predict(jcarry, jdims, jnp.asarray(odom), jnp.asarray(sig))
    pred, cov = predict_slam_update(carry, dims, torch.as_tensor(odom),
                                    torch.as_tensor(sig))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=2e-5)
    _assert_cov_blocks(cov.numpy(), np.asarray(jcov))
    keys = np.asarray([0, 5, 9])
    got = query_pose_uncertainty(carry, dims, torch.as_tensor(keys))
    _assert_cov_blocks(got.numpy(), np.asarray(j_query(jcarry, jdims,
                                                       jnp.asarray(keys))))
    assert np.trace(cov[0].numpy()) > np.trace(got[-1].numpy())


# ---- the update before its sweep and marginal could be captured, frozen ----
# (host values copied in: the scale prior's weights, the first step and
# damping, the marginal's unit columns by index assignment)


def _frozen_normal_equations(state, config, need_b=True):
    from sonar_slam_torch.graph import factor_graph as fg

    K = config.max_poses
    dev = state.poses.device
    A, r, J0, r0 = fg._linear_system(state, config)
    H, b, JtJ, Jtr = fg._products(A, r if need_b else None, J0, r0)
    if config.estimate_scale:
        sp = config.scale_prior_sigma
        sx, sy = sp if isinstance(sp, (tuple, list)) else (sp, sp)
        w_s = torch.tensor([1.0 / sx**2, 1.0 / sy**2], dtype=torch.float32,
                           device=dev)
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


def _frozen_gn_step(state, poses, log_scale, prev_delta, lam, config):
    from sonar_slam_torch.geometry import se2_retract
    from sonar_slam_torch.graph import factor_graph as fg

    K = config.max_poses
    dev = poses.device
    valid = (torch.arange(K, device=dev) < state.num_poses[..., None])[..., None]
    st = state._replace(poses=poses, log_scale=log_scale)
    H, b = _frozen_normal_equations(st, config)
    Hd = H + lam[..., None, None] * torch.diag_embed(
        torch.diagonal(H, dim1=-2, dim2=-1))
    delta = -fg._scaled_cho_solve(fg._scaled_cho_factor(Hd), b)
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


def _frozen_optimize(state, config):
    poses, log_scale = state.poses, state.log_scale
    prev_delta = torch.tensor(float("inf"))
    lam = torch.tensor(0.0)
    sweeps = 0
    for _ in range(config.gn_iters):
        poses, log_scale, prev_delta, lam = _frozen_gn_step(
            state, poses, log_scale, prev_delta, lam, config)
        sweeps += 1
        if not bool(prev_delta > config.convergence_tol):
            break
    return state._replace(poses=poses, log_scale=log_scale), sweeps


def _frozen_marginal(state, keys, config):
    from sonar_slam_torch.graph import factor_graph as fg

    K = config.max_poses
    H, _ = _frozen_normal_equations(state, config, need_b=False)
    Lf = fg._scaled_cho_factor(H)
    if isinstance(keys, int):
        k = torch.full((1,), keys, dtype=torch.int64)
    else:
        k = keys.reshape(-1).to(dtype=torch.int64)
    n = 3 * K + (2 if config.estimate_scale else 0)
    M = k.shape[0]
    rows = (3 * k[:, None] + torch.arange(3)).reshape(-1)
    e = torch.zeros((n, 3 * M), dtype=torch.float32)
    e[rows, torch.arange(3 * M)] = 1.0
    cols = fg._scaled_cho_solve(Lf, e)
    cov = cols[..., rows, :].reshape(cols.shape[:-2] + (M, 3, M, 3))
    cov = cov.diagonal(dim1=-4, dim2=-2).movedim(-1, -3)
    return cov if isinstance(keys, torch.Tensor) and keys.ndim == 1 else cov[..., 0, :, :]


@pytest.mark.parametrize("estimate_scale,nan_factor",
                         [(False, False), (True, False), (True, True)])
def test_update_keeps_its_bits(problem, estimate_scale, nan_factor):
    """The update as it runs now (no host value copied in, so that a card
    can capture it) against the frozen update before: the same bits for
    the poses, the scales and the marginal, and the same number of sweeps
    (the early-exit reads)."""
    from torch.profiler import ProfilerActivity, profile

    from sonar_slam_torch.utils import CodeTimer, reset_timing, trace_records

    steps, loops = problem
    cfg = tgr.GraphConfig(max_poses=12, max_factors=16, gn_iters=6,
                          convergence_tol=1e-7, estimate_scale=estimate_scale,
                          scale_prior_sigma=(0.05, 0.01))
    g = _build(tgr, cfg, steps, loops, nan_factor=nan_factor)
    want, sweeps = _frozen_optimize(g, cfg)
    want_cov = _frozen_marginal(want, 9, cfg)
    reset_timing()
    with profile(activities=[ProfilerActivity.CPU]):
        with CodeTimer("update", silent=True):
            got, cov = tgr.optimize_with_marginal(g, 9, cfg)
    rec = next(r for r in trace_records() if r.name == "update")
    reset_timing()
    assert torch.isfinite(got.poses).all()
    for a, b in ((got.poses, want.poses), (got.log_scale, want.log_scale),
                 (cov, want_cov)):  # bits, NaN included (the NaN factor's)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert rec.reads == sweeps and rec.eager == sweeps + 1


def test_marginal_of_several_keys_keeps_its_bits(problem):
    steps, loops = problem
    cfg = tgr.GraphConfig(max_poses=12, max_factors=16, gn_iters=4,
                          estimate_scale=True, scale_prior_sigma=(0.05, 0.01))
    g = tgr.optimize(_build(tgr, cfg, steps, loops), cfg)
    keys = torch.tensor([0, 4, 9, 4])
    got = tgr.marginal_covariance(g, keys, cfg)
    assert got.shape == (4, 3, 3)
    assert torch.equal(got, _frozen_marginal(g, keys, cfg))


class _StandInGraph:
    """A CUDA graph stood in for on the CPU: its capture runs nothing (the
    buffers it wrote are put back) and its replay runs the captured body."""

    def __init__(self):
        self.body = self.saved = None

    def capture_begin(self, pool=None, capture_error_mode=None):
        rep = _StandInGraph.owner
        held = (list(rep.bufs) + [rep.prev_delta, rep.lam]
                + list(rep.keys.values()) + list(rep.covs.values()))
        self.saved = [(t, t.clone()) for t in held]

    def capture_end(self):
        for t, c in self.saved:
            t.copy_(c)

    def replay(self):
        self.body()


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_replayed_path_bookkeeping(problem, monkeypatch, estimate_scale):
    """The path a card takes (``_Replayed``), run on the CPU with a stand-in
    for the CUDA graphs: the first update of a configuration runs its sweep
    and marginal op by op and captures them, later updates replay them; the
    results are cloned out of the static buffers and equal the op-by-op
    update's bits, sweep counts and all, over graphs of growing size and a
    marginal of several keys."""
    import contextlib

    from sonar_slam_torch.graph import factor_graph as fg

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_stream(self, other):
            pass

    run = fg._Replayed._run

    def tracked(rep, name, body):
        _StandInGraph.owner = rep
        new = name not in rep.graphs
        run(rep, name, body)
        if new:
            rep.graphs[name].body = body

    steps, loops = problem
    cfg = tgr.GraphConfig(max_poses=12, max_factors=16, gn_iters=5,
                          convergence_tol=1e-7, estimate_scale=estimate_scale,
                          scale_prior_sigma=(0.05, 0.01))
    graphs = [_build(tgr, cfg, steps[:n], loops if n == 9 else [])
              for n in (4, 7, 9)]
    keys = torch.tensor([0, 3, 4])
    want = []
    for g in graphs:
        st, cov = tgr.optimize_with_marginal(g, 4, cfg)
        want.append((st, cov, tgr.marginal_covariance(g, keys, cfg)))
    # a configuration that differs only in its sweep count and tolerance
    short = cfg._replace(gn_iters=2, convergence_tol=1e-3)
    want_short = tgr.optimize_with_marginal(graphs[-1], 4, short)
    monkeypatch.setattr(fg, "_REPLAYED", {})
    monkeypatch.setattr(fg._Replayed, "_run", tracked)
    monkeypatch.setattr(fg, "_replayable", lambda state: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None,
                        raising=False)
    for n, (g, (ws, wcov, wmany)) in enumerate(zip(graphs + graphs, want + want)):
        st, cov = tgr.optimize_with_marginal(g, 4, cfg)
        many = tgr.marginal_covariance(g, keys, cfg)
        for a, b in ((st.poses, ws.poses), (st.log_scale, ws.log_scale),
                     (cov, wcov), (many, wmany)):
            assert torch.equal(a, b), n
        rep = fg._replayed(g, cfg)
        assert set(rep.graphs) == {"sweep", 1, 3}
        assert st.poses is not rep.bufs.poses and cov.shape == (3, 3)
        assert st.f_i is g.f_i  # the state's other fields are the caller's
    # it shares the graphs, and runs its own sweep count and tolerance
    st, cov = tgr.optimize_with_marginal(graphs[-1], 4, short)
    assert fg._replayed(graphs[-1], short) is rep
    assert torch.equal(st.poses, want_short[0].poses)
    assert torch.equal(cov, want_short[1])
    assert not torch.equal(st.poses, want[-1][0].poses)

