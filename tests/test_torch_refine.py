"""Loop refinement, function by function: the port against the JAX package.

Both packages start from the same carry: tests/test_refine.py's synthetic
corridor survey (exact poses, clouds sampled from corrugated walls, one
revisit), built by the JAX package and converted with
``convert.carry_from_reference``, with a DVL basis and in-scan SSM slots
added so every branch runs. Tolerances: 1e-4 m / rad on poses and
measurements (float32 ICP and Gauss-Newton with sums in other orders),
covariances relative 1e-3; the decisions (which loops, which slots) equal.
Every measurement that comes out of trimmed ICP gets 2e-3 m, and what is
solved from them (poses, the DVL log-scale) 2e-3 m and 1e-3: this survey's
trimmed ICP amplifies rounding. Measured here, a seed 5.3e-7 m away moves
the pair refinement's result by 1.3e-3 m at the same inlier count (its
trimmed set changes), and the JAX package's vmapped lanes round their
batched products differently from its unbatched calls, which moved one
chain registration by 7.9e-4 m. The decisions (which lanes pass, which
loops and factor slots) stay equal.

The lane axis is held to the per-lane calls exactly: ``icp_pairs`` against
``icp`` on each pair, ``_aggregate_windows`` against ``_aggregate_window``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.slam.refine as jref
from sonar_slam_tpu.slam import RefineParams as JRP
from test_refine import K, _build_carry, _dims, _params

import sonar_slam_torch.slam.core as tcore
import sonar_slam_torch.slam.refine as tref
from sonar_slam_torch.cloud import ICPConfig, icp, icp_pairs
from sonar_slam_torch.convert import (
    carry_from_reference,
    dims_from_reference,
    params_from_reference,
    refine_params_from_reference,
)

torch.set_num_threads(1)
ATOL = 1e-4
ICP_ATOL = 2e-3
SCALE_ATOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_basis(carry, ssm=True):
    """A DVL basis that reproduces the DR positions under a per-axis scale,
    and in-scan SSM slots on keyframes 3..6 (their odometry factors)."""
    dr = np.asarray(carry.dr_poses)
    basis = np.stack([dr[:, :2] * 0.6, dr[:, :2] * 0.4], axis=1)
    basis = basis + np.random.default_rng(3).normal(scale=0.01, size=basis.shape)
    ssm_slot = np.full(K, -1, np.int32)
    if ssm:
        ssm_slot[3:7] = np.arange(2, 6)
    return carry._replace(dr_basis=jnp.asarray(basis, jnp.float32),
                          ssm_slot=jnp.asarray(ssm_slot))


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _case(bias=(0.2, -0.15, 0.02), with_loop=True, **dkw):
    jdims = _dims(**dkw)
    carry, truth = _build_carry(jdims, loop_bias=bias, with_loop=with_loop)
    carry = _with_basis(carry)
    jparams = _params(jdims)
    jrp = JRP.default()
    return dict(
        jdims=jdims, jcarry=carry, jparams=jparams, jrp=jrp, truth=truth,
        dims=dims_from_reference(jdims),
        carry=carry_from_reference(_np(carry), "cpu"),
        params=params_from_reference(_np(jparams), "cpu"),
        rp=refine_params_from_reference(_np(jrp), "cpu"))


def _assert_graph(t, j, atol=ATOL, scale_atol=1e-5):
    assert int(t.num_factors) == int(j.num_factors)
    np.testing.assert_array_equal(t.f_i.numpy(), np.asarray(j.f_i))
    np.testing.assert_array_equal(t.f_j.numpy(), np.asarray(j.f_j))
    np.testing.assert_array_equal(t.f_robust.numpy(), np.asarray(j.f_robust))
    np.testing.assert_array_equal(t.f_scaled.numpy(), np.asarray(j.f_scaled))
    np.testing.assert_allclose(t.f_z.numpy(), np.asarray(j.f_z), atol=atol)
    np.testing.assert_allclose(t.f_sqrt_info.numpy(), np.asarray(j.f_sqrt_info),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(t.log_scale.numpy(), np.asarray(j.log_scale),
                               atol=scale_atol)


def _assert_carry(t, j, atol=ATOL, scale_atol=1e-5):
    assert t.num_loops == int(j.num_loops)
    nl = t.num_loops
    np.testing.assert_array_equal(t.loops_i[:nl].numpy(), np.asarray(j.loops_i)[:nl])
    np.testing.assert_array_equal(t.loops_j[:nl].numpy(), np.asarray(j.loops_j)[:nl])
    np.testing.assert_array_equal(t.loops_slot[:nl].numpy(),
                                  np.asarray(j.loops_slot)[:nl])
    np.testing.assert_allclose(t.loops_tf.numpy(), np.asarray(j.loops_tf), atol=atol)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), atol=atol)
    _assert_graph(t.graph, j.graph, atol, scale_atol)


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def case_dr():
    """Windows aggregated on DR relatives with the basis correction."""
    return _case(aggregate_with_dr=True, aggregate_with_dr_basis=True,
                 estimate_dvl_scale=True)


@pytest.mark.parametrize("fixture", ["case", "case_dr"])
def test_register_pair(request, fixture):
    c = request.getfixturevalue(fixture)
    pairs = [(2, K - 1), (1, 9), (0, 5), (4, 12)]
    i = torch.tensor([p[0] for p in pairs])
    j = torch.tensor([p[1] for p in pairs])
    ok, z, cov = tref._register_pair(c["carry"], i, j, c["params"], c["rp"],
                                     c["dims"])
    jok, jz, jcov = jax.jit(jax.vmap(lambda a, b: jref._register_pair(
        c["jcarry"], a, b, c["jparams"], c["jrp"], c["jdims"])))(
            jnp.asarray(i.numpy()), jnp.asarray(j.numpy()))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ICP_ATOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=2e-2,
                               atol=1e-8)
    assert ok.any()


def test_remeasure(case):
    c = case
    t = tref._remeasure(c["carry"], c["params"], c["rp"], c["dims"])
    j = _jit(jref._remeasure, 3)(c["jcarry"], c["jparams"], c["jrp"], c["jdims"])
    _assert_carry(t, j, ICP_ATOL)
    assert not np.allclose(t.loops_tf.numpy(), c["carry"].loops_tf.numpy())


def test_loops_between_and_remeasure_moved(case):
    c = case
    np.testing.assert_allclose(tref._loops_between(c["carry"]).numpy(),
                               np.asarray(jref._loops_between(c["jcarry"])),
                               atol=1e-6)
    reg = np.asarray(jref._loops_between(c["jcarry"])).copy()
    reg[0] += np.float32([0.1, -0.05, 0.01])  # the loop's endpoints moved
    t, treg = tref._remeasure_moved(c["carry"], torch.as_tensor(reg),
                                    c["params"], c["rp"], c["dims"])
    j, jreg = _jit(jref._remeasure_moved, 4)(
        c["jcarry"], jnp.asarray(reg), c["jparams"], c["jrp"], c["jdims"])
    _assert_carry(t, j, ICP_ATOL)
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), atol=1e-6)
    assert not np.allclose(treg.numpy(), reg)
    # nothing moved: nothing re-registers
    still = tref._loops_between(c["carry"])
    t2, reg2 = tref._remeasure_moved(c["carry"], still, c["params"], c["rp"],
                                     c["dims"])
    assert torch.equal(reg2, still) and torch.equal(t2.loops_tf, c["carry"].loops_tf)


def test_covisibility(case):
    t = tref._covisibility(case["carry"], case["dims"]).numpy()
    j = np.asarray(_jit(jref._covisibility, 1)(case["jcarry"], case["jdims"]))
    np.testing.assert_array_equal(t, j)
    assert (t > 12).sum() > K


@pytest.mark.parametrize("fixture", ["case", "case_dr"])
def test_densify_chain(request, fixture):
    c = request.getfixturevalue(fixture)
    t, tok, tz = tref._densify_chain(c["carry"], c["params"], c["rp"], c["dims"])
    j, jok, jz = _jit(jref._densify_chain, 3)(c["jcarry"], c["jparams"],
                                              c["jrp"], c["jdims"])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tz.numpy()[np.asarray(jok)],
                               np.asarray(jz)[np.asarray(jok)], atol=ICP_ATOL)
    _assert_graph(t.graph, j.graph, ICP_ATOL)
    # SSM slots replaced in place, the others appended
    assert tok[3:7].all() and int(t.graph.num_factors) > int(c["carry"].graph.num_factors)


def test_solve_scale_from_basis():
    rng = np.random.default_rng(5)
    n = 24
    ok = rng.uniform(size=n) < 0.8
    z = rng.normal(scale=[2.0, 0.4, 0.1], size=(n, 3)).astype(np.float32)
    basis = np.cumsum(rng.normal(scale=1.0, size=(n, 2, 2)), axis=0).astype(np.float32)
    head = rng.uniform(-3, 3, size=n).astype(np.float32)
    prior = np.float32([0.05, 0.01])
    ja, je = jref.solve_scale_from_basis(jnp.asarray(ok), jnp.asarray(z),
                                         jnp.asarray(basis), jnp.asarray(head),
                                         jnp.asarray(prior))
    ta, te = tref.solve_scale_from_basis(torch.as_tensor(ok), torch.as_tensor(z),
                                         torch.as_tensor(basis),
                                         torch.as_tensor(head),
                                         torch.as_tensor(prior))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    assert bool(te) == bool(je)


@pytest.mark.parametrize("values", [
    [0.3, -0.1, 0.7, 0.2],  # even count: the two middle values interpolated
    [0.3, -0.1, 0.7, 0.2, 0.05],
    [1.5],
    [],
])
def test_nanmedian(values):
    x = np.full(9, np.nan, np.float32)
    x[: len(values)] = values
    j = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    t = tref._nanmedian(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(t, j)
    if len(values) % 2 == 0 and values:
        assert t != torch.nanmedian(torch.as_tensor(x)).item()


@pytest.mark.parametrize("basis", [False, True])
def test_anchor_scale_from_chain(case_dr, basis):
    c = case_dr
    t, tok, tz = tref._densify_chain(c["carry"], c["params"], c["rp"], c["dims"])
    j, jok, jz = _jit(jref._densify_chain, 3)(c["jcarry"], c["jparams"],
                                              c["jrp"], c["jdims"])
    # the ratio path needs displacement on both axes: an even number (here
    # 10) of usable x samples exercises the interpolated median
    rp = c["rp"]._replace(scale_min_axis_disp=0.05)
    jrp = c["jrp"]._replace(scale_min_axis_disp=jnp.float32(0.05))
    sb = c["carry"].dr_basis if basis else None
    jsb = c["jcarry"].dr_basis if basis else None
    ta = tref._anchor_scale_from_chain(t, tok, tz, rp, c["dims"], sb)
    ja = _jit(jref._anchor_scale_from_chain, 4)(j, jok, jz, jrp, c["jdims"], jsb)
    np.testing.assert_allclose(ta.graph.log_scale_anchor.numpy(),
                               np.asarray(ja.graph.log_scale_anchor),
                               atol=SCALE_ATOL)
    np.testing.assert_allclose(ta.graph.log_scale.numpy(),
                               np.asarray(ja.graph.log_scale), atol=SCALE_ATOL)
    assert np.abs(ta.graph.log_scale_anchor.numpy()).max() > 0


@pytest.mark.parametrize("kw", [dict(), dict(refine_sweep_topk=2),
                                dict(refine_sweep_topk=2, refine_sweep_budget=3),
                                dict(max_loops=2)])
def test_sweep(kw):
    c = _case(with_loop=False, refine_sweep=True, **kw)
    t = tref._sweep(c["carry"], c["params"], c["rp"], c["dims"])
    j = _jit(jref._sweep, 3)(c["jcarry"], c["jparams"], c["jrp"], c["jdims"])
    _assert_carry(t, j)
    assert t.num_loops >= 1


def test_prune_loops(case):
    c = case
    # a second logged loop that disagrees with the graph by 0.5 m
    jc = c["jcarry"]
    bad = np.asarray(jc.loops_tf[0]) + np.float32([0.5, 0.0, 0.0])
    jc = jc._replace(loops_i=jc.loops_i.at[1].set(3),
                     loops_j=jc.loops_j.at[1].set(12),
                     loops_tf=jc.loops_tf.at[1].set(jnp.asarray(bad)),
                     loops_slot=jc.loops_slot.at[1].set(7),
                     num_loops=jnp.asarray(2, jnp.int32))
    jc = jc._replace(loops_i=jc.loops_i.at[0].set(2))
    tc = carry_from_reference(_np(jc), "cpu")
    t = tref._prune_loops(tc, c["rp"], c["dims"])
    j = _jit(jref._prune_loops, 2)(jc, c["jrp"], c["jdims"])
    _assert_carry(t, j)
    assert t.num_loops < 2


def test_refine_disabled_is_identity(case):
    c = case
    dims = dataclasses.replace(c["dims"], refine_iters=0)
    assert tref.refine_loops(c["carry"], c["params"], c["rp"], dims) is c["carry"]


@pytest.mark.parametrize("p2l", [True, False])
def test_icp_pairs_equals_per_lane_calls(case, p2l):
    carry = case["carry"]
    cfg = ICPConfig(max_iterations=15, point_to_line=p2l, outlier_max_dist=1.0)
    pairs = [(2, K - 1), (0, 1), (5, 6), (3, 9), (7, 8)]
    i = torch.tensor([a for a, _ in pairs])
    j = torch.tensor([b for _, b in pairs])
    guess = tcore.se2_between(carry.poses[i], carry.poses[j])
    guess = guess + torch.tensor([0.2, -0.1, 0.03])
    w = torch.linspace(0.5, 1.0, carry.points.shape[1])
    res = icp_pairs(carry.points[j], carry.pmasks[j], carry.points[i],
                    carry.pmasks[i], guess, cfg, w.expand(len(pairs), -1),
                    w.flip(0).expand(len(pairs), -1))
    for lane, (a, b) in enumerate(pairs):
        one = icp(carry.points[b], carry.pmasks[b], carry.points[a],
                  carry.pmasks[a], guess[lane], cfg, w, w.flip(0))
        for name, got, want in zip(one._fields, res, one):
            assert torch.equal(got[lane], want), (lane, name)
    assert len(set(res.iterations.tolist())) > 1  # lanes stop at their own time


@pytest.mark.parametrize("dr", [False, True])
def test_aggregate_windows_equals_per_window_calls(case_dr, dr):
    carry = case_dr["carry"]
    carry = carry._replace(graph=carry.graph._replace(
        log_scale=torch.tensor([0.02, -0.01])))
    dims = case_dr["dims"]
    refs = torch.tensor([0, 4, K - 1, 9])
    out = tcore._aggregate_windows(carry, carry.poses[refs], refs - 2, 5,
                                   dims.agg_spec(), 256, refs, dr, dr)
    for lane, r in enumerate(refs.tolist()):
        one = tcore._aggregate_window(carry, carry.poses[r], r - 2, 5,
                                      dims.agg_spec(), 256, r, dr, dr)
        for got, want in zip(out, one):
            assert torch.equal(got[lane], want), lane
    assert out[1].sum() > 100
