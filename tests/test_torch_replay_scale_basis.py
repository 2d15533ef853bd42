"""The DVL basis integrals reach loop refinement whenever the JAX package
computes them: with ``refine_scale_basis`` and ``estimate_dvl_scale`` on, and
with the DR-basis window aggregation off.

Both packages replay the small survey (tests/test_torch_replay_refine.py's
configuration) with the chain's DVL-scale anchor on, and the windows
aggregated on plain DR relatives (``aggregate_with_dr``): with the windows
on the current poses the survey's scan is ill-conditioned, and a 1.7e-5 m
difference in dead reckoning moves it by 0.09 m. Its basis solve
(``refine.solve_scale_from_basis``) needs the keyframes' basis integrals;
without them ``_anchor_scale_from_chain`` takes the chain-ratio median
instead and the refined scale comes out elsewhere. The refined
``graph.log_scale`` must match the JAX package's within 1e-5 (float32 ICP
and Gauss-Newton with sums in other orders; measured 4e-7); without the
basis the port's comes out 9e-4 away.
"""

import dataclasses

import numpy as np
import jax
import torch

import sonar_slam_tpu.io.simulate as jsim
import sonar_slam_tpu.pipeline as jpipe
import sonar_slam_torch.io.simulate as tsim
import sonar_slam_torch.pipeline as tpipe
from sonar_slam_torch.convert import (
    dims_from_reference,
    feature_config_from_reference,
    params_from_reference,
)
from test_torch_replay_refine import SIM, golden_config

torch.set_num_threads(1)


def test_scale_basis_without_basis_aggregation():
    jdims, jparams, jfc = golden_config()
    jdims = dataclasses.replace(
        jdims, refine_scale_basis=True, estimate_dvl_scale=True,
        aggregate_with_dr=True, aggregate_with_dr_basis=False,
        refine_scale_from_chain=True)
    jres = jpipe.replay(jsim.simulate_bag(jsim.SimConfig(**SIM)), jfc, jparams,
                        jdims)
    dims = dims_from_reference(jdims)
    tres = tpipe.replay(
        tsim.simulate_bag(tsim.SimConfig(**SIM)),
        feature_config_from_reference(jfc),
        params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        dims, "cpu")
    want = np.asarray(jres.carry.graph.log_scale)
    assert np.abs(want).max() > 1e-3  # the anchor moved the scale
    np.testing.assert_allclose(tres.carry.graph.log_scale.numpy(), want,
                               atol=1e-5)
    assert tres.carry.dr_basis.abs().sum() > 0  # the basis reached the carry
    np.testing.assert_array_equal(tres.keyframe_ping_idx, jres.keyframe_ping_idx)
    assert tres.carry.num_loops == int(jres.carry.num_loops)
    np.testing.assert_allclose(tres.carry.graph.log_scale_anchor.numpy(),
                               np.asarray(jres.carry.graph.log_scale_anchor),
                               atol=1e-5)
    np.testing.assert_allclose(tres.trajectory, jres.trajectory, atol=1e-4)
