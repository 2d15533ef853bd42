"""``refine_loops`` as a whole, the port against the JAX package, on the
synthetic corridor survey of tests/test_torch_refine.py (see there for the
inputs and the tolerances): the loop log, the factor table and the refined
poses, for the sweep alone, for every pass of bench.py's full configuration,
and with the DVL-scale anchor on the DR-basis windows.
"""

import numpy as np
import pytest
import torch

import sonar_slam_tpu.slam.refine as jref
from test_torch_refine import ICP_ATOL, SCALE_ATOL, _assert_carry, _case

import sonar_slam_torch.slam.refine as tref

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(refine_sweep=True),
    dict(refine_sweep=True, refine_chain=True, refine_incremental=True,
         refine_final_sweep=True),
    dict(refine_sweep=True, refine_chain=True, refine_scale_from_chain=True,
         estimate_dvl_scale=True, aggregate_with_dr=True,
         aggregate_with_dr_basis=True),
])
def test_refine_loops(kw):
    c = _case(**kw)
    basis = c["carry"].dr_basis if c["dims"].aggregate_with_dr_basis else None
    jbasis = c["jcarry"].dr_basis if basis is not None else None
    t = tref.refine_loops(c["carry"], c["params"], c["rp"], c["dims"], basis)
    j = jref.refine_loops(c["jcarry"], c["jparams"], c["jrp"], c["jdims"], None,
                          jbasis)
    _assert_carry(t, j, ICP_ATOL, SCALE_ATOL)
    err = np.abs(t.poses.numpy()[:, :2] - c["truth"][:, :2]).max()
    assert err < 0.1
