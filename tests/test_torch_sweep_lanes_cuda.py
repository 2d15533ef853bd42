"""The lane-batched sweep on a card: each lane its lone scan, bit for bit.

Marked ``cuda``: they skip without a card (``python -m pytest
--noconftest tests/test_torch_sweep_lanes_cuda.py`` on one).

* ``lone_sums.lone_sum`` over B lanes of G rows equals ``torch.sum`` over
  each lane's G rows alone, bit for bit, at the row and point-cloud
  shapes the sweep's ICP sums (the order is ATen's, so a torch upgrade
  that changes it fails here first), including the shapes outside its
  modeled order (a vectorized row with a tail, a row split across thread
  blocks), which take each lane's own ``torch.sum``. On the CPU
  ``lone_sum`` is ``torch.sum``; the order it takes on the card is checked
  for what it adds (every term once, within float32 rounding of a float64
  sum), and the shapes that leave the model are named.
* ``parallel.sweep_scan`` on ``cli.sweep``'s survey (30 s) at lanes that
  differ in every flag: each lane equals ``sweep_scan_loop``'s (its lone
  ``slam_scan``) bit for bit, alone or among others at any index, and
  identical lanes are equal (``tests/test_torch_sweep_lanes.py`` holds the
  same on the CPU within rounding); the same lanes with bench.py's
  production point-to-line ICP, and at ``max_points`` 130 (every
  keyframe row sum outside the model), bit for bit with
  ``sweep_scan_loop``.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch import lone_sums
from sonar_slam_torch.lone_sums import lone_sum

# (rows of a lone call, terms a row): the sweep's ICP (1 x 128 for a scan
# match, 12 x 512 for a loop search's starts), the tests' small clouds,
# shapes either side of the vectorized and split thresholds, and shapes
# outside the modeled order: rows of 130 and 131 terms (a vectorized row
# with a tail, SlamDims.max_points 130) and clouds of 30 x 4096 and 64 x
# 2048 (split across thread blocks; target_capacity 4096 with 30 starts)
SHAPES = [(1, 128), (12, 512), (1, 32), (8, 32), (4, 64), (1, 64),
          (1, 512), (12, 128), (3, 127), (16, 512), (1, 2048), (2, 4096),
          (1, 130), (1, 131), (30, 4096), (64, 2048)]
# (shape, as a point cloud) that take each lane's own torch.sum
UNMODELED = {((1, 130), False), ((1, 131), False), ((30, 4096), True),
             ((64, 2048), True)}
LANES = 64


def _terms(shape, seed):
    """ICP-like summands: weighted products, a fifth of them masked to
    zero (some negative zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 10.0
    w = (rng.random(shape) > 0.2).astype(np.float32)
    return torch.as_tensor(x * w)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the order modeled is the card's)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("points", [False, True])
def test_lone_sum_is_each_lanes_lone_torch_sum(card, rows, n, points):
    shape = (LANES * rows, n, 2) if points else (LANES * rows, n)
    dim = -2 if points else -1
    x = _terms(shape, rows * 1000 + n).to(card)
    got = lone_sum(x, dim, rows)
    want = torch.cat([torch.sum(x[b * rows:(b + 1) * rows].clone(), dim=dim)
                      for b in range(LANES)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,n", SHAPES)
@pytest.mark.parametrize("points", [False, True])
def test_modeled_order_adds_every_term_once(rows, n, points):
    x = _terms((5 * rows, n, 2) if points else (5 * rows, n), rows + n)
    dim = -2 if points else -1
    got = lone_sums._card_sum(x, dim, rows)
    want = torch.sum(x.double(), dim=dim)
    assert got.shape == want.shape
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-3)


def test_shapes_outside_the_model_take_each_lanes_sum():
    """The decision is the shape's: exactly the unmodeled shapes leave the
    model (at any number of lanes), as does any other rank or dim."""
    for rows, n in SHAPES:
        for points in (False, True):
            for lanes in (1, LANES):
                shape = (lanes * rows, n, 2) if points else (lanes * rows, n)
                want = ((rows, n), points) not in UNMODELED
                got = lone_sums.modeled(shape, -2 if points else -1, rows)
                assert got == want, (rows, n, points)
    assert not lone_sums.modeled((64, 32, 2), -1, 1)
    assert not lone_sums.modeled((64, 3, 32, 2), -2, 1)


def test_lone_sum_on_the_cpu_is_torch_sum():
    x = _terms((24, 512), 3)
    assert torch.equal(lone_sum(x, -1, 12), torch.sum(x, dim=-1))
    p = _terms((24, 128, 2), 4)
    assert torch.equal(lone_sum(p, -2, 12), torch.sum(p, dim=-2))


def _flag_lanes(base):
    """Eight lanes of ``cli.sweep``'s grid that also differ in every flag
    and integer field."""
    from sonar_slam_torch.cli.sweep import lane_grid

    _, grid = lane_grid(base, 8)
    over = [dict(), dict(min_pcm=99), dict(nssm_every=2, conf_power=2.0),
            dict(use_best_start_tf=True, use_censi_cov=True),
            dict(fuse_odometry=True, robust_ssm=True), dict(min_pcm=1,
            pcm_queue_size=1), dict(conf_power=0.25), dict(pcm_queue_size=2)]
    return [g._replace(**o) for g, o in zip(grid, over)]


def _card_sweep(**dims_over):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the roundings held are the card's)")
    from sonar_slam_torch.cli.sweep import small_dims_params, sweep_inputs

    dev = torch.device("cuda", 0)
    _, dims, _, _, frames, _ = sweep_inputs(dev, 1, duration=30.0,
                                            **dims_over)
    lanes = _flag_lanes(small_dims_params(dev)[1])
    return dev, dims, frames, lanes


@pytest.fixture(scope="module")
def card_sweep():
    return _card_sweep()


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    return x.dtype == y.dtype and torch.equal(x, y)


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else
                        None if x is None else x[i] for x in tree))


@pytest.mark.cuda
def test_sweep_lanes_are_their_lone_scans_on_the_card(card_sweep):
    from sonar_slam_torch.parallel import stack_params, sweep_scan

    dev, dims, frames, lanes = card_sweep
    _batched_is_the_loop(dims, frames, lanes)
    alone = sweep_scan(frames, stack_params([lanes[4]]), dims)
    last = sweep_scan(frames, stack_params(lanes[:3] + [lanes[4]]), dims)
    assert _equal(_lane(last[0], 3), _lane(alone[0], 0))
    same = sweep_scan(frames, stack_params([lanes[0]] * 3), dims)
    for i in (1, 2):
        assert _equal(_lane(same[0], i), _lane(same[0], 0))


def _batched_is_the_loop(dims, frames, lanes):
    from sonar_slam_torch.parallel import stack_params, sweep_scan
    from sonar_slam_torch.parallel.sweep import sweep_scan_loop

    stacked = stack_params(lanes)
    batched, loop = sweep_scan(frames, stacked, dims), sweep_scan_loop(
        frames, stacked, dims)
    for i in range(len(lanes)):
        for tree in (0, 1):
            assert _equal(_lane(batched[tree], i), _lane(loop[tree], i)), i


@pytest.mark.cuda
def test_point_to_line_sweep_lanes_are_their_lone_scans_on_the_card(
        card_sweep):
    """bench.py's production ICP: the point-to-line update of each lane is
    its own call (``cloud.icp._p2l_solve``)."""
    import dataclasses

    from sonar_slam_torch.cli.error_budget import icp_prod

    _, dims, frames, lanes = card_sweep
    _batched_is_the_loop(dataclasses.replace(dims, icp=icp_prod()), frames,
                         lanes)


@pytest.mark.cuda
def test_unmodeled_shape_sweep_lanes_are_their_lone_scans_on_the_card():
    """``max_points`` 130: each keyframe's ICP row sums have a vectorized
    tail, outside ``lone_sum``'s model."""
    _, dims, frames, lanes = _card_sweep(max_points=130)
    assert not lone_sums.modeled((8, 130), -1, 1)
    _batched_is_the_loop(dims, frames, lanes)
