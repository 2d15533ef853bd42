"""The robot axis on a card: each robot lane its lone scan, bit for bit.

Marked ``cuda``: they skip without a card (``python -m pytest
--noconftest tests/test_torch_multi_robot_cuda.py`` on one).

* ``parallel.multi_robot_scan`` of three robots on the two-robot demo's
  basin (``cli.two_robot_demo.robot_inputs``, a 60 s survey), robot 2's
  third keyframe slot cleared so that its valid slots are not a prefix:
  every robot lane, carry and outputs, equals ``multi_robot_scan_loop``'s
  (its lone ``slam_scan``) bit for bit, at the demo's small dims, with
  bench.py's production point-to-line ICP, and at ``max_points`` 130
  (every keyframe row sum outside ``lone_sums.lone_sum``'s model).
* ``propose_interrobot_loops`` on the demo's 8 x 8 candidates of robots 0
  and 1 equals ``propose_interrobot_loops_loop`` bit for bit.
* ``cli.lane_bits --robots 2`` at the demo's 90 s: no keyframe step and no
  lane-batched call parts from its lone counterpart.

The CPU forms of these are ``tests/test_torch_multi_robot_lanes.py``.
"""

import dataclasses

import pytest
import torch

DURATION = 60.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the roundings held are the card's)")
    return torch.device("cuda", 0)


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


def _robots(dev, **dims_over):
    """Three robots' stacked streams, robot 2's slot 2 cleared: (bags,
    dims, params, built, frames)."""
    from sonar_slam_torch.cli.two_robot_demo import robot_inputs

    bags, dims, params, built, frames = robot_inputs(dev, DURATION, 3,
                                                     **dims_over)
    valid = frames.valid.clone()
    valid[2, 2] = False
    frames = frames._replace(valid=valid,
                             pmask=frames.pmask & valid[..., None])
    return bags, dims, params, built, frames


def _batched_is_the_loop(dims, params, frames):
    from sonar_slam_torch.parallel.multi_robot import (multi_robot_scan,
                                                       multi_robot_scan_loop)

    batched = multi_robot_scan(frames, params, dims)
    loop = multi_robot_scan_loop(frames, params, dims)
    counts = frames.valid.sum(1)
    assert torch.equal(batched[0].num_kf.cpu(), counts.cpu())
    for r in range(3):
        for tree in (0, 1):
            assert _equal(_lane(batched[tree], r), _lane(loop[tree], r)), r
    return batched


@pytest.fixture(scope="module")
def robots(card):
    return _robots(card)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["small", "production_icp"])
def test_robot_lanes_are_their_lone_scans_on_the_card(card, robots, variant):
    _, dims, params, _, frames = robots
    if variant == "production_icp":
        from sonar_slam_torch.cli.error_budget import icp_prod

        dims = dataclasses.replace(dims, icp=icp_prod())
    carry, _ = _batched_is_the_loop(dims, params, frames)
    assert len(set(carry.num_kf.tolist())) > 1


@pytest.mark.cuda
def test_unmodeled_shape_robot_lanes_are_their_lone_scans_on_the_card(card):
    """``max_points`` 130: each keyframe's ICP row sums have a vectorized
    tail, outside ``lone_sum``'s model."""
    from sonar_slam_torch import lone_sums

    _, dims, params, _, frames = _robots(card, max_points=130)
    assert not lone_sums.modeled((8, 130), -1, 1)
    _batched_is_the_loop(dims, params, frames)


@pytest.mark.cuda
def test_batched_proposals_are_the_loop_on_the_card(card, robots):
    from sonar_slam_torch.cli.two_robot_demo import (candidates, dr_start_pose,
                                                     proposal_search)
    from sonar_slam_torch.parallel.multi_robot import (
        multi_robot_scan, propose_interrobot_loops,
        propose_interrobot_loops_loop)

    bags, dims, params, _, frames = robots
    carries, _ = multi_robot_scan(frames, params, dims)
    cand = [candidates(carries, r, dr_start_pose(bags[r], card), card)
            for r in range(2)]
    search = proposal_search(card)
    batched = propose_interrobot_loops(cand[0], cand[1], **search)
    loop = propose_interrobot_loops_loop(cand[0], cand[1], **search)
    assert batched[0].shape == (8, 8, 3)
    assert _equal(tuple(batched), tuple(loop))


@pytest.mark.cuda
def test_lane_bits_robots_nothing_parts_on_the_card(card):
    from sonar_slam_torch.cli import lane_bits

    out = lane_bits.main(["--robots", "2", "--check", "0,1"])
    assert out["steps_parted"] == {}
    calls = out["calls"]
    assert calls["icp_multistart_lanes"]["calls"] > 0
    for row in calls.values():
        assert row["first_step"] is None and row["0"][0] == row["1"][0] == 0
