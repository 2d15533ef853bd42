"""The device axis on a card: two ranks, bit for bit with one process.

Marked ``cuda``: they skip without a card (``python -m pytest --noconftest
-m cuda tests/test_torch_mesh_cuda.py`` on one; both ranks share the card
where there is one, each takes its own where there are two).

* ``sweep_scan`` over 8 lanes at tests/test_parallel.py's dimensions and
  stream, each rank scanning 4: every lane and every leaf bit for bit with
  the one-process sweep (on a card a lane equals its lone scan whatever
  the batch, ``tests/test_torch_sweep_lanes_cuda.py``).
* ``exchange_keyframes`` of each rank's robots: the whole 4-robot table,
  exactly.
"""

import pytest
import torch

from sonar_slam_torch.parallel import (exchange_keyframes, make_config_mesh,
                                       stack_params, sweep_scan)
from sonar_slam_torch.parallel.mesh import shard, spawn
from sonar_slam_torch.parallel.sweep import vary
from sonar_slam_torch.slam import SlamParams
from test_torch_mesh import DIMS, stream, summary_case, to

RANKS = 2


def lanes(device):
    """tests/test_parallel.py's small params over 8 point-noise lanes."""
    p = SlamParams.default(DIMS, device)._replace(
        keyframe_translation=1.0, ssm_min_points=5, nssm_min_points=5)
    return stack_params(vary(p, point_noise=[0.3, 0.4, 0.5, 0.6] * 2))


def card_ranks(mesh):
    dev = mesh.device
    out = {"sweep": sweep_scan(to(stream(), dev), lanes(dev), DIMS, mesh)}
    robot = make_config_mesh(axis="robot")
    out["exchange"] = exchange_keyframes(
        shard(to(summary_case(), dev), robot), robot)
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return spawn(card_ranks, RANKS, timeout_s=900.0)


def _bit_equal(a, b):
    if isinstance(a, tuple):
        return all(_bit_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_sweep_lanes_bit_for_bit_over_two_ranks(ranks):
    dev = torch.device("cuda", 0)
    one = sweep_scan(to(stream(), dev), lanes(dev), DIMS)
    assert _bit_equal(ranks["sweep"], one)


@pytest.mark.cuda
def test_exchange_keyframes_exact_over_two_ranks(ranks):
    assert _bit_equal(ranks["exchange"], summary_case())
