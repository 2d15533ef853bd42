"""The factor graph's update on a card: the sweep and the marginal replayed
as captured CUDA graphs against the same update run op by op, bit for bit.

Marked ``cuda``: they skip without a card (``python -m pytest --noconftest
-m cuda tests/test_torch_graph_cuda.py`` on one).

A growing graph of the live step's capacity (K 128, F 516: a prior,
DVL-scaled odometry, full-covariance registrations, Cauchy-robust loops,
and in its last state a NaN factor that fails every factorization and
escalates the damping) is updated in the live configuration (3 sweeps, the
DVL scale estimated) and in both of the refinement's (12 sweeps, tolerance
1e-6, the relaxed and the anchored scale prior). Each update runs through
the captured path and op by op on the same state: the poses, the scales and
the marginals keep their bits, and so does the number of sweeps (the early
exit's reads). The first update of a configuration runs its sweep and its
marginal op by op and captures them, leaving under 1 MiB more allocated
(the static buffers; the capture stream's cuBLAS workspace is let go);
every later one replays them without capturing again.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sonar_slam_torch.graph import factor_graph as fg
from sonar_slam_torch.slam.core import SlamDims
from sonar_slam_torch.utils import CodeTimer, reset_timing, trace_records

LIVE = SlamDims(max_keyframes=128, max_loops=128, gn_iters=3,
                estimate_dvl_scale=True,
                dvl_scale_prior_sigma=0.05).graph_config()
REFINE = LIVE._replace(gn_iters=12, convergence_tol=1e-6,
                       scale_prior_sigma=(0.25, 0.01))
CONFIGS = {"live": LIVE, "refine": REFINE,
           "refine_anchored": REFINE._replace(scale_prior_sigma=(0.005, 0.01))}
SIZES = (6, 14, 25, 37, 48)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def graph_sequence(cfg, dev, seed=0):
    """The states of one growing graph at ``SIZES`` poses, then the last
    with a NaN factor."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    g = fg.graph_init(cfg, dev)
    g = fg.add_prior(g, t([0.0, 0.0, 0.0]),
                     fg.sigmas_to_sqrt_info(t([0.1, 0.1, 0.01])))
    z = np.array([1.5, 0.05, 0.12])
    est = np.zeros(3)
    out = []
    for k in range(1, SIZES[-1] + 1):
        zn = z + rng.normal(scale=[0.04, 0.04, 0.01])
        c, s = math.cos(est[2]), math.sin(est[2])
        est = est + [c * zn[0] * 1.03 - s * zn[1], s * zn[0] + c * zn[1], zn[2]]
        g = fg.add_between(g, k - 1, k, t(zn),
                           fg.sigmas_to_sqrt_info(t([0.05, 0.05, 0.01])),
                           scaled=True)
        cov = np.diag([0.02, 0.03, 0.002])
        cov[0, 1] = cov[1, 0] = 0.006
        g = fg.add_between(g, k - 1, k, t(z + rng.normal(scale=0.02, size=3)),
                           fg.cov_to_sqrt_info(t(cov)))
        if k % 7 == 0:  # a robust loop back to the pose 7 keys before
            zi = rng.normal(scale=0.05, size=3) + [7 * 1.5, 0.0, 7 * 0.12]
            g = fg.add_between(g, k - 7, k, t(zi),
                               fg.sigmas_to_sqrt_info(t([0.2, 0.2, 0.05])),
                               robust=True)
        g = fg.set_pose_estimate(g, k, t(est))
        if k in SIZES:
            out.append((k, g))
    bad = fg.add_between(g, 3, SIZES[-1], t([0.5, 0.0, 0.1]),
                         fg.sigmas_to_sqrt_info(t([0.2, 0.2, 0.05]))
                         * float("nan"))
    out.append((SIZES[-1], bad))
    return out


def counted(fn, *args):
    """(fn's result, host reads, replayed runs, op-by-op runs) of one call
    while the tracer records."""
    reset_timing()
    with profile(activities=[ProfilerActivity.CPU]):
        with CodeTimer("update", silent=True):
            out = fn(*args)
    rec = next(r for r in trace_records() if r.name == "update")
    reset_timing()
    return out, rec.reads, rec.replayed, rec.eager


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def replays_of(cfg, state):
    return fg._replayed(state, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replayed_update_keeps_the_eager_bits(card, name, monkeypatch):
    cfg = CONFIGS[name]
    seq = graph_sequence(cfg, card)
    fg._REPLAYED.clear()
    rep = replays_of(cfg, seq[0][1])
    eager_update = []
    with monkeypatch.context() as m:
        m.setattr(fg, "_replayable", lambda state: False)
        for k, g in seq:
            eager_update.append(counted(fg.optimize_with_marginal, g, k, cfg))
    for n, ((k, g), want) in enumerate(zip(seq, eager_update)):
        held = torch.cuda.memory_allocated(card)
        got = counted(fg.optimize_with_marginal, g, k, cfg)
        if n == 0:  # the captures keep only the static buffers allocated
            assert torch.cuda.memory_allocated(card) - held < 2**20
        (gs, cov), reads, replayed, eager = got
        (ws, wcov), wreads, wreplayed, weager = want
        assert wreplayed == 0 and weager == wreads + 1
        assert reads == wreads, (n, reads, wreads)  # the same sweeps
        assert same_bits(gs.poses, ws.poses), n
        assert same_bits(gs.log_scale, ws.log_scale), n
        assert same_bits(cov, wcov), n
        if n == 0:  # the first runs op by op and is captured
            assert (replayed, eager) == (reads - 1, 2)
            assert set(rep.graphs) == {"sweep", 1}
        else:
            assert (replayed, eager) == (reads + 1, 0)
    graphs = dict(rep.graphs)
    # a second pass over the sequence captures nothing again
    for (k, g), want in zip(seq, eager_update):
        (gs, cov), reads, replayed, eager = counted(
            fg.optimize_with_marginal, g, k, cfg)
        assert eager == 0 and reads == want[1]
        assert same_bits(gs.poses, want[0][0].poses) and same_bits(cov, want[0][1])
    assert rep.graphs == graphs
    assert all(rep.graphs[n] is graphs[n] for n in graphs)
    # the last state holds the NaN factor: every sweep failed and the
    # damping escalated, with the poses kept finite
    assert eager_update[-1][1] == cfg.gn_iters
    assert torch.isfinite(eager_update[-1][0][0].poses).all()
    assert not torch.isfinite(eager_update[-1][0][1]).all()


@pytest.mark.cuda
def test_replayed_optimize_and_marginals_keep_the_eager_bits(card, monkeypatch):
    """``optimize`` alone and the marginals of several keys, as the
    refinement and ``query_pose_uncertainty`` call them."""
    cfg = CONFIGS["refine"]
    seq = graph_sequence(cfg, card, seed=1)[:-1]
    keys = torch.tensor([0, 5, 13, 5], device=card)
    with monkeypatch.context() as m:
        m.setattr(fg, "_replayable", lambda state: False)
        want = [(fg.optimize(g, cfg), fg.marginal_covariance(g, keys, cfg))
                for _, g in seq]
    for _ in range(2):
        for (k, g), (ws, wcov) in zip(seq, want):
            gs = fg.optimize(g, cfg)
            cov = fg.marginal_covariance(g, keys, cfg)
            assert same_bits(gs.poses, ws.poses)
            assert same_bits(gs.log_scale, ws.log_scale)
            assert same_bits(cov, wcov)
    assert 4 in replays_of(cfg, seq[0][1]).graphs
