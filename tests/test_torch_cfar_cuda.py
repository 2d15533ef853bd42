"""The CUDA CFAR kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it runs on a machine that has a card and no JAX:
``python -m pytest tests/test_torch_cfar_cuda.py``. Without a card every test
skips. The sum kernel and its plain version add the training rows in the same
order and divide the same way; the OS selection kernel and its plain version
select the same exact order statistic; the OS mask kernel's rank count decides
``x > tau * kth`` exactly for tau > 0. So the masks, and the threshold maps
where asked for, must be bit-for-bit equal.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_os_plain, cfar_plain

OS_GRID = pytest.mark.parametrize(
    "train_hs,rank", [(20, 0), (20, 10), (20, 39), (8, 5)])
RAGGED = pytest.mark.parametrize(
    "shape", [(3, 97, 37), (2, 30, 64)],
    ids=["C-not-a-multiple-of-4", "R-under-the-halo"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CFAR kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _pings(seed, shape):
    """Exponential speckle with bright splats: non-integer float32, as the
    simulator's pings are."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(20.0, size=shape).astype(np.float32)
    for b in range(shape[0]):
        r = rng.integers(0, shape[1], 6)
        c = rng.integers(0, shape[2], 6)
        x[b, r, c] += rng.uniform(100, 700, 6).astype(np.float32)
    return x


def _os_pings(card, integer):
    imgs = torch.as_tensor(np.clip(_pings(7, (8, 512, 256)), 0, 255),
                           device=card)
    return torch.round(imgs) if integer else imgs


def _ragged_pings(card, shape):
    """Pings of a ragged shape with a NaN and an inf pixel."""
    x = _pings(11, shape)
    x[0, 3, 1] = np.nan
    x[-1, shape[1] // 2, shape[2] - 1] = np.inf
    return torch.as_tensor(x, device=card)


def _launches(kernel):
    return cfar_detect.launches, cfar_detect.kernel_launches[kernel]


def _equal_nan(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["CA", "SOCA", "GOCA"])
@pytest.mark.parametrize("edge", ["strict", "extend"])
def test_kernel_matches_plain_on_card(card, mode, edge):
    imgs = torch.as_tensor(_pings(5, (8, 512, 256)), device=card)
    before = cfar_detect.launches
    det, thr = cfar_detect(imgs, 20, 5, 1.6, mode, 65.0, edge,
                           with_threshold=True)
    pdet, pthr = cfar_plain(imgs, 20, 5, 1.6, mode, 65.0, edge)
    torch.cuda.synchronize()
    assert cfar_detect.launches == before + 1
    assert det.dtype == torch.bool and det.shape == imgs.shape
    assert torch.equal(det, pdet)
    assert torch.equal(thr, pthr)


@pytest.mark.cuda
@pytest.mark.parametrize("train_hs,rank", [(20, 0), (20, 10), (20, 39), (8, 5)])
@pytest.mark.parametrize("edge", ["strict", "extend"])
@pytest.mark.parametrize("integer", [False, True])
def test_os_kernel_matches_plain_on_card(card, train_hs, rank, edge, integer):
    """train_hs 20 takes the kernel's unrolled 40-cell instantiation, 8 the
    generic one."""
    imgs = torch.as_tensor(np.clip(_pings(7, (8, 512, 256)), 0, 255),
                           device=card)
    if integer:
        imgs = torch.round(imgs)
    before = cfar_detect.launches
    det, thr = cfar_detect(imgs, train_hs, 5, 1.6, "OS", 65.0, edge,
                           with_threshold=True, rank=rank)
    pdet, pthr = cfar_os_plain(imgs, train_hs, 5, rank, 1.6, 65.0, edge)
    torch.cuda.synchronize()
    assert cfar_detect.launches == before + 1
    assert det.dtype == torch.bool and det.shape == imgs.shape
    assert torch.equal(det, pdet)
    assert torch.equal(thr, pthr)
    assert bool(det.any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["CA", "SOCA", "GOCA"])
@pytest.mark.parametrize("edge", ["strict", "extend"])
def test_sum_mask_path_matches_plain_on_card(card, mode, edge):
    """Mask only, as the feature path calls it: the gated pixels go on the
    block's list."""
    imgs = torch.as_tensor(_pings(5, (8, 512, 256)), device=card)
    before = _launches("sum")
    det = cfar_detect(imgs, 20, 5, 1.6, mode, 65.0, edge)
    pdet, _ = cfar_plain(imgs, 20, 5, 1.6, mode, 65.0, edge)
    torch.cuda.synchronize()
    assert _launches("sum") == (before[0] + 1, before[1] + 1)
    assert torch.equal(det, pdet) and bool(det.any())


@pytest.mark.cuda
@OS_GRID
@pytest.mark.parametrize("edge", ["strict", "extend"])
@pytest.mark.parametrize("integer", [False, True])
def test_os_mask_path_matches_plain_on_card(card, train_hs, rank, edge,
                                            integer):
    """with_threshold=False and tau > 0 take the rank-count mask kernel."""
    imgs = _os_pings(card, integer)
    before = _launches("os_mask")
    det = cfar_detect(imgs, train_hs, 5, 1.6, "OS", 65.0, edge, rank=rank)
    pdet, _ = cfar_os_plain(imgs, train_hs, 5, rank, 1.6, 65.0, edge)
    torch.cuda.synchronize()
    assert _launches("os_mask") == (before[0] + 1, before[1] + 1)
    assert det.dtype == torch.bool and det.shape == imgs.shape
    assert torch.equal(det, pdet) and bool(det.any())


@pytest.mark.cuda
@OS_GRID
@pytest.mark.parametrize("edge", ["strict", "extend"])
def test_os_mask_path_matches_threshold_path_on_card(card, train_hs, rank,
                                                     edge):
    imgs = _os_pings(card, integer=False)
    det = cfar_detect(imgs, train_hs, 5, 1.6, "OS", None, edge, rank=rank)
    tdet, _ = cfar_detect(imgs, train_hs, 5, 1.6, "OS", None, edge,
                          with_threshold=True, rank=rank)
    torch.cuda.synchronize()
    assert torch.equal(det, tdet) and bool(det.any())


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [-1.0, 0.0])
def test_os_tau_not_positive_takes_the_selection_kernel(card, tau):
    imgs = _os_pings(card, integer=False)
    before = _launches("os_select")
    det = cfar_detect(imgs, 20, 5, tau, "OS", None, "extend", rank=10)
    pdet, _ = cfar_os_plain(imgs, 20, 5, 10, tau, None, "extend")
    torch.cuda.synchronize()
    assert _launches("os_select") == (before[0] + 1, before[1] + 1)
    assert torch.equal(det, pdet) and bool(det.any())


@pytest.mark.cuda
@RAGGED
@pytest.mark.parametrize("edge", ["strict", "extend"])
@pytest.mark.parametrize("with_threshold", [False, True])
def test_sum_kernel_on_ragged_shapes(card, shape, edge, with_threshold):
    imgs = _ragged_pings(card, shape)
    for mode in ("CA", "SOCA", "GOCA"):
        for t, g in ((20, 5), (8, 5)):
            out = cfar_detect(imgs, t, g, 1.6, mode, 65.0, edge,
                              with_threshold=with_threshold)
            pdet, pthr = cfar_plain(imgs, t, g, 1.6, mode, 65.0, edge)
            torch.cuda.synchronize()
            det = out[0] if with_threshold else out
            assert torch.equal(det, pdet), (mode, t, g)
            if with_threshold:
                assert _equal_nan(out[1], pthr), (mode, t, g)


@pytest.mark.cuda
@RAGGED
@pytest.mark.parametrize("edge", ["strict", "extend"])
@pytest.mark.parametrize("gate", [None, 65.0])
def test_os_kernels_on_ragged_shapes(card, shape, edge, gate):
    imgs = _ragged_pings(card, shape)
    for t, rank in ((20, 0), (20, 10), (20, 39), (8, 5)):
        pdet, pthr = cfar_os_plain(imgs, t, 5, rank, 1.6, gate, edge)
        det = cfar_detect(imgs, t, 5, 1.6, "OS", gate, edge, rank=rank)
        sdet, sthr = cfar_detect(imgs, t, 5, 1.6, "OS", gate, edge,
                                 with_threshold=True, rank=rank)
        torch.cuda.synchronize()
        assert torch.equal(det, pdet), (t, rank)
        assert torch.equal(sdet, pdet) and _equal_nan(sthr, pthr), (t, rank)


def _selection_pings(card, shape):
    """Float pings of a ragged shape with NaN, +inf, -inf, -0.0 and a run of
    tied cells, and an integer-valued copy (ties everywhere)."""
    x = _pings(17, shape)
    x[0, 3, 1] = np.nan
    x[-1, shape[1] // 2, shape[2] - 1] = np.inf
    x[0, 10, 5] = -np.inf
    x[-1, 5:9, 3] = -0.0
    x[0, 20:40, 7] = 5.0
    imgs = torch.as_tensor(x, device=card)
    return imgs, torch.round(imgs)


# (train_hs, rank): the main path's 40-cell window at ranks 0, 10 (the
# register-sorted split kernel) and 39, and generic windows of 14 and 128
SELECTION_WINDOWS = [(20, 0), (20, 10), (20, 39), (7, 0), (7, 13), (64, 0),
                     (64, 64), (64, 127)]


@pytest.mark.cuda
@RAGGED
@pytest.mark.parametrize("train_hs,rank", SELECTION_WINDOWS)
@pytest.mark.parametrize("tau", [0.0, -1.0, 1.6, "factor"])
def test_os_selection_kernel_bit_for_bit(card, shape, train_hs, rank, tau):
    """The sorted sliding window (cfar_os_kernel) against the sort: mask and
    threshold map, every edge and gate, float and integer pings."""
    from sonar_slam_torch.kernels.cfar_factors import threshold_factor_os

    if tau == "factor":
        tau = threshold_factor_os(2 * train_hs, max(rank, 1), 0.1)
    guard = 2 if train_hs == 64 else 5
    for imgs in _selection_pings(card, shape):
        for edge in ("strict", "extend"):
            for gate in (None, 65.0):
                before = _launches("os_select")
                det, thr = cfar_detect(imgs, train_hs, guard, tau, "OS", gate,
                                       edge, with_threshold=True, rank=rank)
                pdet, pthr = cfar_os_plain(imgs, train_hs, guard, rank, tau,
                                           gate, edge)
                torch.cuda.synchronize()
                assert _launches("os_select") == (before[0] + 1, before[1] + 1)
                assert torch.equal(det, pdet), (edge, gate)
                assert _equal_nan(thr, pthr), (edge, gate)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 10, 39])
def test_os_selection_kernel_at_the_main_path_shape(card, rank):
    """(128, 512, 256), extend, gate 65: two row blocks a column, the main
    path's call with the threshold map."""
    imgs = torch.as_tensor(np.clip(_pings(23, (128, 512, 256)), 0, 255),
                           device=card)
    det, thr = cfar_detect(imgs, 20, 5, 1.6, "OS", 65.0, "extend",
                           with_threshold=True, rank=rank)
    pdet, pthr = cfar_os_plain(imgs, 20, 5, rank, 1.6, 65.0, "extend")
    torch.cuda.synchronize()
    assert torch.equal(det, pdet) and torch.equal(thr, pthr)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    imgs = torch.as_tensor(_pings(6, (2, 64, 32)), device=card)
    with pytest.raises(ValueError):
        cfar_detect(imgs, 65, 2, 2.0, "OS")  # 130 training cells
    with pytest.raises(ValueError):
        cfar_detect(imgs.transpose(1, 2), 8, 2, 2.0)
    with pytest.raises(ValueError):  # a 1,064-row tile: over shared memory
        cfar_detect(imgs, 20, 480, 2.0)


def _vertical_pings(shape, seed=13):
    """Vertical-fan-like pings: speckle under a bright seafloor band whose
    range falls across the fan's beams, as the dual-sonar lane's vertical
    pings look (a band crossing the strict edge rows of some beams)."""
    rng = np.random.default_rng(seed)
    B, R, C = shape
    x = rng.exponential(15.0, size=shape).astype(np.float32)
    rows = np.arange(R)[:, None]
    for b in range(B):
        floor = rng.uniform(0.1, 0.95) * R + np.linspace(-0.3, 0.3, C) * R
        band = np.exp(-0.5 * ((rows - floor[None, :]) / 1.5) ** 2)
        x[b] += (rng.uniform(150, 400) * band).astype(np.float32)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 192, 48), (5, 150, 41)],
                         ids=["dual-lane", "ragged"])
@pytest.mark.parametrize("with_threshold", [False, True])
def test_sum_kernel_on_vertical_fan_pings(card, shape, with_threshold):
    """The dual-sonar lane's vertical call: SOCA, strict edge, gated at 65."""
    imgs = torch.as_tensor(_vertical_pings(shape), device=card)
    before = _launches("sum")
    out = cfar_detect(imgs, 20, 5, 1.6, "SOCA", 65.0, "strict",
                      with_threshold=with_threshold)
    det, thr = out if with_threshold else (out, None)
    pdet, pthr = cfar_plain(imgs, 20, 5, 1.6, "SOCA", 65.0, "strict")
    torch.cuda.synchronize()
    assert _launches("sum") == (before[0] + 1, before[1] + 1)
    assert torch.equal(det, pdet)
    assert int(pdet.sum()) > 10 * shape[0]
    if with_threshold:
        assert torch.equal(thr, pthr)
