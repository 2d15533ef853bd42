"""The CUDA CFAR kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it runs on a machine that has a card and no JAX:
``python -m pytest tests/test_torch_cfar_cuda.py``. Without a card every test
skips. The sum kernel and its plain version add the training rows in the same
order and divide the same way; the OS kernel and its plain version select the
same exact order statistic. So the mask and the threshold map must be
bit-for-bit equal.
"""

import numpy as np
import pytest
import torch

from sonar_slam_torch.kernels.cfar_cuda import cfar_detect, cfar_os_plain, cfar_plain


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
def test_kernel_refuses_what_it_does_not_take(card):
    imgs = torch.as_tensor(_pings(6, (2, 64, 32)), device=card)
    with pytest.raises(ValueError):
        cfar_detect(imgs, 65, 2, 2.0, "OS")  # 130 training cells
    with pytest.raises(ValueError):
        cfar_detect(imgs.transpose(1, 2), 8, 2, 2.0)
