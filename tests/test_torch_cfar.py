"""CFAR parity: the port's plain version against the JAX package.

* Against ``cfar_pallas_batch`` in interpret mode (patched the way
  tests/test_cfar_pallas.py does it) the mask must be EXACT: both add the
  training rows in the same order and compute ``tau * (min / train_hs)``.
  The thresholds agree to one float32 ulp (relative 2.5e-7): XLA on the CPU
  rewrites the division by the constant ``train_hs``.
* Against the XLA ``cfar_*2`` functions, which take prefix-sum differences
  and compute ``tau * min / train_hs``, the thresholds differ in the last
  bits: the mask must agree except at pixels within a relative 1e-5 of
  their threshold (float32 prefix sums over 40 cells of values up to ~1e3
  carry ~1e-6 relative error).
* OS (a sort over the same window values) is exact against ``cfar_os2``,
  and so is ``cfar_os_plain`` with the intensity gate fused in.
* OS against the Pallas kernel's counting bisection (interpret mode): on
  integer images the bisection is exact, so masks and thresholds are equal;
  on float images its threshold is an upper bound within
  ``tau * 256 * 2**-22`` of the exact one, and the masks agree outside that
  margin.
* The OS mask kernel's rank count (``#{i : tau * v_i < x} >= rank + 1``, no
  selection) equals ``x > tau * kth`` for tau > 0 and, without -inf cells,
  for tau == 0: it is held to ``cfar_os_plain``'s mask, with NaN and inf
  pixels, and to the Pallas kernel's mask on integer pings.
* The CUDA kernels against the plain versions are in test_torch_cfar_cuda.py.
"""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.kernels.cfar as jcfar
import sonar_slam_torch.kernels.cfar as tcfar
from sonar_slam_torch.kernels.cfar_cuda import (cfar_detect, cfar_os_plain,
                                                cfar_plain, os_mask_path,
                                                valid_rows)
from sonar_slam_torch.kernels.cfar_factors import threshold_factor_os

torch.set_num_threads(1)
MARGIN = 1e-5


def _pings(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.exponential(20.0, size=shape).astype(np.float32)
    flat = x.reshape(-1, shape[-2], shape[-1])
    for b in range(flat.shape[0]):
        r = rng.integers(0, shape[-2], 6)
        c = rng.integers(0, shape[-1], 6)
        flat[b, r, c] += rng.uniform(100, 700, 6).astype(np.float32)
    flat[0, 1, 2] = 500.0  # inside the strict border band
    return x


def _pallas(imgs, t, g, tau, mode, gate, edge, rank=0):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    with mock.patch.object(pl, "pallas_call", patched):
        from sonar_slam_tpu.kernels.cfar_pallas import cfar_pallas_batch

        det, thr = cfar_pallas_batch(jnp.asarray(imgs), t, g, tau, mode,
                                     intensity_threshold=gate, edge=edge,
                                     rank=rank)
    return np.asarray(det), np.asarray(thr)


@pytest.mark.parametrize("mode", ["CA", "SOCA", "GOCA"])
@pytest.mark.parametrize("edge,gate", [("strict", None), ("extend", 65.0)])
def test_plain_matches_pallas_exactly(mode, edge, gate):
    imgs = _pings(0, (2, 80, 24))
    t, g, tau = 10, 3, 2.7
    jdet, jthr = _pallas(imgs, t, g, tau, mode, gate, edge)
    det, thr = cfar_plain(torch.as_tensor(imgs), t, g, tau, mode, gate, edge)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_allclose(thr.numpy(), jthr, rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("mode", ["CA", "SOCA", "GOCA"])
@pytest.mark.parametrize("edge", ["strict", "extend"])
def test_plain_matches_xla_within_margin(mode, edge):
    img = _pings(1, (96, 40))
    t, g, tau = 10, 2, 3.3
    jfn = {"CA": jcfar.cfar_ca2, "SOCA": jcfar.cfar_soca2,
           "GOCA": jcfar.cfar_goca2}[mode]
    tfn = {"CA": tcfar.cfar_ca2, "SOCA": tcfar.cfar_soca2,
           "GOCA": tcfar.cfar_goca2}[mode]
    jdet, jthr = (np.asarray(a) for a in jfn(jnp.asarray(img), t, g, tau, edge))
    det, thr = (a.numpy() for a in tfn(torch.as_tensor(img), t, g, tau, edge))
    np.testing.assert_allclose(thr, jthr, rtol=MARGIN, atol=1e-4)
    near = np.abs(img - jthr) <= MARGIN * np.abs(jthr)
    np.testing.assert_array_equal(det[~near], jdet[~near])
    assert det.sum() > 0


@pytest.mark.parametrize("edge", ["strict", "extend"])
def test_os_matches_xla(edge):
    img = _pings(2, (72, 20))
    jdet, jthr = (np.asarray(a) for a in jcfar.cfar_os2(jnp.asarray(img), 10, 2,
                                                         7, 2.5, edge))
    det, thr = tcfar.cfar_os2(torch.as_tensor(img), 10, 2, 7, 2.5, edge)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(thr.numpy(), jthr)


@pytest.mark.parametrize("rank", [0, 7, 19])
@pytest.mark.parametrize("edge,gate", [("strict", None), ("extend", 65.0)])
def test_os_plain_matches_xla(rank, edge, gate):
    img = _pings(5, (72, 20))
    jdet, jthr = (np.asarray(a) for a in jcfar.cfar_os2(jnp.asarray(img), 10, 2,
                                                         rank, 2.5, edge))
    if gate is not None:
        jdet = jdet & (img > gate)
    det, thr = cfar_os_plain(torch.as_tensor(img[None]), 10, 2, rank, 2.5,
                             gate, edge)
    np.testing.assert_array_equal(det[0].numpy(), jdet)
    np.testing.assert_array_equal(thr[0].numpy(), jthr)
    assert jdet.any()


def _os_pings(seed, integer):
    """Sonar intensities in [0, 255] (the Pallas bisection's range): decoded
    uint8 levels, or the simulator's float values."""
    x = np.clip(_pings(seed, (2, 80, 24)), 0.0, 255.0)
    return np.floor(x) if integer else x


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("rank", [0, 10, 19])
@pytest.mark.parametrize("edge,gate", [("strict", None), ("extend", 65.0)])
def test_os_plain_against_pallas(integer, rank, edge, gate):
    imgs = _os_pings(6, integer)
    t, g, tau = 10, 3, 2.5
    jdet, jthr = _pallas(imgs, t, g, tau, "OS", gate, edge, rank)
    det, thr = (a.numpy() for a in cfar_os_plain(torch.as_tensor(imgs), t, g,
                                                 rank, tau, gate, edge))
    if integer:
        np.testing.assert_array_equal(det, jdet)
        np.testing.assert_array_equal(thr, jthr)
    else:
        margin = tau * 256 * 2.0**-22
        assert (jthr >= thr).all() and (jthr - thr).max() <= margin
        near = np.abs(imgs - thr) <= margin
        np.testing.assert_array_equal(det[~near], jdet[~near])
    assert det.any()


def _rank_count_mask(imgs, t, g, rank, tau, gate, edge):
    """The OS mask kernel's rule in torch: the clamped window of each pixel,
    times tau, counted below the pixel."""
    R = imgs.shape[-2]
    rows = torch.arange(R)
    offsets = [o for o in range(-t - g, t + g + 1) if abs(o) > g]
    windows = torch.stack(
        [imgs[..., torch.clamp(rows + o, 0, R - 1), :] for o in offsets], -1)
    count = ((tau * windows) < imgs[..., None]).sum(-1)
    det = (count >= rank + 1) & valid_rows(R, t, g, edge, "cpu")[:, None]
    return det & (imgs > gate) if gate is not None else det


TAU_OS = threshold_factor_os(40, 10, 0.1)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("tau", [0.0, 1.6, TAU_OS])
@pytest.mark.parametrize("rank", [0, 10, 39])
@pytest.mark.parametrize("edge", ["strict", "extend"])
@pytest.mark.parametrize("gate", [None, 65.0])
def test_rank_count_equals_selection(integer, tau, rank, edge, gate):
    imgs = _pings(8, (2, 96, 24))
    if integer:
        imgs = np.floor(imgs)
    imgs[0, 40, 3] = np.nan
    imgs[1, 50, 7] = np.inf
    imgs[1, 52, 7] = 300.0  # inf among its training cells
    imgs = torch.as_tensor(imgs)
    det, _ = cfar_os_plain(imgs, 20, 5, rank, tau, gate, edge)
    count_det = _rank_count_mask(imgs, 20, 5, rank, tau, gate, edge)
    assert torch.equal(count_det, det)
    assert det.any() and not det[0, 40, 3]


@pytest.mark.parametrize("rank,tau", [(0, 7.3), (10, TAU_OS), (39, 1.0)])
@pytest.mark.parametrize("edge,gate", [("strict", None), ("extend", 65.0)])
def test_rank_count_equals_pallas_on_integer_pings(rank, tau, edge, gate):
    imgs = np.floor(np.clip(_pings(9, (2, 96, 24)), 0.0, 255.0))
    jdet, _ = _pallas(imgs, 20, 5, tau, "OS", gate, edge, rank)
    det = _rank_count_mask(torch.as_tensor(imgs), 20, 5, rank, tau, gate,
                           edge)
    np.testing.assert_array_equal(det.numpy(), jdet)
    assert jdet.any()


def test_rank_count_needs_positive_tau():
    """With tau == 0 a -inf cell breaks the identity: fl(0 * -inf) is NaN,
    so a window whose rank-th cell is -inf has threshold NaN and no
    detection, while its finite cells still count below x. So the mask
    kernel takes only tau > 0."""
    imgs = torch.full((1, 64, 4), 100.0)
    imgs[0, 20, :] = -np.inf  # a leading cell of rows 26 ... 45
    det, _ = cfar_os_plain(imgs, 20, 5, 0, 0.0, None, "extend")
    count_det = _rank_count_mask(imgs, 20, 5, 0, 0.0, None, "extend")
    assert not det[0, 30].any() and count_det[0, 30].all()
    det, _ = cfar_os_plain(imgs, 20, 5, 0, 1e-3, None, "extend")
    assert torch.equal(_rank_count_mask(imgs, 20, 5, 0, 1e-3, None, "extend"),
                       det)


def test_os_mask_path_takes_only_a_positive_finite_tau():
    assert os_mask_path(TAU_OS, with_threshold=False)
    assert os_mask_path(1e-30, with_threshold=False)
    assert not os_mask_path(TAU_OS, with_threshold=True)
    for tau in (0.0, -1.0, 1e-50, 1e39, np.inf, np.nan):  # 1e-50 rounds to 0
        assert not os_mask_path(tau, with_threshold=False)


def test_detect_os_on_cpu_is_the_plain_version():
    imgs = torch.as_tensor(_pings(7, (3, 64, 16)))
    det, thr = cfar_detect(imgs, 8, 2, 3.0, "OS", 65.0, "extend",
                           with_threshold=True, rank=5)
    pdet, pthr = cfar_os_plain(imgs, 8, 2, 5, 3.0, 65.0, "extend")
    assert torch.equal(det, pdet) and torch.equal(thr, pthr)
    with pytest.raises(ValueError):
        cfar_detect(imgs, 8, 2, 3.0, "OS", rank=16)  # 16 training cells


@pytest.mark.parametrize("alg", ["CA", "SOCA", "GOCA", "OS"])
def test_cfar_class_matches(alg):
    img = _pings(3, (80, 16))
    jd = np.asarray(jcfar.CFAR(20, 4, 0.1, 6, edge="extend").detect(
        jnp.asarray(img), alg))
    td = tcfar.CFAR(20, 4, 0.1, 6, edge="extend").detect(torch.as_tensor(img), alg)
    thr = np.asarray(jcfar.CFAR(20, 4, 0.1, 6, edge="extend").detect2(
        jnp.asarray(img), alg)[1])
    near = np.abs(img - thr) <= MARGIN * np.abs(thr)
    np.testing.assert_array_equal(td.numpy()[~near], jd[~near])


def test_detect_on_cpu_is_the_plain_version():
    imgs = torch.as_tensor(_pings(4, (3, 64, 16)))
    det, thr = cfar_detect(imgs, 8, 2, 3.0, "SOCA", 65.0, "extend",
                           with_threshold=True)
    pdet, pthr = cfar_plain(imgs, 8, 2, 3.0, "SOCA", 65.0, "extend")
    assert det.dtype == torch.bool and det.shape == imgs.shape
    assert torch.equal(det, pdet) and torch.equal(thr, pthr)


def test_detect_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 32, 8))
    with pytest.raises(TypeError):
        cfar_detect(x.double(), 4, 1, 2.0)
    with pytest.raises(ValueError):
        cfar_detect(x[0], 4, 1, 2.0)
    with pytest.raises(ValueError):
        cfar_detect(x, 4, 1, 2.0, edge="wrap")
    with pytest.raises(RuntimeError):
        cfar_detect(torch.zeros((2, 32, 8), device="meta"), 4, 1, 2.0)
