"""The sonar image ops: the port (sonar_slam_torch.slam.sonar) against the
JAX package on the same seeded float32 inputs.

* geometry tables (cubic bearing <-> column interpolants, Cartesian gather
  indices) are the same numpy code: equal;
* the remap is a gather and the field-of-view test a compare on the same
  float32 coordinates: equal (FOV points kept 1e-4 away from the wedge's
  edges, where float32 sin/cos of the two libraries could decide a point
  either way);
* the gammas are one pow: within 2 float32 ulps;
* Wiener deconvolution goes through two different FFT libraries (pocketfft
  in torch, ducc in XLA): within 2e-3 of a 255-scale image, relative 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sonar_slam_tpu.slam.sonar as js
import sonar_slam_torch.slam.sonar as ts
from sonar_slam_torch.geometry import se2_inverse, se2_transform_points

torch.set_num_threads(1)


def _img(rng, shape=(64, 96)):
    x = rng.exponential(20.0, size=shape)
    x[rng.integers(0, shape[0], 8), rng.integers(0, shape[1], 8)] += 200.0
    return np.clip(x, 0, 255).astype(np.float32)


def _geoms():
    b = np.linspace(-65, 65, 48)
    b = np.sign(b) * np.abs(b) ** 1.08 / 65.0 ** 0.08  # a non-uniform table
    warped = np.deg2rad(b).astype(np.float32)
    out = []
    for G in (js.SonarGeometry, ts.SonarGeometry):
        out.append((G.make(num_ranges=40, num_bearings=24, max_range=20.0),
                    G(num_ranges=40, num_bearings=48, range_resolution=0.5,
                      bearings=warped)))
    return out


def test_psf_table_is_the_reference_table():
    np.testing.assert_array_equal(ts.oculus_psf(), js.oculus_psf())


@pytest.mark.parametrize("which", [0, 1])
def test_bearing_interpolants_and_gather_indices(which):
    jg, tg = _geoms()[0][which], _geoms()[1][which]
    b = np.linspace(-1.3, 1.3, 101)
    np.testing.assert_array_equal(tg.bearing_to_col(b), jg.bearing_to_col(b))
    c = np.linspace(-2.0, tg.num_bearings + 1.0, 77)
    np.testing.assert_array_equal(tg.col_to_bearing(c), jg.col_to_bearing(c))
    assert tg.cart_image_shape() == jg.cart_image_shape()
    for a, b_ in zip(tg.cart_gather_indices(), jg.cart_gather_indices()):
        np.testing.assert_array_equal(a, b_)


def test_remap_polar_to_cart():
    rng = np.random.default_rng(0)
    geom = _geoms()[1][1]
    idx = geom.cart_gather_indices()
    img = _img(rng, (geom.num_ranges, geom.num_bearings))
    j = np.asarray(js.remap_polar_to_cart(jnp.asarray(img), *idx))
    t = ts.remap_polar_to_cart(torch.as_tensor(img), *idx).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.shape == geom.cart_image_shape() and (t > 0).mean() > 0.3


@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.2])
def test_adjust_gamma(gamma):
    img = _img(np.random.default_rng(1))
    j = np.asarray(js.adjust_gamma(jnp.asarray(img), gamma))
    t = ts.adjust_gamma(torch.as_tensor(img), gamma).numpy()
    np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=1e-30)


@pytest.mark.parametrize("gamma", [127, 200, 255])
def test_decompress_gamma(gamma):
    img = _img(np.random.default_rng(2))
    j = np.asarray(js.decompress_gamma(jnp.asarray(img), gamma))
    t = ts.decompress_gamma(torch.as_tensor(img), gamma).numpy()
    np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=1e-30)


@pytest.mark.parametrize("shape", [(32, 512), (48, 600)])
def test_deconvolve_ping(shape):
    rng = np.random.default_rng(3)
    img = _img(rng, shape)
    psf = js.oculus_psf()[0]
    for r, c in zip(rng.integers(0, shape[0], 5), rng.integers(0, shape[1], 5)):
        img[r] += 200.0 * np.roll(np.resize(psf / psf.max(), shape[1]),
                                  c - int(np.argmax(psf)))
    j = np.asarray(js.deconvolve_ping(jnp.asarray(img)))
    t = ts.deconvolve_ping(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3, rtol=1e-5)
    assert t.max() == pytest.approx(img.max(), rel=1e-5)


@pytest.mark.parametrize("kernel", [(1, 5), (3, 7)])
def test_wiener_deconvolve_custom_psf(kernel):
    rng = np.random.default_rng(4)
    img = _img(rng, (40, 64))
    psf = rng.uniform(0.0, 1.0, size=kernel).astype(np.float32)
    j = np.asarray(js.wiener_deconvolve(jnp.asarray(img), jnp.asarray(psf), 0.05))
    t = ts.wiener_deconvolve(torch.as_tensor(img), torch.as_tensor(psf), 0.05).numpy()
    np.testing.assert_allclose(t, j, atol=2e-3, rtol=1e-5)


def test_points_in_fov():
    rng = np.random.default_rng(5)
    pose = np.asarray([[2.0, -1.0, 0.7], [-5.0, 3.0, -2.5]], np.float32)
    pts = rng.uniform(-40, 40, size=(2, 4000, 2)).astype(np.float32)
    args = (30.0, float(np.radians(65.0)), 2.0, 0.1)
    # keep points off the wedge's edges, where one float32 ulp of the local
    # coordinates could flip the compare in either library
    local = se2_transform_points(torch.as_tensor(pts),
                                 se2_inverse(torch.as_tensor(pose))).numpy()
    rng_ = np.linalg.norm(local, axis=-1)
    brg = np.abs(np.arctan2(local[..., 1], local[..., 0]))
    off = (np.abs(rng_ - 32.0) > 1e-4) & (np.abs(brg - (args[1] + 0.1)) > 1e-4)
    j = np.asarray(js.points_in_fov(jnp.asarray(pts), jnp.asarray(pose), *args))
    t = ts.points_in_fov(torch.as_tensor(pts), torch.as_tensor(pose), *args).numpy()
    np.testing.assert_array_equal(t[off], j[off])
    assert t.shape == (2, 4000) and 0.1 < t.mean() < 0.9
