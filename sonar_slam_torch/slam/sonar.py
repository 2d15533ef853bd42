"""Oculus imaging-sonar geometry and image ops.

Counterpart of ``sonar_slam_tpu/slam/sonar.py``: ``SonarGeometry`` (numpy
tables, so the simulator and the feature front end can build them on any
host) and the image ops on torch tensors: the polar-to-Cartesian remap as a
precomputed gather, the gamma curves, Wiener deconvolution with the measured
Oculus bearing PSF (``torch.fft``) and the field-of-view test; and for the
bag reader, the fire-message decoder (``OculusFireMsg``) and
``SonarGeometry.from_ping``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

OCULUS_VERTICAL_APERTURE = {1: np.deg2rad(20.0), 2: np.deg2rad(12.0)}
OCULUS_PART_NUMBER = {1042: "M1200d", 1032: "M750d"}

_PSF_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "oculus_psf.npy")
_psf_cache: np.ndarray | None = None


def oculus_psf() -> np.ndarray:
    """The measured 1x512 Oculus bearing point-spread function (a data
    table, ``sonar_slam_torch/data/oculus_psf.npy``)."""
    global _psf_cache
    if _psf_cache is None:
        _psf_cache = np.load(_PSF_PATH).astype(np.float32)
    return _psf_cache


class OculusFireMsg(NamedTuple):
    """A decoded Oculus fire message. ``gamma`` is the raw byte (0 or 0xff
    = 1.0, 127 = 0.5), the value ``decompress_gamma`` expects;
    ``gamma_normalized`` is ``gamma / 255``."""

    mode: int  # 1 = low frequency (wide), 2 = high frequency (narrow)
    gamma: int  # raw gamma-correction byte
    flags: int
    range: float  # range demand: percent or meters, per flag bit 0
    gain: float
    speed_of_sound: float  # m/s; 0 = sonar-internal calc from salinity
    salinity: float  # ppt; 0 = fresh, 35 = salt water

    @property
    def range_in_meters(self) -> bool:
        return bool(self.flags & 0x01)

    @property
    def data_is_16bit(self) -> bool:
        return bool(self.flags & 0x02)

    @property
    def sends_gain(self) -> bool:
        return bool(self.flags & 0x04)

    @property
    def simple_return(self) -> bool:
        return bool(self.flags & 0x08)

    @property
    def gain_assist(self) -> bool:
        return bool(self.flags & 0x10)

    @property
    def low_power(self) -> bool:
        return bool(self.flags & 0x20)

    @property
    def gamma_normalized(self) -> float:
        return self.gamma / 255.0

    def effective_speed_of_sound(self, temperature_c: float = 10.0,
                                 depth_m: float = 10.0) -> float:
        """The speed of sound in effect: the demanded value, or, when the
        message demands 0, the sonar's own estimate from salinity
        (Mackenzie's nine-term equation, JASA 1981)."""
        if self.speed_of_sound > 0:
            return float(self.speed_of_sound)
        t, s, d = temperature_c, self.salinity, depth_m
        return (
            1448.96 + 4.591 * t - 5.304e-2 * t**2 + 2.374e-4 * t**3
            + 1.340 * (s - 35) + 1.630e-2 * d + 1.675e-7 * d**2
            - 1.025e-2 * t * (s - 35) - 7.139e-13 * t * d**3
        )

    @staticmethod
    def decode(msg: dict) -> "OculusFireMsg":
        """From a ``sonar_oculus/OculusFire`` message dict as ``io.rosbag``
        decodes it, keeping the raw gamma byte."""
        return OculusFireMsg(
            mode=int(msg.get("mode", 1)),
            gamma=int(msg.get("gamma", 0)),
            flags=int(msg.get("flags", 0)),
            range=float(msg.get("range", 0.0)),
            gain=float(msg.get("gain", 0.0)),
            speed_of_sound=float(msg.get("speed_of_sound", 0.0)),
            salinity=float(msg.get("salinity", 0.0)),
        )


@dataclass(frozen=True)
class SonarGeometry:
    """Static per-configuration sonar geometry."""

    num_ranges: int
    num_bearings: int
    range_resolution: float
    bearings: np.ndarray  # (C,) radians, ascending
    model: str = "M750d"
    vertical_aperture: float = float(np.deg2rad(20.0))

    @property
    def ranges(self) -> np.ndarray:
        # r[i] = (i + 1) * resolution
        return self.range_resolution * (1 + np.arange(self.num_ranges))

    @property
    def max_range(self) -> float:
        return float(self.num_ranges * self.range_resolution)

    @property
    def horizontal_aperture(self) -> float:
        return float(abs(self.bearings[-1] - self.bearings[0]))

    @property
    def angular_resolution(self) -> float:
        return self.horizontal_aperture / self.num_bearings

    def _interp(self, name: str, x: np.ndarray, y: np.ndarray):
        """Cubic interpolant (linear below 4 samples), -1 outside, cached on
        the instance."""
        cache = self.__dict__.get("_interp_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_interp_cache", cache)
        if name not in cache:
            from scipy.interpolate import interp1d

            kind = "cubic" if len(x) >= 4 else "linear"
            cache[name] = interp1d(x, y, kind=kind, bounds_error=False,
                                   fill_value=-1, assume_sorted=True)
        return cache[name]

    def bearing_to_col(self, bearings) -> np.ndarray:
        """Continuous column of each bearing (rad); -1 outside the aperture."""
        f = self._interp("b2c", np.asarray(self.bearings, np.float64),
                         np.arange(self.num_bearings, dtype=np.float64))
        return np.asarray(f(bearings), np.float32)

    def col_to_bearing(self, cols) -> np.ndarray:
        """Bearing (rad) at each continuous column; -1 outside."""
        f = self._interp("c2b", np.arange(self.num_bearings, dtype=np.float64),
                         np.asarray(self.bearings, np.float64))
        return np.asarray(f(cols), np.float32)

    @staticmethod
    def from_ping(ping: dict) -> "tuple[SonarGeometry, OculusFireMsg]":
        """Geometry and fire message of a decoded ``sonar_oculus/OculusPing``
        dict: bearings arrive as int16 hundredths of a degree, the model
        from ``part_number`` (absent on old bags: M750d), the vertical
        aperture from the fire message's frequency mode."""
        fire = OculusFireMsg.decode(ping.get("fire_msg", {}))
        part = int(ping.get("part_number", 1032))
        bearings = np.deg2rad(
            np.asarray(ping["bearings"], np.float32) / 100.0).astype(np.float32)
        geom = SonarGeometry(
            num_ranges=int(ping["num_ranges"]),
            num_bearings=len(bearings),
            range_resolution=float(ping["range_resolution"]),
            bearings=bearings,
            model=OCULUS_PART_NUMBER.get(part, "M750d"),
            vertical_aperture=float(
                OCULUS_VERTICAL_APERTURE.get(fire.mode, np.deg2rad(20.0))),
        )
        return geom, fire

    @staticmethod
    def make(
        num_ranges: int = 512,
        num_bearings: int = 256,
        max_range: float = 30.0,
        horizontal_aperture: float = float(np.deg2rad(130.0)),
        model: str = "M750d",
        mode: int = 1,
    ) -> "SonarGeometry":
        """Construct a typical geometry (uniform bearing table)."""
        bearings = np.linspace(
            -horizontal_aperture / 2, horizontal_aperture / 2, num_bearings
        ).astype(np.float32)
        return SonarGeometry(
            num_ranges=num_ranges,
            num_bearings=num_bearings,
            range_resolution=max_range / num_ranges,
            bearings=bearings,
            model=model,
            vertical_aperture=float(OCULUS_VERTICAL_APERTURE[mode]),
        )

    def cell_points(self) -> np.ndarray:
        """(R, C, 2) body-frame (x fwd, y lateral) point of each polar cell:
        a detection at range rho / bearing b lands at (rho cos b, rho sin b)."""
        r = self.ranges[:, None]
        b = self.bearings[None, :]
        return np.stack([r * np.cos(b), r * np.sin(b)], axis=-1).astype(np.float32)

    def cart_image_shape(self) -> tuple[int, int]:
        """(rows, cols) of the Cartesian image."""
        height = self.max_range
        width = np.sin((self.bearings[-1] - self.bearings[0]) / 2) * height * 2
        return self.num_ranges, int(np.ceil(width / self.range_resolution))

    def cart_gather_indices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols) index maps and validity for the nearest-neighbour
        polar-to-Cartesian gather; bearings map to columns through the cubic
        interpolant."""
        rows, cols = self.cart_image_shape()
        XX, YY = np.meshgrid(np.arange(cols), np.arange(rows))
        x = self.range_resolution * (rows - YY)
        y = self.range_resolution * (-cols / 2.0 + XX + 0.5)
        b = np.arctan2(y, x)
        r = np.sqrt(x**2 + y**2)
        row_idx = np.round(r / self.range_resolution - 1).astype(np.int32)
        col_idx = np.round(self.bearing_to_col(b)).astype(np.int32)
        valid = (
            (row_idx >= 0)
            & (row_idx < self.num_ranges)
            & (col_idx >= 0)
            & (col_idx < self.num_bearings)
            & (b >= self.bearings[0])
            & (b <= self.bearings[-1])
        )
        return (
            np.clip(row_idx, 0, self.num_ranges - 1),
            np.clip(col_idx, 0, self.num_bearings - 1),
            valid,
        )


def remap_polar_to_cart(img: torch.Tensor, row_idx, col_idx, valid) -> torch.Tensor:
    """Rectify a polar image [..., R, C] to Cartesian with the precomputed
    gather of ``SonarGeometry.cart_gather_indices``."""
    dev = img.device
    row_idx = torch.as_tensor(row_idx, dtype=torch.int64, device=dev)
    col_idx = torch.as_tensor(col_idx, dtype=torch.int64, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    out = img[..., row_idx, col_idx]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev))


def adjust_gamma(img: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """(img / 255)^gamma * 255."""
    return torch.pow(img / 255.0, gamma) * 255.0


def decompress_gamma(img: torch.Tensor, gamma: float) -> torch.Tensor:
    """Undo the sonar's on-device gamma: clip(pow(i / 255, 255 / gamma) *
    255); ``gamma`` is the raw fire-message byte."""
    out = torch.pow(img / 255.0, 255.0 / gamma) * 255.0
    return torch.clamp(out, 0, 255)


def deconvolve_ping(img: torch.Tensor, noise: float = 0.01) -> torch.Tensor:
    """Wiener inverse filtering with the measured Oculus bearing PSF."""
    return wiener_deconvolve(img, torch.as_tensor(oculus_psf(), device=img.device),
                             noise)


def wiener_deconvolve(img: torch.Tensor, psf: torch.Tensor,
                      noise: float = 0.01) -> torch.Tensor:
    """Remove the bearing impulse response by Wiener-style inverse filtering
    of a [R, C] image: divide its spectrum by the PSF's with a
    noise-regularized inverse, recenter, clip at 0 and rescale to the input's
    peak.

    Two choices follow the JAX package on purpose: the PSF spectrum is not
    conjugated (the reference multiplies the raw spectrum, which pairs with
    its recentering for the near-symmetric measured PSF), and the rows roll
    by ``-(kh // 2)``, 0 for the 1-row PSF."""
    img = img.to(torch.float32)
    kh, kw = psf.shape
    psf_padded = torch.zeros_like(img)
    psf_padded[:kh, :kw] = psf
    img_f = torch.fft.fft2(img)
    psf_f = torch.fft.fft2(psf_padded)
    ipsf_f = psf_f / (torch.abs(psf_f) ** 2 + noise)
    result = torch.real(torch.fft.ifft2(img_f * ipsf_f))
    result = torch.roll(result, -(kh // 2), dims=0)
    result = torch.roll(result, -(kw // 2), dims=1)
    result = torch.clamp(result, min=0.0)
    scale = torch.max(img) / torch.clamp(torch.max(result), min=1e-9)
    return result * scale


def points_in_fov(points: torch.Tensor, pose: torch.Tensor, max_range,
                  half_aperture, range_pad=0.0, bearing_pad=0.0) -> torch.Tensor:
    """Which global-frame points [..., N, 2] fall inside the (padded) sonar
    field-of-view wedge at ``pose`` [..., 3]."""
    from ..geometry import se2_inverse, se2_transform_points

    local = se2_transform_points(points, se2_inverse(pose))
    ranges = torch.linalg.norm(local, dim=-1)
    bearings = torch.atan2(local[..., 1], local[..., 0])
    return (ranges < max_range + range_pad) & (
        torch.abs(bearings) < half_aperture + bearing_pad)
