"""CFAR detectors over polar sonar images, in plain PyTorch.

Counterpart of ``sonar_slam_tpu/kernels/cfar.py``, with the same semantics:

* the window slides along the range axis (rows), per bearing column;
* ``train_hs`` / ``guard_hs`` are half-window sizes: the training cells of
  row ``r`` are rows ``i`` with ``guard_hs < |i - r| <= guard_hs + train_hs``;
* ``edge="strict"``: rows closer than ``train_hs + guard_hs`` to either
  border never detect and their threshold is 0; ``edge="extend"``: training
  rows beyond the image take the border row's value, so every row detects;
* CA compares against ``tau * (leading + lagging) / (2 * train_hs)``,
  SOCA/GOCA against ``tau * min/max(leading, lagging) / train_hs``, OS against
  ``tau * kth_smallest(training cells)`` (0-indexed rank ``k``).

The sum-based variants add the training rows one by one, in the order the
CUDA kernel uses (``cfar_cuda.cfar_plain``), rather than by prefix-sum
differences as the JAX module does; the two agree to rounding, so a pixel
lying exactly at its threshold can come out either way. Every function takes
an image [R, C] or a stack [..., R, C].
"""

from __future__ import annotations

import torch

from .cfar_cuda import cfar_os_plain, cfar_plain
from .cfar_factors import (
    threshold_factor_ca,
    threshold_factor_goca,
    threshold_factor_os,
    threshold_factor_soca,
)


def _f32(img: torch.Tensor) -> torch.Tensor:
    return img.to(torch.float32)


def cfar_ca2(img, train_hs: int, guard_hs: int, tau: float,
             edge: str = "strict"):
    """Cell-averaging CFAR; returns (detections bool, threshold map f32)."""
    return cfar_plain(_f32(img), train_hs, guard_hs, tau, "CA", None, edge)


def cfar_soca2(img, train_hs: int, guard_hs: int, tau: float,
               edge: str = "strict"):
    """Smallest-of cell-averaging CFAR."""
    return cfar_plain(_f32(img), train_hs, guard_hs, tau, "SOCA", None, edge)


def cfar_goca2(img, train_hs: int, guard_hs: int, tau: float,
               edge: str = "strict"):
    """Greatest-of cell-averaging CFAR."""
    return cfar_plain(_f32(img), train_hs, guard_hs, tau, "GOCA", None, edge)


def cfar_os2(img, train_hs: int, guard_hs: int, k: int, tau: float,
             edge: str = "strict"):
    """Order-statistic CFAR: threshold from the k-th smallest training cell,
    by a sort over the stacked window (2 * train_hs cells)."""
    return cfar_os_plain(_f32(img), train_hs, guard_hs, k, tau, None, edge)


def cfar_ca(img, train_hs, guard_hs, tau, edge: str = "strict"):
    return cfar_ca2(img, train_hs, guard_hs, tau, edge)[0]


def cfar_soca(img, train_hs, guard_hs, tau, edge: str = "strict"):
    return cfar_soca2(img, train_hs, guard_hs, tau, edge)[0]


def cfar_goca(img, train_hs, guard_hs, tau, edge: str = "strict"):
    return cfar_goca2(img, train_hs, guard_hs, tau, edge)[0]


def cfar_os(img, train_hs, guard_hs, k, tau, edge: str = "strict"):
    return cfar_os2(img, train_hs, guard_hs, k, tau, edge)[0]


class CFAR:
    """Detector front end: threshold-factor math + variant dispatch.

    Construct with (Ntc, Ngc, Pfa, rank) and call ``detect(img, alg)`` or
    ``detect2(img, alg)`` with ``alg`` in {"CA", "SOCA", "GOCA", "OS"}.
    """

    def __init__(self, Ntc: int, Ngc: int, Pfa: float, rank: int | None = None,
                 edge: str = "strict"):
        if Ntc % 2 != 0 or Ngc % 2 != 0:
            raise ValueError("Ntc and Ngc must be even")
        self.Ntc, self.Ngc, self.Pfa = Ntc, Ngc, Pfa
        self.rank = int(Ntc / 2) if rank is None else int(rank)
        if not 0 <= self.rank < Ntc:
            raise ValueError("rank must be in [0, Ntc)")
        self.edge = edge

        self.threshold_factor_CA = threshold_factor_ca(Ntc, Pfa)
        self.threshold_factor_SOCA = threshold_factor_soca(Ntc, Pfa)
        self.threshold_factor_GOCA = threshold_factor_goca(Ntc, Pfa)
        self.threshold_factor_OS = threshold_factor_os(Ntc, self.rank, Pfa)

        t, g = Ntc // 2, Ngc // 2
        self._dispatch2 = {
            "CA": lambda img: cfar_ca2(
                img, t, g, self.threshold_factor_CA, edge),
            "SOCA": lambda img: cfar_soca2(
                img, t, g, self.threshold_factor_SOCA, edge),
            "GOCA": lambda img: cfar_goca2(
                img, t, g, self.threshold_factor_GOCA, edge),
            "OS": lambda img: cfar_os2(
                img, t, g, self.rank, self.threshold_factor_OS, edge),
        }

    def detect(self, img, alg: str = "CA"):
        """Detection mask for polar frame(s) [..., R, C]."""
        return self._dispatch2[alg](img)[0]

    def detect2(self, img, alg: str = "CA"):
        """(detection mask, threshold map)."""
        return self._dispatch2[alg](img)
