"""Oculus imaging-sonar geometry.

Counterpart of ``sonar_slam_tpu/slam/sonar.py``'s ``SonarGeometry`` (numpy
tables, so the simulator and the feature front end can build them on any
host, and the frozen simulator builds its survey's with ``make``); the
port's image ops and bag-reader helpers are left out, since no stage of the
reference uses them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OCULUS_VERTICAL_APERTURE = {1: np.deg2rad(20.0), 2: np.deg2rad(12.0)}


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


