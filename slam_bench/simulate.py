"""Synthetic BlueROV sonar-survey bag generator (numpy only): the
benchmark's traffic generator.

A frozen copy of the port's ``io/simulate.py``, so that a change to the port
cannot move the benchmark's inputs. Same ``SimConfig`` and the same random
stream: for equal configs both return array-equal bags
(``slam_bench/tests/test_bench_inputs.py`` checks it). Its ``SonarGeometry``
is the reference's copy.

* world: walls (densified into scatterer points) around a survey area,
* trajectory: a closed survey loop at fixed depth (re-visits its start),
* sonar: polar intensity frames rendered by splatting visible scatterers
  over an exponential speckle floor,
* DVL body velocities, IMU orientations, pressure depth at realistic rates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from slam_bench.reference.slam.sonar import SonarGeometry


@dataclass(frozen=True)
class SimConfig:
    duration: float = 240.0  # seconds
    speed: float = 0.4  # m/s along track
    depth: float = 2.0
    imu_rate: float = 50.0
    dvl_rate: float = 5.0
    depth_rate: float = 4.0
    sonar_rate: float = 2.0
    gyro_rate: float = 50.0  # FOG delta-angle rate (real sensor: 250 Hz)
    gyro_noise: float = 2e-5  # delta-angle noise per sample (rad)
    num_ranges: int = 256
    num_bearings: int = 128
    max_range: float = 30.0
    loop_radius: float = 18.0  # survey loop radius (closes on itself)
    noise_floor: float = 10.0  # exponential speckle scale
    target_intensity: float = 220.0
    dvl_noise: float = 0.02
    dvl_scale_bias: float = 0.01  # per-run multiplicative velocity bias (~1%)
    imu_yaw_noise: float = 0.002
    imu_yaw_drift: float = 0.00005  # rad/s random-walk yaw bias (heading drift)
    wall_point_spacing: float = 0.25
    seed: int = 0
    # constant crab (sideslip) angle between heading and track tangent —
    # gives the DVL a persistent lateral velocity component so its y-axis
    # scale bias is observable (see _trajectory). Measured: 4 deg leaves
    # accuracy unchanged (5.7 vs 6.4 cm small-config ATE); 8 deg degrades
    # revisit co-visibility enough to bias loop registrations.
    crab_deg: float = 4.0
    # multi-robot support: trajectory phase offset around the survey loop
    # (radians) and an optional separate world seed so two robots with
    # different sensor-noise seeds survey the SAME structure
    phase: float = 0.0
    world_seed: int | None = None
    # pulse/beam rendering: each return is splatted as a separable Gaussian
    # envelope across range bins (transmit pulse length) and bearing columns
    # (beam pattern), centered at the CONTINUOUS (range, bearing) of the
    # scatterer. Real sonar returns span several cells; rounding to cell
    # centers (the round-1 renderer) destroys sub-bin information that the
    # frontend's peak interpolation recovers on real data. Set
    # pulse_sigma_bins=0 for the legacy nearest-cell renderer.
    pulse_sigma_bins: float = 0.7  # range envelope sigma, in range bins
    beam_sigma_bins: float = 0.6  # beam pattern sigma, in bearing columns
    # dual-sonar: render a vertical (M1200d-style) fan imaging the seafloor
    vertical_sonar: bool = False
    seafloor_depth: float = 6.0  # meters below the vehicle plane
    vertical_aperture_deg: float = 24.0
    # downward mount tilt of the vertical fan. Without it a +-12 deg fan
    # about horizontal cannot see a 6 m-deep floor inside 30 m of range
    # (needs rho = z/sin(phi) > 28 m) — real vertical-sonar rigs angle the
    # fan down at the volume of interest.
    vertical_tilt_deg: float = 20.0


class SyntheticBag(NamedTuple):
    # sensor streams (time-sorted)
    imu_time: np.ndarray  # (Ti,)
    imu_rpy: np.ndarray  # (Ti, 3)
    dvl_time: np.ndarray  # (Td,)
    dvl_vel: np.ndarray  # (Td, 3) body-frame
    depth_time: np.ndarray  # (Tp,)
    depth: np.ndarray  # (Tp,)
    ping_time: np.ndarray  # (Ts,)
    ping_images: np.ndarray  # (Ts, R, C) float32
    # ground truth
    true_pose_at_ping: np.ndarray  # (Ts, 3) (x, y, yaw)
    geometry: SonarGeometry
    world_points: np.ndarray  # (W, 2) structure scatterers
    # optional dual-sonar payload
    vertical_images: np.ndarray | None = None  # (Ts, R, Cv)
    vertical_geometry: "SonarGeometry | None" = None
    # optional FOG stream
    gyro_time: np.ndarray | None = None  # (Tg,)
    gyro_delta: np.ndarray | None = None  # (Tg, 3) delta angles (y, p, r)
    # injected per-axis DVL multiplicative bias (x, y, z) — ground truth for
    # the online scale-calibration accuracy metric
    true_dvl_scale: np.ndarray | None = None  # (3,)


def seafloor_z(cfg: SimConfig, x, y):
    """Ground-truth seafloor height below the vehicle plane at (x, y) — the
    profile the vertical sonar images (see simulate_bag); the dual-sonar
    z-accuracy benchmark compares fused 3-D points against it."""
    return cfg.seafloor_depth + 0.8 * np.sin(0.21 * x) + 0.5 * np.cos(0.17 * y)


def _make_world(cfg: SimConfig, rng) -> np.ndarray:
    """Textured basin walls + pillars + rock scatter, densified to points.

    Long featureless straight walls make scan matching translation-ambiguous
    (ICP slides along the wall), which no SLAM system can fix — real sonar
    environments have corrugation and debris. Walls here get sinusoidal
    relief plus random rock clusters so registration is observable.
    """
    L = cfg.loop_radius + cfg.max_range * 0.8
    segs = [
        ((-L, -L), (L, -L)),
        ((L, -L), (L, L)),
        ((L, L), (-L, L)),
        ((-L, L), (-L, -L)),
    ]
    # interior pillars / rock piles for distinctive features
    for cx, cy, r in [(-8, 6, 2.0), (10, -4, 1.5), (2, 14, 2.5), (-12, -10, 1.8)]:
        t = np.linspace(0, 2 * np.pi, max(8, int(2 * np.pi * r / cfg.wall_point_spacing)))
        pts = np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], -1)
        segs.extend([(tuple(pts[i]), tuple(pts[i + 1])) for i in range(len(pts) - 1)])
    out = []
    for (x0, y0), (x1, y1) in segs:
        seg_len = np.hypot(x1 - x0, y1 - y0)
        n = max(2, int(seg_len / cfg.wall_point_spacing))
        t = np.linspace(0, 1, n)
        base = np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], -1)
        # sinusoidal relief along the wall normal (multi-scale corrugation)
        tang = np.array([x1 - x0, y1 - y0]) / max(seg_len, 1e-9)
        normal = np.array([-tang[1], tang[0]])
        arc = t * seg_len
        relief = (0.35 * np.sin(2 * np.pi * arc / 7.3)
                  + 0.18 * np.sin(2 * np.pi * arc / 2.9 + 1.0))
        out.append(base + relief[:, None] * normal[None, :])
        # rock clusters every ~8 m in front of long walls
        if seg_len > 20:
            for a in np.arange(4.0, seg_len - 4.0, 8.0):
                cx, cy = base[int(a / seg_len * (n - 1))] + normal * rng.uniform(1.0, 3.5)
                rr = rng.uniform(0.3, 0.9)
                k = max(6, int(2 * np.pi * rr / cfg.wall_point_spacing))
                th = np.linspace(0, 2 * np.pi, k)
                out.append(np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], -1))
    pts = np.concatenate(out)
    jitter = rng.normal(scale=0.02, size=pts.shape)
    return (pts + jitter).astype(np.float32)


def _trajectory(cfg: SimConfig, t: np.ndarray):
    """Closed loop (slightly squashed circle) traversed at constant speed.
    Returns (xy (T, 2), yaw (T,), body_vel (T, 3)).

    The heading holds a constant crab (sideslip) angle off the track tangent
    — real ROV surveys never move purely along body-x (currents, thruster
    asymmetry), and without lateral body velocity the DVL's y-axis scale
    bias would be both unobservable and harmless (it multiplies zero)."""
    theta = cfg.phase + (cfg.speed / cfg.loop_radius) * t
    x = cfg.loop_radius * np.cos(theta)
    y = cfg.loop_radius * 0.8 * np.sin(theta)
    dx = -cfg.loop_radius * np.sin(theta) * (cfg.speed / cfg.loop_radius)
    dy = cfg.loop_radius * 0.8 * np.cos(theta) * (cfg.speed / cfg.loop_radius)
    yaw = np.arctan2(dy, dx) - np.radians(cfg.crab_deg)
    # body-frame velocity (x fwd, y starboard): world vel rotated by -yaw
    c, s = np.cos(yaw), np.sin(yaw)
    vb_x = c * dx + s * dy
    vb_y = -s * dx + c * dy
    vel = np.stack([vb_x, vb_y, np.zeros_like(vb_x)], -1)
    return np.stack([x, y], -1), yaw, vel


def render_ping(
    pose: np.ndarray,  # (3,) x, y, yaw
    world: np.ndarray,  # (W, 2)
    geom: SonarGeometry,
    rng,
    noise_floor: float,
    target_intensity: float,
    pulse_sigma_bins: float = 0.7,
    beam_sigma_bins: float = 0.6,
) -> np.ndarray:
    """Render one polar frame: exponential speckle + scatterer returns.

    Each return is a separable Gaussian splat centered at the scatterer's
    CONTINUOUS (fractional) range row / bearing column — the transmit-pulse
    envelope along range and the beam pattern across bearings. This is the
    physically faithful model (real Oculus pings spread returns over several
    cells); the round-1 renderer rounded to the nearest cell, which baked a
    ±half-bin uniform quantization error into the data itself
    (range bin = max_range/num_ranges, bearing bin ~0.5 deg -> ~9 cm
    cross-range at 10 m) that no frontend could recover.
    With ``pulse_sigma_bins == 0`` the legacy nearest-cell path is used.
    """
    img = rng.exponential(scale=noise_floor, size=(geom.num_ranges, geom.num_bearings))
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rel = world - pose[:2]
    lx = c * rel[:, 0] + s * rel[:, 1]
    ly = -s * rel[:, 0] + c * rel[:, 1]
    rng_m = np.hypot(lx, ly)
    brg = np.arctan2(ly, lx)
    vis = (
        (rng_m > 0.5)
        & (rng_m < geom.max_range * 0.98)
        & (brg > geom.bearings[0])
        & (brg < geom.bearings[-1])
    )
    # continuous (row, col) image coordinates of each return
    fr = rng_m[vis] / geom.range_resolution - 1
    fc = np.interp(brg[vis], geom.bearings, np.arange(geom.num_bearings))
    intensity = target_intensity * (1.0 - 0.5 * rng_m[vis] / geom.max_range)
    if pulse_sigma_bins <= 0:
        rr = np.clip(np.round(fr).astype(int), 0, geom.num_ranges - 1)
        cc = np.clip(np.round(fc).astype(int), 0, geom.num_bearings - 1)
        np.maximum.at(img, (rr, cc), intensity)
        img[1:] = np.maximum(img[1:], 0.6 * img[:-1])
        return np.clip(img, 0, 255).astype(np.float32)
    # separable Gaussian splat over a (2*hr+1) x (2*hc+1) stencil
    hr = max(1, int(np.ceil(2.5 * pulse_sigma_bins)))
    hc = max(1, int(np.ceil(2.5 * beam_sigma_bins)))
    r0 = np.round(fr).astype(int)
    c0 = np.round(fc).astype(int)
    for dr in range(-hr, hr + 1):
        wr = np.exp(-0.5 * ((r0 + dr - fr) / pulse_sigma_bins) ** 2)
        rr = np.clip(r0 + dr, 0, geom.num_ranges - 1)
        for dc in range(-hc, hc + 1):
            wc = np.exp(-0.5 * ((c0 + dc - fc) / beam_sigma_bins) ** 2)
            cc = np.clip(c0 + dc, 0, geom.num_bearings - 1)
            np.maximum.at(img, (rr, cc), intensity * wr * wc)
    return np.clip(img, 0, 255).astype(np.float32)


def _render_vertical(pose, geom, floor_z, rng, cfg):
    """Vertical-fan frame: each elevation beam hits the seafloor at range
    z_floor / sin(phi) (downward beams only), plus speckle noise."""
    img = rng.exponential(scale=cfg.noise_floor,
                          size=(geom.num_ranges, geom.num_bearings))
    # sample the floor along the beam footprint ahead of the vehicle
    for c, phi in enumerate(geom.bearings):
        if phi <= 0.02:  # up/level beams see nothing
            continue
        # iterate the ray/floor fixed point: range depends on floor height
        # at the horizontal footprint distance. The contraction ratio is
        # ~slope/tan(phi) (up to ~0.4 at shallow beams) — 2 iterations left
        # the rendered band up to ~0.2 m off the analytic floor, a floor on
        # any fusion accuracy metric; 6 converges to millimeters.
        r = cfg.seafloor_depth / np.sin(phi)
        for _ in range(6):
            dx = r * np.cos(phi)
            fx = pose[0] + dx * np.cos(pose[2])
            fy = pose[1] + dx * np.sin(pose[2])
            z = floor_z(fx, fy)
            r = z / np.sin(phi)
        if 0.5 < r < geom.max_range * 0.98:
            row = int(round(r / geom.range_resolution - 1))
            img[max(row - 1, 0) : row + 2, c] = cfg.target_intensity
    img[1:] = np.maximum(img[1:], 0.6 * img[:-1])
    return np.clip(img, 0, 255).astype(np.float32)


def simulate_bag(cfg: SimConfig = SimConfig()) -> SyntheticBag:
    rng = np.random.default_rng(cfg.seed)
    world_rng = (rng if cfg.world_seed is None
                 else np.random.default_rng(cfg.world_seed))
    world = _make_world(cfg, world_rng)
    geom = SonarGeometry.make(
        num_ranges=cfg.num_ranges,
        num_bearings=cfg.num_bearings,
        max_range=cfg.max_range,
    )

    imu_t = np.arange(0, cfg.duration, 1 / cfg.imu_rate)
    dvl_t = np.arange(0.013, cfg.duration, 1 / cfg.dvl_rate)
    dep_t = np.arange(0.007, cfg.duration, 1 / cfg.depth_rate)
    png_t = np.arange(0.5, cfg.duration, 1 / cfg.sonar_rate)

    _, yaw_imu, _ = _trajectory(cfg, imu_t)
    yaw_bias = np.cumsum(
        rng.normal(scale=cfg.imu_yaw_drift / np.sqrt(cfg.imu_rate),
                   size=yaw_imu.shape)
    )
    imu_rpy = np.stack(
        [
            np.zeros_like(yaw_imu),
            np.zeros_like(yaw_imu),
            yaw_imu + yaw_bias
            + rng.normal(scale=cfg.imu_yaw_noise, size=yaw_imu.shape),
        ],
        -1,
    )

    _, _, vel_dvl = _trajectory(cfg, dvl_t)
    scale_bias = 1.0 + rng.normal(scale=cfg.dvl_scale_bias, size=(1, 3))
    vel_dvl = vel_dvl * scale_bias + rng.normal(
        scale=cfg.dvl_noise, size=vel_dvl.shape
    )

    depth = np.full_like(dep_t, cfg.depth) + rng.normal(scale=0.01, size=dep_t.shape)

    # FOG delta angles: successive differences of the true yaw + noise
    gyr_t = np.arange(0.003, cfg.duration, 1 / cfg.gyro_rate)
    _, yaw_g, _ = _trajectory(cfg, gyr_t)
    d_yaw = np.diff(np.unwrap(yaw_g), prepend=yaw_g[0])
    gyro_delta = np.stack(
        [d_yaw, np.zeros_like(d_yaw), np.zeros_like(d_yaw)], -1
    ) + rng.normal(scale=cfg.gyro_noise, size=(len(gyr_t), 3))

    xy_png, yaw_png, _ = _trajectory(cfg, png_t)
    true_poses = np.concatenate([xy_png, yaw_png[:, None]], -1)

    vert_imgs = None
    vert_geom = None
    if cfg.vertical_sonar:
        vert_geom = SonarGeometry.make(
            num_ranges=cfg.num_ranges,
            num_bearings=max(cfg.num_bearings // 2, 32),
            max_range=cfg.max_range,
            horizontal_aperture=float(np.radians(cfg.vertical_aperture_deg)),
            model="M1200d",
            mode=2,
        )
        # apply the downward mount tilt: the fan's "bearings" are elevations
        # below horizontal after mounting; the fusion geometry sees the same
        # tilted table, so the tilt flows through vertical_cell_xz untouched
        vert_geom = SonarGeometry(
            num_ranges=vert_geom.num_ranges,
            num_bearings=vert_geom.num_bearings,
            range_resolution=vert_geom.range_resolution,
            bearings=(vert_geom.bearings
                      + np.radians(cfg.vertical_tilt_deg)).astype(np.float32),
            model=vert_geom.model,
            vertical_aperture=vert_geom.vertical_aperture,
        )
        # seafloor profile: gentle height variation over (x, y)
        def floor_z(x, y):
            return seafloor_z(cfg, x, y)

        vert_imgs = np.stack(
            [
                _render_vertical(p, vert_geom, floor_z, rng, cfg)
                for p in true_poses
            ]
        )
    # express ground truth relative to the start pose (SLAM frame convention:
    # first keyframe anchored near origin with yaw zeroed, slam_ros/DR yaw0)
    imgs = np.stack(
        [
            render_ping(p, world, geom, rng, cfg.noise_floor,
                        cfg.target_intensity, cfg.pulse_sigma_bins,
                        cfg.beam_sigma_bins)
            for p in true_poses
        ]
    )

    return SyntheticBag(
        imu_time=imu_t.astype(np.float32),
        imu_rpy=imu_rpy.astype(np.float32),
        dvl_time=dvl_t.astype(np.float32),
        dvl_vel=vel_dvl.astype(np.float32),
        depth_time=dep_t.astype(np.float32),
        depth=depth.astype(np.float32),
        gyro_time=gyr_t.astype(np.float32),
        gyro_delta=gyro_delta.astype(np.float32),
        ping_time=png_t.astype(np.float32),
        ping_images=imgs,
        vertical_images=vert_imgs,
        vertical_geometry=vert_geom,
        true_pose_at_ping=true_poses.astype(np.float32),
        geometry=geom,
        world_points=world,
        true_dvl_scale=scale_bias[0].astype(np.float32),
    )
