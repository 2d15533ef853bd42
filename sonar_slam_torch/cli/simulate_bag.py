"""Write a synthetic survey as an .npz bundle for ``cli.replay``.

Counterpart of ``scripts/simulate_bag.py``, on the port's simulator (which
gives the JAX package's arrays for the same configuration).

Usage: python -m sonar_slam_torch.cli.simulate_bag --out survey.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.simulate import SimConfig, SyntheticBag, simulate_bag


def write_bundle(path: str, bag: SyntheticBag, compressed: bool = True) -> None:
    """Write ``bag`` in the bundle layout ``cli.replay.load_npz_bag`` reads:
    the sensor streams, the gyro stream, the pings, the true pose at each
    ping, the world points and the sonar geometry. ``compressed=False``
    stores the arrays as they are (a full-size survey's 1.3 GB of pings
    write and read in seconds that way)."""
    out_dir = os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    save = np.savez_compressed if compressed else np.savez
    with open(path, "wb") as f:
        save(
            f,
            imu_time=bag.imu_time, imu_rpy=bag.imu_rpy,
            dvl_time=bag.dvl_time, dvl_vel=bag.dvl_vel,
            depth_time=bag.depth_time, depth=bag.depth,
            gyro_time=bag.gyro_time, gyro_delta=bag.gyro_delta,
            ping_time=bag.ping_time, ping_images=bag.ping_images,
            true_pose_at_ping=bag.true_pose_at_ping,
            world_points=bag.world_points,
            num_ranges=bag.geometry.num_ranges,
            num_bearings=bag.geometry.num_bearings,
            range_resolution=bag.geometry.range_resolution,
            bearings=bag.geometry.bearings,
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="survey.npz")
    ap.add_argument("--duration", type=float, default=240.0)
    ap.add_argument("--speed", type=float, default=0.4)
    ap.add_argument("--sonar-rate", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    bag = simulate_bag(SimConfig(duration=args.duration, speed=args.speed,
                                 sonar_rate=args.sonar_rate, seed=args.seed))
    write_bundle(args.out, bag)
    print(f"wrote {args.out}: {len(bag.ping_time)} pings over {args.duration}s")


if __name__ == "__main__":
    main()
