"""Convert a BlueROV ROS1 bag into the .npz bundle ``cli.replay`` reads.

Counterpart of ``scripts/convert_bag.py``: the port's ROS-free bag reader
(``io.rosbag``) decodes the raw sensor topics, the OculusPing images are
reassembled (raw 8- or 16-bit, or PNG/JPEG-compressed through PIL, which is
imported only for compressed pings) and the fire message's gamma
compression is undone. The 8-bit gamma table is built in float64 and cast to
float32, as the JAX script's native table is, so the bundles are equal.

Usage: python -m sonar_slam_torch.cli.convert_bag input.bag --out survey.npz
"""

from __future__ import annotations

import argparse
import io as _io
import os
import sys

import numpy as np

from ..io.rosbag import bag_to_streams
from ..slam.sonar import SonarGeometry


def gamma_table(gamma: float) -> np.ndarray:
    """The 256-entry decompression table clip(pow(v/255, 255/gamma) * 255,
    0, 255), computed in float64 and cast to float32."""
    x = np.power(np.arange(256, dtype=np.float64) / 255.0, 255.0 / gamma) * 255.0
    return np.clip(x, 0.0, 255.0).astype(np.float32)


def gamma_decompress(img_u8: np.ndarray, gamma: float) -> np.ndarray:
    """Undo the sonar's gamma on uint8 pixels: float32, through the table."""
    return gamma_table(float(gamma))[np.asarray(img_u8, np.uint8)]


def _gamma_decompress_float(x255: np.ndarray, gamma: float) -> np.ndarray:
    """The float-domain form of the table: clip(pow(x/255, 255/gamma) * 255),
    for 16-bit payloads, whose 65536 levels do not fit a 256-entry table."""
    out = np.power(np.clip(x255, 0.0, 255.0) / 255.0, 255.0 / gamma) * 255.0
    return np.clip(out, 0.0, 255.0).astype(np.float32)


def decode_ping_image(ping: dict, gamma_decompress=gamma_decompress) -> np.ndarray | None:
    """OculusPing dict -> (R, C) float32 polar image, or None if it does not
    decode.

    16-bit payloads (fire-message flag bit 0x02, or a mono16/16UC1 Image
    encoding) are read as little-endian uint16 and scaled to the 8-bit
    intensity domain (/257) before the gamma decompression, so later stages
    see the same scale whatever the wire depth."""
    img_msg = ping.get("ping")
    if not (isinstance(img_msg, dict) and "data" in img_msg):
        return None
    data = np.asarray(img_msg["data"], np.uint8)
    h = int(img_msg.get("height", 0))
    w = int(img_msg.get("width", 0))
    fmt = img_msg.get("format", "")
    flags = int(ping.get("fire_msg", {}).get("flags", 0))
    enc = str(img_msg.get("encoding", "")).lower()
    is16 = bool(flags & 0x02) or enc in ("mono16", "16uc1")
    img16 = None
    if fmt or h == 0:  # CompressedImage (jpeg/png)
        try:
            from PIL import Image

            im = Image.open(_io.BytesIO(data.tobytes()))
            if im.mode in ("I;16", "I;16B", "I"):  # 16-bit png
                img16 = np.asarray(im, np.uint16 if "16" in im.mode
                                   else np.int32).astype(np.uint16)
            else:
                img = np.asarray(im.convert("L"), np.uint8)
        except (ImportError, OSError, ValueError):
            return None
    elif is16:
        if data.size != 2 * h * w:
            return None
        img16 = data.view("<u2").reshape(h, w)
    else:
        if data.size != h * w:
            return None
        img = data.reshape(h, w)
    gamma = float(ping.get("fire_msg", {}).get("gamma", 0)) or 255.0
    if img16 is not None:
        return _gamma_decompress_float(img16.astype(np.float32) / 257.0, gamma)
    return gamma_decompress(img, gamma)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bag")
    ap.add_argument("--out", default=None)
    ap.add_argument("--imu-version", type=int, default=1)
    args = ap.parse_args(argv)

    streams, pings = bag_to_streams(args.bag, imu_version=args.imu_version)
    if not pings:
        sys.exit("no sonar pings found in bag")

    # geometry from the first ping (bearings in hundredths of a degree)
    first = pings[0]
    bearings = np.radians(np.asarray(first["bearings"], np.float32) / 100.0)
    geom = SonarGeometry(
        num_ranges=int(first["num_ranges"]),
        num_bearings=len(bearings),
        range_resolution=float(first["range_resolution"]),
        bearings=bearings,
    )

    times, imgs = [], []
    skipped = 0
    for p in pings:
        img = decode_ping_image(p)
        if img is None or img.shape != (geom.num_ranges, geom.num_bearings):
            skipped += 1
            continue
        times.append(p.get("header", {}).get("stamp", p["_t"]))
        imgs.append(img.astype(np.float32))
    if not imgs:
        sys.exit("no decodable ping images (compressed without PIL support?)")
    print(f"{len(imgs)} pings decoded ({skipped} skipped)")

    t0 = min(
        streams.imu_time.min() if len(streams.imu_time) else np.inf,
        streams.dvl_time.min() if len(streams.dvl_time) else np.inf,
        min(times),
    )
    out = args.out or os.path.splitext(args.bag)[0] + ".npz"
    with open(out, "wb") as f:
        np.savez_compressed(
            f,
            imu_time=(streams.imu_time - t0).astype(np.float32),
            imu_rpy=streams.imu_rpy,
            dvl_time=(streams.dvl_time - t0).astype(np.float32),
            dvl_vel=streams.dvl_vel,
            depth_time=(streams.depth_time - t0).astype(np.float32),
            depth=streams.depth,
            ping_time=(np.asarray(times) - t0).astype(np.float32),
            ping_images=np.stack(imgs),
            true_pose_at_ping=np.zeros((len(imgs), 3), np.float32),  # unknown
            world_points=np.zeros((0, 2), np.float32),
            num_ranges=geom.num_ranges,
            num_bearings=geom.num_bearings,
            range_resolution=geom.range_resolution,
            bearings=geom.bearings,
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
