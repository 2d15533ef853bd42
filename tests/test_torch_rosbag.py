"""The port's ROS bag reader (``io/rosbag.py``) and ``cli/convert_bag.py``
against the JAX package's.

The cases of ``tests/test_rosbag.py`` on the port (its slow end-to-end seam
case is ``test_convert_bag_seam`` here, without the replays, which
``tests/test_torch_cli.py`` and ``chip_smoke.py`` phase 11 run), and:

* the port's gamma table equals the native one the JAX script uses, for
  every gamma byte;
* a bag written by the JAX package's ``write_bag`` (lz4 chunk; PNG, raw
  8-bit and raw 16-bit pings) converts through the port's ``convert_bag``
  to a bundle array-equal, key for key, to the JAX ``scripts/convert_bag.py``'s.
"""

import io as _io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import sonar_slam_tpu.io.rosbag as jbag
from sonar_slam_torch.cli import convert_bag
from sonar_slam_torch.io.rosbag import (
    MAGIC,
    OP_BAG_HEADER,
    ROS_TOPICS,
    MessageType,
    _encode_header,
    _encode_record,
    bag_to_streams,
    read_bag,
    write_bag,
)
from sonar_slam_torch.io.dataset import SensorStreams
from sonar_slam_torch.slam.sonar import OculusFireMsg, SonarGeometry
from tests.test_rosbag import (
    DEPTH_DEF,
    DVL_DEF,
    IMU_FULL_DEF,
    OCULUS_PING_FULL_DEF,
    OCULUS_PING_RAW_DEF,
    PING_DEF,
    _gamma_compress,
    _ser_depth,
    _ser_imu,
    _ser_oculus_ping,
    _ser_oculus_ping_raw,
    ser_dvl,
    ser_header,
    ser_ping,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native():
    path = os.path.join(REPO, "native")
    if path not in sys.path:
        sys.path.insert(0, path)
    import runtime

    return runtime


def _jax_convert(bag_path, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convert_bag.py"),
         bag_path, "--out", out], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stderr + r.stdout


def test_message_type_parses_and_decodes():
    mt = MessageType("rti_dvl/DVL", DVL_DEF)
    raw = ser_dvl(7, 123.5, 0.1, -0.2, 0.05, 12.0)
    msg = mt.decode(raw)
    assert msg["header"]["seq"] == 7
    np.testing.assert_allclose(msg["header"]["stamp"], 123.5, atol=1e-6)
    np.testing.assert_allclose(
        [msg["velocity"]["x"], msg["velocity"]["y"], msg["velocity"]["z"]],
        [0.1, -0.2, 0.05])
    assert msg["altitude"] == 12.0
    assert msg == jbag.MessageType("rti_dvl/DVL", DVL_DEF).decode(raw)


def test_bag_roundtrip(tmp_path):
    path = str(tmp_path / "test.bag")
    conns = [
        {"id": 0, "topic": "/rti/body_velocity/raw", "type": "rti_dvl/DVL",
         "definition": DVL_DEF},
        {"id": 1, "topic": "/sonar_oculus_node/M750d/ping",
         "type": "sonar_oculus/OculusPing", "definition": PING_DEF},
    ]
    msgs = [
        (0, 10.0, ser_dvl(0, 10.0, 0.3, 0.0, 0.0, 5.0)),
        (1, 10.2, ser_ping(0, 10.2, 42, 0.06, 4, [-100, 0, 50, 100],
                           [1, 2, 3, 4, 250])),
        (0, 10.4, ser_dvl(1, 10.4, 0.31, 0.01, 0.0, 5.0)),
    ]
    write_bag(path, conns, msgs)
    out = list(read_bag(path))
    assert len(out) == 3
    topic0, t0, m0 = out[0]
    assert topic0 == "/rti/body_velocity/raw"
    np.testing.assert_allclose(t0, 10.0, atol=1e-6)
    assert m0["velocity"]["x"] == 0.3
    _, _, ping = out[1]
    assert ping["ping_id"] == 42
    np.testing.assert_array_equal(np.asarray(ping["bearings"]), [-100, 0, 50, 100])
    np.testing.assert_array_equal(np.asarray(ping["data"]), [1, 2, 3, 4, 250])
    # the JAX writer writes the same bytes, and its reader reads the same
    jpath = str(tmp_path / "jax.bag")
    jbag.write_bag(jpath, conns, msgs)
    assert open(jpath, "rb").read() == open(path, "rb").read()


def test_topic_filter(tmp_path):
    path = str(tmp_path / "f.bag")
    conns = [{"id": 0, "topic": "/a", "type": "rti_dvl/DVL", "definition": DVL_DEF},
             {"id": 1, "topic": "/b", "type": "rti_dvl/DVL", "definition": DVL_DEF}]
    msgs = [(0, 1.0, ser_dvl(0, 1.0, 0, 0, 0, 0)),
            (1, 2.0, ser_dvl(0, 2.0, 1, 1, 1, 0))]
    write_bag(path, conns, msgs)
    out = list(read_bag(path, topics={"/b"}))
    assert len(out) == 1 and out[0][0] == "/b"


def test_bag_to_streams(tmp_path):
    path = str(tmp_path / "s.bag")
    conns = [
        {"id": 0, "topic": ROS_TOPICS["imu"], "type": "sensor_msgs/Imu",
         "definition": IMU_FULL_DEF},
        {"id": 1, "topic": ROS_TOPICS["dvl"], "type": "rti_dvl/DVL",
         "definition": DVL_DEF},
        {"id": 2, "topic": ROS_TOPICS["depth"], "type": "bar30_depth/Depth",
         "definition": DEPTH_DEF},
        {"id": 3, "topic": ROS_TOPICS["sonar"], "type": "sonar_oculus/OculusPing",
         "definition": PING_DEF},
    ]
    msgs = [
        (0, 5.0, _ser_imu(0, 5.0, 0.5)),
        (1, 5.05, ser_dvl(0, 5.05, 0.4, 0, 0, 3.0)),
        (2, 5.02, _ser_depth(0, 5.02, 2.5)),
        (3, 5.1, ser_ping(0, 5.1, 0, 0.06, 4, [0, 1, 2, 3], [9, 9, 9])),
    ]
    write_bag(path, conns, msgs)
    streams, pings = bag_to_streams(path)
    assert isinstance(streams, SensorStreams)
    assert len(streams.imu_time) == 1
    np.testing.assert_allclose(streams.imu_rpy[0, 2], 0.5, atol=1e-6)
    np.testing.assert_allclose(streams.dvl_vel[0], [0.4, 0, 0], atol=1e-6)
    np.testing.assert_allclose(streams.depth[0], 2.5)
    assert len(pings) == 1 and pings[0]["ping_id"] == 0
    jstreams, jpings = jbag.bag_to_streams(path)
    for name in SensorStreams._fields:
        a, b = getattr(streams, name), getattr(jstreams, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name


def test_unchunked_records(tmp_path):
    path = str(tmp_path / "unchunked.bag")
    conn_header = {b"op": bytes([0x07]), b"conn": struct.pack("<I", 0),
                   b"topic": b"/a"}
    conn_payload = _encode_header({
        b"topic": b"/a", b"type": b"rti_dvl/DVL", b"md5sum": b"0" * 32,
        b"message_definition": DVL_DEF.encode(),
    })
    msg_header = {b"op": bytes([0x02]), b"conn": struct.pack("<I", 0),
                  b"time": struct.pack("<II", 3, 0)}
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_encode_record({b"op": bytes([OP_BAG_HEADER])}, b""))
        f.write(_encode_record(conn_header, conn_payload))
        f.write(_encode_record(msg_header, ser_dvl(0, 3.0, 0.1, 0.2, 0.0, 1.0)))
    out = list(read_bag(path))
    assert len(out) == 1
    assert out[0][2]["velocity"]["y"] == 0.2


def test_bz2_chunk(tmp_path):
    import bz2

    chunk = _encode_record(
        {b"op": bytes([0x07]), b"conn": struct.pack("<I", 0), b"topic": b"/a"},
        _encode_header({b"topic": b"/a", b"type": b"rti_dvl/DVL",
                        b"md5sum": b"0" * 32,
                        b"message_definition": DVL_DEF.encode()}),
    ) + _encode_record(
        {b"op": bytes([0x02]), b"conn": struct.pack("<I", 0),
         b"time": struct.pack("<II", 9, 0)},
        ser_dvl(0, 9.0, 0.5, 0.0, 0.0, 2.0),
    )
    path = str(tmp_path / "bz2.bag")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_encode_record(
            {b"op": bytes([0x05]), b"compression": b"bz2",
             b"size": struct.pack("<I", len(chunk))}, bz2.compress(chunk)))
    out = list(read_bag(path))
    assert len(out) == 1 and out[0][2]["velocity"]["x"] == 0.5


def test_gamma_table_matches_native():
    native = _native()
    levels = np.arange(256, dtype=np.uint8)
    for gamma in range(1, 256):
        np.testing.assert_array_equal(
            convert_bag.gamma_decompress(levels, gamma),
            native.gamma_decompress(levels, float(gamma)), err_msg=str(gamma))


def test_16bit_ping_bag_matches_8bit_quantized(tmp_path):
    native = _native()
    rng = np.random.default_rng(3)
    h, w, gamma, n_pings = 48, 24, 127, 3
    imgs16 = rng.integers(0, 65535, size=(n_pings, h, w), dtype=np.uint16)
    bearings_cdeg = np.linspace(-6000, 6000, w)
    conns = [{"id": 0, "topic": ROS_TOPICS["sonar"],
              "type": "sonar_oculus/OculusPing",
              "definition": OCULUS_PING_RAW_DEF}]
    msgs = [(0, 10.0 + k, _ser_oculus_ping_raw(
        k, 10.0 + k, gamma, 0x02, h, w, "mono16", 2,
        imgs16[k].astype("<u2").tobytes(), bearings_cdeg, 0.1, h))
        for k in range(n_pings)]
    bag_path = str(tmp_path / "ping16.bag")
    write_bag(bag_path, conns, msgs, compression="lz4")
    npz_path = str(tmp_path / "ping16.npz")
    convert_bag.main([bag_path, "--out", npz_path])
    got = np.load(npz_path)["ping_images"]
    assert got.shape == (n_pings, h, w)
    want = np.stack([convert_bag._gamma_decompress_float(
        im.astype(np.float32) / 257.0, gamma) for im in imgs16])
    np.testing.assert_array_equal(got, want)
    imgs8 = np.round(imgs16 / 257.0).astype(np.uint8)
    dec8 = np.stack([native.gamma_decompress(im, float(gamma)) for im in imgs8])
    assert np.max(np.abs(got - dec8)) < 2.5


def test_jpeg_ping_decodes():
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, size=(64, 32), dtype=np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    ping = {"ping": {"data": np.frombuffer(buf.getvalue(), np.uint8),
                     "format": "jpeg", "height": 0, "width": 0},
            "fire_msg": {"gamma": 255}}
    out = convert_bag.decode_ping_image(ping)
    assert out is not None and out.shape == (64, 32)
    assert np.mean(np.abs(out.astype(np.float64) - img)) < 6.0


def test_from_ping_geometry():
    ping = {"bearings": np.asarray([-6000, 0, 6000], np.int16),
            "num_ranges": 10, "range_resolution": 0.05, "part_number": 1042,
            "fire_msg": {"mode": 2, "gamma": 127, "flags": 0x03}}
    geom, fire = SonarGeometry.from_ping(ping)
    from sonar_slam_tpu.slam.sonar import SonarGeometry as JGeometry

    jgeom, jfire = JGeometry.from_ping(ping)
    assert fire == OculusFireMsg(*jfire) and fire.data_is_16bit
    np.testing.assert_array_equal(geom.bearings, jgeom.bearings)
    assert (geom.model, geom.vertical_aperture, geom.num_ranges) == (
        jgeom.model, jgeom.vertical_aperture, jgeom.num_ranges) == (
        "M1200d", float(np.deg2rad(12.0)), 10)


def test_convert_bag_seam(tmp_path):
    """A simulated survey in a genuine lz4 bag written by the JAX package
    (fire-message gamma; PNG, raw 8-bit and raw 16-bit pings): the port's
    convert_bag gives the JAX script's bundle, key for key, array-equal."""
    from PIL import Image

    from sonar_slam_torch.io.simulate import SimConfig, simulate_bag

    sim = SimConfig(duration=12.0, speed=0.5, sonar_rate=1.0, num_ranges=96,
                    num_bearings=48, loop_radius=8.0, imu_rate=10.0,
                    dvl_rate=4.0, depth_rate=2.0)
    bag = simulate_bag(sim)
    gamma = 127
    imgs_q = np.stack([_gamma_compress(im, gamma) for im in bag.ping_images])
    bearings_cdeg = np.round(np.degrees(bag.geometry.bearings) * 100)
    nr, nb = bag.geometry.num_ranges, bag.geometry.num_bearings
    res = bag.geometry.range_resolution
    for kind in ("png", "raw8", "raw16"):
        conns = [
            {"id": 0, "topic": ROS_TOPICS["imu"], "type": "sensor_msgs/Imu",
             "definition": IMU_FULL_DEF},
            {"id": 1, "topic": ROS_TOPICS["dvl"], "type": "rti_dvl/DVL",
             "definition": DVL_DEF},
            {"id": 2, "topic": ROS_TOPICS["depth"], "type": "bar30_depth/Depth",
             "definition": DEPTH_DEF},
            {"id": 3, "topic": ROS_TOPICS["sonar"],
             "type": "sonar_oculus/OculusPing",
             "definition": OCULUS_PING_FULL_DEF if kind == "png"
             else OCULUS_PING_RAW_DEF},
        ]
        msgs = [(0, float(t), _ser_imu(k, float(t), bag.imu_rpy[k, 2]))
                for k, t in enumerate(bag.imu_time)]
        msgs += [(1, float(t), ser_dvl(k, float(t), *map(float, bag.dvl_vel[k]), 5.0))
                 for k, t in enumerate(bag.dvl_time)]
        msgs += [(2, float(t), _ser_depth(k, float(t), float(bag.depth[k])))
                 for k, t in enumerate(bag.depth_time)]
        for k, t in enumerate(bag.ping_time):
            if kind == "png":
                buf = _io.BytesIO()
                Image.fromarray(imgs_q[k]).save(buf, format="PNG")
                payload = _ser_oculus_ping(k, float(t), gamma, buf.getvalue(),
                                           "png", bearings_cdeg, res, nr)
            elif kind == "raw8":
                payload = _ser_oculus_ping_raw(
                    k, float(t), gamma, 0, nr, nb, "mono8", 1,
                    imgs_q[k].tobytes(), bearings_cdeg, res, nr)
            else:
                payload = _ser_oculus_ping_raw(
                    k, float(t), gamma, 0x02, nr, nb, "mono16", 2,
                    (imgs_q[k].astype(np.uint16) * 257).astype("<u2").tobytes(),
                    bearings_cdeg, res, nr)
            msgs.append((3, float(t), payload))
        msgs.sort(key=lambda m: m[1])
        bag_path = str(tmp_path / f"seam_{kind}.bag")
        jbag.write_bag(bag_path, conns, msgs, compression="lz4")
        ours, theirs = (str(tmp_path / f"{kind}_{who}.npz")
                        for who in ("port", "jax"))
        convert_bag.main([bag_path, "--out", ours])
        _jax_convert(bag_path, theirs)
        a, b = np.load(ours), np.load(theirs)
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, (kind, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{kind} {key}")
        assert a["ping_images"].shape == (len(bag.ping_time), nr, nb)
