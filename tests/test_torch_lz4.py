"""The port's pure-Python LZ4 codec (``io/lz4.py``): the cases of
``tests/test_lz4.py`` but the native one, and the port's frames against the
JAX package's, byte for byte."""

import numpy as np
import pytest

import sonar_slam_tpu.io.lz4 as jlz4
from sonar_slam_torch.io.lz4 import (
    compress_block,
    compress_frame,
    decompress_block,
    decompress_frame,
    xxh32,
)
from tests.test_rosbag import DVL_DEF, ser_dvl


def test_xxh32_reference_vectors():
    assert xxh32(b"") == 0x02CC5D05
    assert xxh32(b"abc") == xxh32(b"abc")
    assert xxh32(b"abc") != xxh32(b"abd")
    assert xxh32(b"abc", seed=1) != xxh32(b"abc", seed=0)
    data = np.random.default_rng(4).integers(0, 256, 10000, np.uint8).tobytes()
    assert xxh32(data) == jlz4.xxh32(data)
    assert xxh32(data, seed=7) == jlz4.xxh32(data, seed=7)


@pytest.mark.parametrize("case", [
    b"",
    b"a",
    b"hello world",
    b"aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    b"abcabcabcabcabcabcabcabcabcabcabcabc" * 10,
    bytes(range(256)) * 5,
    b"\x00" * 100000,
])
def test_block_roundtrip(case):
    comp = compress_block(case)
    assert decompress_block(comp) == case
    assert comp == jlz4.compress_block(case)


def test_block_roundtrip_random():
    rng = np.random.default_rng(0)
    for n in (1, 13, 100, 5000, 70000):
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert decompress_block(compress_block(raw)) == raw
        rep = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        assert decompress_block(compress_block(rep)) == rep
        assert decompress_block(jlz4.compress_block(rep), n) == rep


def test_frame_roundtrip_multiblock():
    rng = np.random.default_rng(1)
    raw = (b"sonar" * 20000
           + rng.integers(0, 256, 70000, dtype=np.uint8).tobytes())
    frame = compress_frame(raw)
    assert decompress_frame(frame) == raw
    assert len(frame) < len(raw)
    assert frame == jlz4.compress_frame(raw)
    assert decompress_frame(jlz4.compress_frame(raw)) == raw


def test_frame_content_checksum_detects_corruption():
    raw = b"payload" * 1000
    frame = bytearray(compress_frame(raw))
    with pytest.raises(Exception):
        bad = bytearray(frame)
        bad[20] ^= 0xFF
        out = decompress_frame(bytes(bad))
        if out != raw:
            raise AssertionError("corruption not detected")


def test_lz4_bag_roundtrip(tmp_path):
    from sonar_slam_torch.io.rosbag import read_bag, write_bag

    path = str(tmp_path / "lz4.bag")
    conns = [{"id": 0, "topic": "/rti/body_velocity/raw",
              "type": "rti_dvl/DVL", "definition": DVL_DEF}]
    msgs = [(0, 10.0 + 0.2 * i, ser_dvl(i, 10.0 + 0.2 * i, 0.3, 0.01, 0.0, 5.0))
            for i in range(50)]
    write_bag(path, conns, msgs, compression="lz4")
    out = list(read_bag(path))
    assert len(out) == 50
    assert out[0][2]["velocity"]["x"] == np.float32(0.3)
    np.testing.assert_allclose(out[-1][1], 10.0 + 0.2 * 49, atol=1e-6)


def test_bz2_bag_writer_roundtrip(tmp_path):
    from sonar_slam_torch.io.rosbag import read_bag, write_bag

    path = str(tmp_path / "bz2w.bag")
    conns = [{"id": 0, "topic": "/rti/body_velocity/raw",
              "type": "rti_dvl/DVL", "definition": DVL_DEF}]
    msgs = [(0, 5.0, ser_dvl(0, 5.0, 0.1, 0.0, 0.0, 3.0))]
    write_bag(path, conns, msgs, compression="bz2")
    out = list(read_bag(path))
    assert len(out) == 1 and out[0][2]["altitude"] == np.float32(3.0)
