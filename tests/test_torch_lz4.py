"""The port's LZ4 codec (``io/lz4.py``): the cases of ``tests/test_lz4.py``
but the native one, the port's frames against the JAX package's byte for
byte, and the compiled decoder and XXH32 (``io/lz4_lib.py``, built with the
host C++ compiler) against the port's plain versions and against the JAX
package's ``io.lz4``, both its Python path and its native path (called from
here only), on seeded frames: long literal and match runs, overlapping
matches, every descriptor flag the reader accepts, legacy frames, and
truncated and corrupt input, which every decoder refuses with ValueError."""

import os
import struct

import numpy as np
import pytest

import sonar_slam_tpu.io.lz4 as jlz4
from sonar_slam_torch.io import lz4_lib
from sonar_slam_torch.io.lz4 import (
    compress_block,
    compress_frame,
    decompress_block,
    decompress_block_plain,
    decompress_frame,
    decompress_frame_plain,
    xxh32,
    xxh32_plain,
)
from tests.test_rosbag import DVL_DEF, ser_dvl

MAGIC = struct.pack("<I", 0x184D2204)
LEGACY = struct.pack("<I", 0x184C2102)


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


# ----------------------------------------------------------------------
# the compiled decoder and XXH32
# ----------------------------------------------------------------------


def _native():
    rt = jlz4._native_runtime()
    assert rt is not None, "the JAX package's native runtime did not build"
    return rt


def _payloads():
    """Seeded inputs whose blocks hold long literal runs and long matches
    (length bytes of 255), and overlapping matches of periods 1 to 40."""
    rng = np.random.default_rng(8)
    noise = rng.integers(0, 256, 3000, np.uint8).tobytes()
    out = {
        "long literals": noise,
        "long match": b"\x00" * 5000,
        "literals then matches": noise[:700] + b"abc" * 900 + noise[700:900],
    }
    for period in (1, 2, 3, 5, 7, 15, 16, 17, 31, 32, 33, 40):
        pattern = rng.integers(0, 256, period, np.uint8).tobytes()
        out[f"period {period}"] = (noise[:50] + pattern * (1200 // period)
                                   + noise[50:90])
    sonar = rng.integers(0, 256, 60000, np.uint8)
    sonar[rng.random(60000) < 0.9] = 0
    out["sonar-like"] = sonar.tobytes()
    return out


PAYLOADS = _payloads()


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_compiled_block_decoder_matches_every_decoder(name):
    raw = PAYLOADS[name]
    block = compress_block(raw)
    assert block == jlz4.compress_block(raw)
    if name.startswith("long"):
        assert b"\xff\xff" in block  # length bytes of 255
    got = decompress_block(block, len(raw))
    assert got == lz4_lib.decode_block(block, len(raw)) == raw
    assert decompress_block_plain(block) == raw
    assert decompress_block_plain(block, len(raw)) == raw
    assert jlz4.decompress_block(block) == raw  # its Python path
    assert _native().lz4_decompress_block(block, len(raw)) == raw
    # a capacity one byte short is an overflow in every decoder
    for decode in (lambda b: decompress_block(b, len(raw) - 1),
                   lambda b: decompress_block_plain(b, len(raw) - 1),
                   lambda b: _native().lz4_decompress_block(b, len(raw) - 1)):
        with pytest.raises(ValueError):
            decode(block)


def _frame(blocks, flg_extra=0, bd_code=4, content=None, checksum=True,
           block_checksums=False, content_size=False, dict_id=False):
    """An LZ4 frame of (payload, stored raw) blocks with the descriptor's
    flags set as asked."""
    flg = (1 << 6) | flg_extra
    flg |= (block_checksums << 4) | (content_size << 3) | (checksum << 2)
    flg |= int(dict_id)
    desc = bytes([flg, bd_code << 4])
    if content_size:
        desc += struct.pack("<Q", len(content))
    if dict_id:
        desc += struct.pack("<I", 12345)
    out = MAGIC + desc + bytes([(xxh32_plain(desc) >> 8) & 0xFF])
    for payload, raw in blocks:
        out += struct.pack("<I", len(payload) | (raw << 31)) + payload
        if block_checksums:
            out += struct.pack("<I", xxh32_plain(payload))
    out += struct.pack("<I", 0)
    if checksum:
        out += struct.pack("<I", xxh32_plain(content))
    return out


def _frame_cases():
    raw = b"".join(PAYLOADS[k] for k in sorted(PAYLOADS))
    pieces = [raw[i:i + 20000] for i in range(0, len(raw), 20000)]
    blocks = [(compress_block(p), False) for p in pieces]
    blocks[1] = (pieces[1], True)  # one block stored raw
    cases = {}
    for bd in (0, 4, 5, 6, 7):
        cases[f"block size code {bd}"] = (_frame(blocks, bd_code=bd,
                                                 content=raw), raw)
    for flag in ("block_checksums", "content_size", "dict_id"):
        cases[flag] = (_frame(blocks, content=raw, **{flag: True}), raw)
    cases["no content checksum"] = (_frame(blocks, content=raw,
                                           checksum=False), raw)
    cases["block independence"] = (_frame(blocks, flg_extra=1 << 5,
                                          content=raw), raw)
    cases["every flag"] = (_frame(blocks, flg_extra=1 << 5, content=raw,
                                  block_checksums=True, content_size=True,
                                  dict_id=True), raw)
    cases["empty"] = (_frame([], content=b""), b"")
    cases["writer's frame"] = (compress_frame(raw), raw)
    legacy = LEGACY + b"".join(struct.pack("<I", len(b)) + b
                               for b, _ in [(compress_block(p), False)
                                            for p in pieces])
    cases["legacy"] = (legacy, raw)
    cases["legacy, then a frame"] = (legacy + compress_frame(b"next"), raw)
    cases["frame, then bytes"] = (compress_frame(raw) + b"trailing", raw)
    return cases


FRAMES = _frame_cases()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_compiled_frame_decoder_matches_every_decoder(name):
    frame, raw = FRAMES[name]
    assert decompress_frame(frame) == raw
    assert lz4_lib.decode_frame(frame) == raw
    assert decompress_frame_plain(frame) == raw
    assert jlz4.decompress_frame(frame) == raw  # the native path's blocks


def _broken_blocks():
    """Malformed blocks, each with the JAX Python path's verdict: True
    where it raises ValueError (it raises IndexError on the others)."""
    ok = compress_block(PAYLOADS["literals then matches"])
    zero_offset = bytes([0x14]) + b"a" + b"\x00\x00"
    far_offset = bytes([0x14]) + b"a" + b"\x09\x00"
    return {
        "literals past the end": (ok[:40], True),
        "literal length cut": (bytes([0xF0, 255, 255]), False),
        "offset cut": (bytes([0x14]) + b"a" + b"\x01", False),
        "match length cut": (bytes([0x1F]) + b"a" + b"\x01\x00\xff", False),
        "zero offset": (zero_offset, True),
        "offset before the output": (far_offset, True),
        "cut inside a sequence": (ok[:-7], None),
    }


BROKEN = _broken_blocks()


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_malformed_blocks_raise_value_error_everywhere(name):
    block, jax_python_value_error = BROKEN[name]
    decoders = [lambda b: decompress_block(b, 1 << 16),
                lambda b: lz4_lib.decode_block(b, 1 << 16),
                decompress_block_plain,
                lambda b: decompress_block_plain(b, 1 << 16),
                lambda b: _native().lz4_decompress_block(b, 1 << 16)]
    if jax_python_value_error:
        decoders.append(jlz4.decompress_block)
    for decode in decoders:
        try:
            decode(block)
        except ValueError:
            continue
        # a cut that lands on a sequence boundary decodes a shorter output
        assert jax_python_value_error is None
        assert decode(block) == decompress_block_plain(block)
    if jax_python_value_error is not None:
        frame = _frame([(block, False)], checksum=False)
        for decode in (decompress_frame, decompress_frame_plain):
            with pytest.raises(ValueError):
                decode(frame)


@pytest.mark.parametrize("cut", [0, 3, 5, 7, 11, 30, -9, -5, -1])
def test_truncated_and_corrupt_frames_raise_value_error(cut):
    raw = PAYLOADS["sonar-like"]
    frame = compress_frame(raw)
    truncated = frame[:cut]
    for decode in (decompress_frame, decompress_frame_plain):
        with pytest.raises(ValueError):
            decode(truncated)
    corrupt = bytearray(frame)
    corrupt[-3] ^= 0x55  # the content checksum
    for decode in (decompress_frame, decompress_frame_plain):
        with pytest.raises(ValueError, match="checksum"):
            decode(bytes(corrupt))
    with pytest.raises(ValueError):
        decompress_frame(b"\x00\x01\x02\x03 not a frame")
    with pytest.raises(ValueError):
        decompress_frame(MAGIC + bytes([2 << 6, 4 << 4, 0]))  # version 2


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 31, 4096, 4097, 10003])
def test_compiled_xxh32_matches_every_implementation(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for seed in (0, 1, 0x9747B28C, 0xFFFFFFFF):
        want = xxh32_plain(data, seed)
        assert lz4_lib.xxh32(data, seed) == want
        assert xxh32(data, seed) == want
        assert jlz4.xxh32(data, seed) == want
        assert _native().xxh32(data, seed) == want


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                         monkeypatch):
    src = tmp_path / "lz4.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(lz4_lib, "_SRC", str(src))
    monkeypatch.setattr(lz4_lib, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="did not build") as info:
        lz4_lib.build()
    assert "error" in str(info.value)
    assert os.listdir(tmp_path / "build") == []


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_lz4.py prints the decoders' rates
    # on this host: chip_smoke.py phase 11's frames (8 pings a frame, as
    # rendered and gated at 65) of 64 pings of phase 4's configuration (a
    # 13 s survey at full width), through the port's compiled and plain
    # decoders and the JAX package's frame decoder on its native blocks
    import platform
    import time
    from dataclasses import replace

    import chip_smoke
    from sonar_slam_torch.io.simulate import simulate_bag

    sim = replace(chip_smoke.full_config(0)[0], duration=13.0)
    images = simulate_bag(sim).ping_images[:64]
    _native()
    quantized = chip_smoke.gamma_quantize(images)
    for label, raw in (("pings", quantized),
                       ("gated pings", np.where(images > 65.0, quantized, 0)
                        .astype(np.uint8))):
        chunks = [raw[i:i + 8].tobytes() for i in range(0, 64, 8)]
        frames = [compress_frame(c) for c in chunks]
        rates = {}
        for name, decode, reps in (("compiled", decompress_frame, 5),
                                   ("JAX native", jlz4.decompress_frame, 5),
                                   ("plain", decompress_frame_plain, 1)):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                assert [decode(f) for f in frames] == chunks
                best = min(best, time.perf_counter() - t0)
            rates[name] = raw.nbytes / best / 1e6
        print(f"{label} (ratio {raw.nbytes / sum(map(len, frames)):.2f}), "
              f"MB/s on this host ({platform.machine()}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
