"""The compiled LZ4 decoder and XXH32 (``csrc/lz4.cpp``), for the host.

Counterpart of what the JAX package's native runtime gives its LZ4 codec
(``native/csrc/sonar_native.cpp``'s block decoder and XXH32): this package's
own copy, which decodes whole frames as well. The source is compiled at
first use with the host C++ compiler (``c++`` or ``g++`` on ``PATH``) into
``sonar_slam_torch/_build/``, under a name that hashes the source and the
flags, and loaded with ``ctypes``. If the compiler is missing or fails,
:func:`build` raises with its message; nothing falls back to Python.
Malformed input raises ``ValueError``.

:mod:`sonar_slam_torch.io.lz4` routes its decoders through these functions;
its ``*_plain`` functions are the pure-Python versions they are tested
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "lz4.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_ERRORS = {-1: "corrupt or truncated LZ4 data", -2: "not an LZ4 frame",
           -3: "unsupported LZ4 frame version",
           -4: "LZ4 content checksum mismatch"}

_lib = None


def _compiler() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path is not None:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the LZ4 "
                       "decoder cannot be built")


def build() -> str:
    """Compile ``csrc/lz4.cpp`` into a shared library (once per source
    content and flags) and return its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    out = os.path.join(_BUILD_DIR, f"liblz4_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"the LZ4 decoder did not build ({proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.lz4_block_decode.argtypes = [ctypes.c_char_p, i64, ptr, i64]
        lib.lz4_block_decode.restype = i64
        lib.lz4_frame_decode.argtypes = [ctypes.c_char_p, i64, ptr, i64]
        lib.lz4_frame_decode.restype = i64
        lib.lz4_xxh32.argtypes = [ctypes.c_char_p, i64, ctypes.c_uint32]
        lib.lz4_xxh32.restype = ctypes.c_uint32
        _lib = lib
    return _lib


def _check(n: int) -> int:
    if n < 0:
        raise ValueError(_ERRORS.get(n, f"LZ4 decoder error {n}"))
    return n


def decode_block(src: bytes, max_out: int) -> bytes:
    """Decode one raw LZ4 block whose output is at most ``max_out`` bytes."""
    src = bytes(src)
    buf = ctypes.create_string_buffer(max(int(max_out), 1))
    n = _check(_load().lz4_block_decode(src, len(src), buf, int(max_out)))
    return ctypes.string_at(buf, n)


def decode_frame(data: bytes) -> bytes:
    """Decode an LZ4 frame (or legacy frame), checking its content
    checksum when it carries one."""
    data = bytes(data)
    lib = _load()
    cap = _check(lib.lz4_frame_decode(data, len(data), None, 0))
    buf = ctypes.create_string_buffer(max(cap, 1))
    n = _check(lib.lz4_frame_decode(data, len(data), buf, cap))
    return ctypes.string_at(buf, n)


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of ``data``."""
    data = bytes(data)
    return int(_load().lz4_xxh32(data, len(data), seed & 0xFFFFFFFF))
