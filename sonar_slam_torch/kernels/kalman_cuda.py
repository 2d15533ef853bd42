"""The Kalman filter's event stream in one CUDA launch (``csrc/kalman.cu``).

Counterpart of the JAX package's ``estimators/kalman.py::kalman_scan``, which
runs the stream as one ``lax.scan``; the JAX package has no Pallas kernel for
it. ``kalman_filter_kernel`` runs every event of a merged sensor stream in
one block, with the filter's state in shared memory (the file's header says
how). Its plain version is the event loop of
``sonar_slam_torch/estimators/kalman.py::kalman_scan``, which a CPU tensor
takes; that module calls :func:`kalman_filter` for a CUDA tensor.

The kernel is built at first use with ``nvcc`` into
``sonar_slam_torch/_build/`` (its own library, beside the CFAR kernels') and
loaded with ``ctypes``. If the build or the launch fails, this raises.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "kalman.cu")
# the code of an event the kernel skips (a DVL event the gate rejected); the
# codes 0-3 are the event types IMU, DVL, depth and gyro
EVENT_SKIP = -1
N, M = 12, 3  # the state, a measurement

_lib = None


def build() -> str:
    """Compile ``csrc/kalman.cu`` into a shared library (once per source
    content) and return its path."""
    return nvcc_build.build(_SRC, "libkalman")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.kalman_filter_launch
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # codes z T
            + [ctypes.c_void_p] * 10  # A Q, then H R by event type
            + [ctypes.c_void_p] * 5  # x P hist yaw_gyro count
            + [ctypes.c_void_p])  # stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kalman_filter(codes: torch.Tensor, z: torch.Tensor, A: torch.Tensor,
                  Q: torch.Tensor, sensors):
    """Run the ``T`` events of ``codes`` ((T,) int8 on a CUDA device: the
    event type 0-3, or ``EVENT_SKIP``) with their measurements ``z`` ((T, 3)
    float32) through the filter from a zero state, with the transition
    ``A`` and process noise ``Q`` ((12, 12) float32) and ``sensors``, the
    (H (3, 12), R (3, 3)) float32 pair of each event type in order.

    Returns ``(x (12,), P (12, 12), hist (T, 12), yaw_gyro (T + 1,), count
    (1,) int32)``: the final state and covariance, the state after each IMU
    event (zeros in other rows), the FOG yaw summed in stream order after
    each gyro event (zeros elsewhere; slot T stays 0) and the events run.
    Launches one kernel on the current stream and does not wait for it.
    """
    sensors = list(sensors)
    if len(sensors) != 4:
        raise ValueError(f"expected an (H, R) pair for each of the 4 event "
                         f"types, got {len(sensors)}")
    if not isinstance(codes, torch.Tensor) or codes.ndim != 1:
        raise ValueError("codes: expected a (T,) tensor")
    T = codes.shape[0]
    f32 = torch.float32
    args = [("codes", codes, (T,), torch.int8), ("z", z, (T, M), f32),
            ("A", A, (N, N), f32), ("Q", Q, (N, N), f32)]
    for k, (H, R) in enumerate(sensors):
        args += [(f"H[{k}]", H, (M, N), f32), (f"R[{k}]", R, (M, M), f32)]
    for name, t, shape, dtype in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"no Kalman filter kernel for device {dev}")
    for name, t, _, _ in args:
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the codes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if T >= 2**31:
        raise ValueError("event stream too long for one launch")
    x = torch.empty(N, dtype=f32, device=dev)
    P = torch.empty((N, N), dtype=f32, device=dev)
    hist = torch.zeros((T, N), dtype=f32, device=dev)
    yaw_gyro = torch.zeros(T + 1, dtype=f32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kalman_filter_launch(
            codes.data_ptr(), z.data_ptr(), T, A.data_ptr(), Q.data_ptr(),
            *(t.data_ptr() for pair in sensors for t in pair),
            x.data_ptr(), P.data_ptr(), hist.data_ptr(), yaw_gyro.data_ptr(),
            count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"Kalman filter kernel launch failed: CUDA error {err}")
    kalman_filter.launches += 1
    return x, P, hist, yaw_gyro, count


kalman_filter.launches = 0
