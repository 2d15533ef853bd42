"""The CFAR detector kernel (CUDA, sm_90a) and its plain PyTorch version.

Counterpart of ``sonar_slam_tpu/kernels/cfar_pallas.py``: the hand-written
kernel in ``csrc/cfar.cu`` replaces ``_cfar_kernel`` (CA / SOCA / GOCA with
the intensity gate fused in). The OS kernel (``_cfar_os_kernel``) is not
ported yet; asking for it on a CUDA tensor raises ``NotImplementedError``.

``cfar_detect`` is the one entry point. A tensor on the CPU goes through
:func:`cfar_plain`, a tensor on a CUDA device launches the kernel, and any
other device raises. Both versions add the training cells in the same order
and divide the same way, so on the card they agree bit for bit.

The kernel is built at first use with ``nvcc`` from the sources in this
package into ``sonar_slam_torch/_build/`` and loaded with ``ctypes``. If the
build or a launch fails, ``cfar_detect`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_MODES = {"CA": 0, "SOCA": 1, "GOCA": 2}
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "cfar.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CFAR kernel cannot be built")
    return path


def build() -> str:
    """Compile ``csrc/cfar.cu`` into a shared library (once per source
    content) and return its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(_BUILD_DIR, f"libcfar_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.cfar_sum_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img det thr
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R C
            ctypes.c_int, ctypes.c_int,  # train_hs guard_hs
            ctypes.c_float, ctypes.c_int,  # tau mode
            ctypes.c_int, ctypes.c_float,  # use_gate gate
            ctypes.c_int, ctypes.c_void_p,  # extend stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _window_sums(imgs: torch.Tensor, train_hs: int, guard_hs: int):
    """Leading / lagging training sums along rows with clamped row indices
    (edge replication), added j = guard+1 ... guard+train in order."""
    R = imgs.shape[-2]
    rows = torch.arange(R, device=imgs.device)
    lead = torch.zeros_like(imgs)
    lag = torch.zeros_like(imgs)
    for j in range(guard_hs + 1, guard_hs + train_hs + 1):
        lead = lead + imgs[..., torch.clamp(rows - j, min=0), :]
        lag = lag + imgs[..., torch.clamp(rows + j, max=R - 1), :]
    return lead, lag


def valid_rows(R: int, train_hs: int, guard_hs: int, edge: str,
               device) -> torch.Tensor:
    """(R,) rows that may detect: all with ``extend``, the interior with
    ``strict``."""
    if edge == "extend":
        return torch.ones(R, dtype=torch.bool, device=device)
    if edge != "strict":
        raise ValueError(f"unknown CFAR edge mode {edge!r}")
    rows = torch.arange(R, device=device)
    hw = train_hs + guard_hs
    return (rows >= hw) & (rows < R - hw)


def cfar_plain(
    imgs: torch.Tensor,
    train_hs: int,
    guard_hs: int,
    tau: float,
    mode: str = "SOCA",
    intensity_threshold: float | None = None,
    edge: str = "strict",
):
    """Plain PyTorch version of the kernel: (det bool, thr f32), each shaped
    like ``imgs`` ([..., R, C]). The divisors are device tensors so that CUDA
    divides exactly instead of multiplying by a reciprocal."""
    if mode not in _MODES:
        raise ValueError(f"cfar_plain handles CA/SOCA/GOCA, not {mode!r}")
    valid = valid_rows(imgs.shape[-2], train_hs, guard_hs, edge, imgs.device)
    lead, lag = _window_sums(imgs, train_hs, guard_hs)
    if mode == "CA":
        div = torch.tensor(2.0 * train_hs, dtype=imgs.dtype, device=imgs.device)
        stat = (lead + lag) / div
    else:
        div = torch.tensor(float(train_hs), dtype=imgs.dtype, device=imgs.device)
        pick = torch.minimum if mode == "SOCA" else torch.maximum
        stat = pick(lead, lag) / div
    thr = tau * stat
    valid = valid[:, None]
    det = (imgs > thr) & valid
    if intensity_threshold is not None:
        det = det & (imgs > intensity_threshold)
    return det, torch.where(valid, thr, torch.zeros_like(thr))


def cfar_detect(
    imgs: torch.Tensor,
    train_hs: int,
    guard_hs: int,
    tau: float,
    mode: str = "SOCA",
    intensity_threshold: float | None = None,
    edge: str = "strict",
    with_threshold: bool = False,
):
    """Batched fused CFAR over (B, R, C) float32 frames.

    Returns the (B, R, C) bool detection mask, and the threshold map too when
    ``with_threshold``. CPU tensors take :func:`cfar_plain`; CUDA tensors
    launch the kernel (counted in ``cfar_detect.launches``).
    """
    if imgs.ndim != 3:
        raise ValueError(f"expected (B, R, C) frames, got {tuple(imgs.shape)}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"expected float32 frames, got {imgs.dtype}")
    if train_hs < 1 or guard_hs < 0:
        raise ValueError("need train_hs >= 1 and guard_hs >= 0")
    if edge not in ("strict", "extend"):
        raise ValueError(f"unknown CFAR edge mode {edge!r}")
    if imgs.device.type == "cpu":
        det, thr = cfar_plain(imgs, train_hs, guard_hs, tau, mode,
                              intensity_threshold, edge)
        return (det, thr) if with_threshold else det
    if imgs.device.type != "cuda":
        raise RuntimeError(f"no CFAR kernel for device {imgs.device}")
    if mode == "OS":
        raise NotImplementedError(
            "the OS-CFAR kernel (cfar_pallas.py::_cfar_os_kernel) is not "
            "ported to CUDA yet")
    if mode not in _MODES:
        raise ValueError(f"unknown CFAR mode {mode!r}")
    if not imgs.is_contiguous():
        raise ValueError("CFAR kernel needs contiguous frames")
    B, R, C = imgs.shape
    if B * R * C >= 2**31 * 256:
        raise ValueError("frame stack too large for one launch")
    lib = _load()
    det = torch.empty(imgs.shape, dtype=torch.bool, device=imgs.device)
    thr = (torch.empty_like(imgs) if with_threshold else None)
    gate = intensity_threshold is not None
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.cfar_sum_launch(
            imgs.data_ptr(), det.data_ptr(),
            thr.data_ptr() if thr is not None else None,
            B, R, C, int(train_hs), int(guard_hs), float(tau), _MODES[mode],
            int(gate), float(intensity_threshold) if gate else 0.0,
            int(edge == "extend"), stream,
        )
    if err != 0:
        raise RuntimeError(f"CFAR kernel launch failed: CUDA error {err}")
    cfar_detect.launches += 1
    return (det, thr) if with_threshold else det


cfar_detect.launches = 0
