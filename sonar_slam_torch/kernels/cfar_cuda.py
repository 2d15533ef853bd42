"""The CFAR detector kernels (CUDA, sm_90a) and their plain PyTorch versions.

Counterpart of ``sonar_slam_tpu/kernels/cfar_pallas.py``. The hand-written
kernels in ``csrc/cfar.cu`` replace its two bodies, each with the intensity
gate fused in:

* ``cfar_sum_kernel`` replaces ``_cfar_kernel`` (CA / SOCA / GOCA); its plain
  version is :func:`cfar_plain`. Both add the training cells in the same
  order and divide the same way, so on the card they agree bit for bit.
* ``cfar_os_mask_kernel`` replaces ``_cfar_os_kernel`` where only the mask is
  wanted and ``tau > 0`` (the feature path, see :func:`os_mask_path`): it
  counts the training cells whose ``tau * v`` lies below the pixel, which
  decides ``x > tau * kth`` exactly without selecting ``kth``.
* ``cfar_os_kernel`` is OS with the threshold map (or any other ``tau``): it
  selects the exact k-th smallest training cell from a window it keeps
  sorted as it walks down each column (``cfar_os_split_kernel`` for the main
  path's 40 cells at rank 10, ``cfar_os_window_kernel`` for any other).

The plain version of both OS kernels is :func:`cfar_os_plain`, a sort; each
kernel agrees with it bit for bit.

``cfar_detect`` is the one entry point. A tensor on the CPU goes through the
plain version, a tensor on a CUDA device launches a kernel, and any other
device raises.

The kernels are built at first use with ``nvcc`` from the sources in this
package into ``sonar_slam_torch/_build/`` and loaded with ``ctypes``. If the
build or a launch fails, ``cfar_detect`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
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
# widest OS window the kernels take (OS_MAX_CELLS in csrc/cfar.cu)
OS_MAX_CELLS = 128


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
        fn = lib.cfar_os_mask_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # img det
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R C
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # train_hs guard_hs rank
            ctypes.c_float,  # tau
            ctypes.c_int, ctypes.c_float,  # use_gate gate
            ctypes.c_int, ctypes.c_void_p,  # extend stream
        ]
        fn.restype = ctypes.c_int
        fn = lib.cfar_os_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img det thr
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R C
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # train_hs guard_hs rank
            ctypes.c_float,  # tau
            ctypes.c_int, ctypes.c_float,  # use_gate gate
            ctypes.c_int, ctypes.c_void_p,  # extend stream
        ]
        fn.restype = ctypes.c_int
        for name in ("cfar_max_half_window", "cfar_os_max_half_window"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
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


def cfar_os_plain(
    imgs: torch.Tensor,
    train_hs: int,
    guard_hs: int,
    rank: int,
    tau: float,
    intensity_threshold: float | None = None,
    edge: str = "strict",
):
    """Plain PyTorch version of the OS kernel: (det bool, thr f32), each
    shaped like ``imgs`` ([..., R, C]). The 2 * ``train_hs`` training cells
    of every pixel are stacked (row indices clamped, which is the edge
    replication) and sorted; the threshold is ``tau`` times the ``rank``-th
    smallest (0-indexed)."""
    R = imgs.shape[-2]
    valid = valid_rows(R, train_hs, guard_hs, edge, imgs.device)
    rows = torch.arange(R, device=imgs.device)
    hw = train_hs + guard_hs
    offsets = [o for o in range(-hw, hw + 1) if abs(o) > guard_hs]
    windows = torch.stack(
        [imgs[..., torch.clamp(rows + o, 0, R - 1), :] for o in offsets], dim=-1)
    kth = torch.sort(windows, dim=-1).values[..., rank]
    thr = tau * kth
    valid = valid[:, None]
    det = (imgs > thr) & valid
    if intensity_threshold is not None:
        det = det & (imgs > intensity_threshold)
    return det, torch.where(valid, thr, torch.zeros_like(thr))


def os_mask_path(tau: float, with_threshold: bool) -> bool:
    """Whether an OS call on the card takes ``cfar_os_mask_kernel``: only the
    mask is wanted and ``tau``, rounded to float32 as the kernel gets it, is
    finite and positive. The kernel's rank count equals the selection only
    for such ``tau`` (csrc/cfar.cu); every other call takes the selection
    kernel."""
    tau32 = ctypes.c_float(tau).value
    return not with_threshold and 0.0 < tau32 < math.inf


def cfar_detect(
    imgs: torch.Tensor,
    train_hs: int,
    guard_hs: int,
    tau: float,
    mode: str = "SOCA",
    intensity_threshold: float | None = None,
    edge: str = "strict",
    with_threshold: bool = False,
    rank: int = 0,
):
    """Batched fused CFAR over (B, R, C) float32 frames; ``rank`` is OS's
    0-indexed order statistic.

    Returns the (B, R, C) bool detection mask, and the threshold map too when
    ``with_threshold``. CPU tensors take the plain version; CUDA tensors
    launch a kernel. Each call on the card adds one to
    ``cfar_detect.launches`` and to its kernel's entry in
    ``cfar_detect.kernel_launches``.
    """
    if imgs.ndim != 3:
        raise ValueError(f"expected (B, R, C) frames, got {tuple(imgs.shape)}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"expected float32 frames, got {imgs.dtype}")
    if train_hs < 1 or guard_hs < 0:
        raise ValueError("need train_hs >= 1 and guard_hs >= 0")
    if edge not in ("strict", "extend"):
        raise ValueError(f"unknown CFAR edge mode {edge!r}")
    if mode != "OS" and mode not in _MODES:
        raise ValueError(f"unknown CFAR mode {mode!r}")
    if mode == "OS" and not 0 <= rank < 2 * train_hs:
        raise ValueError(f"OS rank {rank} outside [0, {2 * train_hs})")
    if imgs.device.type == "cpu":
        if mode == "OS":
            det, thr = cfar_os_plain(imgs, train_hs, guard_hs, rank, tau,
                                     intensity_threshold, edge)
        else:
            det, thr = cfar_plain(imgs, train_hs, guard_hs, tau, mode,
                                  intensity_threshold, edge)
        return (det, thr) if with_threshold else det
    if imgs.device.type != "cuda":
        raise RuntimeError(f"no CFAR kernel for device {imgs.device}")
    if mode == "OS" and 2 * train_hs > OS_MAX_CELLS:
        raise ValueError(f"the OS kernel takes at most {OS_MAX_CELLS} "
                         f"training cells, not {2 * train_hs}")
    kernel = ("sum" if mode != "OS" else
              "os_mask" if os_mask_path(tau, with_threshold) else "os_select")
    if not imgs.is_contiguous():
        raise ValueError("CFAR kernel needs contiguous frames")
    B, R, C = imgs.shape
    if B * R * C >= 2**31 * 256:
        raise ValueError("frame stack too large for one launch")
    lib = _load()
    hw = train_hs + guard_hs
    widest = (lib.cfar_os_max_half_window() if kernel == "os_select"
              else lib.cfar_max_half_window())
    if hw > widest:
        raise ValueError(f"train_hs + guard_hs = {hw} is too wide for the "
                         f"kernel's tile in shared memory")
    det = torch.empty(imgs.shape, dtype=torch.bool, device=imgs.device)
    thr = (torch.empty_like(imgs) if with_threshold else None)
    gate = intensity_threshold is not None
    gate_v = float(intensity_threshold) if gate else 0.0
    ext = int(edge == "extend")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        if kernel == "os_mask":
            err = lib.cfar_os_mask_launch(
                imgs.data_ptr(), det.data_ptr(), B, R, C, int(train_hs),
                int(guard_hs), int(rank), float(tau), int(gate), gate_v, ext,
                stream)
        else:
            out = (imgs.data_ptr(), det.data_ptr(),
                   thr.data_ptr() if thr is not None else None, B, R, C,
                   int(train_hs), int(guard_hs))
            if kernel == "os_select":
                err = lib.cfar_os_launch(*out, int(rank), float(tau),
                                         int(gate), gate_v, ext, stream)
            else:
                err = lib.cfar_sum_launch(*out, float(tau), _MODES[mode],
                                          int(gate), gate_v, ext, stream)
    if err != 0:
        raise RuntimeError(f"CFAR kernel launch failed: CUDA error {err}")
    cfar_detect.launches += 1
    cfar_detect.kernel_launches[kernel] += 1
    return (det, thr) if with_threshold else det


cfar_detect.launches = 0
cfar_detect.kernel_launches = {"sum": 0, "os_mask": 0, "os_select": 0}
