"""The plain CFAR detectors, frozen from the port's ``kernels/cfar_cuda.py``
without its CUDA kernels: ``cfar_detect`` takes the plain version on every
device."""

from __future__ import annotations


import torch

_MODES = {"CA": 0, "SOCA": 1, "GOCA": 2}


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
    ``with_threshold``. Every device takes the plain version.
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
    if mode == "OS":
        det, thr = cfar_os_plain(imgs, train_hs, guard_hs, rank, tau,
                                 intensity_threshold, edge)
    else:
        det, thr = cfar_plain(imgs, train_hs, guard_hs, tau, mode,
                              intensity_threshold, edge)
    return (det, thr) if with_threshold else det
