"""Sums that round, on a CUDA card, as a lone call's ``torch.sum`` rounds.

A lane-batched caller reduces R = B * G rows where each lane's lone call
reduced G. ATen's CUDA reduction shapes its thread block by the number of
outputs (``setReduceConfig`` in ``ATen/native/cuda/Reduce.cuh``), so the
order in which a row's terms are added, and with it the row's rounding,
follows G: a batched ``torch.sum`` rounds a lane otherwise than its lone
call. :func:`lone_sum` adds each row in the order of a call with G rows:

* each thread's strided partial sums, term after term (``torch.cumsum``
  along an outer dimension adds in that order), in four accumulators;
* the four accumulators combined in order;
* the block's shared-memory folds (halves added pairwise);
* the last warp's shuffle tree, which a ``torch.sum`` over at most 32
  terms runs in the same order for any number of rows.

That order is ATen's, not a promise of torch: ``tests/
test_torch_lone_sums_cuda.py`` holds :func:`lone_sum` to ``torch.sum``
bit for bit on the card at the shapes the sweep uses. On the CPU a row's
order does not follow the number of rows, and :func:`lone_sum` is
``torch.sum``.
"""

from __future__ import annotations

import torch

# ATen loads a fastest-dimension reduction four floats at a time from this
# many terms on
VECTORIZE_FROM = 128
_MAX_THREADS = 512
_WARP = 32


def _last_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _block(dim0: int, dim1: int, max_threads: int):
    """ReduceConfig.set_block_dimension: (block width, block height)."""
    d0 = _last_pow2(dim0) if dim0 < max_threads else max_threads
    d1 = _last_pow2(dim1) if dim1 < max_threads else max_threads
    bw = min(d0, _WARP)
    bh = min(d1, max_threads // bw)
    return min(d0, max_threads // bh), bh


def _split(values_per_thread: int, bh: int) -> bool:
    """Whether the rows' terms are split across the block's warps."""
    if values_per_thread >= 256 * bh:
        raise NotImplementedError("a reduction split across thread blocks")
    return values_per_thread >= min(bh * 16, 256)


def _strided_partials(x, step: int, unit: int):
    """Each thread's four accumulators, summed over the terms it visits:
    x (R, T, unit...) with T terms of ``unit`` elements each; thread t
    visits terms t + step * (4 m + i) into accumulator i (``unit`` 1), or
    vector t + step * m into the vector's lanes (``unit`` 4, given as
    (R, T, 4)). Returns (R, step, ...) after combining the accumulators."""
    R, T = x.shape[:2]
    per = step * (4 if unit == 1 else 1)
    M = -(-T // per)
    if M * per != T:  # pad the sequence's end: + 0 leaves a sum as it is
        pad = x.new_zeros((R, M * per - T) + tuple(x.shape[2:]))
        x = torch.cat([x, pad], dim=1)
    if unit == 1:
        v = x.reshape((R, M, 4, step) + tuple(x.shape[2:]))
        acc = torch.cumsum(v, dim=1)[:, -1] if M > 1 else v[:, 0]
        acc = acc.movedim(1, -1)  # (R, step, ..., 4)
    else:
        v = x.reshape(R, M, step, 4)
        acc = torch.cumsum(v, dim=1)[:, -1] if M > 1 else v[:, 0]
    return ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]


def _fold(v, dim: int, to: int):
    """Shared-memory folds along ``dim``: the upper half added onto the
    lower until ``to`` terms are left."""
    while v.shape[dim] > to:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v


def _rows_sum(x, rows: int):
    """Sum over the last dim of contiguous rows x (R, N), each as a call
    on ``rows`` rows of N adds it."""
    R, N = x.shape
    vec = N >= VECTORIZE_FROM
    if vec and N % 4:
        raise NotImplementedError("a vectorized row with a tail")
    bw, bh = _block(N // 4 if vec else N, rows, _MAX_THREADS)
    step = bw * bh if _split(-(-N // bw), bh) else bw
    p = (_strided_partials(x.reshape(R, N // 4, 4), step, 4) if vec
         else _strided_partials(x, step, 1))  # (R, step)
    p = p.reshape(R, step // bw, bw)
    p = torch.sum(_fold(p, 2, _WARP), dim=2)  # block_x_reduce
    return _fold(p, 1, 1)[:, 0]  # block_y_reduce (a no-op without a split)


def _points_sum(x, rows: int):
    """Sum over dim 1 of contiguous x (R, N, C), each row as a call on
    ``rows`` rows of (N, C) adds it: the C outputs of a row lie side by
    side, so each thread sums terms for its own outputs."""
    R, N, C = x.shape
    vec = 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1
    bw, bh = _block(rows * C // vec, N, _MAX_THREADS // vec)
    step = bh if _split(N, bh) else 1
    p = _strided_partials(x, step, 1)  # (R, step, C)
    return _fold(p, 1, 1)[:, 0]


def lone_sum(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` of a lane-batched x whose leading axis holds
    B lanes of ``rows`` rows each (x (B * rows, N), dim -1; or (B * rows,
    N, C), dim -2), each row rounded as a call on one lane's ``rows`` rows
    rounds it. On the CPU this is ``torch.sum``."""
    if x.device.type != "cuda":
        return torch.sum(x, dim=dim)
    x = x.contiguous()
    if x.ndim == 2 and dim in (-1, 1):
        return _rows_sum(x, rows)
    if x.ndim == 3 and dim in (-2, 1):
        return _points_sum(x, rows)
    raise NotImplementedError(f"lone_sum of a {x.ndim}-d tensor over {dim}")
