"""Sums and library calls that round, on a CUDA card, as a lone call's.

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
test_torch_sweep_lanes_cuda.py`` holds :func:`lone_sum` to ``torch.sum``
bit for bit on the card at the shapes the sweep uses. Where the lone call
would vectorize a row with a tail, or split a row across thread blocks,
the order is not modeled (:func:`modeled` decides from the shape) and each
lane's rows are summed by a ``torch.sum`` of their own. On the CPU a row's
order does not follow the number of rows, and :func:`lone_sum` is
``torch.sum``.

cuBLAS and cuSOLVER pick their kernels, and so their roundings, by the
batch too: :func:`each_lane` makes a library call once a lane, on operands
laid out as the lane's lone call holds them (:func:`lone_operand`).
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


def _split(values_per_thread: int, bh: int):
    """Whether the rows' terms are split across the block's warps; None
    where they are split across thread blocks (not modeled)."""
    if values_per_thread >= 256 * bh:
        return None
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


def _rows_plan(N: int, rows: int):
    """How a call on ``rows`` rows of N terms adds a row: (vectorized,
    block width, partial sums a row), or None where it is not modeled (a
    vectorized row with a tail, a row split across thread blocks)."""
    vec = N >= VECTORIZE_FROM
    if vec and N % 4:
        return None
    bw, bh = _block(N // 4 if vec else N, rows, _MAX_THREADS)
    split = _split(-(-N // bw), bh)
    if split is None:
        return None
    return vec, bw, bw * bh if split else bw


def _points_plan(N: int, C: int, rows: int):
    """How a call on ``rows`` rows of (N, C) adds a row's N terms: the
    partial sums a thread keeps, or None where a row is split across thread
    blocks (not modeled)."""
    vec = 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1
    bw, bh = _block(rows * C // vec, N, _MAX_THREADS // vec)
    split = _split(N, bh)
    if split is None:
        return None
    return bh if split else 1


def modeled(shape, dim: int, rows: int) -> bool:
    """Whether :func:`lone_sum` adds a CUDA tensor of ``shape`` over ``dim``
    in the modeled order (else each lane's rows take a ``torch.sum`` of
    their own)."""
    if len(shape) == 2 and dim in (-1, 1):
        return _rows_plan(shape[1], rows) is not None
    if len(shape) == 3 and dim in (-2, 1):
        return _points_plan(shape[1], shape[2], rows) is not None
    return False


def _rows_sum(x, rows: int):
    """Sum over the last dim of contiguous rows x (R, N), each as a call
    on ``rows`` rows of N adds it (a shape :func:`modeled` covers)."""
    R, N = x.shape
    vec, bw, step = _rows_plan(N, rows)
    p = (_strided_partials(x.reshape(R, N // 4, 4), step, 4) if vec
         else _strided_partials(x, step, 1))  # (R, step)
    p = p.reshape(R, step // bw, bw)
    p = torch.sum(_fold(p, 2, _WARP), dim=2)  # block_x_reduce
    return _fold(p, 1, 1)[:, 0]  # block_y_reduce (a no-op without a split)


def _points_sum(x, rows: int):
    """Sum over dim 1 of contiguous x (R, N, C), each row as a call on
    ``rows`` rows of (N, C) adds it (a shape :func:`modeled` covers): the C
    outputs of a row lie side by side, so each thread sums terms for its
    own outputs."""
    R, N, C = x.shape
    p = _strided_partials(x, _points_plan(N, C, rows), 1)  # (R, step, C)
    return _fold(p, 1, 1)[:, 0]


def lone_operand(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its data does not start on a 256-byte
    boundary (the most alignment torch hands cuBLAS's heuristics, and less
    than a fresh allocation's): a library call on a lane's slice then sees
    the operand its lone call sees."""
    return x if x.data_ptr() % 256 == 0 else x.clone()


def each_lane(fn, lanes, *args):
    """``fn`` of each listed lane's operands (every arg with a leading lane
    axis B), one call a lane, as the lane's lone call makes it: cuBLAS and
    cuSOLVER pick their kernels, and so their roundings, by the batch, and
    a batched call rounds a lane otherwise. Returns fn's outputs stacked
    over the B lanes, zero in the lanes not listed."""
    outs = [fn(*(a[i] for a in args)) for i in lanes]
    B = args[0].shape[0]
    if list(lanes) == list(range(B)):
        return [torch.stack(parts) for parts in zip(*outs)]
    idx = torch.as_tensor(lanes, device=args[0].device)
    stacked = []
    for parts in zip(*outs):
        full = parts[0].new_zeros((B,) + parts[0].shape)
        full[idx] = torch.stack(parts)
        stacked.append(full)
    return stacked


def _each_lane_sum(x, dim: int, rows: int):
    """Each lane's own ``torch.sum`` over its ``rows`` rows of contiguous
    x, on the operand its lone call holds."""
    return torch.cat([torch.sum(lone_operand(part), dim=dim)
                      for part in x.split(rows)])


def lone_sum(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """``torch.sum(x, dim)`` of a lane-batched x whose leading axis holds
    B lanes of ``rows`` rows each (``dim`` not that axis), each row rounded
    as a call on one lane's ``rows`` rows rounds it: in the modeled order
    (x (B * rows, N), dim -1; or (B * rows, N, C), dim -2, where
    :func:`modeled` holds), else by each lane's own ``torch.sum``. On the
    CPU this is ``torch.sum``."""
    if x.device.type != "cuda":
        return torch.sum(x, dim=dim)
    return _card_sum(x.contiguous(), dim, rows)


def _card_sum(x, dim: int, rows: int):
    """:func:`lone_sum`'s card branch on contiguous x (on any device: the
    CPU tests check what it adds)."""
    if not modeled(x.shape, dim, rows):
        return _each_lane_sum(x, dim, rows)
    return _rows_sum(x, rows) if x.ndim == 2 else _points_sum(x, rows)
