"""Sampled-head candidate scores: ``out[t, j] = w[ids[t, j]] . h[t] + b[ids[t, j]]``.

Replaces ``src/repro/kernels/gather_scores.py:gather_scores``, the Pallas TPU
kernel that streams each gathered row HBM->VMEM once. On the H100 the work
is a gather of T*n rows of K values with two operations per value read, so
device memory bytes bound it: 33.5 MB of rows at the prediction beam's call
(T = 256 queries, n = 64 candidates, K = 512, float32), 3.9 MB at the
LM-serving beam's (T = 4, n = 64, K = 3,840), where the latency of
dependent reads, not the bytes, sets the time.

The CUDA kernel (``csrc/gather_scores.cu``) makes two dependent round trips
a row: h[t] and the ids, then every 16-byte chunk of every row a lane owns
and b[id], all in flight before any FMA. :func:`launch_plan` picks, from the
shape alone, one of two variants and its split, and the C entry checks the
plan again:

- ``ROWS``: a row within one warp (8 to 32 lanes), several rows a group
  sharing its h, shuffle sums; many-row calls take it;
- ``SPLIT``: a row over the warps of a block (64 to 256 lanes), summed in
  shared memory; few-row calls take it, so that every SM has blocks.

No gathered row is written back to device memory (the plain version
materializes the (T, n, K) rows), h is not staged in shared memory (K has
no cap), and nothing uses atomics: two calls give the same bits. It reads
torch's int64 ids directly and masks ragged T, n and K itself.

CPU tensors go to the plain version (:func:`..ref.gather_scores_ref`);
CUDA tensors launch the kernel or raise. ``gather_scores.launches`` counts
launches; ``rows_launches`` and ``split_launches`` split it by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_scores_ref

_TABLE_DTYPES = (torch.float32, torch.bfloat16)
ROWS, SPLIT = 0, 1
# The kernel's block, the values of a row a lane holds in a round, and the
# plan's limits (csrc/gather_scores.cu checks them again). BLOCKS_PER_SM is
# the kernel's launch bounds, which its library exports: _lib() refuses a
# library that disagrees.
THREADS, WARP, LANE_VALUES, BLOCKS_PER_SM = 256, 32, 16, 2
MIN_LANES, MAX_ROWS, MAX_ROUNDS = 8, 4, 2
_MAX_BLOCKS = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gather_scores")
    for fn in (lib.gather_scores_f32, lib.gather_scores_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.gather_scores_blocks_per_sm.restype = ctypes.c_int
    if lib.gather_scores_blocks_per_sm() != BLOCKS_PER_SM:
        raise RuntimeError(f"gather_scores: the kernel's launch bounds promise "
                           f"{lib.gather_scores_blocks_per_sm()} blocks an SM, the "
                           f"launch plan assumes {BLOCKS_PER_SM}")
    return lib


def _check(w, b, h, ids) -> None:
    devices = {t.device for t in (w, b, h, ids)}
    if len(devices) != 1:
        raise ValueError(f"gather_scores: operands on several devices {devices}")
    if w.dim() != 2 or b.shape != w.shape[:1]:
        raise ValueError(f"gather_scores: w must be (C, K) and b (C,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if h.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"gather_scores: h must be (T, K={w.shape[1]}), "
                         f"got {tuple(h.shape)}")
    if ids.dim() != 2 or ids.shape[0] != h.shape[0]:
        raise ValueError(f"gather_scores: ids must be (T={h.shape[0]}, n), "
                         f"got {tuple(ids.shape)}")
    if w.dtype not in _TABLE_DTYPES or b.dtype != w.dtype:
        raise TypeError(f"gather_scores: w and b must share a dtype in "
                        f"{_TABLE_DTYPES}, got {w.dtype} and {b.dtype}")
    if h.dtype != torch.float32 or ids.dtype != torch.int64:
        raise TypeError(f"gather_scores: h must be float32 and ids int64, "
                        f"got {h.dtype} and {ids.dtype}")
    for name, t in (("w", w), ("b", b), ("h", h), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"gather_scores: {name} must be contiguous")


def cost(t: int, n: int, k: int, itemsize: int, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a (t, n) call on rows of ``k`` values of
    ``itemsize`` bytes touching ``rows`` distinct rows of the table: each
    distinct row and its bias read once, ids, h read and the scores
    written; a dot product and the bias a score."""
    n_bytes = rows * k * itemsize + rows * itemsize + t * n * 8 + t * k * 4 + t * n * 4
    return float(t * n * (2 * k + 1)), float(n_bytes)


def chunks(k: int, itemsize: int) -> int:
    """16-byte chunks in a row of ``k`` values of ``itemsize`` bytes."""
    return -(-k * itemsize // 16)


def lane_chunks(itemsize: int) -> int:
    """16-byte chunks of a row a lane holds in a round: 4 of float32, 2 of
    bfloat16."""
    return LANE_VALUES * itemsize // 16


def blocks(t: int, n: int, lanes: int, rows: int) -> int:
    """The grid of a (t, n) call under a plan's split."""
    groups = t * -(-n // rows)
    return -(-groups // (THREADS // lanes))


def launch_plan(t: int, n: int, k: int, itemsize: int, sm_count: int):
    """(variant, lanes, rows) for a (t, n) call on rows of ``k`` values of
    ``itemsize`` bytes.

    The grid aims at one wave: ``BLOCKS_PER_SM`` blocks an SM, as many as
    the kernel's registers let reside. A group of ``lanes`` threads takes a
    row: the fewest lanes (8 to 256) that hold it in one round, 16 values a
    lane; a row longer than a round of a whole block takes more rounds. A
    group scores ``rows`` slots of a token: 4, or the largest power of two
    up to n. Short of a wave, ``rows`` halves to 1, then ``lanes`` doubles
    to 256 while a lane has more than one chunk, each step only while the
    grid still fits one wave. Past a wave, ``lanes`` halves while a lane
    then takes at most two rounds. Rows within a warp (lanes <= 32) take
    ``ROWS``, wider rows ``SPLIT``.
    """
    c, vec = chunks(k, itemsize), lane_chunks(itemsize)
    wave = BLOCKS_PER_SM * sm_count
    lanes = min(THREADS, max(MIN_LANES, 1 << max(0, -(-c // vec) - 1).bit_length()))
    rows = min(MAX_ROWS, 1 << (max(n, 1).bit_length() - 1))
    while True:
        if rows > 1:
            step = (lanes, rows // 2)
        elif lanes < THREADS and lanes < c:
            step = (lanes * 2, rows)
        else:
            break
        if blocks(t, n, *step) > wave:
            break
        lanes, rows = step
    while (blocks(t, n, lanes, rows) > wave and lanes > MIN_LANES
           and rounds(c, itemsize, lanes // 2) <= MAX_ROUNDS):
        lanes //= 2
    return (ROWS if lanes <= WARP else SPLIT), lanes, rows


def rounds(c: int, itemsize: int, lanes: int) -> int:
    """Rounds a lane of a group of ``lanes`` takes over a row of ``c``
    chunks."""
    return -(-c // (lane_chunks(itemsize) * lanes))


def gather_scores(w, b, h, ids):
    """w: (C,K) float32/bfloat16, b: (C,) same dtype, h: (T,K) float32,
    ids: (T,n) int64 in [0, C) -> (T,n) float32. On the card an id outside
    [0, C) scores NaN; it is never read."""
    _check(w, b, h, ids)
    if w.device.type == "cpu" and not device_lib.is_fake(w):
        return gather_scores_ref(w, b, h, ids)
    if not device_lib.on_card(w):
        raise ValueError(f"gather_scores: no kernel for device {w.device}")
    (_, k), (t, n) = w.shape, ids.shape
    out = torch.empty((t, n), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    if device_lib.is_fake(w):       # the dry run: every id distinct, the most rows
        device_lib.record_launch("gather_scores", *cost(t, n, k, w.element_size(),
                                                        min(t * n, w.shape[0])))
        return out
    plan = launch_plan(t, n, k, w.element_size(), device_lib.sm_count(w.device.index or 0))
    return _launch(w, b, h, ids, out, *plan)


def _launch(w, b, h, ids, out, variant, lanes, rows):
    """Launch the kernel under a plan into ``out``; counts it."""
    (c, k), (t, n) = w.shape, ids.shape
    if blocks(t, n, lanes, rows) > _MAX_BLOCKS:
        raise ValueError(f"gather_scores: T={t}, n={n} needs more than {_MAX_BLOCKS} blocks")
    lib = _lib()
    fn = lib.gather_scores_f32 if w.dtype == torch.float32 else lib.gather_scores_bf16
    vec = int(w.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0
              and (k * w.element_size()) % 16 == 0)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(w.data_ptr(), b.data_ptr(), h.data_ptr(), ids.data_ptr(),
                  out.data_ptr(), t, n, k, c, vec, variant, lanes, rows, stream)
    build.check_launch(lib, "gather_scores", code)
    gather_scores.launches += 1
    if variant == ROWS:
        gather_scores.rows_launches += 1
    else:
        gather_scores.split_launches += 1
    return out


gather_scores.launches = 0
gather_scores.rows_launches = 0
gather_scores.split_launches = 0
