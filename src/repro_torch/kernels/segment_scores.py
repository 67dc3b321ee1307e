"""Segment sums of per-point statistics: ``out[s] = sum of vals[i] over seg[i] == s``.

Replaces ``src/repro/kernels/segment_scores.py:segment_stats``, the Pallas TPU
kernel that casts the reduction as one-hot matmuls into an (S, D) accumulator
resident in VMEM, which caps S*D at 8 MB. The level-parallel generator fit
(:mod:`repro_torch.genfit.levels`) needs far more: at full ``xc_linear`` width
the Hessian reduction of level 17 is S = 131,072 nodes x D = 289 (151 MB), and
level 0 sums N = 524,288 rows of 289 values (606 MB) into one segment. Each
value is read once and used once, so device memory bytes bound the work.

The CUDA kernel (``csrc/segment_scores.cu``) has no cap and no float atomics,
because the fitters promise bit-exact replay: the ids are stably sorted
(``torch.sort``, the one library call, glue that the TPU kernel does not
need), each segment's rows are summed in their original order in chunks of
256 rows by one warp each, and a second pass adds a long segment's chunk
partials in a fixed order (only an integer counter is atomic). A segment's
sum depends only on its own rows and their order, so it is the same on every
run, whatever N and S are and whatever other rows are present. Skew (every
row in one segment at level 0, a quarter of them in a zipf head label)
spreads over N / 256 warps.

CPU tensors go to the plain version (:func:`..ref.segment_stats_ref`); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import segment_stats_ref

_VAL_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)
_count_lock = threading.Lock()   # the threaded sharded fit calls from several threads


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("segment_scores")
    lib.segment_keys.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                                 + [ctypes.c_int64] * 2 + [ctypes.c_void_p])
    lib.segment_keys.restype = ctypes.c_int
    for fn in (lib.segment_stats_f32, lib.segment_stats_bf16):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.segment_stats_chunk_rows, lib.segment_stats_long_chunks):
        fn.argtypes = []
        fn.restype = ctypes.c_int64
    return lib


def _check(vals, seg, num_segments: int) -> None:
    if vals.device != seg.device:
        raise ValueError(f"segment_stats: vals on {vals.device}, seg on {seg.device}")
    if vals.dim() != 2 or seg.shape != vals.shape[:1]:
        raise ValueError(f"segment_stats: vals must be (N, D) and seg (N,), got "
                         f"{tuple(vals.shape)} and {tuple(seg.shape)}")
    if not vals.is_floating_point() or seg.dtype not in _ID_DTYPES:
        raise TypeError(f"segment_stats: vals must be floating and seg int32/int64, "
                        f"got {vals.dtype} and {seg.dtype}")
    if not 0 <= num_segments < 2 ** 31 - 1:
        raise ValueError(f"segment_stats: num_segments must be in [0, 2^31 - 1), "
                         f"got {num_segments}")


def segment_stats(vals, seg, num_segments: int):
    """segment_sum(vals, seg) -> (num_segments, D) float32.

    vals: (N, D) float (float32 or bfloat16 on the card); seg: (N,) int32 or
    int64. Rows whose id lies outside [0, num_segments), negatives included,
    are dropped; N = 0 gives zeros. On the card the result is the same on
    every run (no float atomics).
    """
    _check(vals, seg, num_segments)
    if vals.device.type == "cpu":
        return segment_stats_ref(vals, seg, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_stats: no kernel for device {vals.device}")
    if vals.dtype not in _VAL_DTYPES:
        raise TypeError(f"segment_stats: the kernel takes vals in {_VAL_DTYPES}, "
                        f"got {vals.dtype}")
    (n, d), s = vals.shape, num_segments
    if n >= 2 ** 31 or d > 2 ** 20:
        raise ValueError(f"segment_stats: kernel takes N < 2^31, D <= 2^20; got N={n}, D={d}")
    out = torch.empty((s, d), dtype=torch.float32, device=vals.device)
    if n == 0 or d == 0 or s == 0:
        return out.zero_()
    vals, seg = vals.contiguous(), seg.contiguous()
    lib = _lib()
    n_win = -(-n // lib.segment_stats_chunk_rows())
    n_long = n_win // lib.segment_stats_long_chunks() + 2
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        keys = torch.empty((n,), dtype=torch.int32, device=vals.device)
        code = lib.segment_keys(seg.data_ptr(), int(seg.dtype == torch.int64),
                                keys.data_ptr(), n, s, stream)
        build.check_launch(lib, "segment_stats", code)
        keys, perm = torch.sort(keys, stable=True)
        off = torch.empty((s + 1,), dtype=torch.int64, device=vals.device)
        head = torch.empty((n_win, d), dtype=torch.float32, device=vals.device)
        tail = torch.empty_like(head)
        longs = torch.empty((n_long,), dtype=torch.int64, device=vals.device)
        fn = lib.segment_stats_f32 if vals.dtype == torch.float32 else lib.segment_stats_bf16
        code = fn(vals.data_ptr(), keys.data_ptr(), perm.data_ptr(), off.data_ptr(),
                  out.data_ptr(), head.data_ptr(), tail.data_ptr(), longs.data_ptr(),
                  n, d, s, stream)
    build.check_launch(lib, "segment_stats", code)
    with _count_lock:
        segment_stats.launches += 1
    return out


segment_stats.launches = 0
