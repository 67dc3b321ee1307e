"""Segment sums of per-point statistics: ``out[s] = sum of vals[i] over seg[i] == s``.

Replaces ``src/repro/kernels/segment_scores.py:segment_stats``, the Pallas TPU
kernel that casts the reduction as one-hot matmuls into an (S, D) accumulator
resident in VMEM, which caps S*D at 8 MB. The level-parallel generator fit
(:mod:`repro_torch.genfit.levels`) needs far more: at full ``xc_linear`` width
the Hessian reduction of level 17 is S = 131,072 nodes x D = 289 (151 MB), and
level 0 sums N = 524,288 rows of 289 values (606 MB) into one segment. Each
value is read once and used once, so device memory bytes bound the work.

The CUDA kernels (``csrc/segment_scores.cu``) have no cap and no float
atomics, because the fitters promise bit-exact replay. The work is split in
two:

- :func:`segment_plan` sorts the ids once (``torch.sort``, stable: glue that
  the TPU kernel does not need) and keeps what the sums need: the kept rows'
  original indices in sorted order, each segment's first sorted position and
  the chunks of 256 rows of every longer segment. The fit's ids do not change
  within a Newton solve, nor its labels within a fit, so one plan serves
  every call of a solve (``segment_stats.plans`` counts the plans built).
- :func:`segment_stats` with a plan launches only the summing kernels: one
  for the segments of at most 256 rows, each summed row by row in its
  original order, and, where the plan has longer segments, one for their
  chunks and one that adds each one's chunk sums in a fixed order. At
  D <= 32 consecutive threads own consecutive output values, so a warp spans
  several segments and no lane idles.

A segment's sum depends only on its own rows and their order, so it is the
same on every run, whatever N and S are and whatever other rows are present,
and zero rows appended after it leave it bit for bit the same.

CPU tensors go to the plain version (:func:`..ref.segment_stats_ref`), with
or without a plan; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional

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
    lib.segment_offsets.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    for fn in (lib.segment_keys, lib.segment_offsets, lib.segment_stats_f32,
               lib.segment_stats_bf16):
        fn.restype = ctypes.c_int
    for fn in (lib.segment_stats_f32, lib.segment_stats_bf16):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    lib.segment_stats_chunk_rows.argtypes = []
    lib.segment_stats_chunk_rows.restype = ctypes.c_int64
    return lib


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The sorted ids of one ``(seg, num_segments)``, reusable by every
    :func:`segment_stats` call over the same ids.

    ``n``, ``num_segments`` and ``device`` are checked against each call. On
    the card it holds, as int32: ``perm`` (the kept rows' original indices in
    stably sorted order), ``off`` ((S + 1,): each segment's first sorted
    position; ``off[S]`` counts the kept rows), ``chunks`` ((n_chunks, 2):
    sorted [begin, end) of each 256-row chunk of the segments longer than 256
    rows, counted from the segment's own first row), ``long_seg`` (those
    segments) and ``long_first`` (each one's first chunk, then n_chunks). On
    the CPU, or with no rows or no segments, the tensors are None.
    """
    n: int
    num_segments: int
    device: torch.device
    perm: Optional[torch.Tensor] = None
    off: Optional[torch.Tensor] = None
    chunks: Optional[torch.Tensor] = None
    long_seg: Optional[torch.Tensor] = None
    long_first: Optional[torch.Tensor] = None

    @property
    def n_chunks(self) -> int:
        """Rows of the chunk-sum scratch a call allocates."""
        return 0 if self.chunks is None else self.chunks.shape[0]

    @property
    def n_long(self) -> int:
        return 0 if self.long_seg is None else self.long_seg.shape[0]


def _check_ids(seg, num_segments: int) -> None:
    if seg.dim() != 1 or seg.dtype not in _ID_DTYPES:
        raise TypeError(f"segment_stats: seg must be (N,) int32/int64, got "
                        f"{tuple(seg.shape)} {seg.dtype}")
    if not 0 <= num_segments < 2 ** 31 - 1:
        raise ValueError(f"segment_stats: num_segments must be in [0, 2^31 - 1), "
                         f"got {num_segments}")


def chunk_table(off: torch.Tensor, rows: int):
    """The chunks of the segments longer than ``rows`` rows, from the
    segments' first sorted positions ``off`` (S + 1,): ``(chunks (n_chunks,
    2) [begin, end), long_seg, long_first)`` as int32, chunks counted from
    each segment's own first row and listed in segment order; all None if no
    segment is longer. One host sync (the two counts)."""
    dev = off.device
    count = (off[1:] - off[:-1]).long()
    q = torch.where(count > rows, (count + rows - 1) // rows, 0)    # chunks a segment
    is_long = q > 0
    n_long, n_chunks = torch.stack([is_long.sum(), q.sum()]).tolist()
    if n_long == 0:
        return None, None, None
    # The i-th long segment: the first where the running count reaches i + 1.
    long_seg = torch.searchsorted(torch.cumsum(is_long, 0),
                                  torch.arange(1, n_long + 1, device=dev))
    q = q[long_seg]
    long_first = torch.cat([q.new_zeros(1), q.cumsum(0)])
    owner = torch.repeat_interleave(torch.arange(n_long, device=dev), q, output_size=n_chunks)
    begin = off[long_seg].long()[owner] + (
        torch.arange(n_chunks, device=dev) - long_first[owner]) * rows
    end = torch.minimum(begin + rows, off[long_seg + 1].long()[owner])
    return (torch.stack([begin, end], dim=1).to(torch.int32).contiguous(),
            long_seg.to(torch.int32), long_first.to(torch.int32))


def segment_plan(seg, num_segments: int) -> SegmentPlan:
    """Sort ``seg`` (N,) once for every :func:`segment_stats` call over the
    same ids and ``num_segments``. On the CPU nothing is computed."""
    _check_ids(seg, num_segments)
    n, s = seg.shape[0], num_segments
    plan = SegmentPlan(n, s, seg.device)
    if seg.device.type == "cpu":
        return plan
    if seg.device.type != "cuda":
        raise ValueError(f"segment_stats: no kernel for device {seg.device}")
    if n >= 2 ** 31:
        raise ValueError(f"segment_stats: kernel takes N < 2^31, got N={n}")
    if n == 0 or s == 0:
        return plan
    lib = _lib()
    dev, seg = seg.device, seg.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        keys = torch.empty((n,), dtype=torch.int32, device=dev)
        build.check_launch(lib, "segment_stats", lib.segment_keys(
            seg.data_ptr(), int(seg.dtype == torch.int64), keys.data_ptr(), n, s, stream))
        keys, perm = torch.sort(keys, stable=True)
        off = torch.empty((s + 1,), dtype=torch.int32, device=dev)
        build.check_launch(lib, "segment_stats", lib.segment_offsets(
            keys.data_ptr(), off.data_ptr(), n, s, stream))
        perm = perm.to(torch.int32)
        chunks, long_seg, long_first = chunk_table(off, lib.segment_stats_chunk_rows())
    with _count_lock:
        segment_stats.plans += 1
    return dataclasses.replace(plan, perm=perm, off=off, chunks=chunks, long_seg=long_seg,
                               long_first=long_first)


def _check(vals, seg, num_segments: int, plan: Optional[SegmentPlan]) -> None:
    if vals.device != seg.device:
        raise ValueError(f"segment_stats: vals on {vals.device}, seg on {seg.device}")
    if vals.dim() != 2 or seg.shape != vals.shape[:1]:
        raise ValueError(f"segment_stats: vals must be (N, D) and seg (N,), got "
                         f"{tuple(vals.shape)} and {tuple(seg.shape)}")
    if not vals.is_floating_point():
        raise TypeError(f"segment_stats: vals must be floating, got {vals.dtype}")
    _check_ids(seg, num_segments)
    if plan is not None and (plan.n, plan.num_segments, plan.device) != (
            seg.shape[0], num_segments, seg.device):
        raise ValueError(f"segment_stats: a plan for N={plan.n}, S={plan.num_segments} on "
                         f"{plan.device} does not fit N={seg.shape[0]}, S={num_segments} "
                         f"on {seg.device}")


def segment_stats(vals, seg, num_segments: int, plan: Optional[SegmentPlan] = None):
    """segment_sum(vals, seg) -> (num_segments, D) float32.

    vals: (N, D) float (float32 or bfloat16 on the card); seg: (N,) int32 or
    int64. Rows whose id lies outside [0, num_segments), negatives included,
    are dropped; N = 0 gives zeros. ``plan`` is :func:`segment_plan` of the
    same ``seg`` and ``num_segments`` (its N, S and device are checked, its
    ids are not); without one the call builds its own. On the card the
    result is the same on every run (no float atomics), with or without a
    plan.
    """
    _check(vals, seg, num_segments, plan)
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
    plan = plan if plan is not None else segment_plan(seg, s)
    vals = vals.contiguous()
    lib = _lib()
    part = torch.empty((plan.n_chunks, d), dtype=torch.float32, device=vals.device)
    fn = lib.segment_stats_f32 if vals.dtype == torch.float32 else lib.segment_stats_bf16
    ptr = lambda t: None if t is None else t.data_ptr()               # noqa: E731
    with torch.cuda.device(vals.device):
        code = fn(vals.data_ptr(), plan.perm.data_ptr(), plan.off.data_ptr(),
                  ptr(plan.chunks), ptr(plan.long_seg), ptr(plan.long_first),
                  part.data_ptr(), out.data_ptr(), d, s, plan.n_chunks, plan.n_long,
                  torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, "segment_stats", code)
    with _count_lock:
        segment_stats.launches += 1
    return out


segment_stats.launches = 0
segment_stats.plans = 0
