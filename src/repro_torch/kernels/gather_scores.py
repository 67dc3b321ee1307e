"""Sampled-head candidate scores: ``out[t, j] = w[ids[t, j]] . h[t] + b[ids[t, j]]``.

Replaces ``src/repro/kernels/gather_scores.py:gather_scores``, the Pallas TPU
kernel that streams each gathered row HBM->VMEM once. On the H100 the work
is a gather of T*n rows of K values with two operations per value read, so
device memory bytes bound it: at the serving shape (T = 256 queries, n = 64
beam candidates, K = 512, float32) about 33.5 MB of rows. The CUDA kernel
(``csrc/gather_scores.cu``) gives each (t, j) pair one warp that reads its
row once with 16-byte loads and reduces it with warp shuffles, against h[t]
staged once in shared memory, so no gathered row is ever written back to
device memory (the plain version materializes the (T, n, K) rows). It reads
torch's int64 ids directly and masks ragged T, n and K itself.

CPU tensors go to the plain version (:func:`..ref.gather_scores_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gather_scores_ref

_TABLE_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gather_scores")
    for fn in (lib.gather_scores_f32, lib.gather_scores_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
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


def gather_scores(w, b, h, ids):
    """w: (C,K) float32/bfloat16, b: (C,) same dtype, h: (T,K) float32,
    ids: (T,n) int64 in [0, C) -> (T,n) float32. On the card an id outside
    [0, C) scores NaN; it is never read."""
    _check(w, b, h, ids)
    if w.device.type == "cpu":
        return gather_scores_ref(w, b, h, ids)
    if w.device.type != "cuda":
        raise ValueError(f"gather_scores: no kernel for device {w.device}")
    (c, k), (t, n) = w.shape, ids.shape
    if k * 4 > 48 * 1024 or t >= 2 ** 31 or n > 65535 * 8:
        raise ValueError(f"gather_scores: kernel takes K <= 12288, T < 2^31, "
                         f"n <= 524280; got K={k}, T={t}, n={n}")
    out = torch.empty((t, n), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = lib.gather_scores_f32 if w.dtype == torch.float32 else lib.gather_scores_bf16
    vec = int(w.data_ptr() % 16 == 0 and (k * w.element_size()) % 16 == 0)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(w.data_ptr(), b.data_ptr(), h.data_ptr(), ids.data_ptr(),
                  out.data_ptr(), t, n, k, c, vec, stream)
    build.check_launch(lib, "gather_scores", code)
    gather_scores.launches += 1
    return out


gather_scores.launches = 0
