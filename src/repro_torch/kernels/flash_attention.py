"""Forward attention with an online softmax: causal and sliding-window
masks, the attention-logit softcap, GQA, end-aligned query positions.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention``, the Pallas
TPU kernel whose grid walks the KV blocks of one (b*h, q block) in order with
the running max, sum and accumulator in VMEM scratch. On the H100 prefill at
h2o-danube-3-4b's shapes (Sq = Skv = 4,608, hd = 120, window 4,096) is bound
by arithmetic (about 4*hd operations per (query, key) pair in the band) and
decode (Sq = 1) by the bytes of the K/V cache, read once per step.

``csrc/flash_attention.cu`` holds three kernels. Each gives one block
query rows of one (b, kv head), with the G = H / KV query heads of the group
packed as rows so that K/V are never expanded and decode still fills a
block; each visits only the keys of the block's causal/window band, masks
the ragged edges and keeps the running state in registers.
:func:`decode_path` and :func:`tensor_core_path` pick one from the operands
alone:

- the decode kernel takes bf16 q, k and v with at most 16 packed rows
  (``Sq * G <= 16``: decode), ``hd % 8 == 0`` and 16-byte aligned pointers
  and (b, h, s) strides. Lane groups of a block each take a few keys a
  step and load their K and V rows 16 bytes a lane straight into
  registers, compute logits, the online softmax and P V in float32, and
  merge in a fixed order; the KV range is split over enough blocks to fill
  the card (:func:`decode_splits`). The cache's bytes bound it, though at
  h2o-danube's decode its instructions take longer.

- the tensor-core kernel takes bf16 q, k and v with more than 16 packed rows
  (``Sq * G > 16``: prefill), ``hd <= 128`` and ``hd % 8 == 0``, 16-byte
  aligned pointers and (b, h, s) strides, and an unsplit KV range. It runs
  Q Kᵀ and P V on ``mma.sync`` m16n8k16 (bf16 in, float32 accumulate), fed
  by a ``cp.async`` ring, with P split into bf16 hi + lo parts so that P V
  keeps ~2^-17 of P's precision. It is bound by the tensor cores' rate; its
  MMA work is ~1.6x the operations the bound counts (hd padded to a
  multiple of 16, two MMAs for P V).
- the FMA kernel takes every other call (float32, hd > 128 in prefill, bf16
  operands the other two refuse) and computes in float32 FMAs over tiles
  staged in shared memory, so prefill in it is bound by the 67 TFLOP/s of
  float32 and decode by the cache's bytes. Where its blocks are too few to
  fill the card, each tile's KV range is split over several blocks and a
  second kernel merges their partial softmax states in a fixed order
  (split-KV), as it does for the decode kernel.

Neither uses atomics: two calls give the same bits. The wrapper takes any
Sq, Skv and hd <= 256 and any strides over (b, h, s) with the last
dimension contiguous, so the model passes its (B, S, KV, hd) cache slices as
permuted views without copying.

CPU tensors go to the plain version (:func:`..ref.flash_attention_ref`);
CUDA tensors launch a kernel or raise. ``flash_attention.launches`` counts
launches; ``decode_launches``, ``tensor_core_launches`` and ``fma_launches``
split it by kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TENSOR_CORE_MAX_HEAD_DIM = 128
# The kernel's tile: 16 packed rows (query rows x the G heads of a KV head)
# when a (b, kv head) has at most 16, else 64; KV tiles of 64 keys.
_FEW_ROWS, _BQ_FEW, _BQ, _BK = 16, 16, 64, 64
_MIN_TILES_PER_SPLIT = 4
# The decode kernel: a block per (b, kv head) and split of the KV range,
# split so that every SM gets about this many blocks in one wave, each
# split at least this many keys long.
_DECODE_BLOCKS_PER_SM, _DECODE_MIN_KEYS = 3, 256
_FMA, _TENSOR_CORES, _DECODE = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 18
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(b, h, kv, sq, skv, causal, window, sm_count) -> int:
    """How many blocks share each query tile's KV range: enough for two
    blocks per SM, each with at least 4 KV tiles of the tile's band."""
    rows = sq * (h // kv)
    bq = _BQ_FEW if rows <= _FEW_ROWS else _BQ
    blocks = -(-rows // bq) * b * kv
    band = skv
    if causal and window > 0 and sq <= skv:
        band = min(skv, window + bq // (h // kv))
    tiles = -(-band // _BK)
    return max(1, min(-(-2 * sm_count // blocks), tiles // _MIN_TILES_PER_SPLIT))


def decode_splits(b, h, kv, sq, skv, causal, window, sm_count) -> int:
    """How many blocks of the decode kernel share each row group's KV range:
    about ``_DECODE_BLOCKS_PER_SM`` blocks per SM in all, each split at
    least ``_DECODE_MIN_KEYS`` keys of the band."""
    blocks = b * kv
    band = skv
    if causal and window > 0 and sq <= skv:
        band = min(skv, window + sq - 1)
    return max(1, min(_DECODE_BLOCKS_PER_SM * sm_count // blocks, band // _DECODE_MIN_KEYS))


def _bf16_aligned(q, k, v) -> bool:
    """q, k and v all bf16, hd % 8 == 0, every base pointer and (b, h, s)
    stride 16-byte aligned. The output takes q's strides, or dense ones,
    which are multiples of hd."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                    for t in (q, k, v)))


def decode_path(q, k, v) -> bool:
    """Whether a call takes the decode kernel: q, k and v all bf16, at most
    16 packed rows (``Sq * G <= 16``), ``hd % 8 == 0`` (hd <= 256), every
    base pointer and (b, h, s) stride 16-byte aligned."""
    _, h, sq, _ = q.shape
    return sq * (h // k.shape[1]) <= _FEW_ROWS and _bf16_aligned(q, k, v)


def tensor_core_path(q, k, v, split: int) -> bool:
    """Whether a call takes the tensor-core kernel: q, k and v all bf16,
    more than 16 packed rows (``Sq * G > 16``, so decode takes the decode
    kernel), ``hd <= 128`` with ``hd % 8 == 0``, every base pointer and
    (b, h, s) stride 16-byte aligned, and ``split`` (:func:`n_splits`) 1."""
    _, h, sq, hd = q.shape
    return (sq * (h // k.shape[1]) > _FEW_ROWS and hd <= TENSOR_CORE_MAX_HEAD_DIM
            and _bf16_aligned(q, k, v) and split == 1)


def _check(q, k, v) -> None:
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v lie on different devices")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and hd, H a multiple of KV)")
    if skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q in {tuple(_DTYPE_CODES)} and k, v of one "
                        f"dtype in it, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None):
    """q: (B, H, Sq, hd), k/v: (B, KV, Skv, hd) with H % KV == 0 ->
    (B, H, Sq, hd) in q's dtype. Query head j reads KV head j // (H / KV).
    Query row i sits at absolute position Skv - Sq + i. ``scale`` defaults to
    1 / sqrt(hd); ``window`` 0 means no window."""
    _check(q, k, v)
    window, softcap = int(window), float(softcap)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, sq, hd = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: kernel takes hd <= {MAX_HEAD_DIM}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")
    out = torch.empty_like(q)       # keeps q's strides: (B, S, H, hd) stays so
    if out.numel() == 0:
        return out
    lib = _lib()
    sms = _sm_count(q.device.index)
    if decode_path(q, k, v):
        kernel, split = _DECODE, decode_splits(b, h, kv, sq, skv, causal, window, sms)
    else:
        split = n_splits(b, h, kv, sq, skv, causal, window, sms)
        kernel = _TENSOR_CORES if tensor_core_path(q, k, v, split) else _FMA
    part_ml = part_acc = None
    if split > 1:
        slots = b * kv * split * sq * (h // kv)
        part_ml = torch.empty(2 * slots, dtype=torch.float32, device=q.device)
        part_acc = torch.empty(slots * hd, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            b, h, kv, sq, skv, hd, scale, int(causal), window, softcap,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], split, kernel,
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(), stream)
    build.check_launch(lib, "flash_attention", code)
    flash_attention.launches += 1
    if kernel == _DECODE:
        flash_attention.decode_launches += 1
    elif kernel == _TENSOR_CORES:
        flash_attention.tensor_core_launches += 1
    else:
        flash_attention.fma_launches += 1
    return out


flash_attention.launches = 0
flash_attention.decode_launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.fma_launches = 0
