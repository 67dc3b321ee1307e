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
  (``Sq * G > 16``), ``hd <= 128`` and ``hd % 8 == 0``, 16-byte aligned
  pointers and (b, h, s) strides, whether or not the call is ragged, paged
  or split: prefill, and the serving engine's multi-token paged steps
  (suffix prefills, speculative verify steps). It runs Q Kᵀ and P V on
  ``mma.sync`` m16n8k16 (bf16 in, float32 accumulate), fed by a
  ``cp.async`` ring, with P split into bf16 hi + lo parts so that P V keeps
  ~2^-17 of P's precision. Prefill is bound by the tensor cores' rate; its
  MMA work is ~1.6x the operations the bound counts (hd padded to a
  multiple of 16, two MMAs for P V). A paged step of few queries a row is
  bound by the K/V bytes of the keys each row's queries see (what
  ``cost(..., kv_lens=..., index_bytes=...)`` counts); where its 128-row
  tiles are too few to fill the card its KV range is split
  (:func:`tensor_core_splits`).
- the FMA kernel takes every other call: float32 q, a float32 cache, and
  the bf16 calls the other two refuse (``hd > 128`` with more than 16
  packed rows, ``hd % 8 != 0``, unaligned operands). It computes in
  float32 FMAs over tiles staged in shared memory, so prefill in it is
  bound by the 67 TFLOP/s of float32 and decode by the cache's bytes. Where
  its blocks are too few to fill the card, each tile's KV range is split
  over several blocks (:func:`n_splits`).

All three split alike: the blocks that share a tile's KV range each leave
their partial softmax state, and a second kernel merges them in a fixed
order (split-KV). :func:`launch_plan` names a call's kernel and split.

Per-row key counts and a page table (the serving engine's paged cache):
``kv_lens`` (B,) gives row b its own ``Skv_b`` (its query i sits at
``Skv_b - Sq + i``; keys at or past ``Skv_b`` are never read), and
``page_table`` (B, max_pages) with the arenas (P, page_len, KV, hd) as k
and v reads key j of row b from arena row ``page_table[b, j // page_len] *
page_len + j % page_len``, inside the kernel: no page is copied. All three
kernels take both, through one address helper every K/V load goes through,
and neither changes which kernel a call takes. Splits are computed from
``max_kv_len``, which the caller knows on the host, and a row's split
bounds depend only on its own key count and the split count, so a row
gives the same bits paged and contiguous.

None uses atomics: two calls give the same bits. The wrapper takes any
Sq, Skv and hd <= 256 and any strides over (b, h, s) with the last
dimension contiguous, so the model passes its (B, S, KV, hd) cache slices as
permuted views without copying.

The kernel is forward-only, as the Pallas kernel is: on the card, inputs
that need gradients (grad mode on and q, k or v requiring grad) raise, so a
trainer cannot take its output, which has no ``grad_fn``, for a
differentiable one. Training runs ``models.layers.plain_attention``.

CPU tensors go to the plain version (:func:`..ref.flash_attention_ref`);
CUDA tensors launch a kernel or raise. ``flash_attention.launches`` counts
launches; ``decode_launches``, ``tensor_core_launches`` and ``fma_launches``
split it by kernel, and ``paged_launches`` counts the launches that read
through a page table.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TENSOR_CORE_MAX_HEAD_DIM = 128
# The kernel's tile: 16 packed rows (query rows x the G heads of a KV head)
# when a (b, kv head) has at most 16, else 64; KV tiles of 64 keys.
_FEW_ROWS, _BQ_FEW, _BQ, _BK = 16, 16, 64, 64
_MIN_TILES_PER_SPLIT = 4
# The tensor-core kernel's tile: 128 packed rows by 64 keys. One block
# holds an SM (255 registers a thread), so its KV range is split only where
# the unsplit grid leaves over half the SMs idle, into at most this many
# blocks an SM.
_TC_BQ, _TC_BLOCKS_PER_SM = 128, 3
# The decode kernel: a block per (b, kv head) and split of the KV range,
# split so that every SM gets about this many blocks in one wave, each
# split at least this many keys long.
_DECODE_BLOCKS_PER_SM, _DECODE_MIN_KEYS = 3, 256
FMA, TENSOR_CORES, DECODE = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 18
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def band_pairs(sq: int, skv: int, causal: bool, window: int) -> Tuple[int, int]:
    """(query, key) pairs inside the causal/window band, and the number of
    keys that some query sees, for end-aligned query positions (host
    arithmetic)."""
    if sq == 0:
        return 0, 0
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
    hi = np.minimum(pos, skv - 1) if causal else np.full_like(pos, skv - 1)
    count = np.maximum(hi - lo + 1, 0)
    seen = int(hi.max() - lo.min() + 1) if bool((count > 0).any()) else 0
    return int(count.sum()), seen


def cost(b, h, kv, sq, skv, hd, causal, window, q_itemsize, kv_itemsize,
         kv_lens=None, index_bytes: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call: q read and the output written once, the
    K and V rows some query of a row sees read once, QKᵀ and PV (4·hd a
    (query, key) pair in the band). ``kv_lens``: each row's key count (a
    host sequence; default ``skv`` for every row); ``index_bytes``: the
    key counts and page table read."""
    pairs = seen = 0
    for n in (kv_lens if kv_lens is not None else [skv] * b):
        p_, s_ = band_pairs(sq, int(n), causal, window)
        pairs, seen = pairs + p_, seen + s_
    n_bytes = 2 * b * h * sq * hd * q_itemsize + 2 * kv * seen * hd * kv_itemsize + index_bytes
    return 4.0 * hd * h * pairs, float(n_bytes)


def n_splits(b, h, kv, sq, skv, causal, window, sm_count) -> int:
    """How many blocks of the FMA kernel share each query tile's KV range:
    enough for two blocks per SM, each with at least 4 KV tiles of the
    tile's band."""
    rows = sq * (h // kv)
    bq = _BQ_FEW if rows <= _FEW_ROWS else _BQ
    blocks = -(-rows // bq) * b * kv
    band = skv
    if causal and window > 0 and sq <= skv:
        band = min(skv, window + bq // (h // kv))
    tiles = -(-band // _BK)
    return max(1, min(-(-2 * sm_count // blocks), tiles // _MIN_TILES_PER_SPLIT))


def tensor_core_splits(b, h, kv, sq, skv, causal, window, sm_count) -> int:
    """How many blocks of the tensor-core kernel share each 128-row tile's
    KV range. 1 where the unsplit blocks fill over half the SMs (there the
    partial accumulators, a packed row a run, written and merged cost more
    than the idle SMs: the engine's suffix prefill, 128 blocks, is slower
    split; ``scripts/kernel_variants.py --only attn --plans`` times it);
    else ``_TC_BLOCKS_PER_SM * sm_count // blocks`` runs, so that the split
    grid holds at most ``_TC_BLOCKS_PER_SM`` blocks an SM, and no more runs
    than leave each at least 4 KV tiles of 64 keys of the tile's band.
    h2o-danube-3-4b's verify step (8 rows x 8 KV heads, 8 queries x G = 4 =
    32 packed rows, ~2,150 keys) is 64 blocks unsplit and takes 6 runs: 384
    blocks, 2.9 blocks an SM on 132 SMs."""
    rows = sq * (h // kv)
    blocks = -(-rows // _TC_BQ) * b * kv
    if 2 * blocks > sm_count:
        return 1
    band = skv
    if causal and window > 0 and sq <= skv:
        band = min(skv, window + _TC_BQ // (h // kv))
    tiles = -(-band // _BK)
    return max(1, min(_TC_BLOCKS_PER_SM * sm_count // blocks,
                      tiles // _MIN_TILES_PER_SPLIT))


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
    """q, k and v all bf16, hd % 8 == 0, every base pointer and every
    stride but the last 16-byte aligned. The output takes q's strides, or
    dense ones, which are multiples of hd."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])
                    for t in (q, k, v)))


def decode_path(q, k, v, kv_heads=None) -> bool:
    """Whether a call takes the decode kernel: q, k and v all bf16, at most
    16 packed rows (``Sq * G <= 16``), ``hd % 8 == 0`` (hd <= 256), every
    base pointer and stride but the last 16-byte aligned. ``kv_heads``
    defaults to k's dimension 1 (k is (B, KV, Skv, hd)); pass it for an
    arena (P, page_len, KV, hd)."""
    _, h, sq, _ = q.shape
    kv = k.shape[1] if kv_heads is None else kv_heads
    return sq * (h // kv) <= _FEW_ROWS and _bf16_aligned(q, k, v)


def tensor_core_path(q, k, v, kv_heads=None) -> bool:
    """Whether a call takes the tensor-core kernel: q, k and v all bf16,
    more than 16 packed rows (``Sq * G > 16``, so decode takes the decode
    kernel), ``hd <= 128`` with ``hd % 8 == 0``, every base pointer and
    (b, h, s) stride 16-byte aligned; ragged, paged or split alike.
    ``kv_heads`` as in :func:`decode_path`."""
    _, h, sq, hd = q.shape
    kv = k.shape[1] if kv_heads is None else kv_heads
    return (sq * (h // kv) > _FEW_ROWS and hd <= TENSOR_CORE_MAX_HEAD_DIM
            and _bf16_aligned(q, k, v))


def launch_plan(q, k, v, kv, skv, causal, window, sm_count) -> Tuple[int, int]:
    """(kernel, n_split) of a CUDA call: the decode kernel where
    :func:`decode_path` holds, else the tensor-core kernel where
    :func:`tensor_core_path` holds, else the FMA kernel, each with its own
    split count. ``kv``: the call's KV heads; ``skv``: its keys, the largest
    row's for a ragged call. Key counts and page tables do not enter the
    choice."""
    b, h, sq, _ = q.shape
    if decode_path(q, k, v, kv_heads=kv):
        return DECODE, decode_splits(b, h, kv, sq, skv, causal, window, sm_count)
    if tensor_core_path(q, k, v, kv_heads=kv):
        return TENSOR_CORES, tensor_core_splits(b, h, kv, sq, skv, causal, window, sm_count)
    return FMA, n_splits(b, h, kv, sq, skv, causal, window, sm_count)


def _check(q, k, v, kv_lens, page_table, max_kv_len):
    """Checks shapes, dtypes and devices; returns (KV, Skv) of the call,
    Skv the largest row's key count."""
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v lie on different devices")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q in {tuple(_DTYPE_CODES)} and k, v of one "
                        f"dtype in it, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, _, hd = q.shape
    paged = page_table is not None
    if paged:   # k, v: arenas (P, page_len, KV, hd)
        kv = k.shape[2]
        if kv_lens is None:
            raise ValueError("flash_attention: a page table needs kv_lens")
        if (page_table.dim() != 2 or page_table.shape[0] != b or page_table.shape[1] == 0
                or page_table.dtype != torch.int32 or page_table.device != q.device):
            raise ValueError(f"flash_attention: page_table must be ({b}, max_pages) int32 "
                             f"on {q.device}, got {tuple(page_table.shape)} "
                             f"{page_table.dtype} on {page_table.device}")
        if k.shape[3] != hd or k.shape[1] == 0:
            raise ValueError(f"flash_attention: arenas {tuple(k.shape)} do not fit q "
                             f"{tuple(q.shape)} (P, page_len, KV, hd)")
        for name, t in (("k", k), ("v", v)):
            if t.stride(0) != t.shape[1] * t.stride(1):
                raise ValueError(f"flash_attention: {name}'s pages must follow each "
                                 "other (stride(0) == page_len * stride(1))")
        skv_cap = page_table.shape[1] * k.shape[1]
    else:
        kv, skv_cap = k.shape[1], k.shape[2]
        if k.shape[0] != b or k.shape[3] != hd:
            raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q "
                             f"{tuple(q.shape)} (same B and hd, H a multiple of KV)")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: H = {h} is not a multiple of KV = {kv}")
    if kv_lens is None:
        skv = skv_cap
    else:
        if (kv_lens.shape != (b,) or kv_lens.dtype != torch.int32
                or kv_lens.device != q.device):
            raise ValueError(f"flash_attention: kv_lens must be ({b},) int32 on "
                             f"{q.device}, got {tuple(kv_lens.shape)} {kv_lens.dtype} "
                             f"on {kv_lens.device}")
        if max_kv_len is None:
            raise ValueError("flash_attention: kv_lens needs max_kv_len, their largest, "
                             "known on the host")
        skv = int(max_kv_len)
        if not paged and skv > skv_cap:
            raise ValueError(f"flash_attention: max_kv_len {skv} exceeds the cache's "
                             f"{skv_cap} positions")
    if skv <= 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    return kv, skv


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None, kv_lens=None, page_table=None,
                    max_kv_len=None):
    """q: (B, H, Sq, hd), k/v: (B, KV, Skv, hd) with H % KV == 0 ->
    (B, H, Sq, hd) in q's dtype. Query head j reads KV head j // (H / KV).
    Query row i sits at absolute position Skv - Sq + i. ``scale`` defaults to
    1 / sqrt(hd); ``window`` 0 means no window.

    ``kv_lens`` (B,) int32 on q's device gives row b its own key count
    (each in [1, Skv]); ``max_kv_len``, a host int, is their largest.
    ``page_table`` (B, max_pages) int32, with ``kv_lens``, makes k and v the
    arenas (P, page_len, KV, hd) (a page's rows contiguous with the next
    page's: stride(0) == page_len * stride(1)) read through the table. The
    page ids are the caller's to keep in [0, P); a logical page past the
    table reads its last entry."""
    kv, skv = _check(q, k, v, kv_lens, page_table, max_kv_len)
    window, softcap = int(window), float(softcap)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and not device_lib.is_fake(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale, kv_lens=kv_lens,
                                   page_table=page_table, max_kv_len=max_kv_len)
    if not device_lib.on_card(q):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the CUDA kernel is forward-only and its output has no "
            "gradient; train through layers.plain_attention (attention impl='plain')")
    b, h, sq, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: kernel takes hd <= {MAX_HEAD_DIM}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")
    out = torch.empty_like(q)       # keeps q's strides: (B, S, H, hd) stays so
    if out.numel() == 0:
        return out
    if device_lib.is_fake(q):       # the dry run: counted, not launched
        lens = None if kv_lens is None else [max_kv_len] * b
        device_lib.record_launch("flash_attention", *cost(
            b, h, kv, sq, skv, hd, causal, window, q.element_size(), k.element_size(), lens))
        return out
    kernel, split = launch_plan(q, k, v, kv, skv, causal, window,
                                device_lib.sm_count(q.device.index))
    return launch(q, k, v, out, kv, skv, kernel, split, causal=causal, window=window,
                  softcap=softcap, scale=scale, kv_lens=kv_lens, page_table=page_table)


def launch(q, k, v, out, kv, skv, kernel, split, *, causal=True, window=0, softcap=0.0,
           scale=None, kv_lens=None, page_table=None):
    """Launch ``kernel`` (FMA, TENSOR_CORES or DECODE) with ``split`` runs of
    each tile's KV range into ``out`` through the C entry, which refuses a
    kernel whose rule the operands do not meet; counts it. The operands as
    :func:`flash_attention` checks them (CUDA tensors); ``kv``: the KV
    heads, ``skv``: the largest row's key count; ``scale`` defaults to 1 /
    sqrt(hd). The wrapper's own launch, and a caller's that times or
    checks one kernel and split on the same call."""
    b, h, sq, hd = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    paged = page_table is not None
    if paged:   # (b, h, s) strides of the arenas: no batch, arena rows
        k_strides = (0, k.stride(2), k.stride(1))
        v_strides = (0, v.stride(2), v.stride(1))
        max_pages, page_len = page_table.shape[1], k.shape[1]
    else:
        k_strides, v_strides = k.stride()[:3], v.stride()[:3]
        max_pages = page_len = 0
    part_ml = part_acc = None
    if split > 1:
        slots = b * kv * split * sq * (h // kv)
        part_ml = torch.empty(2 * slots, dtype=torch.float32, device=q.device)
        part_acc = torch.empty(slots * hd, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k_strides, *v_strides, *out.stride()[:3],
            b, h, kv, sq, skv, hd, scale, int(causal), window, softcap,
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], split, kernel,
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if kv_lens is None else kv_lens.data_ptr(),
            None if page_table is None else page_table.data_ptr(),
            max_pages, page_len, stream)
    build.check_launch(lib, "flash_attention", code)
    flash_attention.launches += 1
    if paged:
        flash_attention.paged_launches += 1
    if kernel == DECODE:
        flash_attention.decode_launches += 1
    elif kernel == TENSOR_CORES:
        flash_attention.tensor_core_launches += 1
    else:
        flash_attention.fma_launches += 1
    return out


flash_attention.launches = 0
flash_attention.decode_launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.fma_launches = 0
flash_attention.paged_launches = 0
