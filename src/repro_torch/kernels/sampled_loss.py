"""Fused sampled-head loss: the gather, scores, per-kind loss, score
gradients and trunk cotangent of one training step, in one pass.

For slot 0 = the positive and slots 1..m-1 = the negatives of each token t:
``xi = softcap(w[ids]·h + b[ids])``, the per-kind loss, ``coeff = dL/dscore``
(with accidental-hit masking) and ``dh = coeff @ w[ids]``.

Replaces ``src/repro/kernels/sampled_loss.py:sampled_head_loss``, the Pallas
TPU kernel that gathers a block of rows into VMEM and reuses them for the
scores and ``dh``. On the H100 the work is a gather of T·m rows of K values
with four operations per value read (two for the score, two for ``dh``), so
device memory bytes bound it: at the training shape of ``xc_linear``
(T = 256, m = 2, K = 512, float32) about 2.1 MB, which is under a
microsecond of bandwidth and far below a launch: what a token waits for is
the latency of its dependent reads. The CUDA kernel (``csrc/sampled_loss.cu``)
gives each token a block of 4 warps and two round trips to device memory: the
ids (with h[t] and slot_logp, which do not depend on them), then every row of
the token and ``b[ids]`` at once, copied into shared memory with 16-byte
``cp.async``. Rows stay there in their own dtype for the score dots (a warp a
slot) and the ``dh`` pass (a column per thread, slots summed in order), up to
the 227 KB a block can have: :func:`staged_slots` says how many slots that is,
and past it the rows are staged a chunk at a time and read again for ``dh``.
Nothing else depends on K: the kernel takes any K whose h, per-slot values
and one row fit a block's 232,448 bytes (:func:`max_k`): K <= 29,044 for a
float32 table and 38,728 for bf16 at m = 2; 28,996 and 38,664 at m = 17;
27,520 and 36,692 at m = 512.
The loss and coefficient math runs on one warp, a lane per slot, in accurate
``expf``/``log1pf``. No gathered row reaches device memory (the plain version
materializes the (T, m, K) rows twice). torch's int64 ids are read as they
are; T and m are ragged, with no padding of the inputs.

:func:`loss_and_coeffs` is the per-kind math in plain torch, shared by
``repro_torch.core.heads`` and the plain version
(:func:`repro_torch.kernels.ref.sampled_head_loss_ref`). CPU tensors go to
the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.kernels import build
from repro_torch.kernels.ref import sampled_head_loss_ref

# Head kinds with a sampled candidate set (everything except `softmax`); a
# kind's index is its code in the CUDA kernel.
SAMPLED_KINDS = ("uniform_ns", "freq_ns", "adversarial_ns", "nce",
                 "sampled_softmax", "ove", "augment_reduce")
_NS_FAMILY = ("uniform_ns", "freq_ns", "adversarial_ns")
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
MAX_M = 512
_MAX_SMEM_BYTES = 232448          # the most shared memory a block can have


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def staged_slots(m: int, k: int, itemsize: int) -> int:
    """How many of a token's m rows (K values of ``itemsize`` bytes) the
    kernel stages in shared memory at once, beside h, the ids and the
    per-slot values: all m where they fit in a block's 227 KB, else as many
    as fit (the rest in later chunks). The C entry checks it again."""
    fixed = _smem_bytes(0, m, k, itemsize)
    fit = (_MAX_SMEM_BYTES - fixed) // (k * itemsize)
    while fit > 1 and _smem_bytes(fit, m, k, itemsize) > _MAX_SMEM_BYTES:
        fit -= 1
    return max(1, min(m, fit))


def _smem_bytes(chunk: int, m: int, k: int, itemsize: int) -> int:
    """Shared memory of a block staging ``chunk`` rows: the C entry's
    ``smem_bytes`` (rows, h, the ids and four per-slot float arrays)."""
    return (_round16(chunk * k * itemsize) + _round16(4 * k) + _round16(8 * m)
            + 4 * _round16(4 * m))


@functools.lru_cache(maxsize=None)
def max_k(m: int, itemsize: int) -> int:
    """The widest K the kernel takes for m slots of ``itemsize``-byte rows:
    h, the per-slot values and one row in a block's 232,448 bytes of
    shared memory (module docstring)."""
    k = _MAX_SMEM_BYTES // (4 + itemsize) + 16
    while _smem_bytes(1, m, k, itemsize) > _MAX_SMEM_BYTES:
        k -= 1
    return k


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def loss_and_coeffs(scores, slot_logp, acc_hit, *, kind: str,
                    num_labels: int, reg: float = 0.0,
                    softcap: float = 0.0, mask_accidental: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token sampled loss and analytic score gradients, every kind.

    scores: (T, m) RAW candidate scores, slot 0 the positive, slots 1..m-1
    the negatives. slot_logp: (T, m) noise log-probs (zeros where a kind
    ignores them). acc_hit: (T, m) bool, True where a negative slot equals
    the positive id (slot 0 always False).

    Returns (loss_vec (T,), coeff (T, m), xi (T, m)) with
    ``coeff[t, j] = d loss_vec[t] / d scores[t, j]``: the per-row head
    gradient is ``coeff · h`` (w) and ``coeff`` (b). ``xi`` are the
    softcapped scores (for metrics). Differentiable in ``scores`` under
    ``torch.autograd``, which is how the tests hold ``coeff`` to it.
    """
    scores = scores.float()
    n = scores.shape[-1] - 1
    if softcap:
        xi = softcap * torch.tanh(scores / softcap)
        chain = 1.0 - torch.square(xi / softcap)        # d xi / d score
    else:
        xi = scores
        chain = torch.ones_like(scores)
    pos, neg = xi[..., 0], xi[..., 1:]

    if kind in _NS_FAMILY:
        # Eq. 2 logistic loss (+ Eq. 6 unbiased-score regularizer).
        loss = -F.logsigmoid(pos) - F.logsigmoid(-neg).mean(dim=-1)
        g_pos = -torch.sigmoid(-pos)
        g_neg = torch.sigmoid(neg) / n
        if reg:
            unb = xi + slot_logp
            loss = loss + reg * (torch.square(unb[..., 0])
                                 + torch.square(unb[..., 1:]).mean(dim=-1))
            g_pos = g_pos + 2.0 * reg * unb[..., 0]
            g_neg = g_neg + (2.0 * reg / n) * unb[..., 1:]
        g = torch.cat([g_pos[..., None], g_neg], dim=-1)
    elif kind == "nce":
        u = xi - slot_logp - math.log(float(n))
        loss = (-F.logsigmoid(u[..., 0])
                - F.logsigmoid(-u[..., 1:]).sum(dim=-1))
        g = torch.cat([-torch.sigmoid(-u[..., :1]), torch.sigmoid(u[..., 1:])],
                      dim=-1)
    elif kind == "sampled_softmax":
        cand = xi - slot_logp
        if mask_accidental:
            cand = torch.where(acc_hit, -torch.inf, cand)
        loss = torch.logsumexp(cand, dim=-1) - cand[..., 0]
        p = torch.softmax(cand, dim=-1)
        g = torch.cat([p[..., :1] - 1.0, p[..., 1:]], dim=-1)
    elif kind == "ove":
        ind = (~acc_hit[..., 1:]).float()
        scl = (num_labels - 1) / n
        diff = neg - pos[..., None]
        loss = scl * (_softplus(diff) * ind).mean(dim=-1)
        g_neg = (scl / n) * torch.sigmoid(diff) * ind
        g = torch.cat([-g_neg.sum(dim=-1, keepdim=True), g_neg], dim=-1)
    elif kind == "augment_reduce":
        ln_rest = (torch.logsumexp(neg, dim=-1)
                   + math.log((num_labels - 1) / n))
        loss = torch.logaddexp(pos, ln_rest) - pos
        a = torch.sigmoid(ln_rest - pos)               # rest-mass weight
        g_neg = a[..., None] * torch.softmax(neg, dim=-1)
        g = torch.cat([-a[..., None], g_neg], dim=-1)
    else:
        raise ValueError(f"{kind} has no sampled candidate loss")
    return loss, g * chain, xi


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sampled_loss")
    for fn in (lib.sampled_head_loss_f32, lib.sampled_head_loss_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4
                       + [ctypes.c_int] + [ctypes.c_float] * 5
                       + [ctypes.c_int] * 2 + [ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(w, b, h, ids, slot_logp, kind) -> None:
    devices = {t.device for t in (w, b, h, ids, slot_logp)}
    if len(devices) != 1:
        raise ValueError(f"sampled_head_loss: operands on several devices {devices}")
    if kind not in SAMPLED_KINDS:
        raise ValueError(f"sampled_head_loss: {kind!r} has no sampled candidate "
                         f"loss; expected one of {SAMPLED_KINDS}")
    if w.dim() != 2 or b.shape != w.shape[:1]:
        raise ValueError(f"sampled_head_loss: w must be (C, K) and b (C,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if h.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"sampled_head_loss: h must be (T, K={w.shape[1]}), "
                         f"got {tuple(h.shape)}")
    if ids.dim() != 2 or ids.shape[0] != h.shape[0] or slot_logp.shape != ids.shape:
        raise ValueError(f"sampled_head_loss: ids and slot_logp must be "
                         f"(T={h.shape[0]}, m), got {tuple(ids.shape)} and "
                         f"{tuple(slot_logp.shape)}")
    if ids.shape[1] < 2:
        raise ValueError("sampled_head_loss: needs a positive and at least one "
                         f"negative (m >= 2), got m={ids.shape[1]}")
    if w.dtype not in _TABLE_DTYPES or b.dtype != w.dtype:
        raise TypeError(f"sampled_head_loss: w and b must share a dtype in "
                        f"{_TABLE_DTYPES}, got {w.dtype} and {b.dtype}")
    if (h.dtype != torch.float32 or slot_logp.dtype != torch.float32
            or ids.dtype != torch.int64):
        raise TypeError(f"sampled_head_loss: h and slot_logp must be float32 and "
                        f"ids int64, got {h.dtype}, {slot_logp.dtype}, {ids.dtype}")
    for name, t in (("w", w), ("b", b), ("h", h), ("ids", ids),
                    ("slot_logp", slot_logp)):
        if not t.is_contiguous():
            raise ValueError(f"sampled_head_loss: {name} must be contiguous")


def cost(t: int, m: int, k: int, itemsize: int, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a (t, m) call on ``rows`` distinct rows of K
    values of ``itemsize`` bytes: each distinct row and its bias read once,
    h, the ids and slot log-probabilities read, the loss, coefficients, ξ
    and dh written; a score's dot product and its dh term, 4·K a slot."""
    n_bytes = (rows * (k + 1) * itemsize + t * k * 4 + t * m * (8 + 4) + t * 4
               + 2 * t * m * 4 + t * k * 4)
    return float(t * m * 4 * k), float(n_bytes)


def sampled_head_loss(w, b, h, ids, slot_logp, *, kind: str,
                      num_labels: int, reg: float = 0.0,
                      softcap: float = 0.0, mask_accidental: bool = True):
    """w: (C,K) float32/bfloat16, b: (C,) same dtype, h: (T,K) float32,
    ids: (T,m) int64 in [0, C), slot_logp: (T,m) float32; slot 0 is the
    positive, m >= 2.

    Returns (loss_vec (T,), coeff (T,m), xi (T,m), dh (T,K)), all float32.
    On the card a token with an id outside [0, C) gets NaN in all its
    outputs; the id is never read.
    """
    _check(w, b, h, ids, slot_logp, kind)
    kw = dict(kind=kind, num_labels=num_labels, reg=reg, softcap=softcap,
              mask_accidental=mask_accidental)
    if w.device.type == "cpu" and not device_lib.is_fake(w):
        return sampled_head_loss_ref(w, b, h, ids, slot_logp, **kw)
    if not device_lib.on_card(w):
        raise ValueError(f"sampled_head_loss: no kernel for device {w.device}")
    (c, k), (t, m) = w.shape, ids.shape
    if m > MAX_M or t >= 2 ** 31:
        raise ValueError(f"sampled_head_loss: kernel takes m <= {MAX_M}, T < 2^31; "
                         f"got m={m}, T={t}")
    if k > max_k(m, w.element_size()):
        raise ValueError(f"sampled_head_loss: kernel takes K <= "
                         f"{max_k(m, w.element_size())} for m={m} and a {w.dtype} "
                         f"table (h, the per-slot values and one row must fit a "
                         f"block's {_MAX_SMEM_BYTES} bytes of shared memory); got K={k}")
    dev = w.device
    loss = torch.empty((t,), dtype=torch.float32, device=dev)
    coeff = torch.empty((t, m), dtype=torch.float32, device=dev)
    xi = torch.empty((t, m), dtype=torch.float32, device=dev)
    dh = torch.empty((t, k), dtype=torch.float32, device=dev)
    if t == 0:
        return loss, coeff, xi, dh
    if device_lib.is_fake(w):       # the dry run: every id distinct, the most rows
        device_lib.record_launch("sampled_head_loss", *cost(t, m, k, w.element_size(),
                                                            min(t * m, c)))
        return loss, coeff, xi, dh
    n = m - 1
    scl = (num_labels - 1) / n                   # ove, as the plain version
    lib = _lib()
    fn = lib.sampled_head_loss_f32 if w.dtype == torch.float32 else lib.sampled_head_loss_bf16
    vec = int(w.data_ptr() % 16 == 0 and h.data_ptr() % 16 == 0
              and (k * w.element_size()) % 16 == 0)
    chunk = staged_slots(m, k, w.element_size())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(w.data_ptr(), b.data_ptr(), h.data_ptr(), ids.data_ptr(),
                  slot_logp.data_ptr(), loss.data_ptr(), coeff.data_ptr(),
                  xi.data_ptr(), dh.data_ptr(), t, m, k, c,
                  SAMPLED_KINDS.index(kind), reg, softcap, scl, scl / n,
                  math.log(scl), int(bool(mask_accidental)), vec, chunk, stream)
    build.check_launch(lib, "sampled_head_loss", code)
    sampled_head_loss.launches += 1
    return loss, coeff, xi, dh


sampled_head_loss.launches = 0
