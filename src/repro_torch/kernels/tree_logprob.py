"""Dense tree log-probs ``log p_n(leaf | x)`` over all C_pad leaves, the Eq. 5
bias-removal term that dense prediction adds to the logits.

Replaces ``src/repro/kernels/tree_logprob.py:tree_logprob_all``, the Pallas
TPU kernel that keeps the level recursion of an aligned leaf block in VMEM.
On the H100 the (B, C_pad) float32 output bounds it: at the serving shape
(B = 256, C_pad = 262,144, k = 16) it writes 268 MB and reads 17 MB of tree,
while the node logits are 2k operations per node and row. The CUDA kernel
(``csrc/tree_logprob.cu``) splits the leaves into aligned blocks of 256 and
stages each block's nodes in shared memory once for 256 query rows; a lane
owns 8 leaves and grows their values in registers from its path sum, the
levels above come from neighbouring lanes by warp shuffles, and 4 rows share
each read of a node's weights. Every output float is written once, with
16-byte stores, and no intermediate level reaches device memory (the plain
version writes every level). Any B is taken; padding leaves come out finite.

CPU tensors go to the plain version (:func:`..ref.tree_logprob_all_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import tree_logprob_all_ref

MAX_DEPTH = 30
MAX_K = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("tree_logprob")
    lib.tree_logprob_all_f32.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.tree_logprob_all_f32.restype = ctypes.c_int
    return lib


def _check(w, b, x) -> int:
    """Validate the operands; returns the tree depth."""
    devices = {t.device for t in (w, b, x)}
    if len(devices) != 1:
        raise ValueError(f"tree_logprob_all: operands on several devices {devices}")
    n_nodes = b.shape[0] if b.dim() == 1 else -1
    depth = (n_nodes + 1).bit_length() - 1
    if n_nodes < 1 or (1 << depth) != n_nodes + 1 or depth > MAX_DEPTH:
        raise ValueError(f"tree_logprob_all: b must be (2^d - 1,) with "
                         f"1 <= d <= {MAX_DEPTH}, got {tuple(b.shape)}")
    if w.dim() != 2 or w.shape[0] != n_nodes:
        raise ValueError(f"tree_logprob_all: w must be ({n_nodes}, k), "
                         f"got {tuple(w.shape)}")
    if x.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"tree_logprob_all: x must be (B, k={w.shape[1]}), "
                         f"got {tuple(x.shape)}")
    for name, t in (("w", w), ("b", b), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"tree_logprob_all: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"tree_logprob_all: {name} must be contiguous")
    return depth


def tree_logprob_all(w, b, x):
    """w: (n_nodes, k), b: (n_nodes,), x: (B, k), all float32 ->
    (B, C_pad) float32 over leaves in natural order (C_pad = n_nodes + 1)."""
    depth = _check(w, b, x)
    if w.device.type == "cpu":
        return tree_logprob_all_ref(w, b, x)
    if w.device.type != "cuda":
        raise ValueError(f"tree_logprob_all: no kernel for device {w.device}")
    bsz, k = x.shape
    if bsz > 65535 * 256 or not 1 <= k <= MAX_K:
        raise ValueError(f"tree_logprob_all: kernel takes B <= 16776960 and "
                         f"1 <= k <= {MAX_K}, got B={bsz}, k={k}")
    out = torch.empty((bsz, 1 << depth), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tree_logprob_all_f32(w.data_ptr(), b.data_ptr(),
                                        x.data_ptr(), out.data_ptr(), bsz,
                                        depth, k, stream)
    build.check_launch(lib, "tree_logprob", code)
    tree_logprob_all.launches += 1
    return out


tree_logprob_all.launches = 0
