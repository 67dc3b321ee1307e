"""Dense tree log-probs ``log p_n(leaf | x)`` over all C_pad leaves, the Eq. 5
bias-removal term that dense prediction adds to the logits.

Replaces ``src/repro/kernels/tree_logprob.py:tree_logprob_all``, the Pallas
TPU kernel that keeps the level recursion of an aligned leaf block in VMEM.
On the H100 the (B, C_pad) float32 output bounds it: at the prediction shape
(B = 256, C_pad = 262,144, k = 16) it writes 268 MB and reads 17 MB of tree,
while the node logits are 2k operations per node and row.

``csrc/tree_logprob.cu`` holds two kernels; :func:`launch_plan` picks one
from the shape alone and the C entry checks its choice again:

- the tensor-core kernel takes every tree of depth >= 8. Its node logits
  for 16 rows and 8 nodes are one ``mma.sync`` m16n8k8 tile with x and w
  split into TF32 hi + lo parts (three products, float32 accuracy), and the
  nodes of a 16-leaf sub-block are placed in two tiles so that each lane
  ends up holding the whole path of its 4 leaves for 2 rows: one
  log_sigmoid a node and row, no shuffles, a 16-byte streaming store a row.
  A block stages the nodes of up to 16 sub-blocks and their ancestors once
  for up to 16 row groups; warps take (row group, sub-block) pairs, so at
  small B the leaves, not the rows, spread over the warps, and only real
  rows of x are read.
- the FMA kernel (the earlier design) takes trees of fewer than 256
  leaves: float32 FMAs over 256-leaf blocks staged in shared memory, a lane
  owning 8 leaves and 4 rows sharing each read of a node.

Every output float is written once and no intermediate level reaches device
memory (the plain version writes every level). Any B is taken; padding
leaves come out finite. Neither kernel uses atomics: two calls give the same
bits.

CPU tensors go to the plain version (:func:`..ref.tree_logprob_all_ref`);
CUDA tensors launch a kernel or raise. ``tree_logprob_all.launches`` counts
launches; ``tensor_core_launches`` and ``fma_launches`` split it by kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import tree_logprob_all_ref

MAX_DEPTH = 30
MAX_K = 32
FMA, TENSOR_CORES = 0, 1
# The tensor-core kernel: leaf blocks of 2^8 leaves, each of 16 sub-blocks
# of 16 leaves; row groups of 16 rows; at most 65,535 row chunks a launch.
TENSOR_CORE_MIN_DEPTH = 8
_ROWS, _SUB_BLOCKS, _MAX_ROW_GROUPS, _MIN_SUB_BLOCKS = 16, 16, 16, 8
_MAX_CHUNKS = 65535
_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("tree_logprob")
    lib.tree_logprob_all_f32.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(bsz: int, depth: int, sm_count: int):
    """(kernel, row_groups, sub_blocks) for a (bsz, 2^depth) call.

    Trees of fewer than 2^8 leaves take the FMA kernel (the other two are
    then 0). Else the tensor-core kernel, whose block takes ``sub_blocks``
    16-leaf sub-blocks of one 256-leaf block and ``row_groups`` groups of
    16 rows: as many rows as B has, up to 256, and all 16 sub-blocks, halved
    (rows first, then sub-blocks down to 8) while the grid has fewer than
    two blocks an SM.
    """
    if depth < TENSOR_CORE_MIN_DEPTH:
        return FMA, 0, 0
    groups = max(1, -(-bsz // _ROWS))
    leaf_blocks = 1 << (depth - TENSOR_CORE_MIN_DEPTH)
    row_groups, sub_blocks = min(_MAX_ROW_GROUPS, groups), _SUB_BLOCKS

    def blocks():
        return leaf_blocks * (_SUB_BLOCKS // sub_blocks) * -(-groups // row_groups)

    while blocks() < _BLOCKS_PER_SM * sm_count:
        if row_groups > 1:
            row_groups = -(-row_groups // 2)
        elif sub_blocks > _MIN_SUB_BLOCKS:
            sub_blocks //= 2
        else:
            break
    return TENSOR_CORES, row_groups, sub_blocks


def tree_logprob_all(w, b, x):
    """w: (n_nodes, k), b: (n_nodes,), x: (B, k), all float32 ->
    (B, C_pad) float32 over leaves in natural order (C_pad = n_nodes + 1)."""
    depth = _check(w, b, x)
    if w.device.type == "cpu":
        return tree_logprob_all_ref(w, b, x)
    if w.device.type != "cuda":
        raise ValueError(f"tree_logprob_all: no kernel for device {w.device}")
    bsz, k = x.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"tree_logprob_all: kernel takes 1 <= k <= {MAX_K}, got k={k}")
    out = torch.empty((bsz, 1 << depth), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return out
    plan = launch_plan(bsz, depth, _sm_count(x.device.index or 0))
    return _launch(w, b, x, out, depth, *plan)


def _launch(w, b, x, out, depth, kernel, row_groups, sub_blocks):
    """Launch ``kernel`` (FMA or TENSOR_CORES) into ``out``; counts it."""
    bsz, k = x.shape
    rows_per_chunk = 256 if kernel == FMA else _ROWS * row_groups
    if rows_per_chunk > 0 and -(-bsz // rows_per_chunk) > _MAX_CHUNKS:
        raise ValueError(f"tree_logprob_all: B={bsz} needs more than {_MAX_CHUNKS} "
                         f"chunks of {rows_per_chunk} rows")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tree_logprob_all_f32(w.data_ptr(), b.data_ptr(), x.data_ptr(),
                                        out.data_ptr(), bsz, depth, k, kernel,
                                        row_groups, sub_blocks, stream)
    build.check_launch(lib, "tree_logprob", code)
    tree_logprob_all.launches += 1
    if kernel == FMA:
        tree_logprob_all.fma_launches += 1
    else:
        tree_logprob_all.tensor_core_launches += 1
    return out


tree_logprob_all.launches = 0
tree_logprob_all.tensor_core_launches = 0
tree_logprob_all.fma_launches = 0
