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

No fixed k: above 32 features the tensor-core kernel adds the products of
32-feature chunks before any ``log_sigmoid`` (a lane's registers hold one
chunk of x), and the FMA kernel takes its width at run time. What bounds k
is the shared memory the staged weights take, which grows with k:
:func:`launch_plan` takes fewer sub-blocks where 16 do not fit a block, and
:func:`largest_k` is the widest x that fits at the fewest (at least 288 at
any depth; 320 at depth 18, 148 on the FMA kernel at depth 7).

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
from typing import Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import build
from repro_torch.kernels.ref import tree_logprob_all_ref

MAX_DEPTH = 30
FMA, TENSOR_CORES = 0, 1
# The tensor-core kernel: leaf blocks of 2^8 leaves, each of 16 sub-blocks
# of 16 leaves; row groups of 16 rows; at most 65,535 row chunks a launch.
TENSOR_CORE_MIN_DEPTH = 8
_ROWS, _SUB_BLOCKS, _MAX_ROW_GROUPS, _MIN_SUB_BLOCKS = 16, 16, 16, 8
_MAX_CHUNKS = 65535
_BLOCKS_PER_SM = 2
_MAX_SMEM_BYTES = 232448          # the most shared memory a block can have
_WARPS, _ROWS_PER_FMA_BLOCK = 8, 256
# A tensor-core warp's scratch, in floats: two (32 node, 20) term tables,
# 16 prefix sums and the (32 unit, 16 row) base table (csrc kScratch).
_TC_SCRATCH = 2 * 32 * 20 + 16 + 32 * 16


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


def cost(bsz: int, n_nodes: int, k: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a call: the nodes' (n_nodes, k) weights and biases
    and x read once, the (B, n_nodes + 1) float32 leaves written; a dot
    product, the bias and a log-sigmoid pair per (row, node)."""
    n_bytes = 4 * (bsz * (n_nodes + 1) + n_nodes * k + n_nodes + bsz * k)
    return float(bsz * n_nodes * (2 * k + 3)), float(n_bytes)


def tc_smem_bytes(depth: int, k: int, sub_blocks: int) -> int:
    """Shared memory of a tensor-core block (csrc ``tc::smem_bytes``): each
    staged tile's 8 nodes as TF32 hi and lo parts of ``node_ld`` floats and
    their biases, and 8 warps' scratch. k <= 32 is one chunk of 8·KS
    features (node_ld 8·KS, 36 at KS = 4); wider k is nc chunks of 32
    (node_ld 32·nc + 4)."""
    ks = 4 if k > 32 else -(-k // 8)
    nc = -(-k // (8 * ks))
    ld = 32 * nc + 4 if ks == 4 else 8 * ks
    n_tiles = -(-(depth - TENSOR_CORE_MIN_DEPTH) // 8) + 4 + 2 * sub_blocks
    return 4 * (n_tiles * 8 * (2 * ld + 1) + _WARPS * _TC_SCRATCH)


def fma_smem_bytes(depth: int, k: int) -> int:
    """Shared memory of an FMA block (csrc ``fma_smem_bytes``): the staged
    nodes' weights (k padded to kp, a multiple of 4, and a row stride with
    an odd number of 16-byte chunks), their biases and 256 rows of x."""
    kp = -(-k // 4) * 4
    stride = kp if (kp // 4) % 2 else kp + 4
    sub = min(depth, TENSOR_CORE_MIN_DEPTH)
    n_slots = depth - sub + (1 << sub) - 1
    return 4 * (n_slots * stride + -(-n_slots // 4) * 4 + _ROWS_PER_FMA_BLOCK * kp)


@functools.lru_cache(maxsize=None)
def largest_k(depth: int, kernel: int) -> int:
    """The widest x ``kernel`` takes for a tree of ``depth``: the most
    features whose staging fits a block's 232,448 bytes of shared memory,
    at one sub-block for the tensor-core kernel."""
    def fits(k):
        n = tc_smem_bytes(depth, k, 1) if kernel == TENSOR_CORES else fma_smem_bytes(depth, k)
        return n <= _MAX_SMEM_BYTES
    k = 1
    while fits(k + 1):
        k += 1
    return k


def launch_plan(bsz: int, depth: int, sm_count: int, k: int):
    """(kernel, row_groups, sub_blocks) for a (bsz, 2^depth) call on x of
    k features.

    Trees of fewer than 2^8 leaves take the FMA kernel (the other two are
    then 0). Else the tensor-core kernel, whose block takes ``sub_blocks``
    16-leaf sub-blocks of one 256-leaf block and ``row_groups`` groups of
    16 rows: as many rows as B has, up to 256, and the most sub-blocks
    whose staging fits a block (16 to k = 64, 8 to 96, 4 to 160, 2 to 256,
    at depth 18 or 30), halved (rows first, then sub-blocks down to 8)
    while the grid has fewer than two blocks an SM. Two blocks share an SM
    where one takes at most about 113 KB: at k <= 16 with 16 sub-blocks, at
    k <= 32 with 8, not at k = 64 (224,448 bytes with 16 at depth 18).
    """
    if depth < TENSOR_CORE_MIN_DEPTH:
        return FMA, 0, 0
    groups = max(1, -(-bsz // _ROWS))
    leaf_blocks = 1 << (depth - TENSOR_CORE_MIN_DEPTH)
    row_groups, sub_blocks = min(_MAX_ROW_GROUPS, groups), _SUB_BLOCKS
    while sub_blocks > 1 and tc_smem_bytes(depth, k, sub_blocks) > _MAX_SMEM_BYTES:
        sub_blocks //= 2

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
    if w.device.type == "cpu" and not device_lib.is_fake(w):
        return tree_logprob_all_ref(w, b, x)
    if not device_lib.on_card(w):
        raise ValueError(f"tree_logprob_all: no kernel for device {w.device}")
    bsz, k = x.shape
    kernel = FMA if depth < TENSOR_CORE_MIN_DEPTH else TENSOR_CORES
    if not 1 <= k <= largest_k(depth, kernel):
        raise ValueError(f"tree_logprob_all: kernel takes 1 <= k <= "
                         f"{largest_k(depth, kernel)} at depth {depth} (the staged "
                         f"weights must fit a block's {_MAX_SMEM_BYTES} bytes of "
                         f"shared memory), got k={k}")
    out = torch.empty((bsz, 1 << depth), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return out
    if device_lib.is_fake(x):       # the dry run: counted, not launched
        device_lib.record_launch("tree_logprob_all", *cost(bsz, w.shape[0], k))
        return out
    plan = launch_plan(bsz, depth, device_lib.sm_count(x.device.index or 0), k)
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
