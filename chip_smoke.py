#!/usr/bin/env python3
"""Drives the PyTorch port's prediction, training, generator-fitting and LM-serving paths on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit) and the TF32 switches;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. time an empty kernel launched through the same ctypes path (the launch
     floor, printed beside each bound); hold each kernel against its plain
     PyTorch version at the shapes of the main paths (full ``xc_linear``
     width; ``sampled_head_loss`` for all 7 kinds, both table dtypes,
     reg/softcap off and on, two calls bit-equal; ``tree_logprob_all`` and
     ``gather_scores`` also at the LM-serving path's shapes, the former
     timed beside its FMA kernel, the latter on the variant its launch plan
     names, each two calls bit-equal and timed alone too; ``segment_stats``
     at the generator fit's 8 shapes over N = 524,288 points, bit-exact
     across two calls with one plan and a call that sorts its own ids; the
     plan and a call with it timed apart), time both, and check the
     prediction path on a small input against the port's CPU run;
  4. the prediction path at full ``xc_linear`` width (C = 217,240, K = 512,
     k = 16, depth 18): 4 request batches of 256 queries through dense Eq. 5
     prediction and tree-beam top-k, launch counters reset just before and
     read just after (every ``gather_scores`` call on the rows variant);
     exhaustive beam against dense top-5 on 4 queries;
  5. the training path at full ``xc_linear`` width: ``train_linear_head``
     (adversarial_ns, 1 negative, batch 256, sparse Adagrad), counters reset
     just before and read just after; ms per step, its device time by
     kernel and layer, the idle share and the wait at ``torch.unique``'s
     sync; kernel against plain version on one step's candidates and over 5
     steps; ms per step at C = 2,097,152;
  6. the paper's pipeline at small size on the card (fit, train adversarial
     and uniform, predict), with the system test's three assertions;
  7. the generator-fitting path at full ``xc_linear`` width: the
     level-parallel fit (C = 217,240, depth 18, k = 16, lambda_n = 0.1) on
     524,288 clustered points, counters reset just before and read just
     after, one ``segment_plan`` per Newton solve and one for the labels;
     wall time, time per level, profiles of levels 2 and 17 (the share of
     ``segment_stats``'s calls and plans, the idle share), the tree's invariants and
     its held-out log-likelihood against uniform; a warm refit on drifted
     features, run twice and bit-equal; at C = 1,024 the fit against the
     numpy oracle, and at C = 4,096 the sharded fit serial against threaded;
  8. ``flash_attention`` against its plain version on seven shapes
     (h2o-danube prefill and decode at B = 4, gemma2's softcap geometry
     and decode, stablelm-3b's prefill and decode, each laid out and scaled
     as the model calls it; a ragged float32 case), within one bf16 ulp of
     each output row and 2^-11 relative RMS, two calls bit-equal, the kernel
     each shape took (the tensor-core kernel for the three bf16 prefills,
     the decode kernel for the three decodes, the FMA kernel for float32);
     kernel, plain and ``scaled_dot_product_attention`` times (phase 3's
     kernel checks run before it);
  9. the LM-serving path at full h2o-danube-3-4b width (24 layers, d 3840,
     32 query heads over 8 KV heads, hd 120, window 4,096, vocab 32,000):
     the lock-step launcher serves 4 requests of 4,608 prompt tokens and 32
     greedy tokens through dense Eq. 5 scoring and again through beam 64,
     counters reset just before and read just after each (prefill on the
     tensor-core kernel, decode on the decode kernel, beam scoring on
     ``gather_scores``'s split variant); prefill and
     per-token ms, the device time by kernel and idle share of one decode
     step, peak memory; prefill plus decode of all 4 requests through the
     cache against the plain version's cache-free forward over the 4,640
     cached tokens (hiddens and dense Eq. 5 scores of every decode step);
 10. print the ``kernels`` JSON line and, last, the device line.

Exits non-zero without a CUDA device, and prints no result then.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, device as device_lib, genfit  # noqa: E402
from repro_torch.configs import xc_linear  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm_head, transformer  # noqa: E402
from repro_torch.train import make_prefill, make_serve_step  # noqa: E402
from repro_torch.core import heads, tree as tree_lib, tree_fit, xc_train  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.genfit import levels as genfit_levels  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import gather_scores as gather_scores_lib, tree_logprob  # noqa: E402
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS  # noqa: E402
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.optim.sparse import accumulate_rows  # noqa: E402

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # bfloat16 tensor cores, dense

BATCH = 256                      # queries in one request batch
N_BATCHES = 4
BEAM = 64
TOPK = 5
GATHER_TOL = dict(atol=1e-5, rtol=1e-5)   # one K-term float32 dot, two orders
TREE_TOL = dict(atol=1e-4, rtol=1e-5)     # depth-term sums, two log_sigmoid forms
SCORE_TOL = dict(atol=1e-4, rtol=1e-5)    # beam scores against dense Eq. 5 scores
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)     # losses, coefficients, scores; dh against its terms
PARAM_TOL = 1e-4                          # params after 5 Adagrad steps, kernel against plain
TIMING_ITERS = 20

TRAIN_EXAMPLES = 65_536          # Gaussian features, zipf labels
TRAIN_STEPS = 300
WIDE_SHAPE = (2048, 17)          # (T, m) of the second timed sampled_head_loss shape
BIG_C = 2_097_152                # the step-cost-independent-of-C figure
BIG_STEPS = 100

SEG_POINTS = 524_288             # the fit's points: 2 per padded leaf of xc_linear
SEG_TOL = 1e-4                   # of the segment's sum of |vals| (+ the same absolute)
SEG_SHAPES = [                   # (name, D, S, ids, vals dtype), the fit's reductions
    ("hessian_level0", 289, 1, "uniform", torch.float32),
    ("hessian_level12", 289, 4096, "uniform", torch.float32),
    ("hessian_level17", 289, 131_072, "uniform", torch.float32),
    ("gradient_level17", 17, 131_072, "uniform", torch.float32),
    ("armijo_level17", 10, 131_072, "uniform", torch.float32),
    ("delta_labels", 1, 262_144, "zipf", torch.float32),
    ("gradient_level17_bf16", 17, 131_072, "uniform", torch.bfloat16),
    ("gradient_level12_out_of_range", 17, 4096, "out_of_range", torch.float32),
]
SEG_MAIN = "hessian_level17"     # the shape of the kernels line
FIT_POINTS = SEG_POINTS
FIT_HELD_OUT = 16_384
FIT_PROFILE_LEVELS = (2, 17)     # levels profiled by kernel: a shallow one, the widest

# flash_attention's shapes: (name, B, H, KV, Sq, Skv, hd, causal, window,
# softcap, dtype, cache length). A shape with a cache length is called as
# the model calls the kernel: q a (B, Sq, H, hd) projection scaled by
# 1/sqrt(hd) in its dtype and permuted, k and v a (B, cache length, KV, hd)
# cache sliced to Skv and permuted, scale=1.0. Cache length 0: contiguous
# (B, H, S, hd) tensors and the default scale.
ATTN_SHAPES = [
    ("danube_prefill", 4, 32, 8, 4608, 4608, 120, True, 4096, 0.0, torch.bfloat16, 4640),
    ("danube_decode", 4, 32, 8, 1, 4640, 120, True, 4096, 0.0, torch.bfloat16, 4640),
    ("gemma2_softcap", 1, 32, 16, 2048, 2048, 128, True, 4096, 50.0, torch.bfloat16, 2080),
    ("ragged_fp32", 2, 4, 2, 37, 101, 80, False, 0, 0.0, torch.float32, 0),
    ("stablelm_prefill", 1, 32, 32, 2048, 2048, 80, True, 0, 0.0, torch.bfloat16, 2080),
    ("gemma2_decode", 4, 32, 16, 1, 2080, 128, True, 4096, 50.0, torch.bfloat16, 2080),
    ("stablelm_decode", 4, 32, 32, 1, 2080, 80, True, 0, 0.0, torch.bfloat16, 2080),
]
ATTN_MAIN = "danube_prefill"     # the shape of the kernels line
# The kernel each shape takes: the tensor-core kernel (bf16, more than 16
# packed rows, hd <= 128), the decode kernel (bf16, at most 16 packed rows)
# or the FMA kernel (float32).
ATTN_KERNEL = {"danube_prefill": "tensor_cores", "gemma2_softcap": "tensor_cores",
               "stablelm_prefill": "tensor_cores", "danube_decode": "decode",
               "gemma2_decode": "decode", "stablelm_decode": "decode", "ragged_fp32": "fma"}
ATTN_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bfloat16: kernel and plain version both keep float32 precision until the
# output and round once to bfloat16, so an output differs by at most one
# rounding of its own value plus their float32 difference, which is far
# below a bf16 ulp of its row:
# |got - want| <= 2^-8 * max|want over the (b, h, i) row| + 2^-7 * |want|.
# The FMA kernel computes in float32 throughout (~2^-20 relative from the
# plain version). The tensor-core kernel multiplies bf16 q, k, v, whose
# products are exact in float32 and are summed in float32, and splits P into
# bf16 hi + lo parts for P.V, so P keeps ~2^-17 of its value: its float32
# result differs by ~2^-17 relative. Either way only a small share of the
# outputs straddle a rounding boundary: over the whole output the relative
# RMS difference is held to 2^-11. Rounding P to bf16 once before P.V (what
# the reference model does, and neither kernel) reads about 2^-9 there.
ATTN_BF16_ROW_ULP, ATTN_BF16_REL, ATTN_BF16_REL_RMS = 2.0 ** -8, 2.0 ** -7, 2.0 ** -11
SERVE_ARCH = "h2o-danube-3-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_BEAM = 4, 4608, 32, 64
ATTN_BLOCK = 512                 # query rows per block of the plain forward's attention
# Kernel path (prefill + decode through the bf16 cache) against the plain
# version's cache-free forward, both in bfloat16 with the same bf16 weights:
# the two differ in float32 summation order inside attention and in the
# matmuls' shapes (4 decode rows against 4,640), so bf16 roundings differ
# and drift through 24 layers. Held to 2^-5 of the reference's RMS (about
# four bf16 roundings of relative error; one fp8 e4m3 rounding, 2^-4, fails
# it), over the hiddens (after the final RMSNorm, unit scale) and over the
# dense Eq. 5 scores of the real labels.
SERVE_REL_RMS_TOL = 2.0 ** -5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def close(got: torch.Tensor, want: torch.Tensor, tol: dict) -> bool:
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())


def round_times(fn, flush: torch.Tensor, rounds: int) -> list:
    """Device ms of each of ``rounds`` calls of ``fn`` with CUDA events, L2
    flushed before each call by reading ``flush`` (a read leaves no dirty
    lines to write back). A GPU-side spin ahead of each call lets the host
    enqueue the whole call before the device reaches it, so host overhead
    is not timed."""
    events = []
    for _ in range(rounds):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def time_ms(fn, flush: torch.Tensor, iters: int = TIMING_ITERS) -> float:
    """Mean of ``round_times`` over ``iters`` calls after one untimed: in
    the first round of a process the host can outlast the spin (loading
    the flush's kernel) and the device waits inside the call."""
    return sum(round_times(fn, flush, iters + 1)[1:]) / iters


def kernel_device_ms(fn, flush, name: str, iters: int = TIMING_ITERS,
                     attempts: int = 3):
    """Mean device time of one launch of the kernels named ``name`` (one a
    call of ``fn``), by torch.profiler, L2 flushed before each call: the
    kernel's own run, without the launch that ``time_ms`` also counts, and
    the launches the mean is over. The profiler now and then records none
    of the kernels of some calls (the flushes' neither), so the mean is over
    the launches it recorded; a line gives every kernel's count when that is
    not ``iters``, and a profile that recorded none is taken again, up to
    ``attempts`` times (NaN over 0 if every one comes back empty)."""
    def calls():
        for _ in range(iters):
            flush.sum()
            fn()
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        by_name, _, _, _, counts = profile_by_kernel(calls)
        seen = sum(v for k, v in counts.items() if name in k)
        if seen != iters:
            print(json.dumps({"profiler_launches": {
                "kernel": name, "calls": iters, "seen": seen, "attempt": attempt,
                "recorded": {k[:60]: v for k, v in counts.items()}}}))
        if seen:
            return sum(v for k, v in by_name.items() if name in k) / seen, seen
    return float("nan"), 0


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def gather_shapes(cfg):
    """(name, C, K, T, n, w scale, table dtypes) of gather_scores's checked
    calls: the prediction beam's at full xc_linear width (B = 256, 64
    candidates, K = 512) and the LM-serving beam path's (4 rows, 64
    candidates, K = d_model = 3,840 of h2o-danube-3-4b, the head's float32
    table)."""
    serve_cfg = configs.get_config(SERVE_ARCH)
    return [("xc_linear", cfg.num_labels, cfg.feature_dim, BATCH, BEAM, 0.05,
             (torch.float32, torch.bfloat16)),
            ("serving_beam", serve_cfg.padded_vocab, serve_cfg.d_model, SERVE_BATCH,
             SERVE_BEAM, 0.02, (torch.float32,))]


def gather_inputs(dev, gen, c, kdim, t, n, scale):
    w32 = scale * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    h = torch.randn((t, kdim), generator=gen, device=dev)
    ids = torch.randint(0, c, (t, n), generator=gen, device=dev)
    return w32, b32, h, ids


def gather_variant(plan) -> str:
    return "rows" if plan[0] == gather_scores_lib.ROWS else "split"


def check_gather(dev, gen, flush, cfg, floor):
    """Each of gather_shapes' calls in its table dtypes: the variant of its
    launch plan taken, kernel against plain version, two calls bit-equal;
    kernel (with its launch), plain version and the kernel alone timed."""
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for shape, c, kdim, t, n, scale, dtypes in gather_shapes(cfg):
        w32, b32, h, ids = gather_inputs(dev, gen, c, kdim, t, n, scale)
        rows = torch.unique(ids).numel()
        for dtype in dtypes:
            w, b = w32.to(dtype), b32.to(dtype)
            plan = gather_scores_lib.launch_plan(t, n, kdim, w.element_size(), sm_count)
            counter = f"{gather_variant(plan)}_launches"
            before = getattr(ops.gather_scores, counter)
            got = ops.gather_scores(w, b, h, ids)
            again = ops.gather_scores(w, b, h, ids)
            took = getattr(ops.gather_scores, counter) - before
            want = ref.gather_scores_ref(w, b, h, ids)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            what = f"gather_scores {shape} {str(dtype)[6:]}: T={t} n={n} K={kdim} C={c}"
            print(f"{what} plan={plan} max_abs_err={err:.3e} tol={GATHER_TOL}")
            check(took == 2, f"{what}: not on the {gather_variant(plan)} variant of its plan")
            check(torch.equal(got, again), f"{what}: two calls differ")
            check(close(got, want, GATHER_TOL), f"{what} disagrees")
            elt = w.element_size()
            n_bytes = (rows * kdim * elt + rows * elt + ids.numel() * 8
                       + h.numel() * 4 + ids.numel() * 4)
            bound, by = bound_ms(n_bytes, ids.numel() * (2 * kdim + 1))
            ms = time_ms(lambda: ops.gather_scores(w, b, h, ids), flush)
            plain = time_ms(lambda: ref.gather_scores_ref(w, b, h, ids), flush)
            device, seen = kernel_device_ms(lambda: ops.gather_scores(w, b, h, ids), flush,
                                            "gather_scores_kernel")
            print(f"{what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by}, {rows} distinct rows), launch floor {floor:.4f} ms; "
                  f"device time alone (profiler) {device:.4f} ms over {seen} launches")
            result[(shape, str(dtype)[6:])] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                device_ms=None if math.isnan(device) else device,
                device_ms_launches_seen=seen, plan=list(plan),
                variant=gather_variant(plan), bit_equal=True)
    print(json.dumps({"gather_scores": {f"{k[0]}/{k[1]}": v for k, v in result.items()}}))
    main = dict(result[("xc_linear", "float32")])
    main["shapes"] = {f"{k[0]}/{k[1]}": {key: v[key] for key in (
        "ms", "device_ms", "device_ms_launches_seen", "bound_ms", "plain_ms", "max_abs_err",
        "variant")}
        for k, v in result.items()}
    return main


def launch_floor_ms(flush):
    """Time of an empty kernel launched through the ctypes path, by
    ``time_ms`` and by the profiler (``kernel_device_ms``: its mean and the
    launches it saw)."""
    lib = build.load("empty")
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def launch():
        build.check_launch(lib, "empty", lib.empty_launch(torch.cuda.current_stream().cuda_stream))

    return time_ms(launch, flush), kernel_device_ms(launch, flush, "empty_kernel")


def tree_shapes(cfg):
    """(name, labels, k, B, init scale) of tree_logprob_all's two calls."""
    serve_cfg = configs.get_config(SERVE_ARCH)
    return [("prediction", cfg.num_labels, cfg.gen_feature_dim, BATCH, 1.0),
            ("serving_dense", serve_cfg.vocab_size, serve_cfg.gen_feature_dim, SERVE_BATCH,
             0.05)]


def sampled_shapes(cfg):
    """(T, m) of sampled_head_loss's two checked shapes."""
    return {"main": (256, 1 + cfg.n_neg), "wide": WIDE_SHAPE}


def check_tree(dev, gen, flush, cfg, floor):
    """Dense prediction's call (B = 256, xc_linear's tree: C_pad = 262,144,
    depth 18, k = 16) and the LM-serving dense path's (B = 4, h2o-danube's
    tree over 32,000 labels: C_pad = 32,768, depth 15, k = 32): kernel
    against plain version, two calls bit-equal, the launch plan's kernel
    timed beside the FMA kernel on the same inputs."""
    shapes = tree_shapes(cfg)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for shape, c, kg, bsz, scale in shapes:
        tree = tree_lib.init_tree(gen, c, kg, scale=scale, device=dev)
        x = torch.randn((bsz, kg), generator=gen, device=dev)
        plan = tree_logprob.launch_plan(bsz, tree.depth, sm_count)
        before = ops.tree_logprob_all.tensor_core_launches
        got = ops.tree_logprob_all(tree.w, tree.b, x)
        again = ops.tree_logprob_all(tree.w, tree.b, x)
        took_tc = ops.tree_logprob_all.tensor_core_launches - before == 2
        want = ref.tree_logprob_all_ref(tree.w, tree.b, x)
        fma_out = torch.empty_like(got)
        tree_logprob._launch(tree.w, tree.b, x, fma_out, tree.depth, tree_logprob.FMA, 0, 0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        fma_err = float((fma_out - want).abs().max())
        pad = got[:, c:]
        what = (f"tree_logprob_all {shape}: B={bsz} k={kg} depth={tree.depth} "
                f"C_pad={got.shape[1]}")
        print(f"{what} plan={plan} max_abs_err={err:.3e} (FMA kernel {fma_err:.3e}) "
              f"tol={TREE_TOL} padding leaves in [{float(pad.min()):.1f}, "
              f"{float(pad.max()):.1f}]")
        check(took_tc and plan[0] == tree_logprob.TENSOR_CORES,
              f"{what}: not on the tensor-core kernel")
        check(bool(torch.isfinite(got).all()), f"{what} gives non-finite values")
        check(close(got, want, TREE_TOL), f"{what} disagrees")
        check(torch.equal(got, again), f"{what}: two calls differ")
        check(close(fma_out, want, TREE_TOL), f"{what}: the FMA kernel disagrees")
        del again, fma_out, want
        n_nodes, _ = tree.w.shape
        n_bytes = got.numel() * 4 + tree.w.numel() * 4 + tree.b.numel() * 4 + x.numel() * 4
        bound, by = bound_ms(n_bytes, bsz * n_nodes * (2 * kg + 3))
        out = torch.empty_like(got)
        fma = time_ms(lambda: tree_logprob._launch(tree.w, tree.b, x, out, tree.depth,
                                                   tree_logprob.FMA, 0, 0), flush)
        ms = time_ms(lambda: ops.tree_logprob_all(tree.w, tree.b, x), flush)
        fma_again = time_ms(lambda: tree_logprob._launch(tree.w, tree.b, x, out, tree.depth,
                                                         tree_logprob.FMA, 0, 0), flush)
        plain = time_ms(lambda: ref.tree_logprob_all_ref(tree.w, tree.b, x), flush)
        device, seen = kernel_device_ms(lambda: ops.tree_logprob_all(tree.w, tree.b, x),
                                        flush, "tree_logprob_tc_kernel")
        fma_device, fma_seen = kernel_device_ms(lambda: tree_logprob._launch(
            tree.w, tree.b, x, out, tree.depth, tree_logprob.FMA, 0, 0), flush,
            "tree_logprob_kernel")
        print(f"{what}: kernel {ms:.4f} ms, FMA kernel {fma:.4f} / {fma_again:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), launch floor {floor:.4f} ms; "
              f"device time alone (profiler): kernel {device:.4f} ms over {seen} launches, "
              f"FMA {fma_device:.4f} ms over {fma_seen}")
        result[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                             bound_by=by, fma_ms=[fma, fma_again], plan=list(plan),
                             device_ms=device, device_ms_launches_seen=seen,
                             fma_device_ms=fma_device, fma_device_ms_launches_seen=fma_seen)
        del got, out, tree, x
    print(json.dumps({"tree_logprob_all": result}))
    main = result["prediction"]
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}


def dh_close(got, want, coeff, w, ids) -> bool:
    """dh within LOSS_TOL of the magnitude of its terms, sum_j |coeff_j| |w_j|
    (an OVE coefficient reaches (C-1)/n)."""
    scale = torch.einsum("tn,tnk->tk", coeff.abs(), w[ids].float().abs())
    return bool(((got - want).abs() <= LOSS_TOL["atol"] + LOSS_TOL["rtol"] * scale).all())


def sampled_inputs(dev, gen, c, kdim, t, m):
    h = torch.randn((t, kdim), generator=gen, device=dev)
    ids = torch.randint(0, c, (t, m), generator=gen, device=dev)
    ids[::8, 1] = ids[::8, 0]                    # accidental hits
    lp = -torch.rand((t, m), generator=gen, device=dev) - 12.0
    return h, ids, lp


def check_sampled_loss(dev, gen, flush, cfg, floor):
    """Every kind, both table dtypes, reg/softcap off and on, at the training
    shape (T = 256, m = 2) and at T = 2048, m = 17, two calls bit-equal;
    kernel and plain version timed at both shapes and dtypes for the main
    path's kind."""
    c, kdim = cfg.num_labels, cfg.feature_dim
    w32 = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    shapes = sampled_shapes(cfg)
    errs, timed = {}, {}
    for shape_name, (t, m) in shapes.items():
        h, ids, lp = sampled_inputs(dev, gen, c, kdim, t, m)
        rows = torch.unique(ids).numel()
        for dtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(dtype), b32.to(dtype)
            for kind in SAMPLED_KINDS:
                for reg, softcap in ((0.0, 0.0), (cfg.head_reg, 25.0)):
                    kw = dict(kind=kind, num_labels=c, reg=reg, softcap=softcap)
                    got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
                    again = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
                    want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
                    torch.cuda.synchronize()
                    what = f"sampled_head_loss {kind} {str(dtype)[6:]} reg={reg} softcap={softcap} T={t} m={m}"
                    check(all(torch.equal(g, a) for g, a in zip(got, again)),
                          f"{what}: two calls differ")
                    for name, g, wn in zip(("loss", "coeff", "xi"), got, want):
                        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
                        check(close(g, wn, LOSS_TOL), f"{what}: {name} disagrees")
                    check(dh_close(got[3], want[3], want[1], w, ids), f"{what}: dh disagrees")
                    err = max(float((g - wn).abs().max()) for g, wn in zip(got[:3], want[:3]))
                    dh_err = float((got[3] - want[3]).abs().max())
                    errs[(shape_name, str(dtype)[6:], kind, reg)] = (err, dh_err)
            # Time the main path's kind (adversarial_ns, reg 1e-3, no softcap).
            kw = dict(kind="adversarial_ns", num_labels=c, reg=cfg.head_reg)
            elt = w.element_size()
            n_bytes = (rows * (kdim + 1) * elt + t * kdim * 4 + t * m * (8 + 4)
                       + t * 4 + 2 * t * m * 4 + t * kdim * 4)
            bound, by = bound_ms(n_bytes, t * m * 4 * kdim)
            ms = time_ms(lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), flush)
            plain = time_ms(lambda: ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw), flush)
            device, seen = kernel_device_ms(
                lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), flush,
                "sampled_loss_kernel")
            print(f"sampled_head_loss {str(dtype)[6:]} T={t} m={m} K={kdim} C={c}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by}, "
                  f"{n_bytes / 1e6:.2f} MB, {rows} distinct rows), launch floor {floor:.4f} ms; "
                  f"device time alone (profiler) {device:.4f} ms over {seen} launches")
            timed[(shape_name, str(dtype)[6:])] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                                       bound_by=by, megabytes=n_bytes / 1e6,
                                                       device_ms=device,
                                                       device_ms_launches_seen=seen)
    by_kind = {}
    for (shape_name, dt, kind, reg), (err, dh_err) in errs.items():
        key = f"{shape_name}/{dt}/{kind}"
        prev = by_kind.get(key, (0.0, 0.0))
        by_kind[key] = (max(prev[0], err), max(prev[1], dh_err))
    print(json.dumps({"sampled_head_loss_max_abs_err": {
        k: {"loss_coeff_xi": e, "dh": d} for k, (e, d) in by_kind.items()}}))
    print(json.dumps({"sampled_head_loss_timing": {
        f"{k[0]}/{k[1]}": v for k, v in timed.items()}}))
    main = dict(timed[("main", "float32")])
    main["max_abs_err"] = max(max(e) for (sh, dt, kind, _), e in errs.items()
                              if (sh, dt, kind) == ("main", "float32", "adversarial_ns"))
    del main["megabytes"], main["device_ms"], main["device_ms_launches_seen"]
    return main


def segment_inputs(dev, gen, d, s, ids, dtype, n=SEG_POINTS):
    """vals (N, D) and ids (N,) int64: uniform over [0, S), zipf(1.3) over a
    random permutation of S labels, or uniform with a tenth of the ids
    outside [0, S) (negative or >= S)."""
    vals = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    if ids == "zipf":
        seg = zipf_labels(dev, gen, s, n)
    else:
        seg = torch.randint(0, s, (n,), generator=gen, device=dev)
    if ids == "out_of_range":
        bad = torch.rand((n,), generator=gen, device=dev) < 0.1
        wild = torch.tensor([-3, -1, s, s + 7], device=dev)
        seg = torch.where(bad, wild[torch.randint(0, 4, (n,), generator=gen, device=dev)], seg)
    return vals, seg


def check_segment_stats(dev, gen, flush):
    """The generator fit's reductions: kernel against plain version (within
    SEG_TOL of each segment's sum of |vals|: float32 sums of up to 5e5 terms
    in two orders, the plain version's atomics in no fixed order), two calls
    with one plan and a call that builds its own bit-equal, and the times of
    the plan (the ids' sort, once per Newton solve in the fit), of a call
    with the plan (what the fit's other calls of a solve cost), of the plain
    version, and of one ``index_add_`` on the in-range ids (atomics, so not
    deterministic)."""
    rows = {}
    for name, d, s, ids, dtype in SEG_SHAPES:
        vals, seg = segment_inputs(dev, gen, d, s, ids, dtype)
        plan = ops.segment_plan(seg, s)
        got = ops.segment_stats(vals, seg, s, plan=plan)
        again = ops.segment_stats(vals, seg, s, plan=plan)
        fresh = ops.segment_stats(vals, seg, s)
        want = ref.segment_stats_ref(vals, seg, s)
        keep = (seg >= 0) & (seg < s)
        seg_in, vals_in = seg[keep], vals[keep].float()
        exact = torch.zeros((s, d), dtype=torch.float64, device=dev).index_add_(
            0, seg_in, vals_in.double())
        scale = ref.segment_stats_ref(vals.abs(), seg, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err64 = float((got.double() - exact).abs().max())
        what = f"segment_stats {name} (N={SEG_POINTS}, D={d}, S={s}, {ids}, {str(dtype)[6:]})"
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite sums")
        check(bool(((got - want).abs() <= SEG_TOL * (scale + 1.0)).all()),
              f"{what}: kernel disagrees with the plain version")
        check(torch.equal(got, again), f"{what}: two calls differ")
        check(torch.equal(got, fresh), f"{what}: a call with a reused plan differs from one "
                                       f"that builds its own")
        del got, again, fresh, want, exact, scale
        n_bytes = SEG_POINTS * (d * vals.element_size() + 8) + s * d * 4
        bound, by = bound_ms(n_bytes, SEG_POINTS * d)
        plan_ms = time_ms(lambda: ops.segment_plan(seg, s), flush)
        ms = time_ms(lambda: ops.segment_stats(vals, seg, s, plan=plan), flush)
        both = time_ms(lambda: ops.segment_stats(vals, seg, s), flush)
        plain = time_ms(lambda: ref.segment_stats_ref(vals, seg, s), flush)
        library = time_ms(lambda: torch.zeros((s, d), device=dev).index_add_(0, seg_in, vals_in),
                          flush)
        rows[name] = dict(d=d, s=s, ids=ids, dtype=str(dtype)[6:], max_abs_err=err,
                          max_abs_err_vs_float64=err64, ms=ms, plan_ms=plan_ms,
                          plan_and_call_ms=both, plain_ms=plain, library_ms=library,
                          bound_ms=bound, bound_by=by, long_segments=plan.n_long,
                          chunks=plan.n_chunks)
        print(f"{what}: max_abs_err={err:.3e} (vs float64 {err64:.3e}), plan {plan_ms:.4f} ms, "
              f"call with the plan {ms:.4f} ms, plan + call {both:.4f} ms, plain "
              f"{plain:.4f} ms, index_add_ {library:.4f} ms (atomics: not deterministic), "
              f"bound {bound:.4f} ms ({by}); {plan.n_long} long segments")
        del vals, seg, seg_in, vals_in, plan
    print(json.dumps({"segment_stats": rows}))
    main = dict(rows[SEG_MAIN])
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}


def check_small_against_cpu(dev, seed):
    """The whole path at the reduced config on the card and on the CPU."""
    cfg = xc_linear.reduced()
    gen = torch.Generator().manual_seed(seed)
    params = heads.init_head_params(gen, cfg.num_labels, cfg.feature_dim,
                                    scale=0.3, device="cpu")
    tree = tree_lib.init_tree(gen, cfg.num_labels, cfg.gen_feature_dim,
                              scale=1.0, device="cpu")
    h = torch.randn((7, cfg.feature_dim), generator=gen)
    xg = torch.randn((7, cfg.gen_feature_dim), generator=gen)
    hcfg = heads.HeadConfig(num_labels=cfg.num_labels)
    results = []
    for d in ("cpu", dev):
        p = heads.HeadParams(*(t.to(d) for t in params))
        g = heads.make_tree_generator(tree_lib.Tree(*(t.to(d) for t in tree)))
        scores = heads.predictive_scores(hcfg, p, g, h.to(d), xg.to(d))
        top, labels = heads.predictive_topk(hcfg, p, g, h.to(d), xg.to(d),
                                            TOPK, beam=16)
        results.append([t.cpu() for t in (scores, top, labels)])
    torch.cuda.synchronize()
    (s0, t0, l0), (s1, t1, l1) = results
    check(close(s1, s0, SCORE_TOL), "small dense scores differ between card and CPU")
    check(close(t1, t0, SCORE_TOL), "small beam scores differ between card and CPU")
    check(bool((l1 == l0).all()), "small beam labels differ between card and CPU")
    print(f"small path C={cfg.num_labels}: card agrees with CPU "
          f"(max dense err {float((s1 - s0).abs().max()):.3e})")


def main_path(dev, seed, cfg):
    """4 request batches at full width, dense and beam; counters around it."""
    c, kdim, kg = cfg.num_labels, cfg.feature_dim, cfg.gen_feature_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = heads.init_head_params(gen, c, kdim, scale=0.05, device=dev)
    tree = tree_lib.init_tree(gen, c, kg, scale=1.0, device=dev)
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns")
    hgen = heads.make_tree_generator(tree)
    torch.cuda.synchronize()

    ops.gather_scores.launches = ops.gather_scores.rows_launches = 0
    ops.gather_scores.split_launches = 0
    ops.tree_logprob_all.launches = 0
    dense_ms, beam_ms = [], []
    for _ in range(N_BATCHES):
        h = torch.randn((BATCH, kdim), generator=gen, device=dev)
        xg = torch.randn((BATCH, kg), generator=gen, device=dev)
        t0 = time.perf_counter()
        scores = heads.predictive_scores(hcfg, params, hgen, h, xg)
        dtop, dlab = torch.topk(scores, TOPK, dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        btop, blab = heads.predictive_topk(hcfg, params, hgen, h, xg, TOPK, beam=BEAM)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dense_ms.append(1e3 * (t1 - t0))
        beam_ms.append(1e3 * (t2 - t1))
        check(tuple(scores.shape) == (BATCH, c) and tuple(blab.shape) == (BATCH, TOPK),
              "unexpected output shapes")
        check(bool(torch.isfinite(dtop).all()), "dense top-k is not finite")
        live = blab >= 0
        check(bool(live[:, 0].all()), "a beam returned no live candidate")
        at_label = torch.gather(scores, -1, blab.clamp(min=0))
        check(close(btop[live], at_label[live], SCORE_TOL),
              "beam scores differ from dense Eq. 5 scores at the same labels")
        check(bool((btop[:, 0] <= dtop[:, 0] + SCORE_TOL["atol"]).all()),
              "beam top-1 beats the dense maximum")

    # Exhaustive beam equals dense top-k, compared by score.
    h = torch.randn((4, kdim), generator=gen, device=dev)
    xg = torch.randn((4, kg), generator=gen, device=dev)
    dtop, dlab = torch.topk(heads.predictive_scores(hcfg, params, hgen, h, xg), TOPK, dim=-1)
    btop, blab = heads.predictive_topk(hcfg, params, hgen, h, xg, TOPK,
                                       beam=tree_lib.padded_size(c))
    torch.cuda.synchronize()
    launches = {"gather_scores": ops.gather_scores.launches,
                "tree_logprob_all": ops.tree_logprob_all.launches}
    check(close(btop, dtop, SCORE_TOL), "exhaustive beam top-5 scores differ from dense")
    check(bool(((blab == dlab) | ((btop - dtop).abs() <= SCORE_TOL["atol"])).all()),
          "exhaustive beam top-5 labels differ from dense")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    check(ops.gather_scores.rows_launches == launches["gather_scores"],
          "the prediction beam's gather_scores calls are not all on the rows variant")
    print(json.dumps({"main_path": {
        "batches": N_BATCHES, "batch": BATCH, "num_labels": c, "beam": BEAM,
        "dense_ms": dense_ms, "beam_ms": beam_ms, "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}))

    h = torch.randn((BATCH, kdim), generator=gen, device=dev)
    xg = torch.randn((BATCH, kg), generator=gen, device=dev)
    print(json.dumps({"profile": {
        "dense": device_time_by_op(lambda: torch.topk(
            heads.predictive_scores(hcfg, params, hgen, h, xg), TOPK, dim=-1)),
        "beam": device_time_by_op(lambda: heads.predictive_topk(
            hcfg, params, hgen, h, xg, TOPK, beam=BEAM))}}))
    return launches


def zipf_labels(dev, gen, c, n, a=1.3):
    """n labels with P(rank r) ~ r^-a over a random permutation of C labels."""
    cdf = torch.cumsum(torch.arange(1, c + 1, device=dev, dtype=torch.float64) ** -a, 0)
    u = torch.rand((n,), generator=gen, device=dev, dtype=torch.float64) * cdf[-1]
    rank = torch.searchsorted(cdf, u).clamp(max=c - 1)
    return torch.randperm(c, generator=gen, device=dev)[rank]


def zipf_training_data(dev, gen, c, kdim, kg, n=TRAIN_EXAMPLES):
    """Gaussian features, their random projection to k dims, zipf labels."""
    x = torch.randn((n, kdim), generator=gen, device=dev)
    xg = x @ (torch.randn((kdim, kg), generator=gen, device=dev) / kdim ** 0.5)
    return x, xg, zipf_labels(dev, gen, c, n)


class Timer:
    """``train_linear_head`` callback: host time of every 10th step, after
    a synchronize."""

    def __init__(self):
        self.marks = []

    def __call__(self, step, params):
        torch.cuda.synchronize()
        self.marks.append((step, time.perf_counter()))

    def ms_per_step(self) -> float:
        (s0, t0), (s1, t1) = self.marks[0], self.marks[-1]
        return 1e3 * (t1 - t0) / (s1 - s0)


def ms_per_train_step(hcfg, gen, data, lr, steps, seed):
    timer = Timer()
    params = xc_train.train_linear_head(hcfg, gen, *data, lr=lr, steps=steps, seed=seed,
                                        callback=timer, device=data[0].device)
    torch.cuda.synchronize()
    return timer.ms_per_step(), params


@contextlib.contextmanager
def swapped(module, **fns):
    """Within the block ``module.<name>`` is ``fns[name]``: the port's paths
    run the plain versions of the kernels on the card, or a recorder."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def train_path(dev, seed, cfg):
    """Training at full xc_linear width; counters around train_linear_head."""
    c, kdim, kg = cfg.num_labels, cfg.feature_dim, cfg.gen_feature_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    data = zipf_training_data(dev, gen, c, kdim, kg)
    tree = tree_lib.init_tree(gen, c, kg, scale=1.0, device=dev)
    hgen = heads.make_tree_generator(tree)
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns", n_neg=cfg.n_neg,
                            reg=cfg.head_reg)
    lr = cfg.learning_rate
    xc_train.train_linear_head(hcfg, hgen, *data, lr=lr, steps=10, seed=seed,
                               device=dev)                                  # warm-up
    torch.cuda.synchronize()

    ops.sampled_head_loss.launches = 0
    ops.gather_scores.launches = 0
    ops.tree_logprob_all.launches = 0
    t0 = time.perf_counter()
    ms_step, params = ms_per_train_step(hcfg, hgen, data, lr, TRAIN_STEPS, seed)
    wall_s = time.perf_counter() - t0
    launches = {"sampled_head_loss": ops.sampled_head_loss.launches,
                "gather_scores": ops.gather_scores.launches,
                "tree_logprob_all": ops.tree_logprob_all.launches}
    check(launches["sampled_head_loss"] == TRAIN_STEPS,
          f"training launched sampled_head_loss {launches['sampled_head_loss']} times "
          f"in {TRAIN_STEPS} steps")
    check(bool(torch.isfinite(params.w).all() and torch.isfinite(params.b).all()),
          "trained parameters are not finite")

    # One more step's candidates: the loss is finite, the kernel agrees with
    # the plain version, and 5 steps through each give the same parameters.
    x, xg, y = data
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    batches = []
    for _ in range(5):
        idx = torch.randint(0, x.shape[0], (256,), generator=g, device=dev)
        ids, slot_logp, _ = heads._sample_candidates(hcfg, hgen, xg[idx], y[idx], g)
        batches.append((x[idx], ids, slot_logp))
    h0, ids0, lp0 = batches[0]
    loss, _, _, _ = heads.sparse_candidate_loss(hcfg, params, h0, ids0, lp0)
    check(bool(torch.isfinite(loss)), "training loss is not finite")
    kw = dict(kind=hcfg.kind, num_labels=c, reg=hcfg.reg)
    got = ops.sampled_head_loss(params.w, params.b, h0, ids0, lp0, **kw)
    want = ref.sampled_head_loss_ref(params.w, params.b, h0, ids0, lp0, **kw)
    check(close(got[1], want[1], LOSS_TOL), "trained step: coefficients disagree")
    check(dh_close(got[3], want[3], want[1], params.w, ids0), "trained step: dh disagrees")
    opt_cfg = OptimizerConfig(name="adagrad", learning_rate=lr, eps=1e-8)
    runs = []
    for plain in (False, True):
        p = heads.HeadParams(params.w.clone(), params.b.clone())
        state = init_opt_state(opt_cfg, p)
        with (swapped(ops, sampled_head_loss=ref.sampled_head_loss_ref) if plain
              else contextlib.nullcontext()):
            for h, ids, lp in batches:
                _, _, grads, _ = heads.sparse_candidate_loss(hcfg, p, h, ids, lp)
                p, state, _ = apply_updates(opt_cfg, p, grads, state)
        runs.append(p)
    step_err = max(float((a - b_).abs().max()) for a, b_ in zip(*runs))
    check(step_err <= PARAM_TOL, f"5 steps: kernel and plain parameters differ by {step_err}")
    del runs

    layers, sync = step_layers(hcfg, hgen, params, data, lr, seed)
    torch.cuda.synchronize()
    big_ms = big_c_ms_per_step(dev, seed, cfg, data)
    print(json.dumps({"train_path": {
        "num_labels": c, "steps": TRAIN_STEPS, "batch": 256, "n_neg": cfg.n_neg,
        "kind": hcfg.kind, "reg": hcfg.reg, "lr": lr, "ms_per_step": ms_step,
        "wall_s": wall_s, "launches": launches, "loss": float(loss),
        "kernel_vs_plain_5_steps_max_param_diff": step_err,
        "ms_per_step_at_c_2097152": big_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}))
    print(json.dumps({"train_step_layers": layers}))
    print(json.dumps({"unique_sync": sync}))
    return launches


def step_layers(hcfg, hgen, params, data, lr, seed, reps: int = 20):
    """Host and device ms of one training step and of each of its layers:
    sampling (tree walk for the negatives and the positive's log-prob), the
    kernel, dedupe (unique + index_add) and the row update. Each layer is
    run ``reps`` times on the same inputs; device time from torch.profiler.
    Also the host's wait at torch.unique's synchronize."""
    x, xg, y = data
    g = torch.Generator(device=x.device).manual_seed(seed + 4)
    opt_cfg = OptimizerConfig(name="adagrad", learning_rate=lr, eps=1e-8)
    p = heads.HeadParams(params.w.clone(), params.b.clone())
    state = init_opt_state(opt_cfg, p)
    idx = torch.randint(0, x.shape[0], (256,), generator=g, device=x.device)
    xb, xgb, yb = x[idx], xg[idx], y[idx]
    ids, lp, _ = heads._sample_candidates(hcfg, hgen, xgb, yb, g)
    m = ids.shape[-1]
    kw = dict(kind=hcfg.kind, num_labels=hcfg.num_labels, reg=hcfg.reg)
    _, coeff, _, _ = ops.sampled_head_loss(p.w, p.b, xb, ids, lp, **kw)
    hrep = xb[:, None, :].expand(-1, m, -1).reshape(-1, xb.shape[-1])
    grads = accumulate_rows(ids.reshape(-1), coeff.reshape(-1), hrep, hcfg.num_labels)

    def step():
        i = torch.randint(0, x.shape[0], (256,), generator=g, device=x.device)
        _, _, gr, _ = heads.sparse_head_loss(hcfg, p, hgen, x[i], xg[i], y[i], g)
        apply_updates(opt_cfg, p, gr, state)

    layers = {
        "step": step,
        "sampling": lambda: heads._sample_candidates(hcfg, hgen, xgb, yb, g),
        "kernel": lambda: ops.sampled_head_loss(p.w, p.b, xb, ids, lp, **kw),
        "dedupe": lambda: accumulate_rows(ids.reshape(-1), coeff.reshape(-1), hrep,
                                          hcfg.num_labels),
        "row_update": lambda: apply_updates(opt_cfg, p, grads, state),
    }
    out = {}
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / reps
        prof = device_time_by_op(lambda: [fn() for _ in range(reps)], top=6)
        out[name] = {"host_ms": host, "device_ms": prof["device_ms"] / reps,
                     "kernels": prof["kernels"] / reps,
                     "idle_share": 1.0 - prof["device_ms"] / reps / host,
                     "top_ms": [[k, v / reps] for k, v in prof["top_ms"]]}

    # torch.unique's synchronize: host time of the dedupe right behind the
    # sampling and the kernel (queued device work) and on an idle device.
    waits = []
    for queued in (True, False):
        total = 0.0
        for _ in range(reps):
            cand, slp, _ = heads._sample_candidates(hcfg, hgen, xgb, yb, g)
            _, cf, _, _ = ops.sampled_head_loss(p.w, p.b, xb, cand, slp, **kw)
            if not queued:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.unique(cand.reshape(-1), return_inverse=True)
            total += time.perf_counter() - t0
        waits.append(1e3 * total / reps)
    sync = {"unique_host_ms_behind_queued_work": waits[0],
            "unique_host_ms_on_idle_device": waits[1],
            "wait_ms": waits[0] - waits[1]}
    return out, sync


def big_c_ms_per_step(dev, seed, cfg, data, c=BIG_C):
    """ms per training step at C = 2,097,152 labels (same data, labels
    redrawn), the figure for the paper's claim that the step cost does not
    depend on C. Printed, not gated."""
    x, xg, _ = data
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    y = zipf_labels(dev, gen, c, x.shape[0])
    tree = tree_lib.init_tree(gen, c, cfg.gen_feature_dim, scale=1.0, device=dev)
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns", n_neg=cfg.n_neg,
                            reg=cfg.head_reg)
    ms, params = ms_per_train_step(hcfg, heads.make_tree_generator(tree), (x, xg, y),
                                   cfg.learning_rate, BIG_STEPS, seed)
    check(bool(torch.isfinite(params.w).all()), f"C={c}: trained parameters are not finite")
    print(f"train C={c}: {ms:.3f} ms per step over {BIG_STEPS} steps")
    return ms


def pipeline_small(dev, seed):
    """The paper's pipeline on the card at the system test's size: fit the
    tree (numpy oracle), train adversarial and uniform heads, predict."""
    c, kdim, kg = 256, 32, 8
    spec = synthetic.ClusteredXCSpec(num_labels=c, feature_dim=kdim, seed=seed)
    x, y, x_te, y_te = synthetic.make_clustered_xc(spec, 6000, 1500)
    proj, mean = tree_fit.pca_projection(x, kg)
    xg, xg_te = (x - mean) @ proj, (x_te - mean) @ proj
    tree = tree_fit.fit_tree(xg, y, c, config=tree_fit.FitConfig(reg=0.1, seed=seed),
                             device=dev)
    test = [torch.as_tensor(a, device=dev) for a in (x_te, xg_te.astype("float32"), y_te)]
    accs = {}
    for kind, gen in [("adversarial_ns", heads.make_tree_generator(tree)),
                      ("uniform_ns", heads.Generator())]:
        hcfg = heads.HeadConfig(num_labels=c, kind=kind, n_neg=1, reg=1e-4)
        params = xc_train.train_linear_head(hcfg, gen, x, xg, y, lr=0.1, steps=150,
                                            seed=seed, device=dev)
        accs[kind] = float(heads.predictive_accuracy(hcfg, params, gen, *test))
        if kind == "adversarial_ns":
            biased = heads.HeadConfig(num_labels=c, kind=kind, debias=False)
            accs["adversarial_ns_biased"] = float(
                heads.predictive_accuracy(biased, params, gen, *test))
    print(json.dumps({"pipeline_small": {"num_labels": c, "steps": 150, "accuracy": accs}}))
    check(accs["adversarial_ns"] > accs["adversarial_ns_biased"] + 0.05,
          "pipeline: Eq. 5 debiasing does not improve accuracy by 0.05")
    check(accs["adversarial_ns"] > accs["uniform_ns"], "pipeline: adversarial does not beat uniform")
    check(accs["adversarial_ns"] > 0.3, "pipeline: adversarial accuracy is not above 0.3")


def profile_by_kernel(fn, ranges=()):
    """Device ms by kernel name and the kernels' count of one call of ``fn``
    (torch.profiler), the call's host ms, for each ``record_function`` range
    named in ``ranges`` the device ms by kernel name of the kernels launched
    inside it (the innermost named range counts), and the launches recorded
    by kernel name."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    # Device-side events, less the GPU spans of the named ranges themselves.
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in ranges]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    inside: dict = {name: {} for name in ranges}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        owner = e
        while owner is not None and owner.name not in inside:
            owner = owner.cpu_parent
        if owner is not None:
            for k in e.kernels:
                inside[owner.name][k.name] = inside[owner.name].get(k.name, 0.0) + k.duration / 1e3
    counts: dict = {}
    for e in kernels:
        counts[e.name] = counts.get(e.name, 0) + 1
    return by_name, len(kernels), host_ms, inside, counts


def in_range(name, fn):
    """``fn`` run inside a ``record_function`` range called ``name``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def device_time_by_op(fn, top: int = 8) -> dict:
    """Device time of one warm call of ``fn`` by kernel (torch.profiler):
    the total, the kernels' count, and the ``top`` kernels by time."""
    fn()
    torch.cuda.synchronize()
    by_name, n_kernels, _, _, _ = profile_by_kernel(fn)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(by_name.values()), "kernels": n_kernels,
            "top_ms": [[name[:60], ms] for name, ms in ranked]}


# The kernels of csrc/segment_scores.cu: a plan's, and a call's.
SEGMENT_PLAN_KERNELS = ("keys_kernel", "offsets_kernel")
SEGMENT_KERNELS = ("segments_kernel", "chunks_kernel", "long_kernel")


def check_tree_invariants(tree, c, x, what):
    """tests/test_genfit.py's invariants: the leaf<->label bijection, real
    mass ~ 1 on 64 queries, path log-probs equal to the dense ones."""
    dev = tree.w.device
    l2l = tree.label_to_leaf
    check(torch.unique(l2l).numel() == c, f"{what}: label->leaf is not injective")
    check(torch.equal(tree.leaf_to_label[l2l], torch.arange(c, device=dev)),
          f"{what}: leaf_to_label does not invert label_to_leaf")
    xs = torch.as_tensor(x[:64], device=dev)
    mass = tree_lib.prob_mass_real(tree, xs)
    check(bool(((mass - 1.0).abs() <= 1e-4).all()), f"{what}: real mass is not 1")
    y = torch.arange(32, device=dev) % c
    lp = tree_lib.log_prob(tree, xs[:32], y)
    lp_all = tree_lib.log_prob_all(tree, xs[:32]).gather(1, y[:, None])[:, 0]
    check(close(lp, lp_all, dict(atol=1e-4, rtol=1e-4)),
          f"{what}: path log-probs differ from the dense ones")
    return float((mass - 1.0).abs().max())


def genfit_path(dev, seed, cfg):
    """The level-parallel fit at full xc_linear width; counters around it."""
    c, kg = cfg.num_labels, cfg.gen_feature_dim
    t0 = time.perf_counter()
    spec = synthetic.ClusteredXCSpec(num_labels=c, feature_dim=kg, seed=seed)
    x, y, x_te, y_te = synthetic.make_clustered_xc(spec, FIT_POINTS, FIT_HELD_OUT)
    data_s = time.perf_counter() - t0
    fcfg = tree_fit.FitConfig(reg=cfg.gen_reg, seed=seed)

    # Time each level (the level ends on the host anyway) and keep the inputs
    # and output of the profiled levels to replay them.
    run_level = genfit_levels._run_level
    level_s, kept = [], {}

    def timed_level(pieces, *args):
        level = pieces.nseg.bit_length() - 1
        t = time.perf_counter()
        out = run_level(pieces, *args)
        torch.cuda.synchronize()
        level_s.append(time.perf_counter() - t)
        if level in FIT_PROFILE_LEVELS:
            kept[level] = dict(args=(pieces, *args), out=out)
        return out

    # Count the Newton solves: each should sort its ids once, and the fit
    # its labels once.
    run_newton, solves = genfit_levels.run_newton, []

    def counted_newton(*args, **kwargs):
        solves.append(1)
        return run_newton(*args, **kwargs)

    genfit_levels._run_level = timed_level
    genfit_levels.run_newton = counted_newton
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kernel in (ops.segment_stats, ops.tree_logprob_all, ops.gather_scores,
                       ops.sampled_head_loss):
            kernel.launches = 0
        ops.segment_stats.plans = 0
        t0 = time.perf_counter()
        tree = genfit.fit_tree_levelwise(x, y, c, config=fcfg, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {"segment_stats": ops.segment_stats.launches,
                    "tree_logprob_all": ops.tree_logprob_all.launches,
                    "gather_scores": ops.gather_scores.launches,
                    "sampled_head_loss": ops.sampled_head_loss.launches}
        plans = ops.segment_stats.plans
    finally:
        genfit_levels._run_level = run_level
        genfit_levels.run_newton = run_newton
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches["segment_stats"] > 0, "the fit never launched segment_stats")
    check(plans == len(solves) + 1, f"the fit built {plans} segment plans for "
                                    f"{len(solves)} Newton solves and one label set")
    depth = tree_lib.padded_size(c).bit_length() - 1
    check(len(level_s) == tree.depth == depth, f"the fit ran {len(level_s)} levels, not {depth}")
    mass_err = check_tree_invariants(tree, c, x_te, "full-width fit")
    ll = tree_fit.tree_log_likelihood(tree, x_te, y_te)
    uniform = -float(np.log(c))
    check(ll > uniform + 0.5, f"held-out log-likelihood {ll:.4f} does not beat uniform "
                              f"{uniform:.4f} by 0.5")

    # The profiled levels again under the profiler: device time by kernel,
    # the share of segment_stats: its calls' kernels (by name) and its plans'
    # (the plan's own kernels by name, and the torch.sort and the chunk
    # table's torch ops inside a record_function range around
    # ops.segment_plan, so the discrete step's and finalize's own argsorts do
    # not count), the idle share against the level's host time in the fit,
    # and a bit-equal replay.
    profiles = {}
    for level, run in sorted(kept.items()):
        lvl_plans, lvl_calls = ops.segment_stats.plans, ops.segment_stats.launches
        with swapped(ops, segment_plan=in_range("segment_plan", ops.segment_plan)):
            by_name, n_kernels, prof_host_ms, inside, _ = profile_by_kernel(
                lambda: run.update(replay=run_level(*run["args"])), ranges=("segment_plan",))
        lvl_plans = ops.segment_stats.plans - lvl_plans
        lvl_calls = ops.segment_stats.launches - lvl_calls
        for a, b in zip(run["out"], run["replay"]):
            check(torch.equal(a, b), f"level {level} replayed to other bits")
        device_ms = sum(by_name.values())
        named = lambda names: sum(v for k, v in by_name.items()             # noqa: E731
                                  if any(n in k for n in names))
        calls_ms = named(SEGMENT_KERNELS)
        plan_torch = {k: v for k, v in inside["segment_plan"].items()
                      if not any(n in k for n in SEGMENT_PLAN_KERNELS)}
        plan_ms = named(SEGMENT_PLAN_KERNELS) + sum(plan_torch.values())
        sort_ms = sum(v for k, v in plan_torch.items() if "adix" in k)
        host_ms = 1e3 * level_s[level]
        profiles[level] = {
            "host_ms": host_ms, "profiled_host_ms": prof_host_ms, "device_ms": device_ms,
            "kernels": n_kernels, "segment_stats_calls": lvl_calls, "segment_plans": lvl_plans,
            "segment_stats_device_ms": calls_ms, "segment_plan_device_ms": plan_ms,
            "segment_plan_sort_device_ms": sort_ms,
            "segment_stats_share": (calls_ms + plan_ms) / device_ms,
            "idle_share": 1.0 - device_ms / host_ms,
            "top_ms": [[k[:60], v] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]}
    del kept

    # Warm refit on drifted features, twice, bit-equal.
    rng = np.random.default_rng(seed + 9)
    x2 = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    x2_te = x_te + 0.3 * rng.standard_normal(x_te.shape).astype(np.float32)
    refits, refit_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        refits.append(genfit.refit_params(tree, x2, y, c, config=fcfg, device=dev))
        torch.cuda.synchronize()
        refit_s.append(time.perf_counter() - t0)
    for name in ("w", "b"):
        check(torch.equal(getattr(refits[0], name), getattr(refits[1], name)),
              f"refit_params gave other bits on the second run ({name})")
    check_tree_invariants(refits[0], c, x2_te, "refit")
    ll_stale = tree_fit.tree_log_likelihood(tree, x2_te, y_te)
    ll_refit = tree_fit.tree_log_likelihood(refits[0], x2_te, y_te)
    print(json.dumps({"genfit_path": {
        "num_labels": c, "depth": tree.depth, "k": kg, "reg": fcfg.reg, "points": FIT_POINTS,
        "held_out": FIT_HELD_OUT, "data_s": data_s, "fit_s": fit_s, "level_s": level_s,
        "launches": launches, "segment_plans": plans, "newton_solves": len(solves),
        "peak_mem_gib": peak_gib,
        "held_out_ll": ll, "uniform_ll": uniform, "real_mass_max_err": mass_err,
        "level_profiles": profiles, "refit_s": refit_s, "refit_bit_equal": True,
        "drifted_held_out_ll_stale": ll_stale, "drifted_held_out_ll_refit": ll_refit}}))
    return launches


def small_fits(dev, seed):
    """At C = 1,024 the level-parallel fit against the numpy oracle (held-out
    log-likelihood within tests/test_genfit.py's 5% + 0.02); at C = 4,096 the
    sharded fit serial and threaded, bit-equal."""
    fcfg = tree_fit.FitConfig(reg=0.1, seed=seed)
    spec = synthetic.ClusteredXCSpec(num_labels=1024, feature_dim=16, seed=seed)
    x, y, x_te, y_te = synthetic.make_clustered_xc(spec, 8192, 2048)
    ll_seq = tree_fit.tree_log_likelihood(
        tree_fit.fit_tree(x, y, 1024, config=fcfg, device=dev), x_te, y_te)
    t0 = time.perf_counter()
    tree = genfit.fit_tree_levelwise(x, y, 1024, config=fcfg, device=dev)
    torch.cuda.synchronize()
    lvl_s = time.perf_counter() - t0
    ll_lvl = tree_fit.tree_log_likelihood(tree, x_te, y_te)
    check_tree_invariants(tree, 1024, x_te, "C=1024 fit")
    check(abs(ll_lvl - ll_seq) <= 0.05 * abs(ll_seq) + 0.02,
          f"C=1024: levelwise {ll_lvl:.4f} against the oracle's {ll_seq:.4f}")
    spec = synthetic.ClusteredXCSpec(num_labels=4096, feature_dim=16, seed=seed)
    x, y, _, _ = synthetic.make_clustered_xc(spec, 16_384, 0)
    t0 = time.perf_counter()
    serial = genfit.fit_tree_sharded(x, y, 4096, config=fcfg, split_depth=2, device=dev)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    with ThreadPoolExecutor(2) as ex:
        threaded = genfit.fit_tree_sharded(x, y, 4096, config=fcfg, split_depth=2,
                                           executor=ex, device=dev)
    for name in ("w", "b", "label_to_leaf", "leaf_to_label"):
        check(torch.equal(getattr(serial, name), getattr(threaded, name)),
              f"C=4096: sharded serial and threaded fits differ ({name})")
    print(json.dumps({"small_fits": {
        "c1024_ll_levelwise": ll_lvl, "c1024_ll_oracle": ll_seq, "c1024_levelwise_s": lvl_s,
        "c4096_sharded_serial_s": serial_s, "c4096_serial_equals_threaded": True}}))


def band_pairs(sq, skv, causal, window) -> tuple:
    """(query, key) pairs inside the causal/window band, and the number of
    keys that some query sees, for end-aligned query positions."""
    pos = torch.arange(sq, dtype=torch.int64) + (skv - sq)
    lo = (pos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(pos)
    hi = pos.clamp(max=skv - 1) if causal else torch.full_like(pos, skv - 1)
    count = (hi - lo + 1).clamp(min=0)
    seen = int(hi.max() - lo.min() + 1) if bool((count > 0).any()) else 0
    return int(count.sum()), seen


def attn_errors(got, want) -> dict:
    """The largest error, the largest ratio of an error to its bound (bf16:
    the per-row ulp bound; float32: ``ATTN_F32_TOL``) and the relative RMS
    difference over the whole output."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        bound = (ATTN_BF16_ROW_ULP * w.abs().amax(dim=-1, keepdim=True)
                 + ATTN_BF16_REL * w.abs())
    else:
        bound = ATTN_F32_TOL["atol"] + ATTN_F32_TOL["rtol"] * w.abs()
    return dict(max_abs_err=float(err.max()), worst_ratio=float((err / bound).max()),
                rel_rms=rel_rms(g, w))


def attn_close(errs: dict, dtype) -> bool:
    return errs["worst_ratio"] <= 1.0 and (dtype != torch.bfloat16
                                           or errs["rel_rms"] <= ATTN_BF16_REL_RMS)


def attn_inputs(dev, gen, b, h, kv, sq, skv, hd, dtype, cache_len):
    """q (B, H, Sq, hd), k, v (B, KV, Skv, hd) and the scale to pass; with a
    cache length, laid out and scaled as the model passes them."""
    if not cache_len:
        return (torch.randn((b, h, sq, hd), generator=gen, device=dev).to(dtype),
                torch.randn((b, kv, skv, hd), generator=gen, device=dev).to(dtype),
                torch.randn((b, kv, skv, hd), generator=gen, device=dev).to(dtype), None)
    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
    q = q * torch.tensor(hd ** -0.5).to(dtype).item()
    cache_k = torch.randn((b, cache_len, kv, hd), generator=gen, device=dev).to(dtype)
    cache_v = torch.randn((b, cache_len, kv, hd), generator=gen, device=dev).to(dtype)
    return (q.transpose(1, 2), cache_k[:, :skv].transpose(1, 2),
            cache_v[:, :skv].transpose(1, 2), 1.0)


def check_flash_attention(dev, gen, flush):
    """The kernel against its plain version on the five shapes, two calls
    bit-equal; kernel, plain and library (scaled_dot_product_attention with
    a boolean band mask, GQA; not where there is a softcap) times. Bound: q,
    k, v of the keys some query sees and the output moved once, against
    4*hd operations per (query, key) pair in the band at the peak of the
    inputs' type (bf16 tensor cores, float32 outside them)."""
    import torch.nn.functional as F
    rows = {}
    for name, b, h, kv, sq, skv, hd, causal, window, softcap, dtype, cache_len in ATTN_SHAPES:
        q, k, v, scale = attn_inputs(dev, gen, b, h, kv, sq, skv, hd, dtype, cache_len)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        before = attn_launches_by_kernel()
        got = ops.flash_attention(q, k, v, **kw)
        path = [name for name, n in attn_launches_by_kernel().items() if n > before[name]]
        path = path[0] if len(path) == 1 else str(path)
        again = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        layout = f"model layout, cache {cache_len}" if cache_len else "contiguous"
        what = (f"flash_attention {name} (B={b} H={h} KV={kv} Sq={sq} Skv={skv} hd={hd} "
                f"causal={causal} window={window} softcap={softcap} {str(dtype)[6:]}, "
                f"{layout}; {path} kernel)")
        check(path == ATTN_KERNEL[name], f"{what}: took the wrong kernel")
        errs = attn_errors(got, want)
        err = errs["max_abs_err"]
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(attn_close(errs, dtype), f"{what}: kernel disagrees with the plain version "
                                       f"({errs})")
        check(torch.equal(got, again), f"{what}: two calls differ")
        del got, again, want
        pairs, seen = band_pairs(sq, skv, causal, window)
        elt = q.element_size()
        n_bytes = 2 * q.numel() * elt + 2 * b * kv * seen * hd * k.element_size()
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        n_flop = 4 * hd * b * h * pairs
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / peak
        bound, by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), flush)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), flush)
        library = None
        if not softcap:
            pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
            delta = pos - torch.arange(skv, device=dev)[None, :]
            band = torch.ones((sq, skv), dtype=torch.bool, device=dev)
            if causal:
                band &= delta >= 0
            if window > 0:
                band &= delta < window
            library = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, scale=scale, enable_gqa=True), flush)
        rows[name] = dict(path=path, max_abs_err=err, worst_ratio=errs["worst_ratio"],
                          rel_rms=errs["rel_rms"], ms=ms, plain_ms=plain, library_ms=library,
                          bound_ms=bound, bound_by=by, flop=n_flop, bytes=n_bytes,
                          tflop_per_s=n_flop / ms / 1e9)
        print(f"{what}: max_abs_err={err:.3e} (worst error/bound {errs['worst_ratio']:.3f}, "
              f"rel RMS {errs['rel_rms']:.3e}), kernel {ms:.4f} ms "
              f"({n_flop / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"sdpa {library if library is None else round(library, 4)} ms, "
              f"bound {bound:.4f} ms ({by})")
        del q, k, v
    print(json.dumps({"flash_attention": rows}))
    main = rows[ATTN_MAIN]
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}


def attn_launches_by_kernel() -> dict:
    fa = ops.flash_attention
    return dict(decode=fa.decode_launches, tensor_cores=fa.tensor_core_launches,
                fma=fa.fma_launches)


def blocked_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """The plain version over query blocks of ATTN_BLOCK rows, each against
    the keys its band can reach, so the (H, rows, keys) logits fit. End
    alignment keeps every row's absolute position. Causal only: the model's
    attention is."""
    check(causal, "the blocked plain attention is causal only")
    sq, skv = q.shape[2], k.shape[2]
    off = skv - sq
    outs = []
    for i0 in range(0, sq, ATTN_BLOCK):
        i1 = min(sq, i0 + ATTN_BLOCK)
        k_lo = max(0, off + i0 - window + 1) if window > 0 else 0
        k_hi = off + i1
        outs.append(ref.flash_attention_ref(q[:, :, i0:i1], k[:, :, k_lo:k_hi],
                                            v[:, :, k_lo:k_hi], causal=True,
                                            window=window, softcap=softcap, scale=scale))
    return torch.cat(outs, dim=2)


def rel_rms(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def serve_path(dev, seed):
    """The lock-step launcher at full h2o-danube-3-4b width, dense and beam;
    counters around each run; the kernel path against the plain forward."""
    cfg = configs.get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    params = transformer.cast_params(transformer.init_params(gen, cfg, device=dev), cfg)
    state = lm_head.default_head_state(gen, cfg, "adversarial_ns", device=dev)
    hcfg = lm_head.head_config(cfg, "adversarial_ns")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30   # float32 weights, then bf16
    torch.cuda.reset_peak_memory_stats()
    kernels = ("flash_attention", "tree_logprob_all", "gather_scores")

    def lockstep(beam, prompt_len=SERVE_PROMPT, gen_len=SERVE_GEN):
        args = serve.parse_args(["--lockstep", "--full", "--arch", SERVE_ARCH,
                                 "--batch", str(SERVE_BATCH), "--prompt-len", str(prompt_len),
                                 "--gen", str(gen_len), "--topk-beam", str(beam),
                                 "--seed", str(seed)])
        return serve.run_lockstep(args, cfg, params, state, hcfg, dev)

    paths = {}
    for path, beam in (("dense", 0), ("beam", SERVE_BEAM)):
        lockstep(beam, prompt_len=64, gen_len=2)                     # warm-up
        rec = {"h": [], "scores": [], "topk": []}
        forward, scores_fn, topk_fn = (transformer.forward, lm_head.lm_predictive_scores,
                                       lm_head.lm_predictive_topk)

        def rec_forward(*a, **kw):
            out = forward(*a, **kw)
            rec["h"].append(out[0])
            return out

        def rec_scores(*a, **kw):
            rec["scores"].append(scores_fn(*a, **kw))
            return rec["scores"][-1]

        def rec_topk(*a, **kw):
            rec["topk"].append(topk_fn(*a, **kw))
            return rec["topk"][-1]

        torch.cuda.synchronize()
        for name in kernels:
            getattr(ops, name).launches = 0
        ops.gather_scores.rows_launches = ops.gather_scores.split_launches = 0
        ops.flash_attention.decode_launches = ops.flash_attention.fma_launches = 0
        ops.flash_attention.tensor_core_launches = 0
        with swapped(transformer, forward=rec_forward), \
                swapped(lm_head, lm_predictive_scores=rec_scores, lm_predictive_topk=rec_topk):
            run = lockstep(beam)
        launches = {name: getattr(ops, name).launches for name in kernels}
        by_path = attn_launches_by_kernel()
        want_flash = cfg.num_layers * (1 + SERVE_GEN)
        check(launches["flash_attention"] == want_flash,
              f"{path}: flash_attention launched {launches['flash_attention']} times, "
              f"not {want_flash}")
        check(by_path == dict(decode=cfg.num_layers * SERVE_GEN, tensor_cores=cfg.num_layers,
                              fma=0),
              f"{path}: prefill's flash_attention launches not all on the tensor-core "
              f"kernel, or decode's not all on the decode kernel: {by_path}")
        check(launches["tree_logprob_all" if beam == 0 else "gather_scores"] == SERVE_GEN,
              f"{path}: the Eq. 5 kernel did not launch once per decode step: {launches}")
        gather_split = ops.gather_scores.split_launches
        check(gather_split == launches["gather_scores"],
              f"{path}: {launches['gather_scores'] - gather_split} gather_scores calls "
              f"not on the split variant")
        check(run["tokens"].shape == (SERVE_BATCH, SERVE_GEN), f"{path}: token shape")
        check(bool(((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab_size)).all()),
              f"{path}: a token outside the vocabulary")
        check(len(rec["h"]) == 1 + SERVE_GEN, f"{path}: {len(rec['h'])} forwards")
        for h in rec["h"]:
            check(bool(torch.isfinite(h).all()), f"{path}: non-finite hiddens")
        # One decode step at the last position, profiled by kernel.
        step = make_serve_step(cfg, hcfg, topk_beam=beam)
        last = SERVE_PROMPT + SERVE_GEN - 1
        by_name, n_kernels, host_ms, _, _ = profile_by_kernel(
            lambda: step(params, state, run["token"], run["cache"], last))
        device_ms = sum(by_name.values())
        flash_ms = sum(v for k, v in by_name.items() if "flash_attention" in k)
        combine_ms = sum(v for k, v in by_name.items() if "combine_kernel" in k)
        paths[path] = dict(
            beam=beam, prefill_ms=run["prefill_ms"], decode_ms=run["decode_ms"],
            ms_per_token=run["decode_ms"] / run["steps"], launches=launches,
            flash_attention_launches_by_kernel=by_path, gather_split_launches=gather_split,
            decode_step_profile=dict(
                host_ms=host_ms, device_ms=device_ms, kernels=n_kernels,
                idle_share=1.0 - device_ms / host_ms, flash_attention_device_ms=flash_ms,
                flash_attention_combine_device_ms=combine_ms,
                top_ms=[[k[:60], v] for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]))
        paths[path]["_rec"], paths[path]["_run"] = rec, run
        del run["cache"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # One prefill of the same 4 prompts, profiled by kernel.
    prompts = paths["dense"]["_run"]["prompts"]
    cache = transformer.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT, device=dev)
    by_name, n_kernels, host_ms, _, _ = profile_by_kernel(
        lambda: make_prefill(cfg)(params, prompts, cache))
    device_ms = sum(by_name.values())
    prefill_profile = dict(
        host_ms=host_ms, device_ms=device_ms, kernels=n_kernels,
        idle_share=1.0 - device_ms / host_ms,
        flash_attention_device_ms=sum(v for k, v in by_name.items() if "flash_attention" in k),
        top_ms=[[k[:60], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]])
    del cache

    # Beam: each step's top score is the dense Eq. 5 score of its label,
    # from the same hidden.
    beam_rec = paths["beam"].pop("_rec")
    paths["beam"].pop("_run")
    head = heads.HeadParams(**params["head"])
    for h, (top, labels) in zip(beam_rec["h"][1:], beam_rec["topk"]):
        dense = lm_head.lm_predictive_scores(cfg, hcfg, head, state, h[:, -1])
        check(close(top[:, 0], dense.gather(1, labels)[:, 0], SCORE_TOL),
              "beam: top scores differ from the dense Eq. 5 scores at their labels")
        check(bool((top[:, 0] <= dense.max(-1).values + SCORE_TOL["atol"]).all()),
              "beam: top-1 beats the dense maximum")
    del beam_rec

    # Dense: the 4 requests through prefill + decode against the plain
    # version's cache-free forward over the 4,640 tokens the cache holds.
    rec, run = paths["dense"].pop("_rec"), paths["dense"].pop("_run")
    fed = torch.cat([run["prompts"], run["prompts"][:, -1:],
                     torch.as_tensor(run["tokens"][:, :-1], device=dev)], dim=1)
    t0 = time.perf_counter()
    with swapped(ops, flash_attention=blocked_attention_ref,
                 tree_logprob_all=ref.tree_logprob_all_ref):
        plain_h, _, _ = transformer.forward(params, cfg, fed)
        plain_scores = lm_head.lm_predictive_scores(
            cfg, hcfg, head, state, plain_h[:, SERVE_PROMPT:].reshape(-1, cfg.d_model))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_h_prompt, plain_h_decode = plain_h[:, :SERVE_PROMPT], plain_h[:, SERVE_PROMPT:]
    kernel_h_prompt = rec["h"][0]
    kernel_h_decode = torch.stack([h[:, -1] for h in rec["h"][1:]], dim=1)
    kernel_scores = torch.stack(rec["scores"], dim=1).reshape(-1, plain_scores.shape[-1])
    real = slice(0, cfg.vocab_size)
    kernel_scores, plain_scores = kernel_scores[:, real], plain_scores[:, real]
    errs = {
        "prefill_hidden_rel_rms": rel_rms(kernel_h_prompt, plain_h_prompt),
        "decode_hidden_rel_rms": rel_rms(kernel_h_decode, plain_h_decode),
        "decode_scores_rel_rms": rel_rms(kernel_scores, plain_scores),
        "prefill_hidden_rel_rms_by_request": [
            rel_rms(kernel_h_prompt[i], plain_h_prompt[i]) for i in range(SERVE_BATCH)],
        "prefill_hidden_max_abs_err": float((kernel_h_prompt.float()
                                             - plain_h_prompt.float()).abs().max()),
        "decode_hidden_max_abs_err": float((kernel_h_decode.float()
                                            - plain_h_decode.float()).abs().max()),
        "decode_scores_max_abs_err": float((kernel_scores - plain_scores).abs().max()),
        "plain_scores_std": float(plain_scores.std()),
        "argmax_agreement": float((kernel_scores.argmax(-1)
                                   == plain_scores.argmax(-1)).float().mean()),
    }
    for key in ("prefill_hidden_rel_rms", "decode_hidden_rel_rms", "decode_scores_rel_rms"):
        check(errs[key] <= SERVE_REL_RMS_TOL,
              f"serving: kernel path against the plain forward, {key} = {errs[key]:.3e} "
              f"> {SERVE_REL_RMS_TOL:.3e}")
    launches = {name: sum(p["launches"][name] for p in paths.values()) for name in kernels}
    print(json.dumps({"serve_path": {
        "arch": SERVE_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
        "window": cfg.window_size, "vocab": cfg.vocab_size, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN, "params_b": cfg.param_count() / 1e9,
        "setup_s": setup_s, "setup_peak_mem_gib": setup_peak_gib, "paths": paths,
        "prefill_profile": prefill_profile,
        "serving_peak_mem_gib": peak_gib,
        "plain_forward_s": plain_s, "kernel_vs_plain": errs,
        "rel_rms_tol": SERVE_REL_RMS_TOL}}))
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    dev = device_lib.resolve("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32: "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = xc_linear.config()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)   # 256 MiB > L2
    torch.cuda._sleep(1_000_000_000)    # about 0.5 s busy, so clocks are up before timing
    torch.cuda.synchronize()
    floor, (floor_device, floor_seen) = launch_floor_ms(flush)
    print(json.dumps({"launch_floor_ms": floor, "empty_kernel_device_ms": floor_device,
                      "empty_kernel_device_ms_launches_seen": floor_seen}))
    gather = check_gather(dev, gen, flush, cfg, floor)
    tree = check_tree(dev, gen, flush, cfg, floor)
    sampled = check_sampled_loss(dev, gen, flush, cfg, floor)
    segment = check_segment_stats(dev, gen, flush)
    attention = check_flash_attention(dev, gen, flush)
    del flush
    check_small_against_cpu(dev, args.seed)

    launches = main_path(dev, args.seed, cfg)
    launches.update(sampled_head_loss=train_path(dev, args.seed, cfg)["sampled_head_loss"])
    pipeline_small(dev, args.seed)
    launches.update(segment_stats=genfit_path(dev, args.seed, cfg)["segment_stats"])
    small_fits(dev, args.seed)
    launches.update(flash_attention=serve_path(dev, args.seed)["flash_attention"])
    src = "src/repro_torch/kernels/csrc"
    kernels = [
        dict(name="gather_scores", route="cuda", source=f"{src}/gather_scores.cu",
             replaces="src/repro/kernels/gather_scores.py:44", **gather),
        dict(name="tree_logprob_all", route="cuda", source=f"{src}/tree_logprob.cu",
             replaces="src/repro/kernels/tree_logprob.py:69", **tree),
        dict(name="sampled_head_loss", route="cuda", source=f"{src}/sampled_loss.cu",
             replaces="src/repro/kernels/sampled_loss.py:162", **sampled),
        dict(name="segment_stats", route="cuda", source=f"{src}/segment_scores.cu",
             replaces="src/repro/kernels/segment_scores.py:51", **segment),
        dict(name="flash_attention", route="cuda", source=f"{src}/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:82", **attention),
    ]
    for k in kernels:
        k.setdefault("library_ms", None)
        k.update(launches=launches[k["name"]], max_err=k["max_abs_err"], kernel_ms=k["ms"],
                 launch_floor_ms=floor)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
