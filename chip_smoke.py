#!/usr/bin/env python3
"""Drives the PyTorch port's prediction, training, head-math, generator-fitting, LM-serving (lock-step and engine), LM-training and backbone-family paths on one NVIDIA card.

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
  8. ``flash_attention`` against its plain version on eleven shapes
     (h2o-danube prefill and decode at B = 4, gemma2's softcap geometry
     and decode, stablelm-3b's, hymba-1.5b's (G = 5, hd 64, window 1,024)
     and qwen2-vl-7b's (G = 7, hd 128) prefill and decode, each laid out
     and scaled as the model calls it; a ragged float32 case), within one bf16 ulp of
     each output row and 2^-11 relative RMS, two calls bit-equal, the kernel
     each shape took (the tensor-core kernel for the five bf16 prefills,
     the decode kernel for the five decodes, the FMA kernel for float32);
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
  9b. the continuous-batching engine (``repro_torch.serve.Engine``) at the
     same width, bf16 cache, 8 lanes, pages of 256 positions, counters
     reset just before and read just after each run, each run printed as
     an ``engine_run`` line (requests, tokens, wall ms, tokens/s, TTFT
     p50/p95, decode steps, prefill calls, share hits, drafts, preemptions,
     page grows, peak pages and GiB, launches by kernel and by
     ``flash_attention`` variant, host seconds by phase): (a) a burst of 8
     prompts of 4,096 tokens, 32 tokens each, dense and beam 64, token for
     token against the lock-step launcher at batch 8 on the same prompts
     (prefill on the tensor-core kernel, decode on the paged decode
     kernel; the largest difference of the decode hiddens printed); (b) 24
     requests of 256 to 4,090 prompt tokens and 8 to 32 new ones in two
     waves, the second of a higher class, under on-demand page growth and
     preemption with 60% of the full page reservation (both must happen;
     one step profiled by kernel and phase); (c) a shared-prefix burst
     (templates of 2,048 tokens, suffixes of 64) with prefix sharing and
     speculative decode (max draft 4), cold then warm, with a preempting
     class; (d) a float32 cache. Fatal: the pool's invariants and no leaked
     lane or page after each run, and the paged kernel against its plain
     version (``check_flash_attention``'s tolerances) on calls recorded
     from the engine — a bf16 decode step from (b), a multi-token step from
     (c), a float32-cache decode step from (d) — each with pages out of
     order, ragged key counts and a free lane on the sink page, timed
     beside its bound and the plain version; the lock-step's token
     agreement on (b) and (c) is reported;
 10. the head math at full ``xc_linear`` width (run after phase 5),
     counters reset just before and read just after: on
     benchmarks/bench_snr.py's conditional problem (256 contexts, p_D =
     softmax(2 ctx @ emb^T), 524,288 pairs) the tree (level-parallel fit),
     LSH (8 bits) and RFF (D = 64) proposals, each normalized, reporting
     its draws' log-probabilities, a chi-square of 2^20 draws, 300 training
     steps (ms per step, one ``sampled_head_loss`` launch a step) and a
     held-out log-likelihood above uniform's; the sparse training step
     with adagrad, sm3 (fp32, bf16) and adamw (fp32, int8) at C = 217,240
     and 2,097,152 (ms per step, p50/p95 from an ``obs`` histogram, state
     bytes, peak growth, one update profiled), SM3 and lazy AdamW sparse
     against dense; closed-form gradient SNR and signal mass of every
     proposal (Theorem 2), the streamed estimator timed; each section in
     an ``obs`` span, a ``record_function`` range in the profiler;
 11. LM training at full stablelm-3b width (32 layers, d 2,560, 32 heads,
     d_ff 6,912, vocab 50,304; tree C_pad 65,536, depth 16, k = 32; bf16
     compute over float32 master weights, remat on): the port's training
     launcher (``launch.train.setup``: ``build``, ``init_train_state``,
     ``make_train_step``) and ``run_loop``, batch 4 x 2,048, 12 steps,
     ``adversarial_ns`` with 1 negative, Adagrad, clip 1.0, generator fits
     at ``--gen-warmup 2 --gen-refresh 4 --gen-async --gen-swap-delay 2``,
     no checkpoint, then ``make_eval_step`` on the held-out batch; counters
     reset just before and read just after (one ``sampled_head_loss`` a
     step, ``segment_stats`` in every fit, one ``tree_logprob_all`` in the
     eval, no ``flash_attention``); ms per step (median, spread), tokens per
     second, fit seconds, peak memory, one profiled step's device time by
     kernel and layer and its idle share; the kernel against its plain
     version at the step's shape (T = 8,192, m = 2, K = 2,560); at full
     width and 2 layers, every trunk gradient against dense autograd on the
     same candidates, and 6 straight steps against 3 + preemption + resume,
     bit for bit;
 12. the backbone's other families at full width (run after phase 11), each
     built from the seed in bf16 layer by layer and deleted before the
     next, counters reset just before and read just after each path, each
     path's prefill ms, decode ms a token or step, one decode step profiled
     (host and device ms, idle share), peak memory and the card's line:
     (a) mamba2-370m (48 layers, d 1,024, 32 SSD heads of 64, state 128,
     chunk 256) through the engine, 8 lanes, 16 requests of 1 to 4,096
     prompt tokens in three bursts, 32 tokens each, dense and beam 64, each
     request's tokens equal to its lock-step decode alone at the engine's
     shapes; ``ssd_chunked`` against ``ssd_sequential`` at S = 4,096
     (relative RMS <= 1e-4, finite ``dt`` gradient); (b) hymba-1.5b (32
     layers, d 1,600, 25 heads over 5, hd 64, window 1,024, 50 SSD heads of
     state 16) the same, bf16 paged cache, pages of 256 (prefills on the
     tensor-core kernel or, at 1 and 2 tokens, the decode kernel; decodes
     paged on the decode kernel); (c) deepseek-moe-16b (28 layers, 64
     routed experts top-6 + 2 shared; 33.8 GB of bf16) lock-step, 4 x 2,048
     prompt tokens and 32, dense and beam 64, its MoE metrics at capacity
     factor 1.25, and on layer 0's real prefill input ``moe_ffn`` at
     capacity factor 8 bit-equal twice and against the dense oracle within
     2^-6 relative RMS; (d) qwen2-vl-7b, 2 requests of 1,024 vision
     embeddings and 1,024 tokens under (3, B, S) M-RoPE positions, 32
     tokens with (3, B, 1), equal streams bit-equal to (B, S) positions,
     and distinct streams against the plain forward over 4 layers (2^-5
     relative RMS, and 4 times closer than plain RoPE);
     (e) mixtral-8x22b at full width and 8 of its 56 layers (printed as
     ``reduced``), 2 x 4,096 prompt tokens and 16, dense, and its layer 0
     ``moe_ffn`` (the ``topk_softmax`` router) checked as (c)'s. Every model
     is built by the serving launcher's ``serve.build``;
 13. print the ``kernels`` JSON line and, last, the device line.

Exits non-zero without a CUDA device, and prints no result then.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, device as device_lib, genfit, obs, optim, tree_util  # noqa: E402
from repro_torch import train as train_lib  # noqa: E402
from repro_torch.configs import xc_linear  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import step as train_step_lib  # noqa: E402
from repro_torch.train.loop import step_generator  # noqa: E402
from repro_torch.models import lm_head, transformer  # noqa: E402
from repro_torch.train import make_prefill, make_serve_step  # noqa: E402
from repro_torch.core import heads, samplers, snr, tree as tree_lib, tree_fit, xc_train  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.genfit import levels as genfit_levels  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import gather_scores as gather_scores_lib, tree_logprob  # noqa: E402
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS  # noqa: E402
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.optim import sparse as sparse_lib  # noqa: E402
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
    ("hymba_prefill", 4, 25, 5, 4096, 4096, 64, True, 1024, 0.0, torch.bfloat16, 4128),
    ("hymba_decode", 8, 25, 5, 1, 4128, 64, True, 1024, 0.0, torch.bfloat16, 4128),
    ("qwen2vl_prefill", 2, 28, 4, 2048, 2048, 128, True, 0, 0.0, torch.bfloat16, 2080),
    ("qwen2vl_decode", 2, 28, 4, 1, 2080, 128, True, 0, 0.0, torch.bfloat16, 2080),
]
ATTN_MAIN = "danube_prefill"     # the shape of the kernels line
# The kernel each shape takes: the tensor-core kernel (bf16, more than 16
# packed rows, hd <= 128), the decode kernel (bf16, at most 16 packed rows)
# or the FMA kernel (float32).
ATTN_KERNEL = {"danube_prefill": "tensor_cores", "gemma2_softcap": "tensor_cores",
               "stablelm_prefill": "tensor_cores", "danube_decode": "decode",
               "gemma2_decode": "decode", "stablelm_decode": "decode", "ragged_fp32": "fma",
               "hymba_prefill": "tensor_cores", "hymba_decode": "decode",
               "qwen2vl_prefill": "tensor_cores", "qwen2vl_decode": "decode"}
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


def ms_per_train_step(hcfg, gen, data, lr, steps, seed, sampler=None):
    timer = Timer()
    params = xc_train.train_linear_head(hcfg, gen, *data, lr=lr, steps=steps, seed=seed,
                                        callback=timer, sampler=sampler,
                                        device=data[0].device)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, state, hcfg = serve.build(SERVE_ARCH, reduced=False, head="adversarial_ns",
                                           seed=seed + 6, device=dev)   # the launcher's build
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30   # bf16, a layer at a time
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
    return launches, (cfg, params, state, hcfg)


# ---------------------------------------------------------------------------
# Phase 9b: the continuous-batching engine at full h2o-danube-3-4b width.
# ---------------------------------------------------------------------------

ENGINE_SLOTS, ENGINE_PAGE_LEN = 8, 256
ENGINE_BURST_PROMPT, ENGINE_GEN = 4096, 32
# (b): prompt lengths from 256 to 4,096 tokens, most just short of a page
# boundary so that decoding crosses it (on-demand growth); two waves, the
# second of a higher class, so that admission preempts (spill and restore).
ENGINE_MIXED_PROMPTS = (256, 1000, 2040, 3070, 4090)
ENGINE_MIXED_GENS = (8, 16, 32)
ENGINE_MIXED_WAVES = (16, 8)
ENGINE_MIXED_PAGES_SHARE = 0.6   # of the full reservation (n_slots x max_pages)
# (c): on one engine, a cold pass, then a warm one that finds every prompt in
# the trie (shared pages, copy-on-write tails) and every context in the draft
# store (multi-token verify steps), joined after its first step by the first
# 8 requests again in a class above the generator's two, which preempt lanes (no 8 lanes can
# retire in one step: at most 1 + 4 tokens a step, at least 8 a request); a
# restored lane's pages come off the free list in the reverse of the order
# they went on.
ENGINE_SHARED = dict(n_requests=24, template_len=2048, suffix_len=64, n_templates=3,
                     exact_repeat_frac=0.5, burst=8, gen_tokens=16,
                     gen_tokens_choices=(8, 16, 32))
ENGINE_MAX_DRAFT = 4
ENGINE_KERNELS = ("flash_attention", "tree_logprob_all", "gather_scores")
ENGINE_SPANS = ("serve/phase/prefill", "serve/phase/decode", "serve/phase/select",
                "serve/phase/descent")


# The kernels' wrappers, which hold the counts: a run may swap a recorder in
# for ``ops.flash_attention``.
ENGINE_KERNEL_FNS = {name: getattr(ops, name) for name in ENGINE_KERNELS}


def reset_engine_counters() -> None:
    torch.cuda.synchronize()
    for fn in ENGINE_KERNEL_FNS.values():
        fn.launches = 0
    fa = ENGINE_KERNEL_FNS["flash_attention"]
    fa.decode_launches = fa.fma_launches = fa.tensor_core_launches = fa.paged_launches = 0
    gs = ENGINE_KERNEL_FNS["gather_scores"]
    gs.rows_launches = gs.split_launches = 0


def engine_counts() -> dict:
    torch.cuda.synchronize()
    out = {name: fn.launches for name, fn in ENGINE_KERNEL_FNS.items()}
    fa = ENGINE_KERNEL_FNS["flash_attention"]
    out["flash_attention_by_kernel"] = dict(
        decode=fa.decode_launches, tensor_cores=fa.tensor_core_launches,
        fma=fa.fma_launches, paged=fa.paged_launches)
    return out


def wants_record(token_rows, table, kv_lens, sink) -> bool:
    """Whether a paged step's host-built inputs show all three things the
    recorded check needs: a row whose mapped pages are out of order, ragged
    key counts among the live rows, and a free lane whose table is all sink."""
    live = [r for r in range(table.shape[0]) if (table[r] != sink).any()]
    free = [r for r in range(table.shape[0]) if (table[r] == sink).all()]
    out_of_order = any(
        (np.diff(table[r][table[r] != sink].astype(np.int64)) < 0).any() for r in live)
    ragged = len({int(kv_lens[r]) for r in live}) > 1
    return bool(free) and out_of_order and ragged and token_rows > 0


class PagedRecorder:
    """Records the first ``flash_attention`` call through a page table of a
    step that ``wants_record`` picks (layer 0 of that step): q, one layer's
    arenas, the key counts and the table, cloned, with the call's output."""

    def __init__(self, eng, attr: str, name: str, max_rows: int = 1 << 30):
        self.name, self.call, self.armed = name, None, False
        step = getattr(eng, attr)
        sink = eng.pool.sink

        def watched(*args):
            if self.call is None:
                tokens = np.asarray(args[1])
                if attr == "_decode":       # (params, token, arena, cache_pos, table)
                    lens, table = np.asarray(args[3]) + 1, np.asarray(args[4])
                else:                       # (params, tokens, start, lengths, arena, table)
                    lens, table = np.asarray(args[2]) + tokens.shape[1], np.asarray(args[5])
                self.armed = (tokens.shape[1] <= max_rows
                              and wants_record(tokens.shape[0], table, lens, sink))
            try:
                return step(*args)
            finally:
                self.armed = False
        setattr(eng, attr, watched)

    def wrap(self, fn):
        def attention(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            if self.armed and self.call is None and kw.get("page_table") is not None:
                self.call = dict(q=q.clone(), k=k.clone(), v=v.clone(), out=out.clone(),
                                 kw={n: (t.clone() if isinstance(t, torch.Tensor) else t)
                                     for n, t in kw.items()})
            return out
        return attention


def check_recorded(rec: PagedRecorder, flush) -> dict:
    """The kernel against its plain version on a recorded engine call, with
    check_flash_attention's tolerances; the call again gives the engine's
    bits; its time beside its bound (q, the output and the K/V of the keys
    each row's queries see, against 4*hd operations per (query, key) pair)
    and the plain version's."""
    check(rec.call is not None, f"{rec.name}: no engine call had pages out of order, "
                                "ragged lengths and a free lane")
    c = rec.call
    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    before = attn_launches_by_kernel()
    got = ops.flash_attention(q, k, v, **kw)
    path = [n for n, m in attn_launches_by_kernel().items() if m > before[n]]
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    errs = attn_errors(got, want)
    what = (f"{rec.name}: paged flash_attention on an engine call (B={q.shape[0]} "
            f"Sq={q.shape[2]} lens={kw['kv_lens'].tolist()} page_len={k.shape[1]} "
            f"q {str(q.dtype)[6:]}, cache {str(k.dtype)[6:]}; {path} kernel)")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(attn_close(errs, q.dtype), f"{what}: kernel disagrees with the plain version "
                                     f"({errs})")
    check(torch.equal(got, c["out"]), f"{what}: the call again differs from the engine's")
    lens = kw["kv_lens"].tolist()
    b, h, sq, hd = q.shape
    kvh = k.shape[2]
    pairs = seen = 0
    for n in lens:
        p_, s_ = band_pairs(sq, n, True, kw.get("window", 0))
        pairs, seen = pairs + p_, seen + s_
    n_bytes = (2 * q.numel() * q.element_size() + 2 * seen * kvh * hd * k.element_size()
               + kw["kv_lens"].numel() * 4 + kw["page_table"].numel() * 4)
    peak = (BF16_FLOP_PER_S if q.dtype == k.dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    n_flop = 4 * hd * h * pairs
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / peak
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), flush)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), flush)
    row = dict(path=path[0] if len(path) == 1 else str(path), rows=b, sq=sq, kv_lens=lens,
               page_len=k.shape[1], q_dtype=str(q.dtype)[6:], cache_dtype=str(k.dtype)[6:],
               max_abs_err=errs["max_abs_err"], worst_ratio=errs["worst_ratio"],
               rel_rms=errs["rel_rms"], ms=ms, plain_ms=plain, library_ms=None,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes)
    print(f"{what}: max_abs_err={errs['max_abs_err']:.3e} (worst error/bound "
          f"{errs['worst_ratio']:.3f}), kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def run_engine_case(name, eng, submit_waves):
    """Drives ``eng`` over the waves of requests (a wave is submitted, then
    the engine steps ``steps`` times before the next, the last runs to the
    end), counters reset just before and read just after; the pool's
    invariants and no leaked lane or page afterwards. Returns the run's
    line (printed) and the handles."""
    host_s = collections.Counter()

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_s[name] += time.perf_counter() - t
        return call
    eng._admit = timed("admission", eng._admit)          # prefill launches included
    eng._emit_token = timed("retire", eng._emit_token)    # token append, stops, release
    torch.cuda.reset_peak_memory_stats()
    reset_engine_counters()
    t0 = time.perf_counter()
    handles = []
    for wave, steps in submit_waves:
        handles += [eng.submit(r) for r in wave]
        if steps is None:
            eng.run()
        else:
            for _ in range(steps):
                eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    del eng._admit, eng._emit_token
    counts = engine_counts()
    pool = eng.pool
    pool.check_invariants()
    check(pool.num_free_lanes == pool.n_lanes and pool.num_mapped_pages == 0
          and eng.num_active == 0 and eng.num_pending == 0,
          f"{name}: leaked lanes or pages ({pool.num_free_lanes} of {pool.n_lanes} lanes "
          f"free, {pool.num_mapped_pages} pages mapped)")
    check(all(h.done and h.status == "ok" for h in handles), f"{name}: a request failed")
    check(counts["flash_attention_by_kernel"]["paged"] > 0,
          f"{name}: no flash_attention launch read through a page table")
    tokens = sum(len(h.tokens) for h in handles)
    st = eng.stats()
    ttft = st["latency"]["ttft"]
    line = dict(
        requests=len(handles), tokens=tokens, wall_ms=wall_ms,
        tokens_per_s=1e3 * tokens / wall_ms, ttft_p50_ms=1e3 * ttft["p50"],
        ttft_p95_ms=1e3 * ttft["p95"], decode_steps=eng.decode_steps,
        prefill_calls=eng.prefill_calls,
        share_hits=st.get("prefix", {}).get("hits", 0),
        prefill_tokens_saved=st.get("prefix", {}).get("prefill_tokens_saved", 0),
        cow_copies=st.get("prefix", {}).get("cow_copies", 0),
        drafts_proposed=st.get("spec", {}).get("drafts_proposed", 0),
        drafts_accepted=st.get("spec", {}).get("drafts_accepted", 0),
        verify_steps=st.get("spec", {}).get("verify_steps", 0),
        preemptions=st["sched"]["preemptions"], restores=st["sched"]["restores"],
        page_grows=st["sched"]["page_grows"], n_pages=pool.n_pages,
        peak_pages=st["peak_pages_in_use"], peak_active=st["peak_active"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=counts,
        phase_host_s=dict({n: eng.registry.histogram(n).total for n in ENGINE_SPANS},
                          **host_s))
    return line, handles


def lockstep_agreement(cfg, hcfg, params, state, handles, beam) -> float:
    """Share of the engine's tokens that the port's lock-step decode gives
    for the same prompts and head path (grouped by prompt length, each group
    one batch). Reported, not checked: the engine pads prompts to a power of
    two, batches other rows beside them and runs multi-token paged steps,
    so its bf16 roundings differ from the lock-step's, near-ties may go the
    other way, and a request's tokens after a flip differ."""
    from repro_torch.serve import lockstep_decode
    groups: dict = {}
    for h in handles:
        groups.setdefault(h.request.prompt.size, []).append(h)
    same = total = 0
    for group in groups.values():
        gen_len = max(h.request.max_new_tokens for h in group)
        out = lockstep_decode(cfg, hcfg, params, state,
                              np.stack([h.request.prompt for h in group]), gen_len,
                              topk_beam=beam, cache_dtype=torch.bfloat16)
        for h, row in zip(group, out):
            n = len(h.tokens)
            same += int((row[:n] == np.asarray(h.tokens)).sum())
            total += n
    return same / max(total, 1)


def engine_path(dev, seed, card, model) -> dict:
    """Phase 9b: the port's continuous-batching engine at full
    h2o-danube-3-4b width, bf16 cache, 8 lanes, pages of 256 positions:
    (a) a burst of 8 prompts of 4,096 tokens, 32 tokens each, dense and beam
    64, token for token against the lock-step launcher at batch 8 on the
    same prompts; (b) 24 mixed-length requests in two waves under on-demand
    page growth and preemption with 60% of the full page reservation; (c) a
    shared-prefix burst (templates of 2,048 tokens, suffixes of 64) with
    prefix sharing and speculative decode. Counters reset just before and
    read just after each run. The paged kernel against its plain version on
    calls recorded from the engine: a bf16 decode step from (b), a
    multi-token step from (c), and a decode step of a float32 cache (the
    reference's default) from a short run (d)."""
    from repro_torch.serve import (Engine, Request, ServeConfig, TrafficConfig,
                                   make_shared_prefix_burst, make_workload)
    cfg, params, state, hcfg = model
    t_phase = time.perf_counter()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    max_len = ENGINE_BURST_PROMPT + ENGINE_GEN
    base = dict(n_slots=ENGINE_SLOTS, max_len=max_len, page_len=ENGINE_PAGE_LEN,
                cache_dtype=torch.bfloat16)
    runs, recorded, total = {}, {}, collections.Counter()

    def show(name, line):
        print(json.dumps({"engine_run": dict(name=name, card=card, **line)}))
        return line

    def add(counts):
        for name in ENGINE_KERNELS:
            total[name] += counts[name]

    # (a) burst against the lock-step launcher.
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    burst = torch.randint(0, cfg.vocab_size, (ENGINE_SLOTS, ENGINE_BURST_PROMPT),
                          generator=gen, device=dev).cpu().numpy()
    for path, beam in (("dense", 0), ("beam", SERVE_BEAM)):
        args = serve.parse_args(["--lockstep", "--full", "--arch", SERVE_ARCH,
                                 "--batch", str(ENGINE_SLOTS), "--prompt-len",
                                 str(ENGINE_BURST_PROMPT), "--gen", str(ENGINE_GEN),
                                 "--topk-beam", str(beam), "--seed", str(seed)])
        hiddens = {"lockstep": [], "engine": []}
        forward = transformer.forward

        def rec_forward(*a, _into=None, **kw):
            out = forward(*a, **kw)
            if out[0].shape[1] == 1:                 # decode steps
                _into.append(out[0][:, -1].float().clone())
            return out

        with swapped(serve, _prompts=lambda *_: torch.as_tensor(burst, device=dev)), \
                swapped(transformer, forward=lambda *a, **kw: rec_forward(
                    *a, _into=hiddens["lockstep"], **kw)):
            want = serve.run_lockstep(args, cfg, params, state, hcfg, dev)
        eng = Engine(cfg, hcfg, params, state, ServeConfig(beam=beam, **base))
        with swapped(transformer, forward=lambda *a, **kw: rec_forward(
                *a, _into=hiddens["engine"], **kw)):
            line, handles = run_engine_case(
                f"burst_{path}", eng, [([Request(prompt=p, max_new_tokens=ENGINE_GEN)
                                         for p in burst], None)])
        got = np.stack([h.result() for h in handles])
        check(np.array_equal(got, want["tokens"]),
              f"burst_{path}: the engine's tokens differ from the lock-step's "
              f"({int((got != want['tokens']).sum())} of {got.size})")
        check(line["prefill_calls"] == 1, f"burst_{path}: the burst took "
                                          f"{line['prefill_calls']} prefill launches, not 1")
        by = line["launches"]["flash_attention_by_kernel"]
        check(by["tensor_cores"] == cfg.num_layers and
              by["decode"] == cfg.num_layers * ENGINE_GEN == by["paged"],
              f"burst_{path}: admission prefill not on the tensor-core kernel or decode "
              f"not on the paged decode kernel: {by}")
        head_kernel = "gather_scores" if beam else "tree_logprob_all"
        check(line["launches"][head_kernel] >= ENGINE_GEN,
              f"burst_{path}: {head_kernel} launched {line['launches'][head_kernel]} times")
        line["last_hidden_max_abs_diff"] = max(
            float((a - b).abs().max()) for a, b in zip(hiddens["engine"],
                                                        hiddens["lockstep"]))
        line["lockstep_tokens_equal"] = True
        add(line["launches"])
        runs[f"burst_{path}"] = show(f"burst_{path}", line)
        del eng, want, hiddens

    # (b) mixed lengths, on-demand growth, preemption, 60% of the pages.
    full = ENGINE_SLOTS * -(-max_len // ENGINE_PAGE_LEN)
    n_pages = int(round(ENGINE_MIXED_PAGES_SHARE * full))
    work = [r for _, r in make_workload(TrafficConfig(
        n_requests=sum(ENGINE_MIXED_WAVES), prompt_len=ENGINE_MIXED_PROMPTS[0],
        gen_tokens=ENGINE_GEN, prompt_len_choices=ENGINE_MIXED_PROMPTS,
        gen_tokens_choices=ENGINE_MIXED_GENS, vocab_size=cfg.vocab_size, seed=seed + 12))]
    first, second = ENGINE_MIXED_WAVES
    wave2 = [dataclasses.replace(r, priority=1) for r in work[first:]]
    eng = Engine(cfg, hcfg, params, state, ServeConfig(
        beam=SERVE_BEAM, n_pages=n_pages, preemption=True, page_growth="ondemand", **base))
    rec_b = PagedRecorder(eng, "_decode", "mixed decode (bf16 cache)")
    with swapped(ops, flash_attention=rec_b.wrap(ops.flash_attention)):
        line, handles = run_engine_case("mixed", eng, [(work[:first], 4), (wave2, None)])
    check(line["preemptions"] >= 1 and line["restores"] >= 1 and line["page_grows"] >= 1,
          f"mixed: no preemption or no page growth ({line['preemptions']} preemptions, "
          f"{line['page_grows']} page grows)")
    for h in handles:
        check(len(h.tokens) == h.request.max_new_tokens and
              all(0 <= t < cfg.vocab_size for t in h.tokens), "mixed: a bad token stream")
    # One steady-state engine step profiled by kernel and phase.
    for r in work[:ENGINE_SLOTS]:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.registry.annotate = True
    by_name, n_kernels, host_ms, inside, _ = profile_by_kernel(eng.step, ranges=ENGINE_SPANS)
    eng.registry.annotate = False
    eng.run()
    device_ms = sum(by_name.values())
    line["step_profile"] = dict(
        active=ENGINE_SLOTS, host_ms=host_ms, device_ms=device_ms, kernels=n_kernels,
        idle_share=1.0 - device_ms / host_ms,
        device_ms_by_phase={n: sum(v.values()) for n, v in inside.items()},
        flash_attention_device_ms=sum(v for k, v in by_name.items() if "flash_attention" in k),
        top_ms=[[k[:60], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]])
    line["lockstep_token_agreement"] = lockstep_agreement(cfg, hcfg, params, state, handles,
                                                         SERVE_BEAM)
    add(line["launches"])
    runs["mixed"] = show("mixed", line)
    recorded["decode_bf16"] = check_recorded(rec_b, flush)
    del eng, rec_b

    # (c) shared-prefix burst with sharing and speculative decode.
    work = [r for _, r in make_shared_prefix_burst(TrafficConfig(
        vocab_size=cfg.vocab_size, seed=seed + 13, **ENGINE_SHARED))]
    shared_len = ENGINE_SHARED["template_len"] + ENGINE_SHARED["suffix_len"] + ENGINE_GEN
    eng = Engine(cfg, hcfg, params, state, ServeConfig(
        beam=SERVE_BEAM, prefix_sharing=True, spec_decode=True, max_draft=ENGINE_MAX_DRAFT,
        preemption=True, **dict(base, max_len=shared_len)))
    # A step of more than one token a row and at most 64 (a verify step with
    # drafts, or a suffix prefill): the plain version's logits of a padded
    # 4,096-token first prefill would not fit.
    # Last, a few requests on a mostly idle engine whose free list the
    # preemptions have permuted: one of each prompt length, so lanes are
    # free and key counts ragged while drafts replay.
    tail = [dataclasses.replace(r) for n in sorted({r.prompt.size for r in work})
            for r in [next(r for r in work if r.prompt.size == n)]] * 2
    rec_c = PagedRecorder(eng, "_paged_prefill", "multi-token paged step (bf16 cache)",
                          max_rows=64)
    rec_c_wrap, ops_flash = rec_c.wrap(ops.flash_attention), ops.flash_attention

    def multi_only(q, k, v, **kw):
        return ops_flash(q, k, v, **kw) if q.shape[2] == 1 else rec_c_wrap(q, k, v, **kw)
    with swapped(ops, flash_attention=multi_only):
        line, handles = run_engine_case(
            "shared_prefix", eng,
            [(work, None), ([dataclasses.replace(r) for r in work], 1),
             ([dataclasses.replace(r, priority=2) for r in work[:ENGINE_SLOTS]], None),
             (tail, None)])
    check(line["share_hits"] >= 1 and line["verify_steps"] >= 1,
          f"shared_prefix: {line['share_hits']} share hits, "
          f"{line['verify_steps']} verify steps")
    check(line["launches"]["flash_attention_by_kernel"]["fma"] >= 1,
          "shared_prefix: no multi-token paged step reached the FMA kernel")
    line["lockstep_token_agreement"] = lockstep_agreement(cfg, hcfg, params, state, handles,
                                                         SERVE_BEAM)
    add(line["launches"])
    runs["shared_prefix"] = show("shared_prefix", line)
    recorded["multi_token_bf16"] = check_recorded(rec_c, flush)
    del eng, rec_c

    # (d) the reference's default float32 cache: a short run whose second
    # wave reuses the first's pages in LIFO order.
    eng = Engine(cfg, hcfg, params, state, ServeConfig(
        n_slots=ENGINE_SLOTS, max_len=1024, page_len=ENGINE_PAGE_LEN, beam=SERVE_BEAM))
    rng = np.random.default_rng(seed + 14)
    waves = [[Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      max_new_tokens=g) for n, g in lens]
             for lens in (((300, 4), (700, 4), (520, 4)), ((610, 6), (260, 6), (900, 6)))]
    rec_d = PagedRecorder(eng, "_decode", "decode (float32 cache)")
    with swapped(ops, flash_attention=rec_d.wrap(ops.flash_attention)):
        line, _ = run_engine_case("f32_cache", eng, [(waves[0], None), (waves[1], None)])
    check(line["launches"]["flash_attention_by_kernel"]["fma"] >= 1,
          "f32_cache: the float32 cache's decode did not reach the FMA kernel")
    add(line["launches"])
    runs["f32_cache"] = show("f32_cache", line)
    recorded["decode_f32_cache"] = check_recorded(rec_d, flush)
    del eng, rec_d, flush

    print(json.dumps({"engine_path": {
        "arch": SERVE_ARCH, "card": card, "slots": ENGINE_SLOTS, "page_len": ENGINE_PAGE_LEN,
        "cache": "bfloat16 (f32_cache: float32)", "wall_s": time.perf_counter() - t_phase,
        "launches": dict(total), "paged_kernel_checks": recorded,
        "runs": sorted(runs)}}))
    return dict(total)


# ---------------------------------------------------------------------------
# Phase 11: LM training at full stablelm-3b width.
# ---------------------------------------------------------------------------

LM_ARCH = "stablelm-3b"
LM_BATCH, LM_SEQ, LM_STEPS = 4, 2048, 12
# The launcher's flags (launch.train), full width and depth; the learning
# rate is cut from the launcher's reduced-model default of 0.05: Adagrad's
# first step moves every weight by about lr, and the weights' scale at
# d_model 2,560 is 0.02.
LM_FLAGS = ["--arch", LM_ARCH, "--full", "--device", "cuda", "--head", "adversarial_ns",
            "--n-neg", "1", "--optimizer", "adagrad", "--lr", "1e-3",
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--steps", str(LM_STEPS),
            "--gen-warmup", "2", "--gen-refresh", "4", "--gen-async", "--gen-swap-delay", "2"]
LM_EVAL_BATCH = 99_999           # the held-out batch, as examples/train_lm.py
LM_FITS = 3                      # submits at 2 and 6 (swaps at 4, 8), a blocking fit at 10
LM_PEAK_GIB = 72.0               # above it the run halves the depth
LM_CHECK_LAYERS = 2              # depth of the gradient and resume checks (full width)
LM_RESUME_STEPS, LM_PREEMPT_AFTER = 6, 3
LM_TRUNK_REL_TOL = 1e-2          # dh rounded to bf16 into the trunk: 2^-8 relative a term
LM_GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
LM_SEG_NODES = 256               # the fit level (8) whose segment_stats calls are checked
LM_RANGES = ("train/forward", "train/head", "train/backward", "train/embed_rows",
             "train/optimizer")
ROW_SUM_KERNELS = ("Sort", "sort", "unique", "Unique")   # torch.unique and the plans' sort


def lm_step_layers(train_step, state, batch, gen, seed_step):
    """One profiled sparse step: device ms by kernel and by layer (trunk
    forward, backward with the recompute, sampling, the head kernel, row
    sums, optimizer), host ms and the idle share. The step's ranges
    (``train/...``) own the PyTorch kernels launched inside them; the CUDA
    kernels of the port, launched through ctypes, are told by name; the
    backward pass runs on autograd's thread, outside every range, and takes
    the rest."""
    out = {}

    def step():
        out["state"], _ = train_step(state, batch, gen(seed_step))

    by_name, n_kernels, host_ms, inside, _ = profile_by_kernel(step, ranges=LM_RANGES)
    device = sum(by_name.values())

    def total(names, table=by_name):
        return sum(v for k, v in table.items() if any(n in k for n in names))

    kernel = total(("sampled_loss_kernel",))
    sums = total(SEGMENT_KERNELS + SEGMENT_PLAN_KERNELS)
    head = inside["train/head"]
    head_sort = total(ROW_SUM_KERNELS, head)
    ranged = {name: sum(v.values()) for name, v in inside.items()}
    layers = {
        "trunk_forward": ranged["train/forward"],
        "sampling": ranged["train/head"] - head_sort,
        "head_kernel": kernel,
        "row_sums": sums + head_sort + ranged["train/embed_rows"],
        "optimizer": ranged["train/optimizer"],
    }
    layers["backward_with_recompute"] = device - sum(layers.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return out["state"], {"host_ms": host_ms, "device_ms": device, "kernels": n_kernels,
                          "idle_share": 1.0 - device / host_ms, "layers_ms": layers,
                          "memcpy_ms": total(("Memcpy",)),
                          "top_ms": [[k[:70], v] for k, v in ranked]}


def lm_kernel_check(dev, state, cfg, hcfg, batch, seed):
    """The sampled_head_loss kernel against its plain version at the
    training step's shape (T = 8,192, m = 2, K = 2,560) on the trained head
    and a step's candidates, within phase 3's tolerances; both timed."""
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    with torch.no_grad():
        h, _, _ = transformer.forward(state.params, cfg, batch["tokens"], attn_impl="plain")
        h = h.reshape(-1, cfg.d_model).float().contiguous()
        ids, lp, _ = heads._sample_candidates(hcfg, state.head_state.gen,
                                              lm_head.gen_features(state.head_state, h),
                                              batch["labels"].reshape(-1), g)
    w, b = state.params["head"]["w"], state.params["head"]["b"]
    kw = dict(kind=hcfg.kind, num_labels=cfg.vocab_size, reg=hcfg.reg,
              softcap=cfg.final_logit_softcap)
    got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
    want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
    for name, g_, w_ in zip(("loss", "coeff", "xi"), got, want):
        check(bool(torch.isfinite(g_).all()), f"LM kernel check: non-finite {name}")
        check(close(g_, w_, LOSS_TOL), f"LM kernel check: {name} disagrees")
    check(dh_close(got[3], want[3], want[1], w, ids), "LM kernel check: dh disagrees")
    t, m = ids.shape
    rows = torch.unique(ids).numel()
    n_bytes = (rows * (cfg.d_model + 1) * 4 + t * cfg.d_model * 4 + t * m * (8 + 4)
               + t * 4 + 2 * t * m * 4 + t * cfg.d_model * 4)
    bound, by = bound_ms(n_bytes, t * m * 4 * cfg.d_model)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), flush)
    plain = time_ms(lambda: ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw), flush)
    return {"t": t, "m": m, "k": cfg.d_model, "distinct_rows": rows,
            "max_abs_err": max(float((g_ - w_).abs().max()) for g_, w_ in zip(got[:3], want[:3])),
            "dh_max_abs_err": float((got[3] - want[3]).abs().max()),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "tol": LOSS_TOL}


def lm_tree_check(calls):
    """The eval's tree_logprob_all call (B = 8,192, depth 16, k = 32), its
    output against the plain version on its own inputs, within TREE_TOL."""
    check(len(calls) == 1, f"LM eval: {len(calls)} tree_logprob_all calls recorded, not 1")
    w, b, x, got = calls.pop()
    want = ref.tree_logprob_all_ref(w, b, x)
    err = float((got - want).abs().max())
    what = f"LM eval tree_logprob_all (B={x.shape[0]}, k={x.shape[1]}, C_pad={got.shape[1]})"
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(close(got, want, TREE_TOL), f"{what} disagrees with the plain version ({err:.3e})")
    return {"b": x.shape[0], "k": x.shape[1], "c_pad": got.shape[1], "max_abs_err": err,
            "tol": TREE_TOL}


def lm_segment_check(calls, k):
    """The first fit's recorded segment_stats calls (its first call, the
    per-label sums, and every call at the level of LM_SEG_NODES nodes: the
    Newton solves' objective, Hessian, gradient and Armijo sums), each
    output against the plain version on its own inputs, within SEG_TOL of
    each segment's sum of |vals|."""
    shapes, worst = collections.Counter(), 0.0
    for vals, seg, s, got in calls:
        want = ref.segment_stats_ref(vals, seg, s)
        scale = ref.segment_stats_ref(vals.abs(), seg, s) + 1.0
        what = f"LM fit segment_stats (N={vals.shape[0]}, D={vals.shape[1]}, S={s})"
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite sums")
        rel = float(((got - want).abs() / scale).max())
        check(rel <= SEG_TOL, f"{what} disagrees with the plain version ({rel:.3e})")
        shapes[f"N={vals.shape[0]},D={vals.shape[1]},S={s}"] += 1
        worst = max(worst, rel)
    hess = f",D={(k + 1) ** 2},S={LM_SEG_NODES}"
    check(any(key.endswith(hess) for key in shapes),
          f"LM fit: no Hessian sum at {LM_SEG_NODES} nodes recorded ({dict(shapes)})")
    return {"calls": len(calls), "shapes": dict(shapes), "worst_err_of_abs_sum": worst,
            "tol": SEG_TOL, "recorded_mib": sum(v.numel() * v.element_size()
                                                for v, _, _, _ in calls) / 2 ** 20}


def lm_grad_check(dev, cfg, hcfg, batch, seed):
    """At full width and LM_CHECK_LAYERS layers: the sparse step's gradients
    (the kernel's dh through the trunk) against dense autograd through the
    candidate scores, on the same candidates; every trunk leaf non-zero."""
    state = train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed + 12),
                                       cfg, OptimizerConfig(), hcfg.kind, device=dev)
    sparse, ms = train_step_lib.make_grad_fn(cfg, hcfg, "sparse")(
        state, batch, torch.Generator(device=dev).manual_seed(seed + 13))
    dense, md = train_step_lib.make_grad_fn(cfg, hcfg, "dense")(
        state, batch, torch.Generator(device=dev).manual_seed(seed + 13))
    check(close(ms["loss"], md["loss"], LM_GRAD_TOL), "LM grads: sparse and dense losses differ")
    head_w, head_b = sparse_lib.to_dense(sparse["head"], state.params["head"]["w"].shape)
    check(close(head_w, dense["head"]["w"], LM_GRAD_TOL)
          and close(head_b, dense["head"]["b"], LM_GRAD_TOL),
          "LM grads: the head's SparseRows differ from dense autograd")
    embed, _ = sparse_lib.to_dense(sparse["embed"], state.params["embed"].shape)
    pairs = [("embed", embed, dense["embed"])]
    trunk = lambda gr: {k: v for k, v in gr.items() if k not in ("head", "embed")}  # noqa: E731
    flat_s, flat_d = tree_util.flatten(trunk(sparse))[0], tree_util.flatten(trunk(dense))[0]
    pairs += [(f"trunk_leaf_{i}", a, b) for i, (a, b) in enumerate(zip(flat_s, flat_d))]
    rels = {}
    for name, a, b in pairs:
        check(bool(torch.isfinite(a).all()) and float(a.abs().sum()) > 0,
              f"LM grads: {name} is zero or not finite")
        rels[name] = float((a.float() - b.float()).norm() / b.float().norm())
        check(rels[name] <= LM_TRUNK_REL_TOL,
              f"LM grads: {name} differs from dense autograd by {rels[name]:.3e}")
    return {"leaves": len(pairs), "worst_rel_err": max(rels.values()), "rel_err": rels,
            "leaf_order": "embed, then the trunk's leaves in sorted-key order (final_norm, "
                          "layers[i].attn.wk/wo/wq/wv, mlp.w_down/w_gate/w_up, norm_ffn, "
                          "norm_mix)", "rel_tol": LM_TRUNK_REL_TOL,
            "loss_sparse": float(ms["loss"]), "loss_dense": float(md["loss"])}


def lm_resume_check(dev, cfg, hcfg, opt, batch_fn, seed):
    """At full width and LM_CHECK_LAYERS layers: LM_RESUME_STEPS straight
    steps against LM_PREEMPT_AFTER steps, a Preemption, and a resume from
    the checkpoint in a fresh state, bit for bit in params and optimizer
    state."""
    def fresh():
        return train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed + 14),
                                          cfg, opt, hcfg.kind, device=dev)

    step = train_lib.make_train_step(cfg, hcfg, opt, skip_nonfinite=True)
    t0 = time.perf_counter()
    straight, _ = train_lib.run_loop(fresh(), step, batch_fn,
                                     train_lib.LoopConfig(total_steps=LM_RESUME_STEPS), seed)
    with tempfile.TemporaryDirectory() as ckpt:
        loop = train_lib.LoopConfig(total_steps=LM_RESUME_STEPS, checkpoint_every=0,
                                    checkpoint_dir=ckpt)
        pre = train_lib.Preemption()
        _, hist = train_lib.run_loop(
            fresh(), step, batch_fn, loop, seed, preemption=pre,
            on_step=lambda s, m: s == LM_PREEMPT_AFTER - 1 and pre.trigger())
        check(hist.get("preempted_at") == LM_PREEMPT_AFTER, "LM resume: no preemption")
        resumed, hist = train_lib.run_loop(fresh(), step, batch_fn, loop, seed)
    check(hist["step"] == list(range(LM_PREEMPT_AFTER, LM_RESUME_STEPS)),
          f"LM resume: the resumed run took steps {hist['step']}")
    for what, a, b in (("params", straight.params, resumed.params),
                       ("optimizer state", straight.opt_state, resumed.opt_state)):
        la, lb = tree_util.flatten(a)[0], tree_util.flatten(b)[0]
        check(all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                  for x, y in zip(la, lb)), f"LM resume: {what} differ from the straight run")
    return {"steps": LM_RESUME_STEPS, "preempted_after": LM_PREEMPT_AFTER,
            "bit_equal": True, "wall_s": time.perf_counter() - t0}


def lm_train_path(dev, seed, card):
    """The port's training launcher at full stablelm-3b width: 12 steps with
    asynchronous generator refits, counters reset just before and read just
    after the loop and the held-out eval; then the profiled step, the kernel
    at the step's shape, and the gradient and resume checks at 2 layers."""
    args = launch_train.parser().parse_args(LM_FLAGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, hcfg, state, train_step, batch_fn, gen_fit, loop = launch_train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # segment_stats calls per fit: each fit runs on one thread (the
    # refresher's, or this one for the blocking fit), so a per-thread tally
    # around it counts its calls alone. The first fit's first call and its
    # calls at LM_SEG_NODES nodes are kept with copies of their inputs, and
    # the eval's tree_logprob_all call with its inputs, to be held against
    # the plain versions after the run.
    tally, real_segment_stats, fits = collections.Counter(), ops.segment_stats, []
    real_tree, seg_calls, tree_calls, first_fit = ops.tree_logprob_all, [], [], {}

    def counted_segment_stats(vals, seg, num_segments, *a, **kw):
        me = threading.get_ident()
        tally[me] += 1
        out = real_segment_stats(vals, seg, num_segments, *a, **kw)
        if first_fit.get("thread") == me and "done" not in first_fit:
            if num_segments == LM_SEG_NODES or tally[me] == first_fit["tally"] + 1:
                seg_calls.append((vals.clone(), seg.clone(), num_segments, out.clone()))
        return out

    def recorded_tree(w, b, x):
        out = real_tree(w, b, x)
        tree_calls.append((w.clone(), b.clone(), x.clone(), out))
        return out

    def fit(st):
        me, t_fit = threading.get_ident(), time.perf_counter()
        n0 = tally[me]
        if not first_fit:
            first_fit.update(thread=me, tally=n0)
        head = gen_fit(st)
        torch.cuda.synchronize()
        first_fit.setdefault("done", True)
        fits.append({"fit_of_step": int(st.step), "thread": threading.current_thread().name,
                     "s": time.perf_counter() - t_fit, "segment_stats_calls": tally[me] - n0,
                     "warm": int(st.gen_fit_step) >= 0})
        return head

    names = ("sampled_head_loss", "segment_stats", "tree_logprob_all", "flash_attention",
             "gather_scores")
    for name in names:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    with swapped(ops, segment_stats=counted_segment_stats):
        state, hist = train_lib.run_loop(state, train_step, batch_fn, loop,
                                         launch_train.LOOP_SEED, gen_fit_fn=fit)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        eval_batch = batch_fn(LM_EVAL_BATCH)
        with swapped(ops, tree_logprob_all=recorded_tree):
            ev = train_lib.make_eval_step(cfg, hcfg)(state, eval_batch)
        ev = {k: float(v) for k, v in ev.items()}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(hist["step"] == list(range(LM_STEPS)), f"LM training ran steps {hist['step']}")
    check(launches["sampled_head_loss"] == LM_STEPS,
          f"LM training launched sampled_head_loss {launches['sampled_head_loss']} times "
          f"in {LM_STEPS} steps")
    check(len(fits) == LM_FITS and all(f["segment_stats_calls"] > 0 for f in fits),
          f"LM training: fits {fits} (each must call segment_stats)")
    check(launches["tree_logprob_all"] == 1,
          f"LM eval launched tree_logprob_all {launches['tree_logprob_all']} times, not once")
    check(launches["flash_attention"] == 0,
          f"LM training launched flash_attention {launches['flash_attention']} times")
    check(all(math.isfinite(x) for x in hist["loss"]), f"LM losses {hist['loss']}")
    check(math.isfinite(ev["eval_loglik"]), f"LM eval log-likelihood {ev['eval_loglik']}")
    check(peak_gib <= LM_PEAK_GIB, f"LM training peak {peak_gib:.1f} GiB > {LM_PEAK_GIB}")
    eval_tree = lm_tree_check(tree_calls)
    fit_sums = lm_segment_check(seg_calls, cfg.gen_feature_dim)
    del seg_calls
    steady = sorted(hist["step_times"])
    median_s = steady[len(steady) // 2]
    tokens = LM_BATCH * LM_SEQ

    gen = lambda s: step_generator(launch_train.LOOP_SEED, s, dev)  # noqa: E731
    train_step(state, batch_fn(LM_STEPS), gen(LM_STEPS))            # warm the profiler's step
    state, profile = lm_step_layers(train_step, state, batch_fn(LM_STEPS + 1), gen,
                                    LM_STEPS + 1)
    kernel = lm_kernel_check(dev, state, cfg, hcfg, eval_batch, seed)
    del state, eval_batch
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS)
    _, _, opt = launch_train.build(args)
    grads = lm_grad_check(dev, small, hcfg, batch_fn(0), seed)
    resume = lm_resume_check(dev, small, hcfg, opt, batch_fn, seed)
    result = {
        "card": card, "arch": LM_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "params_b": cfg.param_count() / 1e9, "batch": LM_BATCH, "seq": LM_SEQ,
        "tokens_per_step": tokens, "steps": LM_STEPS, "flags": LM_FLAGS, "setup_s": setup_s,
        "wall_s": wall_s, "loop_s": loop_s, "compile_time_s": hist.get("compile_time_s"),
        "tokens_per_s": LM_STEPS * tokens / loop_s,
        "ms_per_step_median": 1e3 * median_s,
        "ms_per_step_min": 1e3 * steady[0], "ms_per_step_max": 1e3 * steady[-1],
        "step_ms": [1e3 * x for x in hist["step_times"]],
        "tokens_per_s_median_step": tokens / median_s, "loss": hist["loss"], "eval": ev,
        "eval_tree_check": eval_tree, "fit_segment_check": fit_sums,
        "fits": fits, "gen_submit_steps": hist.get("gen_submit_steps"),
        "gen_swap_steps": hist.get("gen_swap_steps"), "peak_mem_gib": peak_gib,
        "launches": launches, "profiled_step": profile, "kernel_at_step_shape": kernel,
        "grads_2_layers": grads, "resume_2_layers": resume}
    print(json.dumps({"lm_train_path": result}))
    return launches


# ---------------------------------------------------------------------------
# Phase 10: head math (proposals, head state, gradient SNR).
# ---------------------------------------------------------------------------

HM_CONTEXTS = 256                # contexts of the synthetic conditional problem
HM_TAU = 2.0                     # p_D = softmax(tau · ctx @ emb^T), benchmarks/bench_snr.py
HM_PAIRS = SEG_POINTS            # (context, label ~ p_D) pairs the proposals are fitted on
HM_HELD_OUT = 1024
HM_CHI_DRAWS = 2 ** 20
HM_RFF_CHUNK = 4096              # RFF draws gather a (draws, C) CDF block: 3.6 GB at 4,096
HM_STATE_STEPS = 100
HM_STATE_START = 1000            # the step a timed head-state run starts at (see below)
HM_STATE_CS = (217_240, BIG_C)
HM_STATE_VARIANTS = (("adagrad/fp32", "adagrad", "fp32", torch.float32),
                     ("adagrad/bf16", "adagrad", "bf16", torch.bfloat16),
                     ("sm3/fp32", "sm3", "fp32", torch.float32),
                     ("sm3/bf16", "sm3", "bf16", torch.bfloat16),
                     ("adamw/fp32", "adamw", "fp32", torch.float32),
                     ("adamw/int8", "adamw", "int8", torch.float32))
HM_PROFILED = ("adagrad/fp32", "adamw/fp32")   # an update profiled at C = 217,240
HM_SNR_SAMPLES = 2 ** 18
HM_SNR_CHUNK = 2 ** 16
STATE_TOL = dict(atol=1e-6, rtol=1e-5)    # tests/test_state_memory.py's sparse == dense


def conditional_problem(dev, gen, c, kdim, kg, n_pairs):
    """benchmarks/bench_snr.py's synthetic conditional problem at full width:
    HM_CONTEXTS contexts ctx (k dims) and label embeddings emb (C, k),
    p_D(.|x) = softmax(tau · ctx @ emb^T), and (context, y ~ p_D) pairs. The
    head sees each context through a fixed random map to K dims."""
    ctx = torch.randn((HM_CONTEXTS, kg), generator=gen, device=dev)
    emb = torch.randn((c, kg), generator=gen, device=dev)
    p_d = torch.softmax(HM_TAU * ctx @ emb.T, dim=-1)                  # (X, C), 222 MB
    feat = ctx @ (torch.randn((kg, kdim), generator=gen, device=dev) / kg ** 0.5)

    def pairs(n):
        y = torch.multinomial(p_d, n // HM_CONTEXTS, replacement=True, generator=gen)
        xs = torch.arange(HM_CONTEXTS, device=dev).repeat_interleave(n // HM_CONTEXTS)
        perm = torch.randperm(n, generator=gen, device=dev)
        xs, y = xs[perm], y.reshape(-1)[perm]
        return feat[xs], ctx[xs], y

    return ctx, p_d, pairs(n_pairs), pairs(HM_HELD_OUT)


def chi_square(sampler, x1, c, gen, chunk):
    """Chi-square of HM_CHI_DRAWS draws for one query against
    exp(log_prob_all), as tests/test_samplers.py does, with the bins that
    expect fewer than 5 draws pooled into one. Returns (chi2, degrees of
    freedom, draws in zero-probability bins)."""
    p = torch.exp(sampler.log_prob_all(x1)[0].double())
    p = p / p.sum()
    counts = torch.zeros(c, dtype=torch.float64, device=x1.device)
    for _ in range(HM_CHI_DRAWS // chunk):
        ids, _ = sampler.sample(gen, x1, (1, chunk))
        counts += torch.bincount(ids.reshape(-1), minlength=c).double()
    exp = HM_CHI_DRAWS * p
    keep = exp >= 5.0
    obs_b = torch.cat([counts[keep], counts[~keep].sum()[None]])
    exp_b = torch.cat([exp[keep], exp[~keep].sum()[None]])
    if float(exp_b[-1]) < 5.0:
        obs_b, exp_b = obs_b[:-1], exp_b[:-1]
    chi2 = float(((obs_b - exp_b) ** 2 / exp_b).sum())
    return chi2, exp_b.numel() - 1, int(counts[exp < 1e-6].sum())


def proposals_section(dev, seed, cfg, card, reg):
    """Fit the tree, LSH (8 bits) and RFF (D = 64) proposals on the
    conditional problem at full width; check each on 256 queries; train 300
    steps with each; predictive log-likelihood above uniform's."""
    c, kdim, kg = cfg.num_labels, cfg.feature_dim, cfg.gen_feature_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    ctx, p_d, (x, xg, y), (x_te, xg_te, y_te) = conditional_problem(dev, gen, c, kdim, kg,
                                                                    HM_PAIRS)
    fit_s = {}
    t0 = time.perf_counter()
    # fit_sampler("tree") is the per-node fit, sequential in C: at full width
    # the level-parallel fit's tree is wrapped instead.
    tree = genfit.fit_tree_levelwise(xg.cpu().numpy(), y.cpu().numpy(), c,
                                     config=tree_fit.FitConfig(reg=cfg.gen_reg, seed=seed),
                                     device=dev)
    torch.cuda.synchronize()
    fit_s["tree"] = time.perf_counter() - t0
    props = {"tree": samplers.TreeSampler(tree)}
    for kind, kw in (("lsh", dict(n_bits=8)), ("rff", dict(n_features=64))):
        t0 = time.perf_counter()
        props[kind] = samplers.fit_sampler(kind, xg, y, c, seed=seed, device=dev, **kw)
        torch.cuda.synchronize()
        fit_s[kind] = time.perf_counter() - t0
    q = xg_te[:256]
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns", n_neg=cfg.n_neg,
                            reg=cfg.head_reg)
    out = {}
    for kind, s in props.items():
        with obs.span(f"head_math/proposals/{kind}", reg):
            lse = float(torch.logsumexp(s.log_prob_all(q), dim=-1).abs().max())
            ids, lp = s.sample(gen, q, (256, 4))
            lp_err = float((lp - s.log_prob(q, ids)).abs().max())
            chi2, dof, in_zero = chi_square(s, q[:1], c, gen,
                                            HM_RFF_CHUNK if kind == "rff" else HM_CHI_DRAWS)
            check(lse <= 1e-4, f"{kind}: log_prob_all rows do not sum to 1 ({lse})")
            check(lp_err <= 1e-5, f"{kind}: sample's log_pn differs from log_prob by {lp_err}")
            check(in_zero == 0, f"{kind}: {in_zero} draws in zero-probability bins")
            check(chi2 < dof + 5.0 * math.sqrt(2.0 * dof),
                  f"{kind}: chi-square {chi2} over {dof} degrees of freedom")
            before = ops.sampled_head_loss.launches
            ms, params = ms_per_train_step(hcfg, heads.Generator(), (x, xg, y),
                                           cfg.learning_rate, TRAIN_STEPS, seed, sampler=s)
            launched = ops.sampled_head_loss.launches - before
            check(launched == TRAIN_STEPS,
                  f"{kind}: {launched} sampled_head_loss launches in {TRAIN_STEPS} steps")
            ll = float(heads.predictive_log_likelihood(hcfg, params, heads.Generator(),
                                                       x_te, xg_te, y_te, sampler=s))
            check(math.isfinite(ll) and ll > -math.log(c),
                  f"{kind}: predictive log-likelihood {ll} not above uniform's {-math.log(c)}")
        out[kind] = {"fit_s": fit_s[kind], "max_abs_logsumexp": lse,
                     "max_log_pn_err": lp_err, "chi2": chi2, "chi2_dof": dof,
                     "train_ms_per_step": ms, "sampled_head_loss_launches": launched,
                     "predictive_ll": ll}
        del params
    print(json.dumps({"head_math_proposals": {
        "card": card, "num_labels": c, "contexts": HM_CONTEXTS, "tau": HM_TAU,
        "pairs": HM_PAIRS, "held_out": HM_HELD_OUT, "chi2_draws": HM_CHI_DRAWS,
        "distinct_labels": int(torch.unique(y).numel()), "uniform_ll": -math.log(c),
        "proposals": out}}))
    return ctx, p_d, y, props


def state_inputs(dev, seed, c, kdim, kg):
    """benchmarks/bench_heads.py's step inputs: one batch of 256 (features,
    generator features, labels), negatives from a random tree."""
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    batch = (torch.randn((BATCH, kdim), generator=gen, device=dev),
             torch.randn((BATCH, kg), generator=gen, device=dev),
             torch.randint(0, c, (BATCH,), generator=gen, device=dev))
    hgen = heads.make_tree_generator(tree_lib.init_tree(gen, c, kg, scale=0.1, device=dev))
    return batch, hgen


def state_update(ocfg, params, rows, state, reg):
    """optim.apply_updates in an obs span (a profiler range)."""
    with obs.span("head_math/apply_updates", reg):
        return optim.apply_updates(ocfg, params, rows, state)


def state_step(hcfg, ocfg, params, state, hgen, batch, g, reg):
    """The sparse step of benchmarks/bench_heads.py in the port:
    heads.sparse_head_loss, then optim.apply_updates."""
    _, _, rows, _ = heads.sparse_head_loss(hcfg, params, hgen, *batch, g)
    return state_update(ocfg, params, rows, state, reg)


def time_state_variant(dev, seed, cfg, c, variant, reg, batch, hgen):
    """ms per step of one head-state variant over HM_STATE_STEPS steps (each
    in an obs span, its time in the registry's histogram), its state bytes,
    the growth of the allocated bytes and of their peak; at C = 217,240 one
    update of the HM_PROFILED variants under the profiler."""
    label, name, sd, dtype = variant
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns", n_neg=cfg.n_neg,
                            reg=cfg.head_reg)
    ocfg = optim.OptimizerConfig(name=name, learning_rate=cfg.learning_rate, state_dtype=sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = heads.HeadParams(torch.zeros((c, cfg.feature_dim), dtype=dtype, device=dev),
                              torch.zeros((c,), dtype=dtype, device=dev))
    # A run that has gone on for a while: with 512 touched rows a step at
    # C = 217,240 a row waits ~424 steps between touches, so AdamW's
    # catch-up replays its whole horizon (197 steps) nearly every step.
    state = optim.init_opt_state(ocfg, params)._replace(step=HM_STATE_START)
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    for _ in range(5):
        params, state, _ = state_step(hcfg, ocfg, params, state, hgen, batch, g, reg)
    torch.cuda.synchronize()
    hist = f"head_math/state/{label}/c{c}/step_s"
    t0 = time.perf_counter()
    for _ in range(HM_STATE_STEPS):
        with obs.span(hist, reg):
            params, state, _ = state_step(hcfg, ocfg, params, state, hgen, batch, g, reg)
            torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / HM_STATE_STEPS
    resident = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    # After the peak is read: isfinite makes (C, K) temporaries of its own.
    check(bool(torch.isfinite(params.w).all()), f"{label} C={c}: params not finite")
    h = reg.histogram(hist)
    row = {"variant": label, "num_labels": c, "ms_per_step": ms,
           "p50_ms": 1e3 * h.quantile(0.5), "p95_ms": 1e3 * h.quantile(0.95),
           "state_bytes": optim.head_state_bytes(params, state),
           "resident_growth_gib": resident / 2 ** 30, "peak_growth_gib": peak / 2 ** 30}
    if c == HM_STATE_CS[0] and label in HM_PROFILED:
        _, _, rows, _ = heads.sparse_head_loss(hcfg, params, hgen, *batch, g)
        gap = (None if state.last is None else
               int((state.step - state.last.w.index_select(0, rows.ids)).max()))
        torch.cuda.synchronize()
        by_name, n_kernels, host_ms, inside, _ = profile_by_kernel(
            lambda: state_update(ocfg, params, rows, state, reg),
            ranges=("head_math/apply_updates",))
        row["profiled_update"] = {
            "host_ms": host_ms, "kernels": n_kernels, "device_ms": sum(by_name.values()),
            "device_ms_in_span": sum(inside["head_math/apply_updates"].values()),
            "largest_gap_of_touched_rows": gap}
    return row


def check_sm3_sparse_dense(dev, seed, cfg, batch, hgen):
    """SM3 at C = 217,240: 5 steps of the same gradients as SparseRows and
    in dense form agree at the reference test's tolerance (params and both
    covers); rows no step touched are bit for bit unchanged."""
    c, kdim = cfg.num_labels, cfg.feature_dim
    hcfg = heads.HeadConfig(num_labels=c, kind="adversarial_ns", n_neg=cfg.n_neg,
                            reg=cfg.head_reg)
    ocfg = optim.OptimizerConfig(name="sm3", learning_rate=0.1, clip_norm=1.0)
    gen = torch.Generator(device=dev).manual_seed(seed + 32)
    p0 = heads.HeadParams(0.05 * torch.randn((c, kdim), generator=gen, device=dev),
                          torch.zeros((c,), device=dev))
    ps = heads.HeadParams(p0.w.clone(), p0.b.clone())
    pd = heads.HeadParams(p0.w.clone(), p0.b.clone())
    ss, sd = optim.init_opt_state(ocfg, ps), optim.init_opt_state(ocfg, pd)
    touched = torch.zeros(c, dtype=torch.bool, device=dev)
    for _ in range(5):
        _, _, rows, _ = heads.sparse_head_loss(hcfg, ps, hgen, *batch, gen)
        touched[rows.ids] = True
        pd, sd, _ = optim.apply_updates(ocfg, pd, heads.HeadParams(
            *sparse_lib.to_dense(rows, tuple(pd.w.shape))), sd)
        ps, ss, _ = optim.apply_updates(ocfg, ps, rows, ss)
    for a, b_, what in ((ps.w, pd.w, "w"), (ps.b, pd.b, "b"),
                        (ss.nu.w.row, sd.nu.w.row, "row cover"),
                        (ss.nu.w.col, sd.nu.w.col, "column cover")):
        check(close(a, b_, STATE_TOL), f"sm3: sparse and dense {what} differ")
    check(torch.equal(ps.w[~touched], p0.w[~touched]), "sm3: an untouched row moved")
    return {"steps": 5, "rows_touched": int(touched.sum()),
            "max_abs_w_diff": float((ps.w - pd.w).abs().max())}


def check_adamw_sparse_dense(dev, seed, cfg):
    """Lazy AdamW at C = 217,240: random touches of 4,096 rows for 9 steps,
    a jump of 250 steps (past the 197-step horizon), then every row touched;
    sparse and dense agree at the reference test's tolerance."""
    c, kdim = cfg.num_labels, cfg.feature_dim
    ocfg = optim.OptimizerConfig(name="adamw", learning_rate=0.01, weight_decay=0.1)
    gen = torch.Generator(device=dev).manual_seed(seed + 33)
    p0 = heads.HeadParams(torch.randn((c, kdim), generator=gen, device=dev),
                          torch.randn((c,), generator=gen, device=dev))
    ps = heads.HeadParams(p0.w.clone(), p0.b.clone())
    pd = heads.HeadParams(p0.w.clone(), p0.b.clone())
    ss, sd = optim.init_opt_state(ocfg, ps), optim.init_opt_state(ocfg, pd)
    for step in range(10):
        if step == 9:
            ss, sd = ss._replace(step=ss.step + 250), sd._replace(step=sd.step + 250)
            ids = torch.arange(c, device=dev)
        else:
            ids = torch.randperm(c, generator=gen, device=dev)[:4096].sort().values
        rows = sparse_lib.SparseRows(
            ids, torch.randn((ids.numel(), kdim), generator=gen, device=dev),
            torch.randn((ids.numel(),), generator=gen, device=dev))
        pd, sd, _ = optim.apply_updates(ocfg, pd, heads.HeadParams(
            *sparse_lib.to_dense(rows, (c, kdim))), sd)
        ps, ss, _ = optim.apply_updates(ocfg, ps, rows, ss)
    err = max(float((ps.w - pd.w).abs().max()), float((ps.b - pd.b).abs().max()))
    check(close(ps.w, pd.w, STATE_TOL) and close(ps.b, pd.b, STATE_TOL),
          f"adamw: lazy sparse and dense differ by {err}")
    return {"steps": 10, "gap_jump": 250, "max_abs_diff": err}


def head_state_section(dev, seed, cfg, card, reg):
    """The head-state variants at C = 217,240 and 2,097,152 (ms per step,
    state bytes, peak growth), their bytes at C = 16,777,216 on meta
    tensors, and the sparse == dense checks."""
    kdim, kg = cfg.feature_dim, cfg.gen_feature_dim
    rows = []
    for c in HM_STATE_CS:
        batch, hgen = state_inputs(dev, seed, c, kdim, kg)
        for variant in HM_STATE_VARIANTS:
            with obs.span(f"head_math/state/{variant[0]}/c{c}", reg):
                row = time_state_variant(dev, seed, cfg, c, variant, reg, batch, hgen)
            rows.append(row)
            print(json.dumps({"head_math_state_row": dict(row, card=card)}))
            torch.cuda.empty_cache()
    meta_bytes = {}
    for label, name, sd, dtype in HM_STATE_VARIANTS:
        p = heads.HeadParams(torch.empty((16_777_216, kdim), dtype=dtype, device="meta"),
                             torch.empty((16_777_216,), dtype=dtype, device="meta"))
        meta_bytes[label] = optim.head_state_bytes(
            p, optim.init_opt_state(optim.OptimizerConfig(name=name, state_dtype=sd), p))
    batch, hgen = state_inputs(dev, seed, cfg.num_labels, kdim, kg)
    with obs.span("head_math/state/checks", reg):
        sm3 = check_sm3_sparse_dense(dev, seed, cfg, batch, hgen)
        adamw = check_adamw_sparse_dense(dev, seed, cfg)
    torch.cuda.empty_cache()
    print(json.dumps({"head_math_state": {
        "card": card, "steps": HM_STATE_STEPS, "start_step": HM_STATE_START, "batch": BATCH,
        "K": kdim, "ms_per_step": {f"{r['variant']}/c{r['num_labels']}": r["ms_per_step"]
                                   for r in rows},
        "state_bytes_c16777216": meta_bytes, "sm3_sparse_vs_dense": sm3,
        "adamw_sparse_vs_dense": adamw}}))


def snr_section(dev, seed, card, reg, ctx, p_d, y, props):
    """Closed-form eta and signal mass of each proposal on the conditional
    problem (Theorem 2: p_n = p_D maximizes both, and the mass is at most
    1/2); the streamed estimator for the tree timed at 2^18 samples; the
    estimator against the closed form at tests/test_snr.py's size."""
    c = p_d.shape[1]

    def table(s):
        p = torch.exp(s.log_prob_all(ctx).double())
        return (p / p.sum(dim=-1, keepdim=True)).float()

    tables = {"uniform": torch.full_like(p_d, 1.0 / c),
              "unigram": table(samplers.fit_sampler("unigram", None, y, c, device=dev))}
    tables.update({kind: table(s) for kind, s in props.items()})
    tables["p_D"] = p_d
    out = {}
    with obs.span("head_math/snr/closed_form", reg):
        for kind, p_n in tables.items():
            out[kind] = {"eta": float(snr.snr_closed_form(p_d, p_n)),
                         "signal_mass": float(snr.alpha(p_d, p_n).sum(-1).mean())}
    best = out["p_D"]
    check(abs(best["signal_mass"] - 0.5) <= 1e-4, f"snr: mass at p_D is {best['signal_mass']}")
    for kind, r in out.items():
        check(r["signal_mass"] <= 0.5 + 1e-5, f"snr: {kind}'s signal mass is above 1/2")
        check(r["signal_mass"] <= best["signal_mass"] + 1e-5
              and r["eta"] <= best["eta"] * (1 + 1e-6), f"snr: {kind} beats p_D (Theorem 2)")
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.span("head_math/snr/empirical_tree", reg):
        eta_emp = float(snr.snr_empirical(p_d, tables["tree"], g, n_samples=HM_SNR_SAMPLES,
                                          chunk=HM_SNR_CHUNK))
    emp_s = time.perf_counter() - t0
    check(math.isfinite(eta_emp) and eta_emp > 0, "snr: empirical eta is not positive")
    rng = np.random.default_rng(0)

    def dist(temp):
        p = np.exp(rng.standard_normal((4, 12)) * temp)
        return torch.as_tensor(p / p.sum(-1, keepdims=True), dtype=torch.float32, device=dev)

    small_d, small_n = dist(1.2), dist(0.8)
    small_cf = float(snr.snr_closed_form(small_d, small_n))
    small_mc = float(snr.snr_empirical(small_d, small_n, g, n_samples=400_000))
    check(abs(small_mc - small_cf) <= 0.05 * small_cf,
          f"snr: empirical {small_mc} against closed form {small_cf} at (4, 12)")
    print(json.dumps({"head_math_snr": {
        "card": card, "contexts": HM_CONTEXTS, "num_labels": c, "tau": HM_TAU,
        "proposals": out, "tree_empirical": {"samples": HM_SNR_SAMPLES, "chunk": HM_SNR_CHUNK,
                                             "eta": eta_emp, "seconds": emp_s},
        "small_check": {"closed_form": small_cf, "empirical": small_mc, "rtol": 0.05}}}))


def head_math_path(dev, seed, cfg, card):
    """Phase 10: proposals, head state and gradient SNR at full xc_linear
    width; sampled_head_loss's and tree_logprob_all's launches counted from
    just before to just after."""
    reg = obs.Registry(annotate=True)
    ops.sampled_head_loss.launches = 0
    ops.tree_logprob_all.launches = 0
    t0 = time.perf_counter()
    with obs.span("head_math/proposals", reg):
        ctx, p_d, y, props = proposals_section(dev, seed, cfg, card, reg)
    with obs.span("head_math/state", reg):
        head_state_section(dev, seed, cfg, card, reg)
    with obs.span("head_math/snr", reg):
        snr_section(dev, seed, card, reg, ctx, p_d, y, props)
    torch.cuda.synchronize()
    launches = {"sampled_head_loss": ops.sampled_head_loss.launches,
                "tree_logprob_all": ops.tree_logprob_all.launches}
    for name, n in launches.items():
        check(n > 0, f"the head-math path never launched {name}")
    print(json.dumps({"head_math": {
        "card": card, "wall_s": time.perf_counter() - t0, "launches": launches,
        "phase_s": {name: reg.histogram(name).total for name in
                    ("head_math/proposals", "head_math/state", "head_math/snr")},
        "apply_updates_calls": reg.histogram("head_math/apply_updates").count}}))
    return launches


# Phase 12: the backbone families at full width. Each model is built by the
# serving launcher's own build (serve.build: bf16, a layer at a time), and
# deleted, with the allocator's cache emptied, before the next.
FAM_SLOTS, FAM_PAGE_LEN, FAM_GEN, FAM_BEAM = 8, 256, 32, 64
# The engine's traffic: three bursts, each run to its end before the next
# (16 requests). The gate is the lock-step decode of each request alone at
# the engine's shapes: its prompt replicated over the rows of the engine's
# prefill call and over the 8 decode lanes, since cuBLAS picks its kernels
# by shape and only equal shapes give equal bits. The decode kernel's split
# count follows the longest lane (flash_attention.decode_splits), so each
# burst keeps lanes of one split count: prompts of 1, 2 and 300 stay under
# 512 keys, the 1,000s and the 4,096s run alone.
FAM_BURSTS = ((1, 2, 300, 1, 2, 300, 2, 1), (1000,) * 4, (4096,) * 4)
FAM_SSD_S = 4096
FAM_SSD_TOL = 1e-4               # relative RMS, chunked against sequential, float32
FAM_MOE_TOL = 2.0 ** -6          # relative RMS, bf16 dispatch against the float32 oracle
MOE_BATCH, MOE_PROMPT = 4, 2048
VL_BATCH, VL_TEXT, VL_GRID = 2, 1024, 32           # 32 x 32 = 1,024 vision embeddings
# The distinct-stream prefill against the plain forward: over the first 4
# layers, within SERVE_REL_RMS_TOL and 4 times closer to it than plain RoPE is.
VL_PLAIN_LAYERS, VL_PLAIN_MARGIN = 4, 4.0
MIXTRAL_LAYERS, MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_GEN = 8, 2, 4096, 16


def family_model(dev, seed, arch, num_layers=None) -> tuple:
    """(cfg, params, head state, head config, build line) of ``arch`` at full
    width (``num_layers`` cuts the depth), built by the serving launcher's
    ``serve.build``: bf16 matrices, a layer at a time."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, state, hcfg = serve.build(arch, reduced=False, head="adversarial_ns",
                                           seed=seed + 23, device=dev, num_layers=num_layers)
    torch.cuda.synchronize()
    leaves = tree_util.flatten(params)[0]
    build = dict(build_s=time.perf_counter() - t0,
                 params=sum(t.numel() for t in leaves),
                 params_gib=sum(t.numel() * t.element_size() for t in leaves) / 2 ** 30,
                 build_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return cfg, params, state, hcfg, build


def step_profile(fn) -> dict:
    """Host ms, device ms, idle share and kernels of one call of ``fn``."""
    by_name, n_kernels, host_ms, _, _ = profile_by_kernel(fn)
    device_ms = sum(by_name.values())
    return dict(host_ms=host_ms, device_ms=device_ms, idle_share=1.0 - device_ms / host_ms,
                kernels=n_kernels, top_ms=[[k[:60], v] for k, v in
                                           sorted(by_name.items(), key=lambda kv: -kv[1])[:6]])


def lockstep_alone(cfg, hcfg, params, state, prompt, prefill_rows, rows, gen_len,
                   beam) -> dict:
    """The lock-step decode of one request alone, at the engine's shapes:
    the prompt replicated over ``prefill_rows`` for the prefill (bf16
    cache, as the engine's) and its cache row over ``rows`` for the decode
    steps, half of them following dense Eq. 5 and half beam ``beam``: each
    row's bits depend on the batch's shapes only, so one forward a step
    serves both paths. Returns each path's ``gen_len`` tokens."""
    dev = params["embed"].device
    pl = prompt.size
    prompts = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None].repeat(prefill_rows, 1)
    cache = transformer.init_cache(cfg, prefill_rows, pl + gen_len, dtype=torch.bfloat16,
                                   device=dev)
    head, half = heads.HeadParams(**params["head"]), rows // 2
    dense_rows = torch.arange(rows, device=dev) < half
    with torch.inference_mode():
        make_prefill(cfg)(params, prompts, cache)
        cache = {k: v[:, :1].repeat(1, rows, *([1] * (v.ndim - 2))) for k, v in cache.items()}
        token, out = prompts[:1, -1:].repeat(rows, 1), []
        for t in range(gen_len):
            h, cache, _ = transformer.forward(params, cfg, token, cache=cache, cache_pos=pl + t)
            x = h[:, -1]
            dense = lm_head.lm_predictive_scores(cfg, hcfg, head, state, x).argmax(dim=-1)
            _, labels = lm_head.lm_predictive_topk(cfg, hcfg, head, state, x, topk=1, beam=beam)
            token = torch.where(dense_rows, dense, labels[..., 0])[:, None]
            out.append(token[[0, half], 0])
    toks = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    return {"dense": toks[0], "beam": toks[1]}


def family_engine(name, dev, seed, card, model) -> tuple:
    """The engine over FAM_BURSTS, dense and beam 64, bf16 paged cache (pages
    of 256; pure SSM pins one page a lane), 8 lanes; counters reset just
    before and read just after each path; one decode step of the last burst
    profiled; then each request's tokens on both paths against
    ``lockstep_alone``. Returns the launches and the paths' lines."""
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg, params, state, hcfg, _ = model
    gen = np.random.default_rng(seed + 29)
    bursts = [[gen.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
              for lengths in FAM_BURSTS]
    total, paths, handles_of, rows_of = collections.Counter(), {}, {}, {}
    has_attn = cfg.block in ("attn", "hybrid")
    for path, beam in (("dense", 0), ("beam", FAM_BEAM)):
        eng = Engine(cfg, hcfg, params, state, ServeConfig(
            n_slots=FAM_SLOTS, max_len=max(FAM_BURSTS[-1]) + FAM_GEN, page_len=FAM_PAGE_LEN,
            beam=beam, cache_dtype=torch.bfloat16))
        prefill = eng._prefill

        def rec_prefill(p, tokens, lengths, lanes, arena, ptab, prefill=prefill, path=path):
            for r in np.nonzero(lengths)[0]:
                rows_of[path, tokens[r, :lengths[r]].tobytes()] = tokens.shape[0]
            return prefill(p, tokens, lengths, lanes, arena, ptab)

        eng._prefill = rec_prefill
        torch.cuda.reset_peak_memory_stats()
        reset_engine_counters()
        t0 = time.perf_counter()
        handles, profile = [], None
        for i, burst in enumerate(bursts):
            handles += [eng.submit(Request(prompt=p, max_new_tokens=FAM_GEN)) for p in burst]
            if i == len(bursts) - 1:
                eng.step()                      # admission, prefill, first token
                eng.step()
                profile = step_profile(eng.step)
            eng.run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        counts = engine_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del eng._prefill
        pool = eng.pool
        pool.check_invariants()
        check(pool.num_free_lanes == pool.n_lanes and eng.num_active == 0,
              f"{name} {path}: leaked lanes")
        check(all(h.done and h.status == "ok" for h in handles), f"{name} {path}: a request failed")
        check(counts["tree_logprob_all" if beam == 0 else "gather_scores"] == eng.decode_steps,
              f"{name} {path}: the Eq. 5 kernel did not launch once a decode step: {counts}")
        fa = counts["flash_attention_by_kernel"]
        if has_attn:
            check(fa["tensor_cores"] > 0 and fa["decode"] > 0 and fa["fma"] == 0
                  and fa["paged"] > 0,
                  f"{name} {path}: flash_attention not on the tensor-core kernel for prefill "
                  f"and the decode kernel for decode: {fa}")
        else:
            check(counts["flash_attention"] == 0, f"{name} {path}: attention in an SSM")
        for k in ENGINE_KERNELS:
            total[k] += counts[k]
        spans = {n: eng.registry.histogram(n).total for n in ENGINE_SPANS}
        decode_s = sum(v for n, v in spans.items() if n != "serve/phase/prefill")
        tokens = sum(len(h.tokens) for h in handles)
        paths[path] = dict(
            requests=len(handles), tokens=tokens, wall_ms=wall_ms,
            prefill_ms=1e3 * spans["serve/phase/prefill"], prefill_calls=eng.prefill_calls,
            decode_steps=eng.decode_steps, decode_ms_per_step=1e3 * decode_s / eng.decode_steps,
            tokens_per_s=1e3 * tokens / wall_ms, decode_step_profile=profile, peak_gib=peak,
            launches=counts)
        handles_of[path] = handles
        print(json.dumps({"family_path": dict(model=name, path=path, card=card,
                                              **paths[path])}))
    # The gate: every request against its lock-step decode alone, both paths.
    t1 = time.perf_counter()
    mismatched = []
    for hd, hb in zip(handles_of["dense"], handles_of["beam"]):
        key = hd.request.prompt.tobytes()
        check(rows_of["dense", key] == rows_of["beam", key],
              f"{name}: the two paths prefilled a prompt at different row counts")
        want = lockstep_alone(cfg, hcfg, params, state, hd.request.prompt,
                              rows_of["dense", key], FAM_SLOTS, FAM_GEN, FAM_BEAM)
        for path, h in (("dense", hd), ("beam", hb)):
            if not np.array_equal(h.result(), want[path]):
                mismatched.append(dict(path=path, prompt_len=int(h.request.prompt.size),
                                       got=h.result().tolist(), want=want[path].tolist()))
    check(not mismatched, f"{name}: tokens differ from the lock-step decode alone: "
                          f"{mismatched[:2]} ({len(mismatched)} of {2 * len(handles)})")
    gate = dict(model=name, requests=len(handles), paths=2, matched=2 * len(handles),
                prefill_rows=sorted({v for (p, _), v in rows_of.items() if p == "dense"}),
                oracle_s=time.perf_counter() - t1)
    print(json.dumps({"family_gate": gate}))
    return total, dict(paths, gate=gate)


def ssd_check(dev, seed, cfg, flush) -> dict:
    """``ssd_chunked`` against ``ssd_sequential`` at S = 4,096 and the
    config's chunk, float32, at its heads and state; the chunked version's
    ``dt`` gradient finite (the decay over a chunk passes 88, where the
    reference's is NaN); the chunked forward timed at the prefill's shape
    (B = 4) beside its bound."""
    from repro_torch.models import ssm as ssm_lib
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(seed + 31)

    def inputs(b):
        x = torch.randn((b, FAM_SSD_S, h, p), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((b, FAM_SSD_S, h), generator=gen, device=dev) - 0.5)
        a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
        bm = torch.randn((b, FAM_SSD_S, n), generator=gen, device=dev) / n ** 0.5
        cm = torch.randn((b, FAM_SSD_S, n), generator=gen, device=dev) / n ** 0.5
        return x, dt, a, bm, cm, torch.ones((h,), device=dev)

    x, dt, a, bm, cm, d = inputs(1)
    dt.requires_grad_()
    y, st = ssm_lib.ssd_chunked(x, dt, a, bm, cm, d, cfg.ssm_chunk)
    (g_dt,) = torch.autograd.grad(y.sum(), dt)
    with torch.no_grad():
        t0 = time.perf_counter()
        y_ref, st_ref = ssm_lib.ssd_sequential(x, dt, a, bm, cm, d)
        torch.cuda.synchronize()
        seq_ms = 1e3 * (time.perf_counter() - t0)
    chunk_decay = float((dt * -a).detach().reshape(1, -1, cfg.ssm_chunk, h).sum(2).max())
    out = dict(rel_rms=rel_rms(y.detach(), y_ref), state_rel_rms=rel_rms(st.detach(), st_ref),
               dt_grad_finite=bool(torch.isfinite(g_dt).all()),
               max_decay_over_a_chunk=chunk_decay, sequential_ms=seq_ms)
    check(out["rel_rms"] <= FAM_SSD_TOL and out["state_rel_rms"] <= FAM_SSD_TOL,
          f"ssd_chunked against ssd_sequential: {out}")
    check(out["dt_grad_finite"], "ssd_chunked: non-finite dt gradient at chunk 256")
    del x, dt, y, st, g_dt, y_ref, st_ref
    args = inputs(MOE_BATCH)
    with torch.no_grad():
        out["chunked_ms_b4"] = time_ms(lambda: ssm_lib.ssd_chunked(*args, cfg.ssm_chunk), flush, 5)
    b, s, q = MOE_BATCH, FAM_SSD_S, cfg.ssm_chunk
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n)
    n_flop = (2 * b * (s // q) * q * q * (n + h * p)          # C·Bᵀ and the masked P·x̄
              + 4 * b * s * n * h * p)                       # chunk states and y_inter
    out["chunked_bound_ms"], out["chunked_bound_by"] = bound_ms(n_bytes, n_flop)
    print(json.dumps({"ssd_check": dict(S=FAM_SSD_S, chunk=q, heads=h, head_dim=p, state=n,
                                        **out)}))
    return out


def moe_check(cfg, moe_params, x, flush) -> dict:
    """On one layer's real prefill input: ``moe_ffn`` at capacity factor 8
    twice (bit-equal, nothing dropped) and against ``moe_ffn_dense_oracle``
    within FAM_MOE_TOL relative RMS; ``moe_ffn`` at the config's capacity
    factor timed beside the oracle and its bound."""
    from repro_torch.models import moe as moe_lib
    cf8 = dataclasses.replace(cfg, capacity_factor=8.0)
    with torch.no_grad():
        y1, m1 = moe_lib.moe_ffn(moe_params, cf8, x)
        y2, m2 = moe_lib.moe_ffn(moe_params, cf8, x)
        err = rel_rms(y1, moe_lib.moe_ffn_dense_oracle(moe_params, cf8, x))
        check(torch.equal(y1, y2) and all(torch.equal(m1[k], m2[k]) for k in m1),
              "moe_ffn: two calls differ")
        check(float(m1["moe_dropped_frac"]) == 0.0, "moe_ffn dropped at capacity factor 8")
        check(err <= FAM_MOE_TOL, f"moe_ffn against the dense oracle: rel RMS {err}")
        del y1, y2
        ms = time_ms(lambda: moe_lib.moe_ffn(moe_params, cfg, x), flush, 5)
        oracle_ms = time_ms(lambda: moe_lib.moe_ffn_dense_oracle(moe_params, cfg, x), flush, 2)
        _, m = moe_lib.moe_ffn(moe_params, cfg, x)
    b, s, d = x.shape
    kept = (1.0 - float(m["moe_dropped_frac"])) * b * s * cfg.top_k
    fs = cfg.d_ff * cfg.n_shared_experts
    n_bytes = (3 * cfg.n_experts * d * cfg.d_ff + 3 * d * fs) * 2 + 4 * d * cfg.n_experts \
        + 2 * b * s * d * 2
    n_flop = 6 * d * cfg.d_ff * kept + 6 * d * fs * b * s + 2 * d * cfg.n_experts * b * s
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / BF16_FLOP_PER_S
    out = dict(rel_rms_vs_oracle=err, tol=FAM_MOE_TOL, bit_equal=True, ms=ms,
               oracle_ms=oracle_ms, bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tokens=b * s, dropped_frac=float(m["moe_dropped_frac"]))
    print(json.dumps({"moe_check": dict(model=cfg.name, **out)}))
    return out


def family_lockstep(name, dev, seed, card, model, batch, prompt_len, gen_len, beams):
    """The lock-step launcher over ``batch`` prompts, dense (and beam 64),
    counters reset just before and read just after each path; the forward's
    MoE metrics and layer 0's MoE input recorded from the prefill; one
    decode step profiled."""
    from repro_torch.models import moe as moe_lib
    cfg, params, state, hcfg, _ = model
    total, paths, moe_in = collections.Counter(), {}, {}
    for beam in beams:
        path = "beam" if beam else "dense"
        args = serve.parse_args(["--lockstep", "--full", "--arch", cfg.name, "--batch",
                                 str(batch), "--prompt-len", str(prompt_len), "--gen",
                                 str(gen_len), "--topk-beam", str(beam), "--seed", str(seed)])
        metrics, forward, ffn = [], transformer.forward, moe_lib.moe_ffn

        def rec_forward(*a, **kw):
            out = forward(*a, **kw)
            metrics.append(out[2])              # read after the run: no sync a step
            return out

        def rec_ffn(p, c, x):
            if "x" not in moe_in and x.shape[1] > 1:
                moe_in["x"] = x.clone()
            return ffn(p, c, x)

        torch.cuda.reset_peak_memory_stats()
        reset_engine_counters()
        with swapped(transformer, forward=rec_forward), swapped(moe_lib, moe_ffn=rec_ffn):
            run = serve.run_lockstep(args, cfg, params, state, hcfg, dev)
        counts = engine_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        fa = counts["flash_attention_by_kernel"]
        check(fa == dict(decode=cfg.num_layers * gen_len, tensor_cores=cfg.num_layers, fma=0,
                         paged=0),
              f"{name} {path}: flash_attention launches {fa}")
        check(counts["tree_logprob_all" if beam == 0 else "gather_scores"] == gen_len,
              f"{name} {path}: the Eq. 5 kernel did not launch once a step: {counts}")
        check(run["tokens"].shape == (batch, gen_len) and bool(
            ((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab_size)).all()),
              f"{name} {path}: tokens")
        for k in ENGINE_KERNELS:
            total[k] += counts[k]
        step = make_serve_step(cfg, hcfg, topk_beam=beam)
        last = prompt_len + gen_len - 1
        profile = step_profile(lambda: step(params, state, run["token"], run["cache"], last))
        line = dict(batch=batch, prompt=prompt_len, gen=gen_len, beam=beam,
                    prefill_ms=run["prefill_ms"], decode_ms_per_token=run["decode_ms"] / run["steps"],
                    prefill_metrics=metrics[0] if metrics else {},
                    decode_metrics_mean={k: float(np.mean([m[k] for m in metrics[1:]]))
                                         for k in (metrics[0] if metrics else {})},
                    decode_step_profile=profile, peak_gib=peak, launches=counts)
        print(json.dumps({"family_path": dict(model=name, path=path, card=card, **line)}))
        paths[path] = line
        del run
    return total, paths, moe_in.get("x")


def vision_path(dev, seed, card, model) -> tuple:
    """qwen2-vl-7b: a lock-step prefill of 2 requests of 1,024 seeded vision
    embeddings and 1,024 text tokens under (3, B, S) M-RoPE positions (the
    temporal stream the index; height and width a 32 x 32 grid over the
    image, the index over the text), then 32 decode tokens with (3, B, 1)
    positions; counters reset just before and read just after. Gates: with
    the three streams set to the index the hiddens equal those of (B, S)
    positions, bit for bit; with distinct streams the first layers' hiddens
    agree with the plain forward's (``VL_PLAIN_LAYERS``)."""
    cfg, params, state, hcfg, _ = model
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    nv = VL_GRID * VL_GRID
    s = nv + VL_TEXT
    vision = (0.02 * torch.randn((VL_BATCH, nv, cfg.d_model), generator=gen, device=dev)
              ).bfloat16()
    tokens = torch.randint(0, cfg.vocab_size, (VL_BATCH, VL_TEXT), generator=gen, device=dev)
    idx = torch.arange(s, device=dev)
    grid = torch.arange(nv, device=dev)
    hh = torch.cat([grid // VL_GRID, idx[nv:]])
    ww = torch.cat([grid % VL_GRID, idx[nv:]])
    positions = torch.stack([idx, hh, ww])[:, None].expand(3, VL_BATCH, s)
    prefill, step = make_prefill(cfg), make_serve_step(cfg, hcfg)
    cache = transformer.init_cache(cfg, VL_BATCH, s + FAM_GEN, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_engine_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h, cache = prefill(params, tokens, cache, vision_embeds=vision, positions=positions)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    token, out = tokens[:, -1:], []
    t0 = time.perf_counter()
    for t in range(FAM_GEN):
        token, cache = step(params, state, token, cache, s + t,
                            positions=np.full((3, VL_BATCH, 1), s + t))
        out.append(token)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0)
    counts = engine_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fa = counts["flash_attention_by_kernel"]
    check(fa == dict(decode=cfg.num_layers * FAM_GEN, tensor_cores=cfg.num_layers, fma=0,
                     paged=0), f"qwen2-vl: flash_attention launches {fa}")
    check(counts["tree_logprob_all"] == FAM_GEN, f"qwen2-vl: Eq. 5 launches {counts}")
    check(bool(torch.isfinite(h).all()) and h.shape == (VL_BATCH, s, cfg.d_model),
          "qwen2-vl: prefill hiddens")
    toks = torch.cat(out, 1)
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "qwen2-vl: tokens")
    last = s + FAM_GEN - 1
    profile = step_profile(lambda: step(params, state, token, cache, last,
                                        positions=np.full((3, VL_BATCH, 1), last)))
    del cache
    same = idx[None].expand(VL_BATCH, s)
    h3, _ = prefill(params, tokens, transformer.init_cache(cfg, VL_BATCH, s, device=dev),
                    vision_embeds=vision, positions=same[None].expand(3, VL_BATCH, s))
    h2, _ = prefill(params, tokens, transformer.init_cache(cfg, VL_BATCH, s, device=dev),
                    vision_embeds=vision, positions=same)
    check(torch.equal(h3, h2), "qwen2-vl: M-RoPE with equal streams differs from RoPE")
    del h3, h2
    # The distinct-stream prefill over the first VL_PLAIN_LAYERS layers against
    # the plain forward on the same inputs; its distance from plain RoPE (the
    # index in every stream) shows that a wrong section split or stream order
    # would be seen.
    cfg_n = dataclasses.replace(cfg, num_layers=VL_PLAIN_LAYERS)
    params_n = {**params, "layers": params["layers"][:VL_PLAIN_LAYERS]}
    with torch.no_grad():
        hk, _ = make_prefill(cfg_n)(params_n, tokens,
                                    transformer.init_cache(cfg_n, VL_BATCH, s, device=dev),
                                    vision_embeds=vision, positions=positions)
        hp = transformer.forward(params_n, cfg_n, tokens, positions=positions,
                                 vision_embeds=vision, attn_impl="plain")[0]
        hr = transformer.forward(params_n, cfg_n, tokens, positions=same,
                                 vision_embeds=vision, attn_impl="plain")[0]
    plain = dict(layers=VL_PLAIN_LAYERS, rel_rms=rel_rms(hk, hp), tol=SERVE_REL_RMS_TOL,
                 rope_rel_rms=rel_rms(hr, hp))
    print(json.dumps({"qwen2_vl_plain": plain}))
    check(plain["rel_rms"] <= SERVE_REL_RMS_TOL
          and plain["rel_rms"] <= plain["rope_rel_rms"] / VL_PLAIN_MARGIN,
          f"qwen2-vl: distinct-stream prefill against the plain forward {plain}")
    line = dict(batch=VL_BATCH, vision=nv, text=VL_TEXT, gen=FAM_GEN, prefill_ms=prefill_ms,
                decode_ms_per_token=decode_ms / FAM_GEN, decode_step_profile=profile,
                peak_gib=peak, launches=counts, equal_streams_bit_equal=True,
                distinct_streams_vs_plain=plain)
    print(json.dumps({"family_path": dict(model=cfg.name, path="dense", card=card, **line)}))
    return collections.Counter({k: counts[k] for k in ENGINE_KERNELS}), line


def backbone_path(dev, seed, card) -> dict:
    """Phase 12: (a) mamba2-370m and (b) hymba-1.5b through the engine, (c)
    deepseek-moe-16b, (d) qwen2-vl-7b and (e) mixtral-8x22b (8 of 56 layers)
    through the lock-step path, at full width; the SSD scan and the MoE
    dispatch checked on the card. Returns the launches by kernel."""
    t_phase = time.perf_counter()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    total, lines = collections.Counter(), {}

    def build(arch, num_layers=None):
        model = family_model(dev, seed, arch, num_layers)
        line = dict(model=arch, card=card, **model[4])
        if num_layers is not None:
            line["reduced"] = {"num_layers": [configs.get_config(arch).num_layers, num_layers]}
        print(json.dumps({"family_model": line}))
        lines[arch] = {"build": line}
        return model

    model = build("mamba2-370m")
    lines["mamba2-370m"]["ssd"] = ssd_check(dev, seed, model[0], flush)
    counts, lines["mamba2-370m"]["paths"] = family_engine("mamba2-370m", dev, seed, card, model)
    total.update(counts)
    del model
    model = build("hymba-1.5b")
    counts, lines["hymba-1.5b"]["paths"] = family_engine("hymba-1.5b", dev, seed, card, model)
    total.update(counts)
    del model
    model = build("deepseek-moe-16b")
    counts, lines["deepseek-moe-16b"]["paths"], x0 = family_lockstep(
        "deepseek-moe-16b", dev, seed, card, model, MOE_BATCH, MOE_PROMPT, FAM_GEN,
        (0, FAM_BEAM))
    total.update(counts)
    check(x0 is not None, "deepseek-moe-16b: no MoE input recorded from the prefill")
    lines["deepseek-moe-16b"]["moe"] = moe_check(model[0], model[1]["layers"][0]["moe"], x0,
                                                 flush)
    del model, x0
    model = build("qwen2-vl-7b")
    counts, lines["qwen2-vl-7b"]["paths"] = vision_path(dev, seed, card, model)
    total.update(counts)
    del model
    model = build("mixtral-8x22b", num_layers=MIXTRAL_LAYERS)
    counts, lines["mixtral-8x22b"]["paths"], x0 = family_lockstep(
        "mixtral-8x22b", dev, seed, card, model, MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_GEN, (0,))
    total.update(counts)
    check(x0 is not None, "mixtral-8x22b: no MoE input recorded from the prefill")
    lines["mixtral-8x22b"]["moe"] = moe_check(model[0], model[1]["layers"][0]["moe"], x0,
                                              flush)
    del model, x0, flush
    torch.cuda.empty_cache()
    print(json.dumps({"backbone_path": dict(card=card, wall_s=time.perf_counter() - t_phase,
                                            launches=dict(total))}))
    return dict(total)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    dev = device_lib.resolve("cuda")
    card = card_line()
    print(card)
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
    for name, n in head_math_path(dev, args.seed, cfg, card).items():
        launches[name] += n
    pipeline_small(dev, args.seed)
    launches.update(segment_stats=genfit_path(dev, args.seed, cfg)["segment_stats"])
    small_fits(dev, args.seed)
    serve_launches, model = serve_path(dev, args.seed)
    launches.update(flash_attention=serve_launches["flash_attention"])
    for name, n in engine_path(dev, args.seed, card, model).items():
        launches[name] += n
    del model
    for name, n in lm_train_path(dev, args.seed, card).items():
        if name in launches:
            launches[name] += n
    for name, n in backbone_path(dev, args.seed, card).items():
        launches[name] += n
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
