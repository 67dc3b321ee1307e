#!/usr/bin/env python3
"""Drives the PyTorch port's prediction, training, head-math, generator-fitting, LM-serving (lock-step and engine), LM-training, backbone-family, process-mesh, sharded-trunk (serving and training, sequence parallelism) and dry-run paths on one NVIDIA card.

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
     prediction path on a small input against the port's CPU run; the two
     kernels past their old fixed widths (``check_wide_kernels``):
     ``sampled_head_loss`` at mixtral-8x22b's and gemma2-27b's LM step (T
     = 8,192, K = 6,144, vocab 32,768; T = 4,096, K = 4,608, vocab
     256,000; m = 2), both table dtypes, timed, and at K = 6,144, m = 17
     (the chunked staging) for all 7 kinds with reg and softcap on;
     ``tree_logprob_all`` at gemma2-27b's serving shape (B = 4, depth 18,
     k = 64), at B = 256, at k = 33 and 48, and on the FMA kernel at depth
     7, k = 64, timed, k = 64 also under 16, 8, 4 and 2 sub-blocks; every
     call twice, bit-equal;
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
     and scaled as the model calls it; a ragged float32 case), and the
     engine's verify step and suffix prefill at h2o-danube width (8 rows of
     8 queries, 2,100 to 2,200 keys a row; 8 rows of 64 queries, 2,112 to
     2,240 keys, two row tiles; pages of 256 out of order), within one bf16
     ulp of each output row and 2^-11 relative RMS, two calls bit-equal,
     each paged call bit-equal to its keys gathered into a contiguous cache,
     the kernel each shape took (the tensor-core kernel for the five bf16
     prefills and the two paged steps, the decode kernel for the five
     decodes, the FMA kernel for float32); kernel, plain and ``scaled_dot_product_attention``
     times (phase 3's kernel checks run before it);
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
     class (its multi-token paged steps on the tensor-core kernel, none on
     the FMA kernel); (d) a float32 cache (its decode on the FMA kernel).
     Fatal: the pool's invariants and no leaked
     lane or page after each run, and the paged kernel against its plain
     version (``check_flash_attention``'s tolerances) on calls recorded
     from the engine — a bf16 decode step from (b), a multi-token step from
     (c), a float32-cache decode step from (d) — each with pages out of
     order, ragged key counts and a free lane on the sink page, bit-equal
     to the same keys gathered into a contiguous cache, timed beside its
     bound, the plain version, the gathered call and the FMA kernel on the
     same call; also (c)'s first cold prefill (padded to 4,096 tokens:
     128 row tiles a (b, kv head)), on the tensor-core kernel, bit-equal to
     its keys gathered contiguous, against the plain version on its first
     row; the lock-step's token
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
     and 2,097,152 (ms per step over 25 steps, cut from 50 and printed as
     ``reduced``, p50/p95 from an ``obs`` histogram, state
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
     bit for bit; (b) gemma2-27b's sampled head at full width (d 4,608,
     vocab 256,000) and 2 of its 46 layers (printed as ``reduced``), batch
     2 x 2,048, 3 steps, ``adversarial_ns`` with the sparse head and
     embedding, float32 parameters, Adagrad: losses finite, one
     ``sampled_head_loss`` and 3 ``segment_stats`` a step, the step's own
     kernel call against the plain version (line ``gemma2_train``);
 12. the backbone's other families at full width (run after phase 11), each
     built from the seed in bf16 layer by layer and deleted before the
     next, counters reset just before and read just after each path, each
     path's prefill ms, decode ms a token or step, one decode step profiled
     (host and device ms, idle share), peak memory and the card's line:
     (a) mamba2-370m (12 of its 48 layers, printed as ``reduced``; d
     1,024, 32 SSD heads of 64, state 128, chunk 256) through the engine,
     8 lanes, 16 requests of 1 to 4,096 prompt tokens in three bursts, 32
     tokens each, dense and beam 64, each request's tokens equal to its
     lock-step decode alone at the engine's shapes; ``ssd_chunked``
     against ``ssd_sequential`` at S = 4,096 (relative RMS <= 1e-4, finite
     ``dt`` gradient); (b) hymba-1.5b (8 of its 32 layers, printed as
     ``reduced``; d 1,600, 25 heads over 5, hd 64, window 1,024, 50 SSD
     heads of state 16) the same, bf16 paged cache, pages of 256 (prefills on the
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
     (e) mixtral-8x22b at full width and 4 of its 56 layers (printed as
     ``reduced``), 2 x 4,096 prompt tokens and 16, dense, and its layer 0
     ``moe_ffn`` (the ``topk_softmax`` router) checked as (c)'s; (f)
     gemma2-27b at full width and depth (46 layers, d 4,608, 32 heads over
     16, hd 128, windows of 4,096 alternating, softcaps 50 and 30, vocab
     256,000, generator features 64), lock-step 4 x 2,048 + 32, dense Eq. 5
     (``tree_logprob_all`` at k = 64 on the tensor-core kernel) and beam
     64, each request's prefill and decode hiddens and dense scores within
     2^-5 relative RMS of the cache-free forward (line ``gemma2_serve``).
     Every model is built by the serving launcher's ``serve.build``;
 13. the vocab-sharded head on a ("data", "model") process mesh over
     ``torch.distributed`` (run after phase 12), every rank on the one card
     over gloo, each world started by ``torchrun``, any rank's failure or a
     wait past the time limit fatal: (a) one world of 4 ranks (this script
     with ``--mesh-worker``) at full ``xc_linear`` width on a (1, 4) mesh,
     ``sharded_candidate_scores`` for 256 queries × 64 candidates against
     the unsharded ``gather_scores`` kernel (bit-equal, else within its
     tolerance) and ``apply_updates(mesh=)`` (``sharded_rows_update``) for
     adagrad, sm3 (bf16) and adamw (int8) over 3 steps against the
     unsharded update, bit-equal; ms a rank and the ``all_reduce``'s share;
     then, in the same world on a (2, 2) mesh, stablelm-3b at full width,
     2 layers, float32, its trunk sharded over ``model`` and over ``data``
     (FSDP, ``init_train_state(mesh=)``): each rank's parameter and
     optimizer-state bytes the one-rank state's bytes over ``model`` ÷ 2,
     over both ÷ 4, plus its whole bytes, exactly (``rank_bytes``); the
     FSDP gathers' and reduce-scatters' calls, bytes and host seconds by
     phase; 3 sharded steps on a global batch of 4 × 256
     against 3 one-rank steps from the same seed (loss within 1e-5
     relative, parameters within 1e-3 relative + 1e-4, the reference's
     bounds), ``sampled_head_loss`` and ``segment_stats`` launches a rank,
     the trunk's gradient sum over ``data`` timed (calls, bytes, seconds,
     share of the steps), each step's sums of the sparse rows over ``data``
     by owner (bytes a rank held, within their bound; ``segment_stats``
     launches counted from them); a checkpoint written under the mesh leaf
     by leaf, every rank's part restored bit-equal and the whole restored by
     one process bit-equal; and, before (c), the sparse rows' sum over
     ``data`` by owner on (2, 2) and (4, 1) at stablelm-3b's table (Zipf
     ids, a rank with none, no ``db``) bit-equal to the gather-everything
     sum it replaced (line ``mesh_rows_sum``);
     (b), the serving launcher on 2 ranks, is phase 14's (a) now that the
     trunk is sharded; (d) the serving launcher as a one-rank NCCL world,
     its tokens equal to this process's; lines ``mesh_collectives``,
     ``mesh_train``, ``mesh_path``; every rank's launches join the
     ``kernels`` line;
 14. the trunk sharded over the mesh's ``model`` axis (run after phase 13),
     every rank on the one card over gloo, each world started by
     ``torchrun``, any rank's failure or a wait past the time limit fatal;
     the one-rank reference values come from this process before each
     world starts, through a temporary file, and are freed: (a)
     h2o-danube-3-4b at full width, 4 of its 24 layers (printed as
     ``reduced``), through the serving launcher (``serve.main`` in this
     script's ``--tp-worker``, the model built at that depth; ``--device
     cuda:0 --model-axis M --time-collectives``) on (1, 2): phase 9's
     lock-step shapes (4 × 4,608 + 32) dense and beam 64 and an engine
     burst of 8 × 4,096 + 32 at beam 64 (the three runs in one world, the
     launcher called once for each), and on (1, 4) the dense lock-step; (b)
     deepseek-moe-16b at full width, 8 of its 28 layers (printed as
     ``reduced``), on (1, 4), 16 of its 64 experts a rank (this script
     with ``--tp-worker``): lock-step 4 × 2,048 + 32, dense; (c) hymba-1.5b at full width, 4 of its 32 layers
     (printed as ``reduced``), on (1, 2), 25
     heads whole on each rank and its 50 SSD heads split, under
     ``sharding_hints``: the engine (8 lanes, pages of 256) on a burst of 8
     requests of 1 to 4,096 prompt tokens, 32 tokens each, dense, and a
     (2, 4,096) prefill with and without the hints. Fatal: every rank's
     tokens equal to every other rank's; each rank's trunk bytes the
     one-rank trunk's split leaves ÷ tp plus its whole leaves, exactly;
     each rank's launches by route (beam: ``gather_scores``, dense:
     ``tree_logprob_all``); for the lock-step paths of (a) and for (b), the
     prefill's last hiddens and 32 decode steps fed the one-rank tokens
     (``--teacher-tokens``), each step's dense Eq. 5 scores, within 2^-5
     relative RMS of the one-rank run; for the engines of (a) and (c),
     each prefilled row's last hidden and each request's hidden at its
     first decode step (``serve.HiddenTap``: the batched prefill, the
     arena split by KV heads or whole, the paged reads) within 2^-5 of the
     one-rank engine's; (b) layer 0's routing (top-k ids and drops)
     bit-equal to one rank's on the same input and its MoE output within
     2^-5, and, since near-tie routings flip between any two orders of
     its bf16 sums, its prefill's last hiddens held in float32 (the same
     model at 4 layers, prefill and scores within 2^-5); (c) the
     hinted prefill within 2^-5 of the unhinted and of one rank's, in bf16
     and in float32, and the same prefill under ``seq_parallel_residual``
     (sequence parallelism) within 2^-5 of the unhinted and of one rank's
     in bf16 and in float32, its trunk collectives' calls and bytes equal
     to the count from the shapes (``sp_hybrid_prefill_trunk``). Printed
     for each path
     (line ``tp_path``): the share of free-running tokens equal to the
     one-rank run's, each rank's ms a token, the trunk collectives' calls,
     bytes and share of the run, peak memory and launches (which join the
     ``kernels`` line); line ``sharded_trunk_path``;
 15. training with the trunk sharded over ``model`` (run after phase 14):
     one world of 4 ranks on the card over gloo (this script with
     ``--tp-train-worker``), any rank's failure or a wait past the time
     limit fatal; the one-rank references come first from this process
     (float32, TF32 off: one step's gradients and the parameters after 3
     SGD steps, written to a temporary directory that each rank reads
     mapped and slices, never gathering through gloo) and are freed. At
     full width, cut in depth (printed as ``reduced``): (a) stablelm-3b, 4
     of 32 layers, on (1, 4); (b) deepseek-moe-16b, 2 of 28 layers, on
     (1, 4), 16 experts a rank; (c) hymba-1.5b, 2 of 32 layers, on (2, 2)
     under ``sharding_hints``, FSDP over ``data``; (d) deepseek-moe-16b, 2
     of 28 layers, on (2, 2), FSDP, and one step's gradients in bf16 (on
     its first layer) without and with ``fsdp_gather_weights``, bit-equal,
     the expert
     leaves' gather bytes exactly half, the same calls; (e) stablelm-3b, 2
     of 32 layers, on (2, 2) with the ``softmax`` head and the dense
     embedding, FSDP; (f) stablelm-3b, 2 of 32 layers, on (1, 4) under
     ``seq_parallel_residual``, its trunk collectives' calls and bytes by
     forward, recompute and backward exact against ``tpt_sp_trunk`` and
     each checkpointed layer's saved input exactly 1/4 of the unhinted
     run's. Fatal: each rank's parameter and Adagrad state bytes
     the one-rank bytes over ``model`` ÷ tp, over ``data`` ÷ dp, over both
     ÷ (dp·tp), plus whole, exactly; on (2, 2) the peak a rank below its
     parameters and their gradients, two gathered layers and one rank's
     activations (its peak less twice its parameters), and one
     reduce-scatter a cut leaf a step; one step's
     gradient of every leaf within 1e-4 relative RMS of one rank's
     (each rank's part against its slice); 3 steps' losses within 1e-5
     relative and the parameters within the reference's bounds; the
     leaves a rank holds whole bit-equal across ranks (a digest);
     (b)'s layer-0 routing bit-equal to one rank's; (c) hinted gradients
     within 1e-4 of the unhinted; ``sampled_head_loss`` once a step a rank,
     ``segment_stats`` 3 a step a rank (the head's and the embedding's row
     sums) and, on (2, 2), the owner's sums over ``data`` (none where an
     owner received no row), none of either for (e)'s dense head, and no
     ``flash_attention``; on (2, 2) the first gradient's sums over ``data``
     by owner bit-equal to the gather-everything sum, and each step's
     within their bound (bytes a rank printed). Printed (line
     ``tp_train``): ms a step a rank, the trunk's ``model`` collectives'
     and FSDP's calls, bytes and host seconds for the forward, the
     recompute and the backward, peak memory a rank and its bound, the
     card; line ``tp_train_path``; every rank's launches join the
     ``kernels`` line;
 16. the dry run (``repro_torch.launch.dryrun``) on this machine's CPU, in
     a process of its own started when phase 13 starts (it needs no card,
     so it runs beside phases 13-15) and read here: (a) phase 11's step (stablelm-3b
     at full width and depth, batch 4 x 2,048, one rank) counted on fake
     tensors against that step as measured in phase 11: each kernel's
     launches exact (``sampled_head_loss`` 1, ``segment_stats`` 3,
     ``flash_attention`` 0), the roofline's step time at or below the
     measured median ms a step, the counted peak (arguments plus the
     step's temporaries) within 20% of ``torch.cuda.max_memory_allocated``
     over one step (line ``dryrun_step``); (b) h2o-danube-3-4b
     ``train_4k`` on the (32, 8) production mesh of 256 fake ranks to
     status ``ok`` and under 20 GB a rank, its roofline terms and bytes a
     rank on line ``dryrun_cell``; (c), after (b) in the same process: gemma2-27b's
     ``train_4k``, ``prefill_32k`` and ``decode_32k`` and mixtral-8x22b's
     ``train_4k`` on (32, 8), and (b)'s cell on (64, 8), each ``ok``, the
     last at no more bytes a rank than on (32, 8);
 17. print the ``kernels`` JSON line and, last, the device line.

Exits non-zero without a CUDA device, and prints no result then.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import ctypes
import dataclasses
import gc
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
from repro_torch.kernels import flash_attention as flash_attention_lib  # noqa: E402
from repro_torch.kernels import gather_scores as gather_scores_lib, tree_logprob  # noqa: E402
from repro_torch.kernels import sampled_loss as sampled_loss_lib  # noqa: E402
from repro_torch.kernels import segment_scores as segment_scores_lib  # noqa: E402
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
# The families whose widths passed the kernels' old fixed limits: each LM
# training step's sampled_head_loss (arch, T, m; K = d_model and C = vocab of
# the arch), the chunked staging at mixtral's K (T, m, K), and
# tree_logprob_all's calls (name, B, depth, k; the FMA kernel at depth 7).
WIDE_LOSS_STEPS = (("mixtral-8x22b", 8192, 2), ("gemma2-27b", 4096, 2))
WIDE_LOSS_CHUNKED = (256, 17, 6144)
WIDE_TREE_SHAPES = (("gemma2_serving", 4, 18, 64), ("gemma2_b256", 256, 18, 64),
                    ("k33", 4, 18, 33), ("k48", 4, 18, 48), ("fma_depth7", 256, 7, 64))
WIDE_TREE_SUB_BLOCKS = (16, 8, 4, 2)   # the tensor-core plan's sub-blocks timed at k = 64
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
# The engine's multi-token paged steps at h2o-danube-3-4b width, as a
# speculative verify step (8 queries a row: 32 packed rows, one row tile)
# and a shared-prefix suffix prefill (64 queries after a template of about
# 2,048 keys: 256 packed rows, two row tiles) call the kernel: (name, B, H,
# KV, Sq, (fewest, most) keys a row, hd, window, page length, dtype). Each
# row's key count is drawn in the range, the arenas' pages are handed out in
# a random order, q is laid out and scaled as the model passes it.
ATTN_PAGED_SHAPES = [
    ("danube_verify_paged", 8, 32, 8, 8, (2100, 2200), 120, 4096, 256, torch.bfloat16),
    ("danube_suffix_paged", 8, 32, 8, 64, (2112, 2240), 120, 4096, 256, torch.bfloat16),
]
ATTN_MAIN = "danube_prefill"     # the shape of the kernels line
# The kernel each shape takes: the tensor-core kernel (bf16, more than 16
# packed rows, hd <= 128; ragged, paged or split alike), the decode kernel
# (bf16, at most 16 packed rows) or the FMA kernel (float32).
ATTN_KERNEL = {"danube_prefill": "tensor_cores", "gemma2_softcap": "tensor_cores",
               "stablelm_prefill": "tensor_cores", "danube_decode": "decode",
               "gemma2_decode": "decode", "stablelm_decode": "decode", "ragged_fp32": "fma",
               "hymba_prefill": "tensor_cores", "hymba_decode": "decode",
               "qwen2vl_prefill": "tensor_cores", "qwen2vl_decode": "decode",
               "danube_verify_paged": "tensor_cores", "danube_suffix_paged": "tensor_cores"}
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
            n_flop, n_bytes = gather_scores_lib.cost(t, n, kdim, w.element_size(), rows)
            bound, by = bound_ms(n_bytes, n_flop)
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
        plan = tree_logprob.launch_plan(bsz, tree.depth, sm_count, kg)
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
        n_flop, n_bytes = tree_logprob.cost(bsz, tree.w.shape[0], kg)
        bound, by = bound_ms(n_bytes, n_flop)
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


def check_wide_kernels(dev, gen, flush, floor):
    """Both kernels past their old fixed width limits, against their plain
    versions: sampled_head_loss at mixtral-8x22b's and gemma2-27b's LM step
    (K = 6,144 and 4,608), both table dtypes, timed, and at K = 6,144, m =
    17 (three float32 chunks, two bf16) for all 7 kinds with reg and
    softcap on; tree_logprob_all at gemma2-27b's serving shape (B = 4,
    depth 18, k = 64), at B = 256, at k = 33 and 48, and on the FMA kernel
    at depth 7, k = 64, timed, the tensor-core kernel also under 16, 8, 4
    and 2 sub-blocks at k = 64. Every call twice, bit-equal."""
    out = {"sampled_head_loss": {}, "tree_logprob_all": {}}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for arch, t, m in WIDE_LOSS_STEPS:
        mcfg = configs.get_config(arch)
        c, kdim = mcfg.vocab_size, mcfg.d_model
        w32 = (0.5 / math.sqrt(kdim)) * torch.randn((c, kdim), generator=gen, device=dev)
        b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
        h, ids, lp = sampled_inputs(dev, gen, c, kdim, t, m)
        rows = torch.unique(ids).numel()
        for dtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(dtype), b32.to(dtype)
            kw = dict(kind="adversarial_ns", num_labels=c, reg=1e-4,
                      softcap=mcfg.final_logit_softcap)
            got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
            again = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
            want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
            torch.cuda.synchronize()
            what = f"sampled_head_loss {arch} {str(dtype)[6:]} T={t} m={m} K={kdim}"
            check(all(torch.equal(g, a) for g, a in zip(got, again)), f"{what}: two calls differ")
            for name, g, wn in zip(("loss", "coeff", "xi"), got, want):
                check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
                check(close(g, wn, LOSS_TOL), f"{what}: {name} disagrees")
            check(dh_close(got[3], want[3], want[1], w, ids), f"{what}: dh disagrees")
            n_flop, n_bytes = sampled_loss_lib.cost(t, m, kdim, w.element_size(), rows)
            bound, by = bound_ms(n_bytes, n_flop)
            ms = time_ms(lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), flush)
            plain = time_ms(lambda: ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw), flush)
            row = dict(t=t, m=m, k=kdim, c=c, distinct_rows=rows,
                       chunk=sampled_loss_lib.staged_slots(m, kdim, w.element_size()),
                       max_abs_err=max(float((g - wn).abs().max())
                                       for g, wn in zip(got[:3], want[:3])),
                       dh_max_abs_err=float((got[3] - want[3]).abs().max()), ms=ms,
                       plain_ms=plain, bound_ms=bound, bound_by=by, launch_floor_ms=floor)
            print(f"{what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), errors {row['max_abs_err']:.3e} / dh {row['dh_max_abs_err']:.3e}")
            out["sampled_head_loss"][f"{arch}/{str(dtype)[6:]}"] = row
            del got, again, want, w, b
        del w32, b32, h, ids, lp
    torch.cuda.empty_cache()
    t, m, kdim = WIDE_LOSS_CHUNKED
    c = configs.get_config("mixtral-8x22b").vocab_size
    w32 = (0.5 / math.sqrt(kdim)) * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    h, ids, lp = sampled_inputs(dev, gen, c, kdim, t, m)
    for dtype in (torch.float32, torch.bfloat16):
        w, b = w32.to(dtype), b32.to(dtype)
        chunk = sampled_loss_lib.staged_slots(m, kdim, w.element_size())
        check(chunk < m, f"sampled_head_loss K={kdim} m={m} {dtype}: not chunked ({chunk})")
        worst = 0.0
        for kind in SAMPLED_KINDS:
            kw = dict(kind=kind, num_labels=c, reg=1e-2, softcap=25.0)
            got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
            again = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
            want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
            torch.cuda.synchronize()
            what = f"sampled_head_loss {kind} {str(dtype)[6:]} T={t} m={m} K={kdim} chunk={chunk}"
            check(all(torch.equal(g, a) for g, a in zip(got, again)), f"{what}: two calls differ")
            for name, g, wn in zip(("loss", "coeff", "xi"), got, want):
                check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
                check(close(g, wn, LOSS_TOL), f"{what}: {name} disagrees")
            check(dh_close(got[3], want[3], want[1], w, ids), f"{what}: dh disagrees")
            worst = max([worst] + [float((g - wn).abs().max()) for g, wn in zip(got[:3], want[:3])])
        out["sampled_head_loss"][f"chunked/{str(dtype)[6:]}"] = dict(
            t=t, m=m, k=kdim, chunk=chunk, kinds=len(SAMPLED_KINDS), max_abs_err=worst)
    del w32, b32, w, b, h, ids, lp
    torch.cuda.empty_cache()
    for shape, bsz, depth, kg in WIDE_TREE_SHAPES:
        tree = tree_lib.init_tree(gen, 1 << depth, kg, scale=0.05, device=dev)
        x = torch.randn((bsz, kg), generator=gen, device=dev)
        plan = tree_logprob.launch_plan(bsz, depth, sm_count, kg)
        before = (ops.tree_logprob_all.tensor_core_launches, ops.tree_logprob_all.fma_launches)
        got = ops.tree_logprob_all(tree.w, tree.b, x)
        again = ops.tree_logprob_all(tree.w, tree.b, x)
        want = ref.tree_logprob_all_ref(tree.w, tree.b, x)
        torch.cuda.synchronize()
        took = (ops.tree_logprob_all.tensor_core_launches - before[0],
                ops.tree_logprob_all.fma_launches - before[1])
        what = f"tree_logprob_all {shape}: B={bsz} depth={depth} k={kg} plan={plan}"
        check(took == ((2, 0) if depth >= tree_logprob.TENSOR_CORE_MIN_DEPTH else (0, 2)),
              f"{what}: launches by kernel {took}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        check(close(got, want, TREE_TOL), f"{what} disagrees")
        check(torch.equal(got, again), f"{what}: two calls differ")
        err = float((got - want).abs().max())
        del again, want
        n_flop, n_bytes = tree_logprob.cost(bsz, tree.w.shape[0], kg)
        bound, by = bound_ms(n_bytes, n_flop)
        ms = time_ms(lambda: ops.tree_logprob_all(tree.w, tree.b, x), flush)
        plain = time_ms(lambda: ref.tree_logprob_all_ref(tree.w, tree.b, x), flush)
        row = dict(b=bsz, depth=depth, k=kg, plan=list(plan), max_abs_err=err, ms=ms,
                   plain_ms=plain, bound_ms=bound, bound_by=by, launch_floor_ms=floor,
                   smem_bytes=(tree_logprob.tc_smem_bytes(depth, kg, plan[2]) if plan[2]
                               else tree_logprob.fma_smem_bytes(depth, kg)))
        if kg == 64 and plan[0] == tree_logprob.TENSOR_CORES:
            variants = {}
            for sub in WIDE_TREE_SUB_BLOCKS:
                var = (tree_logprob.TENSOR_CORES, plan[1], sub)
                buf = torch.empty_like(got)
                tree_logprob._launch(tree.w, tree.b, x, buf, depth, *var)
                torch.cuda.synchronize()
                check(torch.equal(buf, got), f"{what}: {sub} sub-blocks give other bits")
                variants[sub] = dict(
                    smem_bytes=tree_logprob.tc_smem_bytes(depth, kg, sub),
                    ms=time_ms(lambda: tree_logprob._launch(tree.w, tree.b, x, buf, depth,
                                                            *var), flush))
            row["sub_blocks_ms"] = variants
        print(f"{what}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"max_abs_err {err:.3e}" + (f", by sub-blocks {row['sub_blocks_ms']}"
                                          if "sub_blocks_ms" in row else ""))
        out["tree_logprob_all"][shape] = row
        del got, tree, x
    torch.cuda.empty_cache()
    print(json.dumps({"wide_kernels": out}))
    return out


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
            n_flop, n_bytes = sampled_loss_lib.cost(t, m, kdim, w.element_size(), rows)
            bound, by = bound_ms(n_bytes, n_flop)
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
        n_flop, n_bytes = segment_scores_lib.cost(SEG_POINTS, d, s, vals.element_size())
        bound, by = bound_ms(n_bytes, n_flop)
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


def attn_paged_inputs(dev, gen, h, kv, sq, n, hd, page_len, dtype):
    """q laid out and scaled as the model passes it; arenas (P, page_len,
    KV, hd) whose pages go to the rows in a random order, a sink page last;
    and the paged keywords: ``n``, each row's key count, the page tables
    (sink entries past a row's pages), the largest count."""
    b = len(n)
    need = [-(-x // page_len) for x in n]
    n_phys = sum(need) + 1
    order = torch.randperm(n_phys - 1, generator=gen, device=dev).tolist()
    table = np.full((b, max(need)), n_phys - 1, np.int32)
    at = 0
    for r, m in enumerate(need):
        table[r, :m] = order[at:at + m]
        at += m
    q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
    q = (q * torch.tensor(hd ** -0.5).to(dtype).item()).transpose(1, 2)
    k, v = (torch.randn((n_phys, page_len, kv, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, dict(kv_lens=torch.tensor(n, dtype=torch.int32, device=dev),
                         page_table=torch.from_numpy(table).to(dev), max_kv_len=max(n))


def attn_gathered(k, v, kw):
    """A paged call's keys gathered into contiguous (B, KV, max_kv_len, hd)
    caches, and its keywords without the page table: the same call on
    contiguous K/V."""
    kc, vc = (ref.gather_pages(a, kw["page_table"], kw["max_kv_len"]).contiguous()
              for a in (k, v))
    return kc, vc, {n: x for n, x in kw.items() if n != "page_table"}


def attn_calls(dev, gen):
    """Phase 8's calls, one at a time, for every shape of ATTN_SHAPES and
    then ATTN_PAGED_SHAPES: (name, description, q, k, v, keywords, cost's
    shape arguments, cost's keywords). scripts/attn_planted_faults.py drives
    the same calls."""
    for name, b, h, kv, sq, skv, hd, causal, window, softcap, dtype, cache_len in ATTN_SHAPES:
        q, k, v, scale = attn_inputs(dev, gen, b, h, kv, sq, skv, hd, dtype, cache_len)
        layout = f"model layout, cache {cache_len}" if cache_len else "contiguous"
        what = (f"flash_attention {name} (B={b} H={h} KV={kv} Sq={sq} Skv={skv} hd={hd} "
                f"causal={causal} window={window} softcap={softcap} {str(dtype)[6:]}, "
                f"{layout}")
        yield (name, what, q, k, v,
               dict(causal=causal, window=window, softcap=softcap, scale=scale),
               (b, h, kv, sq, skv, hd, causal, window), {})
    for name, b, h, kv, sq, lens, hd, window, page_len, dtype in ATTN_PAGED_SHAPES:
        n = torch.randint(lens[0], lens[1] + 1, (b,), generator=gen, device=dev).tolist()
        q, k, v, paged = attn_paged_inputs(dev, gen, h, kv, sq, n, hd, page_len, dtype)
        what = (f"flash_attention {name} (B={b} H={h} KV={kv} Sq={sq} keys {n} hd={hd} "
                f"causal=True window={window} {str(dtype)[6:]}, pages of {page_len} "
                f"out of order")
        yield (name, what, q, k, v,
               dict(causal=True, window=window, softcap=0.0, scale=1.0, **paged),
               (b, h, kv, sq, max(n), hd, True, window),
               dict(kv_lens=n, index_bytes=4 * (b + paged["page_table"].numel())))


def check_flash_attention(dev, gen, flush):
    """The kernel against its plain version on every shape of
    ``attn_calls``, two calls bit-equal, a paged call bit-equal to the same
    keys gathered into a contiguous cache; kernel, plain and library
    (scaled_dot_product_attention with a boolean band mask, GQA; not where
    there is a softcap or a page table) times. Bound: q, k, v of the keys
    some query of a row sees and the output moved once (the key counts and
    page tables too), against 4*hd operations per (query, key) pair in the
    band at the peak of the inputs' type (bf16 tensor cores, float32 outside
    them)."""
    import torch.nn.functional as F
    rows = {}
    for name, what, q, k, v, kw, shape, cost_kw in attn_calls(dev, gen):
        dtype = q.dtype
        before = attn_launches_by_kernel()
        got = ops.flash_attention(q, k, v, **kw)
        path = [name for name, n in attn_launches_by_kernel().items() if n > before[name]]
        path = path[0] if len(path) == 1 else str(path)
        again = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"{what}; {path} kernel)"
        check(path == ATTN_KERNEL[name], f"{what}: took the wrong kernel")
        errs = attn_errors(got, want)
        err = errs["max_abs_err"]
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(attn_close(errs, dtype), f"{what}: kernel disagrees with the plain version "
                                       f"({errs})")
        check(torch.equal(got, again), f"{what}: two calls differ")
        paged = "page_table" in kw
        if paged:
            kc, vc, flat_kw = attn_gathered(k, v, kw)
            check(torch.equal(got, ops.flash_attention(q, kc, vc, **flat_kw)),
                  f"{what}: a row's bits depend on where its keys lie")
            del kc, vc
        del got, again, want
        n_flop, n_bytes = flash_attention_lib.cost(*shape, q.element_size(), k.element_size(),
                                                   **cost_kw)
        peak = BF16_FLOP_PER_S if q.dtype == k.dtype == torch.bfloat16 else FP32_FLOP_PER_S
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / peak
        bound, by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), flush)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), flush)
        library = None
        if not kw["softcap"] and not paged:
            _, _, _, sq, skv, _, causal, window = shape
            pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
            delta = pos - torch.arange(skv, device=dev)[None, :]
            band = torch.ones((sq, skv), dtype=torch.bool, device=dev)
            if causal:
                band &= delta >= 0
            if window > 0:
                band &= delta < window
            library = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, scale=kw["scale"], enable_gqa=True), flush)
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
    """The wrapper's launches by kernel (read from the module's wrapper, which
    holds the counts, also while a run swaps a recorder in for
    ``ops.flash_attention``)."""
    fa = flash_attention_lib.flash_attention
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


def cache_free_errors(cfg, hcfg, params, state, rec, prompts, tokens) -> dict:
    """The requests through prefill + decode (``rec``: the forwards'
    hiddens and each step's dense Eq. 5 scores) against the plain version's
    cache-free forward over every token the cache holds: relative RMS of
    the prefill's and the decode steps' hiddens and of the scores, overall
    and by request."""
    dev = prompts.device
    prompt_len, batch = prompts.shape[1], prompts.shape[0]
    head = heads.HeadParams(**params["head"])
    fed = torch.cat([prompts, prompts[:, -1:],
                     torch.as_tensor(tokens[:, :-1], device=dev)], dim=1)
    t0 = time.perf_counter()
    with swapped(ops, flash_attention=blocked_attention_ref,
                 tree_logprob_all=ref.tree_logprob_all_ref):
        plain_h, _, _ = transformer.forward(params, cfg, fed)
        plain_scores = lm_head.lm_predictive_scores(
            cfg, hcfg, head, state, plain_h[:, prompt_len:].reshape(-1, cfg.d_model))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_h_prompt, plain_h_decode = plain_h[:, :prompt_len], plain_h[:, prompt_len:]
    kernel_h_prompt = rec["h"][0]
    kernel_h_decode = torch.stack([h[:, -1] for h in rec["h"][1:]], dim=1)
    kernel_scores = torch.stack(rec["scores"], dim=1).reshape(-1, plain_scores.shape[-1])
    real = slice(0, cfg.vocab_size)
    kernel_scores, plain_scores = kernel_scores[:, real], plain_scores[:, real]
    gen = kernel_h_decode.shape[1]
    by_req = lambda x: x.reshape(batch, gen, -1)  # noqa: E731
    return {
        "prefill_hidden_rel_rms": rel_rms(kernel_h_prompt, plain_h_prompt),
        "decode_hidden_rel_rms": rel_rms(kernel_h_decode, plain_h_decode),
        "decode_scores_rel_rms": rel_rms(kernel_scores, plain_scores),
        "prefill_hidden_rel_rms_by_request": [
            rel_rms(kernel_h_prompt[i], plain_h_prompt[i]) for i in range(batch)],
        "decode_hidden_rel_rms_by_request": [
            rel_rms(kernel_h_decode[i], plain_h_decode[i]) for i in range(batch)],
        "decode_scores_rel_rms_by_request": [
            rel_rms(by_req(kernel_scores)[i], by_req(plain_scores)[i]) for i in range(batch)],
        "prefill_hidden_max_abs_err": float((kernel_h_prompt.float()
                                             - plain_h_prompt.float()).abs().max()),
        "decode_hidden_max_abs_err": float((kernel_h_decode.float()
                                            - plain_h_decode.float()).abs().max()),
        "decode_scores_max_abs_err": float((kernel_scores - plain_scores).abs().max()),
        "plain_scores_std": float(plain_scores.std()),
        "argmax_agreement": float((kernel_scores.argmax(-1)
                                   == plain_scores.argmax(-1)).float().mean()),
        "plain_forward_s": plain_s,
    }


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
    errs = cache_free_errors(cfg, hcfg, params, state, rec, run["prompts"], run["tokens"])
    plain_s = errs.pop("plain_forward_s")
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
    step that ``pick(tokens, table, kv_lens, sink)`` picks (default
    ``wants_record``; layer 0 of that step): q, one layer's arenas, the key
    counts and the table, cloned, with the call's output."""

    def __init__(self, eng, attr: str, name: str, pick=None):
        self.name, self.call, self.armed = name, None, False
        step = getattr(eng, attr)
        sink = eng.pool.sink
        pick = pick or (lambda tokens, *rest: wants_record(tokens.shape[0], *rest))

        def watched(*args):
            if self.call is None:
                tokens = np.asarray(args[1])
                if attr == "_decode":       # (params, token, arena, cache_pos, table)
                    lens, table = np.asarray(args[3]) + 1, np.asarray(args[4])
                else:                       # (params, tokens, start, lengths, arena, table)
                    lens, table = np.asarray(args[2]) + tokens.shape[1], np.asarray(args[5])
                self.armed = pick(tokens, table, lens, sink)
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


def check_recorded(rec: PagedRecorder, flush, plain_rows=None) -> dict:
    """The kernel against its plain version on a recorded engine call, with
    check_flash_attention's tolerances; the call again gives the engine's
    bits, and so does the same call on its keys gathered into a contiguous
    cache; its time beside its bound (q, the output and the K/V of the keys
    each row's queries see, against 4*hd operations per (query, key) pair),
    the plain version's, the gathered call's and the FMA kernel's on the
    same call (the C entry with kernel 0, its own split count). With
    ``plain_rows``, the plain version (its check and its time) and the FMA
    kernel's check take the call's first ``plain_rows`` rows alone: the
    plain version's logits of a whole padded prefill would not fit."""
    check(rec.call is not None, f"{rec.name}: no engine call was recorded")
    c = rec.call
    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    lens = kw["kv_lens"].tolist()
    b, h, sq, hd = q.shape
    kvh, skv, window = k.shape[2], kw["max_kv_len"], kw.get("window", 0)
    rows = slice(0, b if plain_rows is None else plain_rows)
    part_kw = dict(kw, kv_lens=kw["kv_lens"][rows], page_table=kw["page_table"][rows],
                   max_kv_len=max(lens[rows]))
    before = attn_launches_by_kernel()
    got = ops.flash_attention(q, k, v, **kw)
    path = [n for n, m in attn_launches_by_kernel().items() if m > before[n]]
    want = ref.flash_attention_ref(q[rows], k, v, **part_kw)
    kc, vc, flat_kw = attn_gathered(k, v, kw)
    flat = ops.flash_attention(q, kc, vc, **flat_kw)
    fma_split = flash_attention_lib.n_splits(
        b, h, kvh, sq, skv, True, window, torch.cuda.get_device_properties(q.device)
        .multi_processor_count)

    def fma_call():
        return flash_attention_lib.launch(
            q, k, v, torch.empty_like(q), kvh, skv, flash_attention_lib.FMA, fma_split,
            causal=True, window=window, softcap=kw.get("softcap", 0.0),
            scale=kw.get("scale"), kv_lens=kw["kv_lens"], page_table=kw["page_table"])
    fma_out = fma_call()
    torch.cuda.synchronize()
    errs = attn_errors(got[rows], want)
    fma_errs = attn_errors(fma_out[rows], want)
    what = (f"{rec.name}: paged flash_attention on an engine call (B={b} "
            f"Sq={sq} lens={lens} page_len={k.shape[1]} "
            f"q {str(q.dtype)[6:]}, cache {str(k.dtype)[6:]}; {path} kernel; plain "
            f"version on rows {rows.start}..{rows.stop - 1})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(attn_close(errs, q.dtype), f"{what}: kernel disagrees with the plain version "
                                     f"({errs})")
    check(torch.equal(got, c["out"]), f"{what}: the call again differs from the engine's")
    check(torch.equal(got, flat), f"{what}: the gathered contiguous call gives other bits")
    check(attn_close(fma_errs, q.dtype), f"{what}: the FMA kernel disagrees with the plain "
                                         f"version ({fma_errs})")
    del got, want, flat, fma_out
    n_flop, n_bytes = flash_attention_lib.cost(
        b, h, kvh, sq, skv, hd, True, window, q.element_size(), k.element_size(),
        kv_lens=lens, index_bytes=kw["kv_lens"].numel() * 4 + kw["page_table"].numel() * 4)
    peak = (BF16_FLOP_PER_S if q.dtype == k.dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / peak
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), flush)
    fma = time_ms(fma_call, flush)
    contiguous = time_ms(lambda: ops.flash_attention(q, kc, vc, **flat_kw), flush)
    fma_again = time_ms(fma_call, flush)
    plain = time_ms(lambda: ref.flash_attention_ref(q[rows], k, v, **part_kw), flush)
    row = dict(path=path[0] if len(path) == 1 else str(path), rows=b, sq=sq, kv_lens=lens,
               plain_rows=rows.stop,
               page_len=k.shape[1], q_dtype=str(q.dtype)[6:], cache_dtype=str(k.dtype)[6:],
               max_abs_err=errs["max_abs_err"], worst_ratio=errs["worst_ratio"],
               rel_rms=errs["rel_rms"], ms=ms, plain_ms=plain, library_ms=None,
               contiguous_ms=contiguous, fma_ms=[fma, fma_again], fma_split=fma_split,
               fma_max_abs_err=fma_errs["max_abs_err"],
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes)
    print(f"{what}: max_abs_err={errs['max_abs_err']:.3e} (worst error/bound "
          f"{errs['worst_ratio']:.3f}), kernel {ms:.4f} ms, the same keys contiguous "
          f"{contiguous:.4f} ms, FMA kernel {fma:.4f} / {fma_again:.4f} ms (split "
          f"{fma_split}, max_abs_err {fma_errs['max_abs_err']:.3e}), plain {plain:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
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
    multi-token step and the first cold prefill (padded to 4,096 tokens,
    the plain version on its first row) from (c), and a decode step of a
    float32 cache (the reference's default) from a short run (d)."""
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
    # drafts, or a suffix prefill) that wants_record picks; and the first
    # template's cold prefill, padded to 4,096 tokens (128 row tiles a (b,
    # kv head)), held against the plain version on its first row.
    # Last, a few requests on a mostly idle engine whose free list the
    # preemptions have permuted: one of each prompt length, so lanes are
    # free and key counts ragged while drafts replay.
    tail = [dataclasses.replace(r) for n in sorted({r.prompt.size for r in work})
            for r in [next(r for r in work if r.prompt.size == n)]] * 2
    rec_c = PagedRecorder(
        eng, "_paged_prefill", "multi-token paged step (bf16 cache)",
        pick=lambda tokens, *rest: (tokens.shape[1] <= 64
                                    and wants_record(tokens.shape[0], *rest)))
    rec_cold = PagedRecorder(eng, "_paged_prefill", "cold paged prefill (bf16 cache)",
                             pick=lambda tokens, *_: tokens.shape[1] > 64)
    rec_c_wrap = rec_c.wrap(rec_cold.wrap(ops.flash_attention))
    ops_flash = ops.flash_attention
    multi_paged = collections.Counter()     # multi-token paged launches by kernel

    def multi_only(q, k, v, **kw):
        if q.shape[2] == 1:
            return ops_flash(q, k, v, **kw)
        before = attn_launches_by_kernel()
        out = rec_c_wrap(q, k, v, **kw)
        if kw.get("page_table") is not None:
            multi_paged.update({n: m - before[n] for n, m in attn_launches_by_kernel().items()})
        return out
    with swapped(ops, flash_attention=multi_only):
        line, handles = run_engine_case(
            "shared_prefix", eng,
            [(work, None), ([dataclasses.replace(r) for r in work], 1),
             ([dataclasses.replace(r, priority=2) for r in work[:ENGINE_SLOTS]], None),
             (tail, None)])
    check(line["share_hits"] >= 1 and line["verify_steps"] >= 1,
          f"shared_prefix: {line['share_hits']} share hits, "
          f"{line['verify_steps']} verify steps")
    line["multi_token_paged_by_kernel"] = dict(multi_paged)
    check(multi_paged["tensor_cores"] >= 1
          and line["launches"]["flash_attention_by_kernel"]["fma"] == 0,
          f"shared_prefix: the bf16 multi-token paged steps did not all take the "
          f"tensor-core kernel: {dict(multi_paged)}, by kernel "
          f"{line['launches']['flash_attention_by_kernel']}")
    line["lockstep_token_agreement"] = lockstep_agreement(cfg, hcfg, params, state, handles,
                                                         SERVE_BEAM)
    add(line["launches"])
    runs["shared_prefix"] = show("shared_prefix", line)
    recorded["multi_token_bf16"] = check_recorded(rec_c, flush)
    recorded["cold_prefill_bf16"] = check_recorded(rec_cold, flush, plain_rows=1)
    check(recorded["cold_prefill_bf16"]["path"] == "tensor_cores",
          f"{rec_cold.name}: took {recorded['cold_prefill_bf16']['path']}")
    del eng, rec_c, rec_cold

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
    n_flop, n_bytes = sampled_loss_lib.cost(t, m, cfg.d_model, 4, rows)
    bound, by = bound_ms(n_bytes, n_flop)
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
    # The profiler's warm step, its peak read alone for phase 16's dry run.
    step_batch = batch_fn(LM_STEPS)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_step = time.perf_counter()
    train_step(state, step_batch, gen(LM_STEPS))
    torch.cuda.synchronize()
    one_step = dict(ms=1e3 * (time.perf_counter() - t_step),
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    held_bytes=torch.cuda.memory_allocated())
    del step_batch
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
        "one_step": one_step,
        "launches": launches, "profiled_step": profile, "kernel_at_step_shape": kernel,
        "grads_2_layers": grads, "resume_2_layers": resume}
    print(json.dumps({"lm_train_path": result}))
    return launches, result


# Phase 11 (b): the sampled head trained at gemma2-27b's width (d 4,608:
# past the kernel's old limit of K = 4,096), 2 of its 46 layers.
G2_ARCH = "gemma2-27b"
G2_TRAIN_LAYERS, G2_TRAIN_BATCH, G2_TRAIN_SEQ, G2_TRAIN_STEPS = 2, 2, 2048, 3
G2_TRAIN_OPT = dict(name="adagrad", learning_rate=1e-3, clip_norm=1.0)


def gemma2_train_path(dev, seed, card) -> dict:
    """gemma2-27b at full width and G2_TRAIN_LAYERS layers, float32
    parameters, Adagrad: G2_TRAIN_STEPS sparse steps (adversarial_ns, the
    sparse head and the sparse embedding) on batch 2 x 2,048, counters reset
    just before and read just after; the first step's own sampled_head_loss
    call (T = 4,096, m = 2, K = 4,608) against the plain version on its
    inputs, within phase 3's tolerances; losses finite; one
    sampled_head_loss and 3 segment_stats (the head's dw and db, the
    embedding's dw) a step. Returns the launches."""
    from repro_torch.data import lm_batch_fn
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(G2_ARCH), num_layers=G2_TRAIN_LAYERS)
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    ocfg = optim.OptimizerConfig(**G2_TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed + 60),
                                       cfg, ocfg, hcfg.kind, device=dev)
    step = train_lib.make_train_step(cfg, hcfg, ocfg)
    make = lm_batch_fn(cfg.vocab_size, G2_TRAIN_BATCH, G2_TRAIN_SEQ, seed=seed)
    batch = lambda s: {k: torch.as_tensor(v).to(dev) for k, v in make(s).items()}  # noqa: E731
    setup_s = time.perf_counter() - t0
    real, calls = ops.sampled_head_loss, []

    def recorded(w, b, h, ids, lp, **kw):
        out = real(w, b, h, ids, lp, **kw)
        if not calls:       # the rows it read, before the optimizer writes them
            uniq, inv = torch.unique(ids, return_inverse=True)
            calls.append((w.index_select(0, uniq), b.index_select(0, uniq), h.clone(), inv,
                          lp.clone(), kw, [o.clone() for o in out]))
        return out

    names = ("sampled_head_loss", "segment_stats", "tree_logprob_all", "flash_attention")
    for name in names:
        getattr(ops, name).launches = 0
    losses, step_ms = [], []
    with swapped(ops, sampled_head_loss=recorded):
        for s_ in range(G2_TRAIN_STEPS):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            state, m = step(state, batch(s_), step_generator(seed, s_, dev))
            losses.append(float(m["loss"]))
            step_ms.append(1e3 * (time.perf_counter() - t_step))
    launches = {name: getattr(ops, name).launches for name in names}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"{G2_ARCH} training losses {losses}")
    want_launches = {"sampled_head_loss": G2_TRAIN_STEPS, "segment_stats": 3 * G2_TRAIN_STEPS,
                     "tree_logprob_all": 0, "flash_attention": 0}
    check(launches == want_launches, f"{G2_ARCH} training launches {launches}, not "
                                     f"{want_launches}")
    del state, step
    torch.cuda.empty_cache()
    w, b, h, ids, lp, kw, got = calls.pop()
    want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
    what = f"{G2_ARCH} training step's sampled_head_loss (T={h.shape[0]}, m={ids.shape[1]}, " \
           f"K={h.shape[1]})"
    for name, g, wn in zip(("loss", "coeff", "xi"), got, want):
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        check(close(g, wn, LOSS_TOL), f"{what}: {name} disagrees with the plain version")
    check(dh_close(got[3], want[3], want[1], w, ids), f"{what}: dh disagrees")
    result = dict(
        card=card, arch=G2_ARCH, d_model=cfg.d_model, vocab=cfg.vocab_size,
        reduced={"num_layers": [configs.get_config(G2_ARCH).num_layers, G2_TRAIN_LAYERS]},
        batch=G2_TRAIN_BATCH, seq=G2_TRAIN_SEQ, steps=G2_TRAIN_STEPS, optimizer=G2_TRAIN_OPT,
        head=hcfg.kind, loss=losses, ms_per_step=step_ms, setup_s=setup_s,
        peak_mem_gib=peak_gib, launches=launches,
        kernel_check=dict(t=h.shape[0], m=ids.shape[1], k=h.shape[1],
                          distinct_rows=w.shape[0], tol=LOSS_TOL,
                          max_abs_err=max(float((g - wn).abs().max())
                                          for g, wn in zip(got[:3], want[:3])),
                          dh_max_abs_err=float((got[3] - want[3]).abs().max())),
        wall_s=time.perf_counter() - t0)
    print(json.dumps({"gemma2_train": result}))
    del w, b, h, ids, lp, got, want
    torch.cuda.empty_cache()
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
HM_STATE_STEPS = 25              # of HM_STATE_STEPS_FULL: cut for the script's time
HM_STATE_STEPS_FULL = 50
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
        "reduced": {"steps": [HM_STATE_STEPS_FULL, HM_STATE_STEPS]},
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
MIXTRAL_LAYERS, MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_GEN = 4, 2, 4096, 16
# (a) and (b) at full width and a quarter of their depth (printed as
# ``reduced``): their decode and each request's lock-step oracle are
# host-bound, a layer's launches at a time, and took 144 s of the script
# whole (NVIDIA H100 80GB HBM3, 700.00 W).
MAMBA_LAYERS, HYMBA_LAYERS = 12, 8          # of 48 and 32
# (f) gemma2-27b: all 46 layers (52 GB of bf16; the float32 head table 4.7 GB,
# the cache 3.1 GB), lock-step, dense Eq. 5 (tree_logprob_all at k = 64 on
# the tensor-core kernel) and beam 64, each request against the cache-free
# forward. G2_SERVE_LAYERS = None keeps every layer.
G2_SERVE_LAYERS, G2_SERVE_BATCH, G2_SERVE_PROMPT, G2_SERVE_GEN = None, 4, 2048, 32


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


def family_lockstep(name, dev, seed, card, model, batch, prompt_len, gen_len, beams,
                    dense_rec=None):
    """The lock-step launcher over ``batch`` prompts, dense (and beam 64),
    counters reset just before and read just after each path; the forward's
    MoE metrics and layer 0's MoE input recorded from the prefill; one
    decode step profiled. ``dense_rec``, a dict, takes the dense path's
    hiddens, scores, prompts and tokens (for :func:`cache_free_errors`)."""
    from repro_torch.models import moe as moe_lib
    cfg, params, state, hcfg, _ = model
    total, paths, moe_in = collections.Counter(), {}, {}
    for beam in beams:
        path = "beam" if beam else "dense"
        args = serve.parse_args(["--lockstep", "--full", "--arch", cfg.name, "--batch",
                                 str(batch), "--prompt-len", str(prompt_len), "--gen",
                                 str(gen_len), "--topk-beam", str(beam), "--seed", str(seed)])
        metrics, forward, ffn = [], transformer.forward, moe_lib.moe_ffn
        scores_fn = lm_head.lm_predictive_scores
        rec = dense_rec if dense_rec is not None and beam == 0 else None
        if rec is not None:
            rec.update(h=[], scores=[])

        def rec_forward(*a, **kw):
            out = forward(*a, **kw)
            metrics.append(out[2])              # read after the run: no sync a step
            if rec is not None:
                rec["h"].append(out[0])
            return out

        def rec_scores(*a, **kw):
            out = scores_fn(*a, **kw)
            if rec is not None:
                rec["scores"].append(out)
            return out

        def rec_ffn(p, c, x, **kw):
            if "x" not in moe_in and x.shape[1] > 1:
                moe_in["x"] = x.clone()
            return ffn(p, c, x, **kw)

        torch.cuda.reset_peak_memory_stats()
        reset_engine_counters()
        tc0 = ops.tree_logprob_all.tensor_core_launches
        with swapped(transformer, forward=rec_forward), swapped(moe_lib, moe_ffn=rec_ffn), \
                swapped(lm_head, lm_predictive_scores=rec_scores):
            run = serve.run_lockstep(args, cfg, params, state, hcfg, dev)
        counts = engine_counts()
        counts["tree_logprob_all_tensor_cores"] = ops.tree_logprob_all.tensor_core_launches - tc0
        if rec is not None:
            rec.update(prompts=run["prompts"], tokens=run["tokens"])
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


def gemma2_serve(dev, seed, card, total, build) -> dict:
    """(f) gemma2-27b at full width (``build``: the phase's serving-launcher
    build): lock-step dense and beam 64, the dense path's tree_logprob_all
    at k = 64 on the tensor-core kernel, and each request's prefill and
    decode hiddens and dense Eq. 5 scores within SERVE_REL_RMS_TOL of the
    cache-free forward."""
    t0 = time.perf_counter()
    model = build(G2_ARCH, G2_SERVE_LAYERS)
    cfg, params, state, hcfg, _ = model
    rec = {}
    counts, paths, _ = family_lockstep(G2_ARCH, dev, seed, card, model, G2_SERVE_BATCH,
                                       G2_SERVE_PROMPT, G2_SERVE_GEN, (0, FAM_BEAM),
                                       dense_rec=rec)
    total.update({k: v for k, v in counts.items() if k in ENGINE_KERNELS})
    dense = paths["dense"]["launches"]
    check(dense["tree_logprob_all_tensor_cores"] == G2_SERVE_GEN,
          f"{G2_ARCH} dense: tree_logprob_all not on the tensor-core kernel: {dense}")
    check(cfg.gen_feature_dim == 64 and cfg.d_model == 4608,
          f"{G2_ARCH}: not at the widths the slice opens")
    errs = cache_free_errors(cfg, hcfg, params, state, rec, rec["prompts"], rec["tokens"])
    for key in ("prefill_hidden_rel_rms_by_request", "decode_hidden_rel_rms_by_request",
                "decode_scores_rel_rms_by_request"):
        check(max(errs[key]) <= SERVE_REL_RMS_TOL,
              f"{G2_ARCH}: a request's {key} {errs[key]} > {SERVE_REL_RMS_TOL:.3e} from the "
              f"cache-free forward")
    line = dict(model=G2_ARCH, card=card, layers=cfg.num_layers, k=cfg.gen_feature_dim,
                kernel_vs_plain=errs, rel_rms_tol=SERVE_REL_RMS_TOL,
                wall_s=time.perf_counter() - t0)
    print(json.dumps({"gemma2_serve": line}))
    del model, params, state, rec
    torch.cuda.empty_cache()
    return dict(paths=paths, cache_free=errs)


def backbone_path(dev, seed, card) -> dict:
    """Phase 12: (a) mamba2-370m and (b) hymba-1.5b through the engine, (c)
    deepseek-moe-16b, (d) qwen2-vl-7b and (e) mixtral-8x22b (4 of 56 layers)
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

    model = build("mamba2-370m", num_layers=MAMBA_LAYERS)
    lines["mamba2-370m"]["ssd"] = ssd_check(dev, seed, model[0], flush)
    counts, lines["mamba2-370m"]["paths"] = family_engine("mamba2-370m", dev, seed, card, model)
    total.update(counts)
    del model
    model = build("hymba-1.5b", num_layers=HYMBA_LAYERS)
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
    served = gemma2_serve(dev, seed, card, total, build)     # builds lines[G2_ARCH]
    lines[G2_ARCH].update(served)
    print(json.dumps({"backbone_path": dict(card=card, wall_s=time.perf_counter() - t_phase,
                                            launches=dict(total))}))
    return dict(total)


# ---------------------------------------------------------------------------
# Phase 13: the vocab-sharded head on a (data, model) process mesh.
# ---------------------------------------------------------------------------

MESH_RANKS = 4                   # (a) and (c): one world of 4 ranks on the one card
MESH_DEVICE = "cuda:0"           # every rank shares it: gloo (NCCL refuses two ranks)
MESH_TIMEOUT_S = 300             # the group's timeout; the world's own limit is above it
MESH_OPT_CASES = (("adagrad", "fp32"), ("sm3", "bf16"), ("adamw", "int8"))
MESH_ROWS_STEPS = 3
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 2, 4, 256, 3
# SGD: the check holds the data-parallel sum of the gradients, and SGD's
# update is linear in it. Adagrad's first step, -lr·g/(|g| + eps), turns
# float32 reordering at |g| near eps into 1e-4 parameter differences.
MESH_TRAIN_OPT = dict(name="sgd", learning_rate=0.05, clip_norm=1.0)
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_TOL = dict(atol=1e-4, rtol=1e-3)          # tests/test_parallel.py:65-70
MESH_ENGINE_BATCH, MESH_ENGINE_PROMPT = 8, 4096


def rank_bytes(b: dict, dp: int, tp: int) -> int:
    """What a rank of (dp, tp) holds of a state whose one-rank bytes ``b``
    (``launch.train.state_bytes``) split over ``model`` only, over ``data``
    only, over both, and whole: exactly model / tp + data / dp + both /
    (dp·tp) + whole (``sharding.SplitBytes.a_rank``)."""
    from repro_torch.parallel.sharding import SplitBytes
    return SplitBytes(*(b[k] for k in SplitBytes._fields)).a_rank((dp, tp))


def mesh_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Host ms a call, each ending in a synchronize, after one untimed: a
    rank's collective waits for the others, so device events would time
    the wait inside gloo's host copies, not the call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def mesh_collectives(mesh, dev, seed) -> dict:
    """(a) at full xc_linear width over (1, 4): sharded_candidate_scores
    against the unsharded gather_scores kernel, and sharded_rows_update
    (through apply_updates(mesh=)) against the unsharded update."""
    import torch.distributed as dist
    from repro_torch.parallel import collectives, gather_head, shard_head, sharding
    cfg = xc_linear.config()
    c, kdim = cfg.num_labels, cfg.feature_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    w = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b = 0.1 * torch.randn((c,), generator=gen, device=dev)
    h = torch.randn((BATCH, kdim), generator=gen, device=dev)
    ids = torch.randint(0, c, (BATCH, BEAM), generator=gen, device=dev)
    lo, hi = sharding.row_range(c, mesh)
    w_l, b_l = w[lo:hi].clone(), b[lo:hi].clone()
    torch.cuda.synchronize()
    ops.gather_scores.launches = 0
    got = collectives.sharded_candidate_scores(mesh, w_l, b_l, h, ids)
    torch.cuda.synchronize()
    launches = ops.gather_scores.launches
    want = heads.kernel_scores(heads.HeadParams(w, b), h, ids)
    bit_equal = bool(torch.equal(got, want))
    check(bit_equal or close(got, want, GATHER_TOL),
          "sharded_candidate_scores disagrees with the unsharded gather_scores kernel")
    buf = torch.zeros_like(got)
    g_model = sharding.group(mesh, "model")
    ms = mesh_ms(lambda: collectives.sharded_candidate_scores(mesh, w_l, b_l, h, ids))
    reduce_ms = mesh_ms(lambda: dist.all_reduce(buf, group=g_model))
    rows = {}
    for rule, sd in MESH_OPT_CASES:
        ocfg = optim.OptimizerConfig(name=rule, learning_rate=0.05, state_dtype=sd,
                                     weight_decay=0.1 if rule == "adamw" else 0.0)
        full = heads.HeadParams(w.clone(), b.clone())
        full_state = init_opt_state(ocfg, full)
        own = tree_util.tree_map(  # the column cover is whole: no tensor shared with full
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x, (full, full_state))
        local, local_state = shard_head(own, mesh)
        step_ms = []
        for t in range(MESH_ROWS_STEPS):
            r_ids = torch.unique(torch.randint(0, c, (2 * BATCH,), generator=gen, device=dev))
            g = sparse_lib.SparseRows(
                r_ids, torch.randn((r_ids.numel(), kdim), generator=gen, device=dev),
                torch.randn((r_ids.numel(),), generator=gen, device=dev))
            full, full_state, _ = apply_updates(ocfg, full, g, full_state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local, local_state, _ = apply_updates(ocfg, local, g, local_state, mesh=mesh)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        back = tree_util.leaves(gather_head((local, local_state), mesh))
        ref = tree_util.leaves((full, full_state))
        equal = all(torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
                    for x, y in zip(back, ref))
        check(equal, f"sharded {rule}/{sd} row update differs from the unsharded update")
        rows[f"{rule}_{sd}"] = dict(bit_equal=equal, ms_per_step=step_ms)
    return dict(scores=dict(shape=[BATCH, BEAM], c=c, k=kdim, rows_per_rank=hi - lo,
                            bit_equal=bit_equal, max_abs_err=float((got - want).abs().max()),
                            ms=ms, allreduce_ms=reduce_ms, collective_share=reduce_ms / ms,
                            gather_scores_launches=launches),
                rows_update=rows)


MESH_SUM_ROWS, MESH_SUM_D, MESH_SUM_IDS = 50_304, 2_560, 8_192   # stablelm-3b's table
MESH_SUM_CASES = ("zipf", "empty_rank", "no_db")


def gather_everything_sum(mesh, rows, n_rows):
    """The sum over ``data`` that the by-owner sum replaced, kept here as its
    oracle: every data rank's rows gathered in rank order and summed per
    unique id by ``segment_stats``, then cut to the rank's ``model`` slice."""
    import torch.distributed as dist
    from repro_torch.parallel import sharding
    g = sharding.group(mesh, "data")

    def gather(x):
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        sizes = [torch.empty_like(n) for _ in range(dist.get_world_size(g))]
        dist.all_gather(sizes, n, group=g)
        sizes = [int(v) for v in sizes]
        buf = torch.zeros((max(sizes),) + x.shape[1:], dtype=x.dtype, device=x.device)
        buf[:x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in sizes]
        dist.all_gather(parts, buf, group=g)
        return torch.cat([p[:k] for p, k in zip(parts, sizes)])

    uniq, inv = sparse_lib.unique_rows(gather(rows.ids))
    plan = ops.segment_plan(inv, uniq.shape[0])
    dw = ops.segment_stats(gather(rows.dw), inv, uniq.shape[0], plan=plan)
    db = None if rows.db is None else ops.segment_stats(
        gather(rows.db)[:, None], inv, uniq.shape[0], plan=plan)[:, 0]
    lo = sharding.rank(mesh, "model") * n_rows
    keep = (uniq >= lo) & (uniq < lo + n_rows)
    return sparse_lib.SparseRows(uniq[keep], dw[keep], None if db is None else db[keep])


def same_rows(a, b) -> bool:
    return (torch.equal(a.ids, b.ids) and torch.equal(a.dw, b.dw)
            and (a.db is None) == (b.db is None) and (a.db is None or torch.equal(a.db, b.db)))


def recorded_row_sum(record: list, checked: bool = False):
    """A stand-in for ``collectives.sum_rows_over_data`` that appends each
    call's record (``collectives.ROW_SUMS.last``) to ``record`` where there
    is more than one data rank (with one the rows pass through, unsummed);
    ``checked``: it also runs the oracle and records ``bit_equal``, the
    oracle's own segment_stats launches not counted."""
    from repro_torch.parallel import collectives, sharding
    owner = collectives.sum_rows_over_data

    def rec(mesh, rows, n_rows):
        got = owner(mesh, rows, n_rows)
        if sharding.size(mesh, "data") == 1:
            return got
        call = dict(collectives.ROW_SUMS.last)
        if checked:
            n = ops.segment_stats.launches
            call["bit_equal"] = same_rows(got, gather_everything_sum(mesh, rows, n_rows))
            ops.segment_stats.launches = n
        record.append(call)
        return got

    return rec


def mesh_rows_sum(meshes, dev, seed) -> dict:
    """(b) the sparse rows' sum over ``data`` by owner on (2, 2) and (4, 1),
    each data rank's rows Zipf-skewed over stablelm-3b's table (most fall to
    one owner), a rank with none, and without ``db``: bit-equal to the
    gather-everything sum, the bytes each call held within its bound."""
    from repro_torch.parallel import sharding
    out = {}
    for name, mesh in meshes.items():
        n_rows = MESH_SUM_ROWS // sharding.size(mesh, "model")
        d_rank = sharding.rank(mesh, "data")
        for case in MESH_SUM_CASES:
            rng = np.random.default_rng((seed, d_rank, MESH_SUM_CASES.index(case)))
            n = 0 if case == "empty_rank" and d_rank == 1 else MESH_SUM_IDS
            ids = np.unique(np.minimum(rng.zipf(1.2, n) - 1, MESH_SUM_ROWS - 1))
            u = len(ids)
            rows = sparse_lib.SparseRows(
                torch.as_tensor(ids, dtype=torch.int64, device=dev),
                torch.as_tensor(rng.standard_normal((u, MESH_SUM_D), np.float32), device=dev),
                None if case == "no_db" else
                torch.as_tensor(rng.standard_normal(u, np.float32), device=dev))
            record = []
            got = recorded_row_sum(record, checked=True)(mesh, rows, n_rows)
            torch.cuda.synchronize()
            call = record[0]
            check(call["bit_equal"], f"the sum over data by owner on {name}, {case}: not "
                                     "bit-equal to the gather-everything sum")
            check(call["bytes"] <= call["bound_bytes"],
                  f"the sum over data on {name}, {case}: {call['bytes']} B held over the "
                  f"bound {call['bound_bytes']} B")
            out[f"{name}/{case}"] = dict(call, rows_in=u, rows_out=got.ids.shape[0])
    return out


def timed_data_sum(record: dict):
    """A stand-in for ``collectives.all_reduce_over_data`` that appends
    each of the trunk's sums (more than one tensor a call: the step's
    metrics are one) to ``record``: its float32 bytes and host seconds,
    the call synchronized before and after."""
    from repro_torch.parallel import collectives
    reduce = collectives.all_reduce_over_data

    def rec(mesh, tensors):
        if len(tensors) < 2:
            return reduce(mesh, tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(mesh, tensors)
        torch.cuda.synchronize()
        record["bytes"].append(4 * sum(t.numel() for t in tensors))
        record["seconds"].append(time.perf_counter() - t0)

    return rec


def write_sharded_checkpoint(path: str, step: int, state, mesh, cfg) -> None:
    """A checkpoint of a rank's state written leaf by leaf: every rank joins
    the gather of each leaf, rank 0 writes it."""
    import torch.distributed as dist
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.parallel import iter_gathered_leaves
    tree = state.as_pytree()
    leaves = iter_gathered_leaves(tree, mesh, cfg)
    if dist.get_rank() == 0:
        save_checkpoint(path, step, tree, leaves=leaves)
    else:
        for _ in leaves:
            pass
    dist.barrier()


def mesh_train(mesh, dev, seed, out_dir) -> dict:
    """(c) stablelm-3b at full width, 2 layers, float32, mesh (2, 2), the
    trunk sharded over model: 3 steps on the global batch against 3
    one-rank steps from the same seed (on rank 0), launches counted, each
    rank's parameter and optimizer-state bytes against the one-rank
    state's split and whole bytes, the trunk's sum over data timed; a
    checkpoint written under the mesh leaf by leaf, restored by every rank
    (its part) and by one process (the whole), each bit-equal."""
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import lm_batch_fn
    from repro_torch.parallel import collectives, sharding
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), num_layers=MESH_TRAIN_LAYERS,
                              dtype="float32")
    hcfg = lm_head.head_config(cfg, "adversarial_ns", reg=1e-4)
    ocfg = optim.OptimizerConfig(**MESH_TRAIN_OPT)

    def fresh(on=None):
        return train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed + 41),
                                          cfg, ocfg, "adversarial_ns", device=dev, mesh=on)

    make = lm_batch_fn(cfg.vocab_size, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, seed=seed)
    batch = lambda s: {k: torch.as_tensor(v).to(dev) for k, v in make(s).items()}  # noqa: E731
    state = fresh(mesh)
    nbytes = launch_train.state_bytes(cfg, ocfg, state, mesh)
    dp, tp = sharding.size(mesh, "data"), sharding.size(mesh, "model")
    for name, b in nbytes.items():
        check(b["rank"] == rank_bytes(b, dp, tp),
              f"{name}: rank {dist.get_rank()} holds {b['rank']} bytes, not "
              f"{rank_bytes(b, dp, tp)} ({b})")
    step = train_lib.make_train_step(cfg, hcfg, ocfg, mesh=mesh)
    names = ("sampled_head_loss", "segment_stats")
    torch.cuda.synchronize()
    for name in names:
        getattr(ops, name).launches = 0
    losses, step_ms = [], []
    data_sum = dict(bytes=[], seconds=[])
    collectives.FSDP.reset()
    collectives.FSDP.timed = True
    row_sums = []
    with swapped(collectives, all_reduce_over_data=timed_data_sum(data_sum)):
        for s in range(MESH_TRAIN_STEPS):
            row_sums.append([])
            t0 = time.perf_counter()
            with swapped(collectives, sum_rows_over_data=recorded_row_sum(row_sums[-1])):
                state, m = step(state, batch(s), step_generator(seed, s, dev))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
    collectives.FSDP.timed = False
    fsdp = {p: dict(c) for p, c in collectives.FSDP.phases.items()}
    launches = {name: getattr(ops, name).launches for name in names}
    ckpt = str(Path(out_dir) / "ckpt")
    write_sharded_checkpoint(ckpt, MESH_TRAIN_STEPS, state, mesh, cfg)
    tree = state.as_pytree()
    part, _ = restore_checkpoint(ckpt, tree, step=MESH_TRAIN_STEPS,
                                 layout=sharding.StateLayout(tree, mesh, cfg))
    part_equal = all(torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
                     for x, y in zip(tree_util.leaves(part), tree_util.leaves(tree)))
    check(part_equal, f"rank {dist.get_rank()}: its part of the checkpoint written under "
                      "the mesh does not restore bit-equal")
    del part
    out = dict(arch=LM_ARCH, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
               batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ, optimizer=MESH_TRAIN_OPT,
               loss=losses, ms_per_step=step_ms, launches=launches, bytes=nbytes,
               fsdp_collectives=fsdp, row_sums=row_sums,
               # The first step builds kernels and warms the allocator.
               data_sum=dict(data_sum, share_of_steps_after_the_first=sum(
                   data_sum["seconds"][1:]) / (1e-3 * sum(step_ms[1:]))),
               checkpoint_part_bit_equal=part_equal)
    if dist.get_rank() == 0:
        one, one_step, one_losses = fresh(), train_lib.make_train_step(cfg, hcfg, ocfg), []
        for s in range(MESH_TRAIN_STEPS):
            one, m = one_step(one, batch(s), step_generator(seed, s, dev))
            one_losses.append(float(m["loss"]))
        # One process restores the whole checkpoint: one rank's state's shapes.
        full, _ = restore_checkpoint(ckpt, one.as_pytree(), step=MESH_TRAIN_STEPS)
        lay = sharding.StateLayout(one.as_pytree(), mesh, cfg)
        out["checkpoint_bit_equal"] = all(
            torch.equal(lay.cut(i, x.cpu()).to(dev), y) if isinstance(y, torch.Tensor)
            else x == y for i, (x, y) in enumerate(zip(tree_util.leaves(full),
                                                       tree_util.leaves(tree))))
        check(out["checkpoint_bit_equal"], "a checkpoint written under the mesh did not "
              "restore bit-equal in one process")
        out["one_rank_loss"] = one_losses
        out["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
        worst = 0.0
        for x, y in zip(tree_util.leaves(full["params"]), tree_util.leaves(one.params)):
            excess = (x - y).abs() - (MESH_PARAM_TOL["atol"] + MESH_PARAM_TOL["rtol"] * y.abs())
            worst = max(worst, float(excess.max()))
        out["param_excess_over_tol"] = worst
        check(out["loss_rel_err"] <= MESH_LOSS_RTOL,
              f"sharded losses {losses} against one rank's {one_losses}")
        check(worst <= 0.0, "sharded parameters differ from one rank's beyond the reference's "
                            "bounds")
        del one, full
    dist.barrier()
    return out


def mesh_worker(out_dir: str, seed: int) -> int:
    """One rank of phase 13's world (started by ``torchrun``): (a) on a
    (1, 4) mesh, (b) on (2, 2) and (4, 1), (c) on (2, 2); its results to
    ``rank<r>.json``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(MESH_DEVICE)
    mesh = make_host_mesh(MESH_RANKS, MESH_DEVICE, timeout_s=MESH_TIMEOUT_S)
    res = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "collectives": mesh_collectives(mesh, dev, seed)}
    torch.cuda.empty_cache()
    mesh22 = make_host_mesh(MESH_RANKS // 2, MESH_DEVICE, timeout_s=MESH_TIMEOUT_S)
    mesh41 = make_host_mesh(1, MESH_DEVICE, timeout_s=MESH_TIMEOUT_S)
    res["rows_sum"] = mesh_rows_sum({"2x2": mesh22, "4x1": mesh41}, dev, seed)
    torch.cuda.empty_cache()
    res["train"] = mesh_train(mesh22, dev, seed, out_dir)
    Path(out_dir, f"rank{res['rank']}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def torchrun(n: int, argv: list, timeout: float) -> str:
    """Run ``torchrun --standalone --nproc-per-node n argv`` in its own
    session; any rank's failure, or the time limit, is fatal, and the whole
    session is killed then."""
    import os
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n)] + argv
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"{' '.join(argv[:3])}: no result within {timeout} s")
    first = err.find("Traceback")        # a rank's own error, before torchrun's summary
    check(proc.returncode == 0, f"{' '.join(argv[:3])} exited {proc.returncode}:\n"
                                f"{err[max(first, 0):max(first, 0) + 4000]}\n...\n{err[-1500:]}")
    return out


def mesh_serve_args(path: str, seed: int) -> list:
    base = ["--arch", SERVE_ARCH, "--full", "--gen", str(SERVE_GEN), "--seed", str(seed + 42)]
    if path == "engine":
        return base + ["--batch", str(MESH_ENGINE_BATCH), "--prompt-len",
                       str(MESH_ENGINE_PROMPT), "--topk-beam", str(SERVE_BEAM)]
    return base + ["--lockstep", "--batch", str(SERVE_BATCH), "--prompt-len",
                   str(SERVE_PROMPT), "--topk-beam", str(SERVE_BEAM if path == "beam" else 0)]


def mesh_path(dev, seed, card) -> dict:
    """Phase 13: (a) and (c) in one world of 4 ranks on the card; (d) the
    serving launcher as a one-rank NCCL world ((b), the serving launcher on
    2 ranks, is phase 14's (a) since the trunk is sharded). Returns the
    launches of every rank of every world."""
    t_phase = time.perf_counter()
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        torchrun(MESH_RANKS, [__file__, "--mesh-worker", tmp, "--seed", str(seed)],
                 timeout=MESH_TIMEOUT_S + 120)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    for r in ranks:
        check(r["backend"] == "gloo", f"rank {r['rank']} ran on {r['backend']}")
        total["gather_scores"] += r["collectives"]["scores"]["gather_scores_launches"]
        check(r["train"]["launches"]["sampled_head_loss"] == MESH_TRAIN_STEPS,
              f"rank {r['rank']}: sampled_head_loss {r['train']['launches']}")
        want_seg = sum_launches(r["train"]["row_sums"])
        check(r["train"]["launches"]["segment_stats"] == want_seg,
              f"rank {r['rank']}: segment_stats {r['train']['launches']}, not {want_seg}")
        check_row_sums(f"rank {r['rank']}'s mesh step", r["train"]["row_sums"])
        for name, n in r["train"]["launches"].items():
            total[name] += n
    print(json.dumps({"mesh_collectives": dict(card=card, ranks=[
        dict(rank=r["rank"], **r["collectives"]) for r in ranks])}))
    print(json.dumps({"mesh_rows_sum": dict(card=card, ranks=[
        dict(rank=r["rank"], **r["rows_sum"]) for r in ranks])}))
    print(json.dumps({"mesh_train": dict(card=card, lead=ranks[0]["train"], ranks=[
        dict(rank=r["rank"], loss=r["train"]["loss"], ms_per_step=r["train"]["ms_per_step"],
             launches=r["train"]["launches"],
             data_sum_bytes_by_step=[[c["bytes"] for c in st] for st in r["train"]["row_sums"]],
             data_sum_bound_bytes_by_step=[[c["bound_bytes"] for c in st]
                                           for st in r["train"]["row_sums"]])
        for r in ranks])}))

    # (d) one rank of NCCL.
    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--arch", SERVE_ARCH, "--reduced", "--lockstep", "--topk-beam", "8",
                 "--seed", str(seed)]
        out = torchrun(1, ["-m", "repro_torch.launch.serve", *flags, "--device", "cuda",
                           "--report-dir", tmp], timeout=300)
        nccl = json.loads(Path(tmp, "serve_rank0.json").read_text())
    check("backend nccl" in out, f"one-rank world not on NCCL: {out[:200]}")
    small = serve.build(SERVE_ARCH, reduced=True, head="adversarial_ns", seed=seed, device=dev)
    with torch.no_grad(), contextlib.redirect_stdout(sys.stderr):
        want = serve.run_lockstep(serve.parse_args(flags), *small, dev)["tokens"].tolist()
    check(nccl["tokens"] == want, "the NCCL world's tokens differ from the one-process run's")
    for name, n in nccl["launches"].items():
        total[name] += n
    result = dict(card=card, wall_s=time.perf_counter() - t_phase, launches=dict(total),
                  nccl=dict(tokens_equal=True, launches=nccl["launches"]))
    print(json.dumps({"mesh_path": result}))
    return dict(total)


# ---------------------------------------------------------------------------
# Phase 14: the trunk sharded over the mesh's model axis.
# ---------------------------------------------------------------------------

# (a): the serving launcher on h2o-danube-3-4b, (model ranks, path).
TP_PATHS = ((2, "dense"), (2, "beam"), (2, "engine"), (4, "dense"))
# (a) runs 4 of the 24 layers at full width (printed as ``reduced``): cut
# for the time limit once phase 15 took FSDP's cases, and again when phases
# 15 (f) and 16 came (phase 9 serves the whole depth on one rank).
TP_DANUBE_LAYERS = 4
TP_MOE_ARCH, TP_MOE_RANKS = "deepseek-moe-16b", 4
TP_MOE_LAYERS = 8               # of 28, full width: (b)'s depth, cut for the time limit
TP_HYB_ARCH, TP_HYB_RANKS = "hymba-1.5b", 2
TP_HYB_LENGTHS = (1, 586, 1171, 1756, 2341, 2926, 3511, 4096)   # one burst, 8 lanes
TP_HYB_LAYERS = 4                # of 32, full width: (c)'s depth, cut for the time limit
TP_HYB_PREFILL = (2, 4096)       # the hinted prefill's (B, S): S even, so the hint splits it
# Sharded against one rank, bf16: each rank's part of a sum over heads,
# d_ff or experts is a float32 partial (a bf16 GEMM writing float32), the
# parts are summed in float32 and rounded once, as one rank's GEMM rounds
# its output once; only the order of the float32 sums differs. Held to the
# bound served requests meet against the cache-free forward (phase 9).
TP_REL_RMS_TOL = SERVE_REL_RMS_TOL
# deepseek-moe-16b's bf16 run flips near-tie routings between any two
# orders of its sums, and a flipped token's hidden moves far: with the
# partials rounded once its prefill's last hiddens still lie 0.15 from one
# rank's (0.064 with them rounded twice), though 99.97% of layer 0's top-k
# ids in the run agree. So they are not held in bf16: its float32 model,
# at full width cut to TP_F32_LAYERS layers (a float32 copy of all 28
# would not fit the card beside the ranks'), holds them and the decode's
# scores to TP_REL_RMS_TOL of one rank's; bf16 holds the scores. hymba's
# (c) prefill is checked in float32 as well as in bf16.
TP_F32_LAYERS = 4


def tp_expected_bytes(cfg, tp: int) -> dict:
    """The one-rank trunk's bytes (bf16 matrices, as ``serve.build`` casts
    them), split over ``model`` and whole, and what a rank of ``tp`` holds."""
    from repro_torch.parallel import sharding
    full = transformer.init_params(torch.Generator(), cfg, device="meta", cast=True)
    b = sharding.split_bytes({"layers": full["layers"]}, cfg, (1, tp))
    return dict(one_rank=sharding.tree_bytes(full["layers"]), split=b.model, whole=b.whole,
                rank=b.a_rank((1, tp)))


def tp_scores_gate(ref: dict, parts: list, vocab: int) -> dict:
    """The prefill's last hiddens of every rank and the teacher-forced
    dense scores (the ranks' vocabulary slices put together) against the
    one-rank run's, relative RMS (the largest over ranks and steps)."""
    parts = sorted(parts, key=lambda p: p["lo"])
    scores = torch.cat([p["scores"] for p in parts], dim=-1)[..., :vocab]
    want = ref["scores"][..., :vocab]
    step_rms = [rel_rms(scores[t], want[t]) for t in range(want.shape[0])]
    prefill = max(rel_rms(p["prefill_last"], ref["prefill_last"]) for p in parts)
    return dict(prefill_rel_rms=prefill, scores_rel_rms_max=max(step_rms),
                scores_rel_rms_mean=sum(step_rms) / len(step_rms), steps=len(step_rms))


def tp_engine_gate(ref: dict, parts: list) -> dict:
    """An engine's ``HiddenTap`` tensors on every rank against the one-rank
    run's: each prefilled row's last hidden and each request's hidden at
    its first decode step, relative RMS (the largest over ranks)."""
    out = {}
    for key in ("prefill_last", "decode_first"):
        for p in parts:
            check(p[key].shape == ref[key].shape,
                  f"{key}: {tuple(p[key].shape)} against one rank's {tuple(ref[key].shape)}")
        out[f"{key}_rel_rms"] = max(rel_rms(p[key], ref[key]) for p in parts)
    return out


def tp_rank_rows(reports: list, run_s) -> list:
    """Each rank's ms a token, collective share, peak GiB and launches."""
    rows = []
    for rep in reports:
        tc = rep["trunk_collectives"]
        secs = run_s(rep)
        rows.append(dict(rank=rep["rank"], trunk_bytes=rep["bytes"]["trunk"],
                         params_bytes=rep["bytes"]["params"],
                         ms_per_token=rep.get("ms_per_token"),
                         ms_per_step=rep.get("ms_per_step"), run_s=secs,
                         collective_calls=tc["calls"], collective_bytes=tc["bytes"],
                         collective_s=tc["seconds"], collective_share=tc["seconds"] / secs,
                         peak_gib=(rep["peak_bytes"] or 0) / 2 ** 30,
                         launches=rep["launches"]))
    return rows


def tp_common_gates(name: str, reports: list, one_tokens, expected: dict) -> float:
    """Every rank's tokens equal to every other rank's, every rank's trunk
    bytes the split leaves' share plus the whole ones. Returns the share of
    the tokens equal to the one-rank run's (printed, not gated)."""
    for rep in reports:
        check(rep["tokens"] == reports[0]["tokens"],
              f"{name}: rank {rep['rank']}'s tokens differ from rank 0's")
        check(rep["bytes"]["trunk"] == expected["rank"],
              f"{name}: rank {rep['rank']} holds {rep['bytes']['trunk']} trunk bytes, "
              f"not {expected['rank']} ({expected})")
    got = [x for row in reports[0]["tokens"] for x in row]
    want = [x for row in one_tokens for x in row]
    check(len(got) == len(want), f"{name}: {len(got)} tokens against {len(want)}")
    return sum(a == b for a, b in zip(got, want)) / len(want)


def tp_danube(dev, seed, card, total) -> list:
    """(a) h2o-danube-3-4b at full width, TP_DANUBE_LAYERS of its layers,
    through the serving launcher's steps, every rank on the card: (1, 2)
    dense, beam 64 and the engine burst, (1, 4) dense; the one-rank runs of
    the same flags here first."""
    cfg, params, state, hcfg = serve.build(SERVE_ARCH, reduced=False, head="adversarial_ns",
                                           seed=seed + 42, device=dev,
                                           num_layers=TP_DANUBE_LAYERS)
    full_layers = configs.get_config(SERVE_ARCH).num_layers
    one, one_ms, ref = {}, {}, {}
    for path in ("dense", "beam", "engine"):
        args = serve.parse_args(mesh_serve_args(path, seed) + ["--device", "cuda"])
        with torch.no_grad(), contextlib.redirect_stdout(sys.stderr):
            if path == "engine":
                run = serve.run_engine(args, cfg, params, state, hcfg, dev, tap=True)
                one[path] = [[int(x) for x in h.tokens] for h in run["handles"]]
                ref[path] = run["hiddens"]
            else:
                run = serve.run_lockstep(args, cfg, params, state, hcfg, dev)
                one[path] = run["tokens"].tolist()
                one_ms[path] = run["decode_ms"] / run["steps"]
                if path == "dense":
                    ref[path] = serve.teacher_forced(args, cfg, params, state, hcfg, dev,
                                                     run["tokens"], run=run)
    del params, state, run
    torch.cuda.empty_cache()
    rows, worlds = [], {}
    for tp in sorted({tp for tp, _ in TP_PATHS}):      # one world a mesh, its paths in turn
        paths = [path for t, path in TP_PATHS if t == tp]
        with tempfile.TemporaryDirectory() as tmp:
            runs = []
            for path in paths:
                teacher = []
                if path == "dense":
                    np.save(Path(tmp, "teacher.npy"), np.asarray(one[path], np.int64))
                    teacher = ["--teacher-tokens", str(Path(tmp, "teacher.npy"))]
                runs.append([*mesh_serve_args(path, seed), "--device", MESH_DEVICE,
                             "--model-axis", str(tp), "--shard-scores", "--time-collectives",
                             "--report-dir", str(Path(tmp, path)), *teacher])
            Path(tmp, "argv.json").write_text(json.dumps(runs))
            t_world = time.perf_counter()
            out = torchrun(tp, [__file__, "--tp-worker", tmp, "--tp-case", "danube",
                                "--seed", str(seed)], timeout=600)
            world_s = time.perf_counter() - t_world
            for path in paths:
                worlds[tp, path] = out, world_s, [
                    json.loads(Path(tmp, path, f"serve_rank{r}.json").read_text())
                    for r in range(tp)], ([
                        torch.load(Path(tmp, path, f"serve_rank{r}.pt"), weights_only=False)
                        for r in range(tp)] if path in ref else None)
    for tp, path in TP_PATHS:
        expected = tp_expected_bytes(cfg, tp)
        name = f"{SERVE_ARCH} {path} (1, {tp})"
        out, world_s, reports, forced = worlds[tp, path]
        check(f"over {tp} ranks, backend gloo" in out, f"{name}: {out[:300]}")
        equal_share = tp_common_gates(name, reports, one[path], expected)
        row = dict(arch=SERVE_ARCH, path=path, mesh=[1, tp], card=card, world_s=world_s,
                   reduced={"num_layers": [full_layers, TP_DANUBE_LAYERS]},
                   tokens_equal_one_rank_share=equal_share, bytes=expected,
                   one_rank_ms_per_token=one_ms.get(path))
        if path == "engine":
            row.update(tp_engine_gate(ref[path], forced))
        elif forced is not None:
            row.update(tp_scores_gate(ref[path], forced, cfg.vocab_size))
            row["teacher_collective_s"] = [f["trunk_collectives"]["seconds"] for f in forced]
        for rep in reports:
            if "steps" in rep:
                rep["ms_per_token"] = rep["decode_ms"] / rep["steps"]
            for k, n in rep["launches"].items():
                total[k] += n
        row["ranks"] = tp_rank_rows(reports, lambda rep: 1e-3 * (
            rep["wall_ms"] if "wall_ms" in rep else rep["prefill_ms"] + rep["decode_ms"]))
        print(json.dumps({"tp_path": row}))
        beam = path != "dense"      # the engine burst runs at beam 64
        for rep in reports:
            check((rep["launches"]["gather_scores"] > 0) == beam
                  and (rep["launches"]["tree_logprob_all"] > 0) != beam,
                  f"{name}: rank {rep['rank']}'s launches {rep['launches']}")
        if path == "engine":
            check(row["prefill_last_rel_rms"] <= TP_REL_RMS_TOL
                  and row["decode_first_rel_rms"] <= TP_REL_RMS_TOL,
                  f"{name}: the engine's prefill {row['prefill_last_rel_rms']}, first decode "
                  f"step {row['decode_first_rel_rms']} relative RMS from one rank")
        elif forced is not None:
            check(row["prefill_rel_rms"] <= TP_REL_RMS_TOL
                  and row["scores_rel_rms_max"] <= TP_REL_RMS_TOL,
                  f"{name}: prefill {row['prefill_rel_rms']}, scores "
                  f"{row['scores_rel_rms_max']} relative RMS from one rank")
        rows.append(row)
    return rows


def route_recorder(store: list):
    """A stand-in for ``moe._route`` that keeps its first call's input and
    top-k ids (layer 0 of a prefill) on the host."""
    from repro_torch.models import moe as moe_lib
    route = moe_lib._route

    def rec(cfg, params, xt):
        out = route(cfg, params, xt)
        if not store:
            store.append((xt.detach().cpu(), out[1].detach().cpu()))
        return out

    return rec


def moe_drops(cfg, idx: torch.Tensor) -> int:
    """Assignments past their expert's capacity, each row a group, from the
    (B, S, k) top-k ids."""
    from repro_torch.models import moe as moe_lib
    b, s, _ = idx.shape
    flat = idx.reshape(b, -1).long()
    counts = torch.zeros((b, cfg.n_experts), dtype=torch.int64).scatter_add_(
        1, flat, torch.ones_like(flat))
    return int((counts - moe_lib._capacity(cfg, s)).clamp(min=0).sum())


def tp_moe_args(seed: int, device: str) -> list:
    return ["--arch", TP_MOE_ARCH, "--full", "--lockstep", "--batch", str(MOE_BATCH),
            "--prompt-len", str(MOE_PROMPT), "--gen", str(SERVE_GEN), "--seed",
            str(seed + 43), "--device", device]


def tp_moe_f32(args, dev, seed: int, tokens=None, mesh=None) -> tuple:
    """deepseek-moe-16b in float32 at full width, TP_F32_LAYERS layers: the
    lock-step run's tokens and the decode fed ``tokens`` (its own when
    None), as ``serve.teacher_forced`` gives it. Everything is freed after."""
    cfg, params, state, hcfg = serve.build(
        TP_MOE_ARCH, reduced=False, head="adversarial_ns", seed=seed, device=dev, mesh=mesh,
        num_layers=TP_F32_LAYERS, dtype="float32")
    with torch.no_grad(), contextlib.redirect_stdout(sys.stderr):
        run = serve.run_lockstep(args, cfg, params, state, hcfg, dev, mesh=mesh)
        forced = serve.teacher_forced(args, cfg, params, state, hcfg, dev,
                                      run["tokens"] if tokens is None else tokens,
                                      mesh=mesh, run=run)
    out = run["tokens"], forced
    del params, state, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_danube_worker(out_dir: str) -> int:
    """One rank of an (a) world: the serving launcher (``serve.main``) on
    each flag list of ``argv.json`` in turn, its model built at
    TP_DANUBE_LAYERS layers. The runs share the world's process group (the
    launcher joins one that exists): each run's teardown is held back but
    the last's, so the world starts once for its paths."""
    import torch.distributed as dist
    build = serve.build
    serve.build = lambda *a, **kw: build(*a, num_layers=TP_DANUBE_LAYERS, **kw)
    runs = json.loads(Path(out_dir, "argv.json").read_text())
    for i, argv in enumerate(runs):
        held = {} if i == len(runs) - 1 else dict(destroy_process_group=lambda *a, **kw: None)
        with swapped(dist, **held):
            rc = serve.main(argv)
        if rc:
            return rc
    return 0


def tp_worker(out_dir: str, case: str, seed: int) -> int:
    """One rank of a phase 14 world (started by ``torchrun``): (b) the
    MoE model on (1, 4) or (c) the hybrid one on (1, 2), under the hints;
    its results to ``rank<r>.json`` and ``rank<r>.pt``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel.collectives import TRUNK
    from repro_torch.parallel.hints import sharding_hints
    dev = torch.device(MESH_DEVICE)
    tp = TP_MOE_RANKS if case == "moe" else TP_HYB_RANKS
    mesh = make_host_mesh(tp, MESH_DEVICE, timeout_s=MESH_TIMEOUT_S)
    r = dist.get_rank()
    ref = torch.load(Path(out_dir, "ref.pt"), weights_only=False)
    arch, build_seed = (TP_MOE_ARCH, seed + 43) if case == "moe" else (TP_HYB_ARCH, seed + 44)
    big = {}
    if case == "moe":        # the small float32 check first: nothing else on the card yet
        args = serve.parse_args(tp_moe_args(seed, MESH_DEVICE))
        big["forced_f32"] = tp_moe_f32(args, dev, build_seed, ref["tokens_f32"], mesh)[1]
    cfg, params, state, hcfg = serve.build(
        arch, reduced=False, head="adversarial_ns", seed=build_seed, device=dev, mesh=mesh,
        num_layers=TP_MOE_LAYERS if case == "moe" else TP_HYB_LAYERS)
    res = {"rank": r, "backend": dist.get_backend(),
           "bytes": serve.param_bytes(cfg, params, mesh)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_engine_counters()
    TRUNK.reset()
    TRUNK.timed = True
    if case == "moe":
        routes = []
        with swapped(moe_lib, _route=route_recorder(routes)), torch.no_grad(), \
                contextlib.redirect_stdout(sys.stderr):
            run = serve.run_lockstep(args, cfg, params, state, hcfg, dev, mesh=mesh)
        res.update(tokens=run["tokens"].tolist(), prefill_ms=run["prefill_ms"],
                   decode_ms=run["decode_ms"], steps=run["steps"],
                   ms_per_token=run["decode_ms"] / run["steps"],
                   run_layer0_route_share=float((routes[0][1] == ref["idx0"]).float().mean()))
    else:
        from repro_torch.serve import Engine, Request, ServeConfig
        eng = Engine(cfg, hcfg, params, state, ServeConfig(
            n_slots=FAM_SLOTS, max_len=max(TP_HYB_LENGTHS) + FAM_GEN, page_len=FAM_PAGE_LEN,
            cache_dtype=torch.bfloat16, mesh=mesh))
        tap = serve.HiddenTap(eng)
        t0 = time.perf_counter()
        with sharding_hints(mesh), torch.no_grad():
            handles = [eng.submit(Request(prompt=p, max_new_tokens=FAM_GEN))
                       for p in ref["prompts"]]
            eng.run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        eng.pool.check_invariants()
        big["engine"] = tap.tensors()
        tokens = sum(len(h.tokens) for h in handles)
        res.update(tokens=[[int(x) for x in h.tokens] for h in handles], wall_ms=wall_ms,
                   decode_steps=eng.decode_steps, tokens_per_s=1e3 * tokens / wall_ms,
                   ms_per_step=wall_ms / eng.decode_steps,
                   arena_bytes=eng.stats()["arena_bytes_this_rank"])
    torch.cuda.synchronize()
    res.update(launches={k: v for k, v in engine_counts().items() if k in ENGINE_KERNELS},
               trunk_collectives=dataclasses.asdict(TRUNK),
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    TRUNK.timed = False
    with torch.no_grad():
        if case == "moe":
            big["forced"] = serve.teacher_forced(args, cfg, params, state, hcfg, dev,
                                                 ref["tokens"], mesh=mesh, run=run)
            routes = []
            with swapped(moe_lib, _route=route_recorder(routes)):
                y = moe_lib.moe_ffn(params["layers"][0]["moe"], cfg, ref["x0"].to(dev),
                                    mesh=mesh)[0]
            res.update(layer0_route_equal=bool(torch.equal(routes[0][1], ref["idx0"])),
                       layer0_drops=moe_drops(cfg, routes[0][1]),
                       layer0_out_rel_rms=rel_rms(y.cpu(), ref["y0"]))
        else:
            toks = ref["prefill_tokens"].to(dev)
            b, s = TP_HYB_PREFILL

            def run_prefill(model_cfg, model):
                cache = transformer.init_cache(model_cfg, b, s, device=dev, mesh=mesh)
                return make_prefill(model_cfg, mesh=mesh)(model, toks, cache)[0]

            plain = run_prefill(cfg, params)
            with sharding_hints(mesh):
                hinted = run_prefill(cfg, params)
            TRUNK.reset()
            with sharding_hints(mesh, seq_parallel_residual=True):
                sp = run_prefill(cfg, params)
            res["sp_trunk"] = dict(calls=TRUNK.calls, bytes=TRUNK.bytes)
            res.update(hint_vs_plain_rel_rms=rel_rms(hinted, plain),
                       bf16_vs_one_bf16_rel_rms=rel_rms(hinted[:, -1].cpu(), ref["last_bf16"]),
                       bf16_vs_one_f32_rel_rms=rel_rms(hinted[:, -1].cpu(), ref["last_f32"]),
                       sp_vs_plain_rel_rms=rel_rms(sp, plain),
                       sp_bf16_vs_one_bf16_rel_rms=rel_rms(sp[:, -1].cpu(), ref["last_bf16"]))
            del params, plain, hinted, sp
            torch.cuda.empty_cache()
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            params32 = transformer.init_params(torch.Generator(device=dev).manual_seed(
                build_seed), cfg32, device=dev, cast=True, mesh=mesh)
            with sharding_hints(mesh):
                h32 = run_prefill(cfg32, params32)
            with sharding_hints(mesh, seq_parallel_residual=True):
                sp32 = run_prefill(cfg32, params32)
            res["f32_vs_one_f32_rel_rms"] = rel_rms(h32[:, -1].cpu(), ref["last_f32"])
            res["sp_f32_vs_plain_rel_rms"] = rel_rms(sp32, h32)
            res["sp_f32_vs_one_f32_rel_rms"] = rel_rms(sp32[:, -1].cpu(), ref["last_f32"])
    Path(out_dir, f"rank{r}.json").write_text(json.dumps(res))
    if big:
        torch.save(big, Path(out_dir, f"rank{r}.pt"))
    dist.destroy_process_group()
    return 0


def tp_moe(dev, seed, card, total) -> dict:
    """(b) deepseek-moe-16b at full width, TP_MOE_LAYERS of its layers, on
    (1, 4), 16 of its 64 experts a rank: the one-rank lock-step run here
    (layer 0's routing and MoE output recorded on its real prefill input),
    then the world."""
    from repro_torch.models import moe as moe_lib
    cfg, params, state, hcfg = serve.build(TP_MOE_ARCH, reduced=False, head="adversarial_ns",
                                           seed=seed + 43, device=dev,
                                           num_layers=TP_MOE_LAYERS)
    args = serve.parse_args(tp_moe_args(seed, "cuda"))
    routes = []
    with swapped(moe_lib, _route=route_recorder(routes)), torch.no_grad(), \
            contextlib.redirect_stdout(sys.stderr):
        run = serve.run_lockstep(args, cfg, params, state, hcfg, dev)
    x0, idx0 = routes[0]
    with torch.no_grad():
        y0 = moe_lib.moe_ffn(params["layers"][0]["moe"], cfg, x0.to(dev))[0].cpu()
        forced = serve.teacher_forced(args, cfg, params, state, hcfg, dev, run["tokens"],
                                      run=run)
    one_ms = run["decode_ms"] / run["steps"]
    del run["cache"]
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    tokens32, forced32 = tp_moe_f32(args, dev, seed + 43)
    held_gib = torch.cuda.memory_reserved() / 2 ** 30     # this process's, during the world
    expected = tp_expected_bytes(cfg, TP_MOE_RANKS)
    name = f"{TP_MOE_ARCH} dense (1, {TP_MOE_RANKS})"
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(tokens=run["tokens"], x0=x0, idx0=idx0, y0=y0, tokens_f32=tokens32),
                   Path(tmp, "ref.pt"))
        torchrun(TP_MOE_RANKS, [__file__, "--tp-worker", tmp, "--tp-case", "moe", "--seed",
                                str(seed)], timeout=600)
        reports = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                   for r in range(TP_MOE_RANKS)]
        parts = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP_MOE_RANKS)]
    equal_share = tp_common_gates(name, reports, run["tokens"].tolist(), expected)
    row = dict(arch=TP_MOE_ARCH, path="dense", mesh=[1, TP_MOE_RANKS], card=card,
               reduced={"num_layers": [configs.get_config(TP_MOE_ARCH).num_layers,
                                       TP_MOE_LAYERS]},
               experts_per_rank=cfg.n_experts // TP_MOE_RANKS, reference_process_gib=held_gib,
               tokens_equal_one_rank_share=equal_share, bytes=expected, one_rank_ms_per_token=one_ms,
               layer0_drops_one_rank=moe_drops(cfg, idx0),
               bf16=tp_scores_gate(forced, [p["forced"] for p in parts], cfg.vocab_size),
               f32=dict(layers=TP_F32_LAYERS, **tp_scores_gate(
                   forced32, [p["forced_f32"] for p in parts], cfg.vocab_size)),
               layer0_out_rel_rms=[rep["layer0_out_rel_rms"] for rep in reports],
               run_layer0_route_share=[rep["run_layer0_route_share"] for rep in reports],
               ranks=tp_rank_rows(reports, lambda rep: 1e-3 * (rep["prefill_ms"]
                                                                + rep["decode_ms"])))
    print(json.dumps({"tp_path": row}))
    for rep in reports:
        check(rep["layer0_route_equal"] and rep["layer0_drops"] == row["layer0_drops_one_rank"],
              f"{name}: rank {rep['rank']}'s layer 0 routing differs from one rank's on the "
              "same input")
        check(rep["layer0_out_rel_rms"] <= TP_REL_RMS_TOL,
              f"{name}: layer 0's MoE output {rep['layer0_out_rel_rms']} from one rank's")
        for k, n in rep["launches"].items():
            total[k] += n
    f32, bf16 = row["f32"], row["bf16"]
    check(max(f32["prefill_rel_rms"], f32["scores_rel_rms_max"]) <= TP_REL_RMS_TOL,
          f"{name}: float32 at {TP_F32_LAYERS} layers: prefill {f32['prefill_rel_rms']}, "
          f"scores {f32['scores_rel_rms_max']} from one rank's")
    check(bf16["scores_rel_rms_max"] <= TP_REL_RMS_TOL,
          f"{name}: bf16 teacher-forced scores {bf16['scores_rel_rms_max']} from one rank's")
    return row


def sp_hybrid_prefill_trunk(cfg, tp: int) -> dict:
    """The trunk collectives of (c)'s prefill under ``seq_parallel_residual``
    (B, S) = TP_HYB_PREFILL, bf16, on (1, tp): in each layer an all-gather
    of the rank's S/tp rows (counted at the part sent) at each of three
    entries (the whole attention under the attention hint, the split SSM,
    the split MLP), a float32 reduce-scatter of the (B, S, d) partial at the
    SSM's and the MLP's exits (counted at the whole input) and the gated
    norm's float32 sum of squares (B, S, 1); after the last block one
    gather."""
    b, s = TP_HYB_PREFILL
    part, whole = b * s // tp * cfg.d_model * 2, b * s * cfg.d_model * 4
    n = cfg.num_layers
    return dict(calls=6 * n + 1, bytes=n * (3 * part + 2 * whole + b * s * 4) + part)


def tp_hybrid(dev, seed, card, total) -> dict:
    """(c) hymba-1.5b at full width on (1, 2), attention whole on each rank
    (25 heads), its 50 SSD heads split: the engine burst under
    ``sharding_hints``, and a (2, 4,096) prefill with and without the
    hints, against the one-rank run here."""
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg, params, state, hcfg = serve.build(TP_HYB_ARCH, reduced=False, head="adversarial_ns",
                                           seed=seed + 44, device=dev, num_layers=TP_HYB_LAYERS)
    rng = np.random.default_rng(seed + 44)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in TP_HYB_LENGTHS]
    prefill_tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, TP_HYB_PREFILL))
    eng = Engine(cfg, hcfg, params, state, ServeConfig(
        n_slots=FAM_SLOTS, max_len=max(TP_HYB_LENGTHS) + FAM_GEN, page_len=FAM_PAGE_LEN,
        cache_dtype=torch.bfloat16))
    tap = serve.HiddenTap(eng)
    t0 = time.perf_counter()
    with torch.no_grad():
        handles = [eng.submit(Request(prompt=p, max_new_tokens=FAM_GEN)) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0) / eng.decode_steps
        one_tokens = [[int(x) for x in h.tokens] for h in handles]
        one_engine = tap.tensors()
        cache = transformer.init_cache(cfg, *TP_HYB_PREFILL, device=dev)
        last_bf16 = make_prefill(cfg)(params, prefill_tokens.to(dev), cache)[0][:, -1].cpu()
    del params, state, eng, cache
    torch.cuda.empty_cache()
    # The same weights unrounded, in float32 (serve.build's draws, not cast).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.init_params(torch.Generator(device=dev).manual_seed(seed + 44),
                                       cfg32, device=dev, cast=True)
    with torch.no_grad():
        cache = transformer.init_cache(cfg32, *TP_HYB_PREFILL, device=dev)
        last_f32 = make_prefill(cfg32)(params32, prefill_tokens.to(dev), cache)[0][:, -1].cpu()
    one_bf16_vs_f32 = rel_rms(last_bf16, last_f32)
    del params32, cache
    torch.cuda.empty_cache()
    expected = tp_expected_bytes(cfg, TP_HYB_RANKS)
    name = f"{TP_HYB_ARCH} engine (1, {TP_HYB_RANKS}) hinted"
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(prompts=prompts, prefill_tokens=prefill_tokens, last_bf16=last_bf16,
                        last_f32=last_f32), Path(tmp, "ref.pt"))
        torchrun(TP_HYB_RANKS, [__file__, "--tp-worker", tmp, "--tp-case", "hybrid", "--seed",
                                str(seed)], timeout=600)
        reports = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                   for r in range(TP_HYB_RANKS)]
        parts = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)["engine"]
                 for r in range(TP_HYB_RANKS)]
    equal_share = tp_common_gates(name, reports, one_tokens, expected)
    row = dict(arch=TP_HYB_ARCH, path="engine dense, hinted", mesh=[1, TP_HYB_RANKS],
               card=card, reduced={"num_layers": [configs.get_config(TP_HYB_ARCH).num_layers,
                                                  TP_HYB_LAYERS]},
               prompt_lengths=list(TP_HYB_LENGTHS), gen=FAM_GEN,
               tokens_equal_one_rank_share=equal_share, bytes=expected,
               one_rank_ms_per_step=one_ms, engine=tp_engine_gate(one_engine, parts),
               prefill=dict(one_bf16_vs_one_f32_rel_rms=one_bf16_vs_f32, **{k: [
                   rep[k] for rep in reports] for k in (
                   "hint_vs_plain_rel_rms", "bf16_vs_one_bf16_rel_rms", "bf16_vs_one_f32_rel_rms",
                   "f32_vs_one_f32_rel_rms")}),
               seq_parallel_prefill=dict(
                   predicted_trunk=sp_hybrid_prefill_trunk(cfg, TP_HYB_RANKS), **{k: [
                       rep[k] for rep in reports] for k in (
                       "sp_trunk", "sp_vs_plain_rel_rms", "sp_bf16_vs_one_bf16_rel_rms",
                       "sp_f32_vs_plain_rel_rms", "sp_f32_vs_one_f32_rel_rms")}),
               arena_bytes=[rep["arena_bytes"] for rep in reports],
               tokens_per_s=[rep["tokens_per_s"] for rep in reports],
               ranks=tp_rank_rows(reports, lambda rep: 1e-3 * rep["wall_ms"]))
    print(json.dumps({"tp_path": row}))
    for rep in reports:
        check(max(rep["hint_vs_plain_rel_rms"], rep["bf16_vs_one_bf16_rel_rms"],
                  rep["f32_vs_one_f32_rel_rms"]) <= TP_REL_RMS_TOL,
              f"{name}: rank {rep['rank']}'s prefill: hinted against plain "
              f"{rep['hint_vs_plain_rel_rms']}; against one rank's, bf16 "
              f"{rep['bf16_vs_one_bf16_rel_rms']}, float32 {rep['f32_vs_one_f32_rel_rms']}")
        sp_errs = [rep[k] for k in ("sp_vs_plain_rel_rms", "sp_bf16_vs_one_bf16_rel_rms",
                                    "sp_f32_vs_plain_rel_rms", "sp_f32_vs_one_f32_rel_rms")]
        check(max(sp_errs) <= TP_REL_RMS_TOL,
              f"{name}: rank {rep['rank']}'s sequence-parallel prefill against the unhinted "
              f"and one rank's (bf16, bf16, float32, float32): {sp_errs}")
        want = row["seq_parallel_prefill"]["predicted_trunk"]
        check(rep["sp_trunk"] == want,
              f"{name}: rank {rep['rank']}'s sequence-parallel prefill issued trunk "
              f"collectives {rep['sp_trunk']}, not {want}")
        for k, n in rep["launches"].items():
            total[k] += n
    check(max(row["engine"].values()) <= TP_REL_RMS_TOL,
          f"{name}: the engine's hiddens {row['engine']} relative RMS from one rank's")
    return row


def sharded_trunk_path(dev, seed, card) -> dict:
    """Phase 14: (a), (b) and (c). Returns the launches of every rank."""
    t_phase = time.perf_counter()
    total, phase_s = collections.Counter(), {}
    rows = tp_danube(dev, seed, card, total)
    phase_s["a"] = time.perf_counter() - t_phase
    rows.append(tp_moe(dev, seed, card, total))
    phase_s["b"] = time.perf_counter() - t_phase - phase_s["a"]
    rows.append(tp_hybrid(dev, seed, card, total))
    phase_s["c"] = time.perf_counter() - t_phase - phase_s["a"] - phase_s["b"]
    print(json.dumps({"sharded_trunk_path": dict(card=card, wall_s=time.perf_counter() - t_phase,
                                                 phase_s=phase_s, paths=len(rows),
                                                 launches=dict(total))}))
    return dict(total)


# ---------------------------------------------------------------------------
# Phase 15: training with the trunk sharded over the mesh's model axis.
# ---------------------------------------------------------------------------

TPT_RANKS = 4                    # one world of 4 ranks on the one card, over gloo
# (name, arch, layers kept, model ranks, hinted, head, FSDP hint check): full
# width, cut in depth. (d) and (e) run FSDP on (2, 2) as (c) does.
# The hint column: False (none), True (``sharding_hints``: the attention
# hint) or "sp" (with ``seq_parallel_residual``, (f)).
TPT_CASES = (("stablelm", "stablelm-3b", 4, 4, False, "adversarial_ns", False),
             ("deepseek_moe", "deepseek-moe-16b", 2, 4, False, "adversarial_ns", False),
             ("hymba", "hymba-1.5b", 2, 2, True, "adversarial_ns", False),
             ("deepseek_moe_fsdp", "deepseek-moe-16b", 2, 2, False, "adversarial_ns", True),
             ("stablelm_softmax", "stablelm-3b", 2, 2, False, "softmax", False),
             ("stablelm_sp", "stablelm-3b", 2, 4, "sp", "adversarial_ns", False))
TPT_BATCH, TPT_SEQ, TPT_STEPS = 2, 256, 3
# SGD, as phase 13: its update is linear in the gradient (Adagrad's first
# step turns the float32 reordering of a sum at |g| near eps into
# parameter differences above the bounds, a property of the rule). The
# optimizer-state bytes are read on an Adagrad state of the same parts.
TPT_OPT = MESH_TRAIN_OPT
TPT_GRAD_REL_RMS = 1e-4          # each leaf's gradient against one rank's
TPT_TIMEOUT_S = 900
TPT_COUNTED = ("sampled_head_loss", "segment_stats", "flash_attention")
TPT_EXPERTS = ("moe/w_gate", "moe/w_up", "moe/w_down")
TPT_HINT_LAYERS = 1              # (d)'s bf16 hint check: its first layer (the time limit)
# The peak a rank may reach computing one step's gradients: what it holds
# (its parameters and state), its gradients, two gathered layers (the one
# being run or recomputed, and its gradient or the gather's own buffers),
# and the activations one rank's gradient on the whole global batch needs
# beyond what it holds and its gradients (that call's peak less those),
# an upper bound on a rank's with half the batch and a part of each
# layer. The optimizer's update is the same code with or without FSDP;
# the steps' peak is printed beside.
TPT_PEAK_GATHERED_LAYERS = 2


def sum_launches(row_sums: list) -> int:
    """``segment_stats`` launches of the sampled head's steps with these
    sums over ``data`` (:func:`recorded_row_sum`'s records, by step): the
    head's row sums (dw and db) and the embedding's (dw), 3 a step, and each
    sum over ``data`` by owner: the owner's dw (and db) sums, none where it
    received no row."""
    return sum(3 + sum((c["received"] > 0) * (1 + c["db"]) for c in step)
               for step in row_sums)


def check_row_sums(what: str, row_sums: list) -> None:
    for s, step in enumerate(row_sums):
        for c in step:
            check(c["bytes"] <= c["bound_bytes"],
                  f"{what}: step {s}'s sum over data held {c['bytes']} B, over its bound "
                  f"{c['bound_bytes']} B")


def tpt_launches_a_rank(head: str, row_sums: list) -> dict:
    """The launches of one rank's TPT_STEPS steps. The sampled head: its
    loss once a step; ``segment_stats`` as :func:`sum_launches` counts them
    (on a mesh with ``data`` > 1 the sums over ``data`` by owner, recorded
    a step in ``row_sums``). The dense ``softmax`` head and the dense
    embedding: none (plain torch under autograd). No ``flash_attention``
    (the plain attention)."""
    if head == "softmax":
        return {"sampled_head_loss": 0, "segment_stats": 0, "flash_attention": 0}
    return {"sampled_head_loss": TPT_STEPS, "segment_stats": sum_launches(row_sums),
            "flash_attention": 0}
# The training launcher under torchrun on (1, 2), bf16 (the reduced config's
# dtype): the row-parallel partial products' gradients on the card (mm and
# the experts' bmm), SM3's whole covers, the launcher's bytes.
TPT_LAUNCH = ["--arch", "deepseek-moe-16b", "--reduced", "--device", MESH_DEVICE,
              "--model-axis", "2", "--optimizer", "sm3", "--steps", "3", "--batch", "2",
              "--seq", "64"]


def tpt_sp_trunk(cfg, tp: int) -> dict:
    """(f)'s trunk collectives over TPT_STEPS steps under
    ``seq_parallel_residual`` on (1, tp), float32, heads and ``d_ff``
    split, each layer checkpointed (``cfg.remat``), by phase. Forward: at
    the attention's and the MLP's entries an all-gather of the rank's S/tp
    rows (counted at the part sent), at their exits a reduce-scatter of the
    (B, S, d) partial (counted at the whole input); after the last block
    one gather. Recompute: each layer's forward again up to the last
    tensor its backward saved (``torch.utils.checkpoint`` stops there), so
    without the MLP's exit reduce-scatter. Backward: each
    gather's transpose a reduce-scatter, each reduce-scatter's a gather, an
    all-reduce of each of the layer's two norm scales (used on the rank's
    rows alone), the embedding's split a gather; the last gather's
    transpose a slice, no collective."""
    part = TPT_BATCH * TPT_SEQ // tp * cfg.d_model * 4
    whole = TPT_BATCH * TPT_SEQ * cfg.d_model * 4
    n, k = cfg.num_layers, TPT_STEPS
    layer = 2 * part + 2 * whole
    return {"forward": dict(calls=k * (4 * n + 1), bytes=k * (n * layer + part)),
            "recompute": dict(calls=k * 3 * n, bytes=k * n * (2 * part + whole)),
            "backward": dict(calls=k * (6 * n + 1),
                             bytes=k * (n * (layer + 2 * cfg.d_model * 4) + part))}


@contextlib.contextmanager
def saved_layer_inputs(record: list):
    """Record the bytes of each checkpointed layer's input, what the layer
    keeps for its recompute (``transformer.forward``'s checkpoint)."""
    real = transformer.checkpoint_lib

    def checkpoint(fn, lp, x, **kw):
        record.append(x.untyped_storage().nbytes())
        return real.checkpoint(fn, lp, x, **kw)

    transformer.checkpoint_lib = type("Checkpoint", (), {"checkpoint": staticmethod(checkpoint)})
    try:
        yield record
    finally:
        transformer.checkpoint_lib = real


def tpt_cfg(arch: str, layers: int):
    return dataclasses.replace(configs.get_config(arch), num_layers=layers, dtype="float32")


def tpt_batch(cfg, seed: int, dev):
    from repro_torch.data import lm_batch_fn
    make = lm_batch_fn(cfg.vocab_size, TPT_BATCH, TPT_SEQ, seed=seed)
    return lambda s: {k: torch.as_tensor(v).to(dev) for k, v in make(s).items()}


def tpt_reference(name, arch, layers, head, dev, seed, tmp) -> dict:
    """One rank's gradients of the first step and parameters after
    TPT_STEPS steps, written to ``tmp`` for the ranks to slice (read
    mapped, never gathered), its losses, layer 0's routing, its ms a step
    and the activations its gradient needed (the peak of that call less
    what it held and the gradients); everything on the card freed after."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel import sharding
    cfg = tpt_cfg(arch, layers)
    hcfg = lm_head.head_config(cfg, head, reg=1e-4)
    ocfg = optim.OptimizerConfig(**TPT_OPT)
    state = train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed),
                                       cfg, ocfg, head, device=dev)
    batch = tpt_batch(cfg, seed, dev)
    routes = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    with swapped(moe_lib, _route=route_recorder(routes)):
        grads, _ = train_step_lib.make_grad_fn(cfg, hcfg)(state, batch(0),
                                                         step_generator(seed, 0, dev))
    torch.cuda.synchronize()
    activations = (torch.cuda.max_memory_allocated(dev) - held
                   - sharding.tree_bytes(grads))
    torch.save(tree_util.tree_map(lambda t: t.cpu(), grads), Path(tmp, f"{name}_grads.pt"))
    del grads
    step = train_lib.make_train_step(cfg, hcfg, ocfg)
    losses, ms = [], []
    for s in range(TPT_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch(s), step_generator(seed, s, dev))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    torch.save(tree_util.tree_map(lambda t: t.cpu(), state.params),
               Path(tmp, f"{name}_params.pt"))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=ms, idx0=routes[0][1] if routes else None,
                activation_bytes=activations)


def tpt_grad_errors(cfg, mesh, grads, ref) -> tuple:
    """The largest relative RMS over the leaves of a rank's gradients
    against its slice of one rank's (a sampled head's and a sparse
    embedding's ``SparseRows``: whole with one data rank, else the rank's
    ``model`` slice of the rows, as the sum over ``data`` leaves them; a
    dense head's and embedding's rows the rank's slice), and its leaf."""
    from repro_torch.parallel import collectives, sharding
    sliced = bool(collectives.data_sum_axes(mesh))
    lo, hi = sharding.row_range(cfg.padded_vocab, mesh)

    def err(got, want) -> float:        # a leaf whose reference is all zero: exact
        if float(want.float().abs().max()) == 0.0:
            return 0.0 if float(got.float().abs().max()) == 0.0 else float("inf")
        return rel_rms(got, want)

    worst, at = 0.0, None
    rows = [k for k in ("head", "embed") if sparse_lib.is_sparse(grads[k])]
    for key in rows:
        g, r = grads[key], ref[key]
        if sliced:
            keep = (r.ids >= lo) & (r.ids < hi)
            r = sparse_lib.SparseRows(r.ids[keep], r.dw[keep],
                                      None if r.db is None else r.db[keep])
        n = int(max(int(g.ids.max()), int(r.ids.max()))) + 1
        for part in ("dw", "db"):
            if getattr(r, part) is None:
                continue
            a = torch.zeros((n,) + tuple(getattr(g, part).shape[1:]), device=g.ids.device)
            b = torch.zeros_like(a)
            a.index_add_(0, g.ids, getattr(g, part))
            b.index_add_(0, r.ids.to(a.device), getattr(r, part).to(a.device))
            e = err(a, b)
            if e > worst:
                worst, at = e, f"{key}/{part}"
    rest = {k: v for k, v in ref.items() if k not in rows}
    want = sharding.shard_train_state(rest, mesh, cfg)
    for (path, r), g in zip(tree_util.flatten_with_paths(want)[0],
                            tree_util.leaves({k: grads[k] for k in rest})):
        e = err(g, r.to(g.device))
        if e > worst:
            worst, at = e, "/".join(path)
    return worst, at


def whole_digest(cfg, mesh, params) -> str:
    """A digest of the bytes of every leaf a rank holds whole."""
    import hashlib
    from repro_torch.parallel import sharding
    h = hashlib.sha256()
    for (path, x), (_, sp) in zip(tree_util.flatten_with_paths(params)[0],
                                  sharding.train_state_spec(cfg, mesh, params)):
        if not sharding.split_axes(sp, mesh):
            h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def tpt_fsdp_hint(cfg, hcfg, mesh, state, batch, seed, dev) -> dict:
    """(d)'s hints in bf16, on the case's first TPT_HINT_LAYERS layers: one
    step's gradients without and with ``fsdp_gather_weights`` (the expert
    leaves cast to bf16 on each rank's part before the gather)
    bit-equal, the expert leaves' gather bytes halved and every other
    count the same. Both under ``torch.use_deterministic_algorithms``: the
    MoE's token gathers have a backward that adds with atomics on the
    card, in no fixed order."""
    from repro_torch.parallel.collectives import FSDP, TRUNK
    from repro_torch.parallel.hints import sharding_hints
    bcfg = dataclasses.replace(cfg, dtype="bfloat16", num_layers=TPT_HINT_LAYERS)
    state = state._replace(params={**state.params,
                                   "layers": state.params["layers"][:TPT_HINT_LAYERS]})
    runs = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    for name, hints in (("plain", None), ("hinted", dict(fsdp_gather_weights=True))):
        FSDP.reset()
        TRUNK.reset()
        with sharding_hints(mesh, **hints) if hints else contextlib.nullcontext():
            grads, m = train_step_lib.make_grad_fn(bcfg, hcfg, mesh=mesh)(
                state, batch(0), step_generator(seed, 0, dev))
        runs[name] = (tree_util.leaves(grads), float(m["loss"]), dict(FSDP.leaves),
                      {p: c["calls"] for p, c in FSDP.phases.items()},
                      {p: c["calls"] for p, c in TRUNK.phases.items()})
        del grads
    torch.use_deterministic_algorithms(deterministic)
    (ga, la, ba, fa, ta), (gb, lb, bb, fb, tb) = runs["plain"], runs["hinted"]
    equal = la == lb and all(torch.equal(x, y) for x, y in zip(ga, gb)
                             if isinstance(x, torch.Tensor))
    halved = all(bb[k] == (v // 2 if k in TPT_EXPERTS else v) for k, v in ba.items()) and \
        all(k in ba for k in TPT_EXPERTS)
    return dict(bit_equal=equal, expert_bytes_halved=halved, same_calls=fa == fb and ta == tb,
                gather_bytes={"plain": ba, "hinted": bb})


def tpt_case(name, arch, layers, tp, hinted, head, fsdp_hint, dev, seed, tmp, ref) -> dict:
    """One case on one rank of the world (module docstring's phase 15)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import FSDP, TRUNK
    from repro_torch.parallel.hints import sharding_hints
    mesh = make_host_mesh(tp, MESH_DEVICE, timeout_s=MESH_TIMEOUT_S)
    cfg = tpt_cfg(arch, layers)
    hcfg = lm_head.head_config(cfg, head, reg=1e-4)
    ocfg = optim.OptimizerConfig(**TPT_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = train_lib.init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                                       ocfg, head, device=dev, mesh=mesh)
    adagrad = optim.OptimizerConfig(name="adagrad")
    nbytes = launch_train.state_bytes(cfg, adagrad, state._replace(
        opt_state=init_opt_state(adagrad, state.params)), mesh)
    batch = tpt_batch(cfg, seed, dev)
    hint = ((lambda: sharding_hints(mesh, seq_parallel_residual=hinted == "sp")) if hinted
            else contextlib.nullcontext)
    routes = []
    t_case = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    saved = {"hinted": [], "plain": []}
    from repro_torch.parallel import collectives
    checked = []
    owner_sum = (recorded_row_sum(checked, checked=True) if sharding.size(mesh, "data") > 1
                 else collectives.sum_rows_over_data)
    with swapped(moe_lib, _route=route_recorder(routes)), hint(), \
            saved_layer_inputs(saved["hinted"]), \
            swapped(collectives, sum_rows_over_data=owner_sum):
        grads, _ = train_step_lib.make_grad_fn(cfg, hcfg, mesh=mesh)(
            state, batch(0), step_generator(seed, 0, dev))
    torch.cuda.synchronize()
    refs = torch.load(Path(tmp, f"{name}_grads.pt"), mmap=True, weights_only=False)
    out = dict(rank=dist.get_rank(), bytes=nbytes, grad_bytes=sharding.tree_bytes(grads),
               held_bytes=held, peak_bytes=torch.cuda.max_memory_allocated(dev),
               checked_row_sums=checked)
    out["grad_rel_rms"], out["grad_worst_leaf"] = tpt_grad_errors(cfg, mesh, grads, refs)
    trunk = lambda g: tree_util.leaves({k: v for k, v in g.items()  # noqa: E731
                                        if k not in ("head", "embed")})
    if hinted:
        with saved_layer_inputs(saved["plain"]):
            plain, _ = train_step_lib.make_grad_fn(cfg, hcfg, mesh=mesh)(
                state, batch(0), step_generator(seed, 0, dev))
        out["hint_vs_plain_rel_rms"] = max(
            rel_rms(a, b) for a, b in zip(trunk(grads), trunk(plain)))
        out["saved_layer_input_bytes"] = saved
        del plain
    if ref["idx0"] is not None:     # a data rank routes its rows of the batch
        want = ref["idx0"][sharding.batch_slice(ref["idx0"].shape[0], mesh)]
        out["layer0_route_equal"] = bool(torch.equal(routes[0][1], want))
    del grads, refs
    if fsdp_hint:
        t0 = time.perf_counter()
        out["fsdp_hint"] = tpt_fsdp_hint(cfg, hcfg, mesh, state, batch, seed, dev)
        out["fsdp_hint"]["seconds"] = time.perf_counter() - t0
    step = train_lib.make_train_step(cfg, hcfg, ocfg, mesh=mesh)
    for k in TPT_COUNTED:
        getattr(ops, k).launches = 0
    TRUNK.reset()
    FSDP.reset()
    TRUNK.timed = FSDP.timed = True
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, row_sums = [], [], []
    with hint():
        for s in range(TPT_STEPS):
            row_sums.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with swapped(collectives, sum_rows_over_data=recorded_row_sum(row_sums[-1])):
                state, m = step(state, batch(s), step_generator(seed, s, dev))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    TRUNK.timed = FSDP.timed = False
    dp = TPT_RANKS // tp
    fwd = FSDP.phases["forward"]
    layer = int(fwd["bytes"] / fwd["calls"] * dp) if fwd["calls"] else 0
    out.update(losses=losses, ms_per_step=ms, row_sums=row_sums,
               trunk_collectives={p: dict(c) for p, c in TRUNK.phases.items()},
               fsdp_collectives={p: dict(c) for p, c in FSDP.phases.items()},
               launches={k: getattr(ops, k).launches for k in TPT_COUNTED},
               steps_peak_bytes=torch.cuda.max_memory_allocated(dev),
               peak_bound=(held + out["grad_bytes"] + TPT_PEAK_GATHERED_LAYERS * layer
                           + ref["activation_bytes"]),
               gathered_layer_bytes=layer, whole_digest=whole_digest(cfg, mesh, state.params),
               cut_leaves=sum(p[:2] == ("layers", "0") and "data" in ax for p, ax in
                              sharding.split_dims(cfg, mesh, state.params).items()),
               case_seconds=time.perf_counter() - t_case)
    want = sharding.shard_train_state(torch.load(Path(tmp, f"{name}_params.pt"), mmap=True,
                                                 weights_only=False), mesh, cfg)
    worst = 0.0
    for x, y in zip(tree_util.leaves(state.params), tree_util.leaves(want)):
        y = y.to(dev)
        excess = (x - y).abs() - (MESH_PARAM_TOL["atol"] + MESH_PARAM_TOL["rtol"] * y.abs())
        worst = max(worst, float(excess.max()))
    out["param_excess_over_tol"] = worst
    del state, step, want
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_train_worker(out_dir: str, seed: int) -> int:
    """One rank of phase 15's world (started by ``torchrun``): every case on
    its mesh of the world's 4 ranks; its results to ``rank<r>.json``."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(MESH_DEVICE)
    refs = torch.load(Path(out_dir, "ref.pt"), weights_only=False)
    res = {}
    for name, arch, layers, tp, hinted, head, fsdp_hint in TPT_CASES:
        res[name] = tpt_case(name, arch, layers, tp, hinted, head, fsdp_hint, dev, seed + 45,
                             out_dir, refs[name])
    Path(out_dir, f"rank{dist.get_rank()}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def tp_train_path(dev, seed, card) -> dict:
    """Phase 15: the one-rank references here, then the world. Returns the
    launches of every rank."""
    t_phase = time.perf_counter()
    total = collections.Counter()
    rows = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        refs = {name: tpt_reference(name, arch, layers, head, dev, seed + 45, tmp)
                for name, arch, layers, _, _, head, _ in TPT_CASES}
        torch.save(refs, Path(tmp, "ref.pt"))
        t_world = time.perf_counter()
        torchrun(TPT_RANKS, [__file__, "--tp-train-worker", tmp, "--seed", str(seed)],
                 timeout=TPT_TIMEOUT_S)
        world_s = time.perf_counter() - t_world
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(TPT_RANKS)]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for name, arch, layers, tp, hinted, head, fsdp_hint in TPT_CASES:
        reports = [r[name] for r in ranks]
        ref = refs[name]
        dp = TPT_RANKS // tp
        what = f"{arch} at {layers} layers on ({dp}, {tp}), head {head}"
        loss_err = max(abs(a - b) / abs(b) for rep in reports
                       for a, b in zip(rep["losses"], ref["losses"]))
        row = dict(arch=arch, mesh=[dp, tp], hinted=hinted, head=head, card=card,
                   reduced={"num_layers": [configs.get_config(arch).num_layers, layers]},
                   batch=TPT_BATCH, seq=TPT_SEQ, steps=TPT_STEPS, optimizer=TPT_OPT,
                   one_rank_losses=ref["losses"], one_rank_ms_per_step=ref["ms_per_step"],
                   one_rank_activation_bytes=ref["activation_bytes"],
                   loss_rel_err=loss_err,
                   grad_rel_rms=max(rep["grad_rel_rms"] for rep in reports),
                   ranks=[dict(rank=rep["rank"], bytes=rep["bytes"],
                               ms_per_step=rep["ms_per_step"],
                               trunk_collectives=rep["trunk_collectives"],
                               fsdp_collectives=rep["fsdp_collectives"],
                               held_gib=rep["held_bytes"] / 2 ** 30,
                               grad_gib=rep["grad_bytes"] / 2 ** 30,
                               peak_gib=rep["peak_bytes"] / 2 ** 30,
                               peak_bound_gib=rep["peak_bound"] / 2 ** 30,
                               steps_peak_gib=rep["steps_peak_bytes"] / 2 ** 30,
                               case_seconds=rep["case_seconds"],
                               gathered_layer_bytes=rep["gathered_layer_bytes"],
                               launches=rep["launches"],
                               grad_worst_leaf=rep["grad_worst_leaf"],
                               data_sum_bytes_by_step=[[c["bytes"] for c in st]
                                                       for st in rep["row_sums"]],
                               data_sum_bound_bytes_by_step=[[c["bound_bytes"] for c in st]
                                                             for st in rep["row_sums"]],
                               data_sum_bit_equal=[c["bit_equal"]
                                                   for c in rep["checked_row_sums"]],
                               param_excess_over_tol=rep["param_excess_over_tol"],
                               **{k: rep[k] for k in ("layer0_route_equal",
                                                      "hint_vs_plain_rel_rms", "fsdp_hint",
                                                      "saved_layer_input_bytes")
                                  if k in rep})
                              for rep in reports])
        print(json.dumps({"tp_train": row}))
        check(loss_err <= MESH_LOSS_RTOL, f"{what}: losses {loss_err} from one rank's")
        for rep in reports:
            r = rep["rank"]
            want_launches = tpt_launches_a_rank(head, rep["row_sums"])
            check(all(c["bit_equal"] for c in rep["checked_row_sums"]),
                  f"{what}: rank {r}'s sum over data by owner is not bit-equal to the "
                  f"gather-everything sum")
            check(len(rep["checked_row_sums"]) == (2 if dp > 1 and head != "softmax" else 0),
                  f"{what}: rank {r} checked {len(rep['checked_row_sums'])} sums over data")
            check_row_sums(f"{what}: rank {r}", rep["row_sums"])
            for part, b in rep["bytes"].items():
                check(b["rank"] == rank_bytes(b, dp, tp),
                      f"{what}: rank {r} holds {b['rank']} {part} bytes, not "
                      f"{rank_bytes(b, dp, tp)} ({b})")
            check(rep["grad_rel_rms"] <= TPT_GRAD_REL_RMS,
                  f"{what}: rank {r}'s gradient of {rep['grad_worst_leaf']} "
                  f"{rep['grad_rel_rms']} relative RMS from one rank's")
            check(rep["param_excess_over_tol"] <= 0.0,
                  f"{what}: rank {r}'s parameters beyond the reference's bounds")
            check(rep.get("layer0_route_equal", True),
                  f"{what}: rank {r}'s layer 0 routing differs from one rank's")
            check(rep.get("hint_vs_plain_rel_rms", 0.0) <= TPT_GRAD_REL_RMS,
                  f"{what}: rank {r}'s hinted gradients {rep.get('hint_vs_plain_rel_rms')} "
                  "from the unhinted")
            if hinted == "sp":
                want_trunk = tpt_sp_trunk(tpt_cfg(arch, layers), tp)
                got_trunk = {p: dict(calls=c["calls"], bytes=c["bytes"])
                             for p, c in rep["trunk_collectives"].items()}
                check(got_trunk == want_trunk,
                      f"{what}: rank {r}'s sequence-parallel collectives {got_trunk}, not "
                      f"{want_trunk}")
                sv = rep["saved_layer_input_bytes"]
                check(len(sv["hinted"]) == len(sv["plain"]) == layers
                      and all(p == tp * h for h, p in zip(sv["hinted"], sv["plain"])),
                      f"{what}: rank {r}'s checkpointed layers keep {sv['hinted']} bytes under "
                      f"sequence parallelism against {sv['plain']} without, not 1/{tp}")
            if fsdp_hint:
                h = rep["fsdp_hint"]
                check(h["bit_equal"] and h["expert_bytes_halved"] and h["same_calls"],
                      f"{what}: rank {r}'s fsdp_gather_weights run {h}")
            if dp > 1:
                check(rep["peak_bytes"] <= rep["peak_bound"],
                      f"{what}: rank {r}'s peak {rep['peak_bytes']} B over one step's "
                      f"gradients above what it held, its gradients, "
                      f"{TPT_PEAK_GATHERED_LAYERS} gathered layers and the activations "
                      f"({rep['peak_bound']} B)")
                check(rep["fsdp_collectives"]["backward"]["calls"]
                      == TPT_STEPS * layers * rep["cut_leaves"],
                      f"{what}: rank {r}'s reduce-scatters {rep['fsdp_collectives']}, not "
                      f"{rep['cut_leaves']} a layer a step")
            check(rep["launches"] == want_launches,
                  f"{what}: rank {r}'s launches {rep['launches']}, not {want_launches}")
            check(rep["whole_digest"] == reports[0]["whole_digest"],
                  f"{what}: rank {r}'s whole leaves differ from rank 0's")
            for k, n in rep["launches"].items():
                total[k] += n
        rows.append(row)
    import re
    t_launch = time.perf_counter()
    out = torchrun(2, ["-m", "repro_torch.launch.train", *TPT_LAUNCH], timeout=300)
    launch = dict(flags=TPT_LAUNCH, wall_s=time.perf_counter() - t_launch, card=card)
    for label in ("parameter", "optimizer-state"):
        m = re.search(label + r" bytes a rank \[(\d+), (\d+)\] \(one rank's (\d+): (\d+) "
                      r"split over model, (\d+) whole\)", out)
        check(m is not None, f"the training launcher printed no {label} bytes: {out[:500]}")
        a, b, _, split, whole = map(int, m.groups())
        check(a == b == split // 2 + whole,
              f"the training launcher's {label} bytes a rank {[a, b]}, not {split} / 2 + {whole}")
        launch[label] = dict(rank=a, split=split, whole=whole)
    losses = [float(x) for x in re.findall(r"loss=([-0-9.naif]+)", out)]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"the training launcher's losses {losses}")
    launch["losses"] = losses
    print(json.dumps({"tp_train_launcher": launch}))
    print(json.dumps({"tp_train_path": dict(card=card, wall_s=time.perf_counter() - t_phase,
                                            world_s=world_s, cases=len(rows),
                                            launches=dict(total))}))
    return dict(total)


# ---------------------------------------------------------------------------
# Phase 16: the dry run (repro_torch.launch.dryrun) on this machine's CPU.
# ---------------------------------------------------------------------------

DRY_PEAK_RTOL = 0.2              # the counted peak against the allocator's over the step
DRY_CELL = ("h2o-danube-3-4b", "train_4k", "single")      # (b): 256 fake ranks, (32, 8)
DRY_LAUNCHES = {"sampled_head_loss": 1, "segment_stats": 3, "flash_attention": 0}
# (c): the production cells the kernels' widths and the sum over data by
# owner opened, and (b)'s cell on (64, 8); each must end "ok".
DRY_CELLS = (("gemma2-27b", "train_4k", "single"), ("gemma2-27b", "prefill_32k", "single"),
             ("gemma2-27b", "decode_32k", "single"), ("mixtral-8x22b", "train_4k", "single"),
             ("h2o-danube-3-4b", "train_4k", "multi"))
DRY_TRAIN_MAX_BYTES = 20e9       # (b)'s bytes a rank, the sparse rows' sum no longer gathered


def dryrun_worker(path: str) -> int:
    """Phase 16's counts, in a process of their own (the fake world of (b)
    is a process group): (a) phase 11's step, stablelm-3b at full width
    and depth, batch LM_BATCH x LM_SEQ, one rank; (b) DRY_CELL on the
    production mesh; (c) DRY_CELLS in turn. No card is used."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    one = dryrun.run_cell(LM_ARCH, "phase11", "one", "adversarial_ns", cell={
        "mode": "train", "seq_len": LM_SEQ, "global_batch": LM_BATCH})
    one["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, shape, mesh_kind = DRY_CELL
    prod = dryrun.run_cell(arch, shape, mesh_kind, "adversarial_ns")
    prod["wall_s"] = time.perf_counter() - t0
    cells = {}
    for arch, shape, mesh_kind in DRY_CELLS:
        t0 = time.perf_counter()
        try:
            cell = dryrun.run_cell(arch, shape, mesh_kind, "adversarial_ns")
        except Exception as e:          # noqa: BLE001 -- reported and gated by dryrun_path
            cell = {"status": "error", "error": f"{type(e).__name__}: {e}"}
        cell["wall_s"] = time.perf_counter() - t0
        cells["/".join((arch, shape, mesh_kind))] = cell
    Path(path).write_text(json.dumps({"one_rank": one, "production": prod, "cells": cells}))
    return 0


def start_dryrun():
    """Start phase 16's counts (``dryrun_worker``) in a process of their
    own, at a lower priority: they need the CPU alone, so they run while
    phases 13-15 hold the card. Returns the job for :func:`dryrun_path`."""
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name, "dryrun.json")
    proc = subprocess.Popen(["nice", "-n", "5", sys.executable, __file__, "--dryrun-worker",
                             str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())   # a phase failed first
    return dict(tmp=tmp, out=out, proc=proc, t0=time.perf_counter())


def dryrun_path(card, lm_result, job) -> None:
    """Phase 16: (a) the dry run's count of phase 11's step against that
    step as measured here: each kernel's launches exact, the roofline's
    step time at or below the measured ms a step, the counted peak within
    DRY_PEAK_RTOL of the allocator's over the step; (b) DRY_CELL to status
    ``ok`` (line ``dryrun_cell``). ``job``: :func:`start_dryrun`'s."""
    t0 = time.perf_counter()
    proc, out = job["proc"], job["out"]
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0 and out.exists(),
          f"the dry run exited {proc.returncode}: {err[-3000:]}")
    res = json.loads(out.read_text())
    job["tmp"].cleanup()
    one, prod, cells = res["one_rank"], res["production"], res["cells"]
    check(one["status"] == "ok", f"the dry run of phase 11's step: {one.get('error')}")
    step = lm_result["one_step"]
    measured_ms = lm_result["ms_per_step_median"]
    launches = {k: one["kernels"].get(k, 0) for k in DRY_LAUNCHES}
    peak_err = one["bytes_per_device"] / step["peak_bytes"] - 1.0
    line_a = dict(card=card, arch=LM_ARCH, batch=LM_BATCH, seq=LM_SEQ,
                  launches=one["kernels"], step_time_s=one["step_time_s"],
                  compute_s=one["compute_s"], memory_s=one["memory_s"],
                  bottleneck=one["bottleneck"], measured_ms_per_step_median=measured_ms,
                  measured_one_step_ms=step["ms"], predicted_peak_bytes=one["bytes_per_device"],
                  argument_bytes=one["argument_size_in_bytes"],
                  temp_bytes=one["temp_size_in_bytes"], measured_peak_bytes=step["peak_bytes"],
                  measured_held_after_bytes=step["held_bytes"], peak_rel_err=peak_err,
                  flops=one["flops_per_device"], bytes_accessed=one["bytes_accessed_per_device"],
                  count_wall_s=one["wall_s"])
    print(json.dumps({"dryrun_step": line_a}))
    keys = ("arch", "shape", "mesh", "chips", "mesh_shape", "status", "bytes_per_device",
            "argument_size_in_bytes", "temp_size_in_bytes", "flops_per_device",
            "bytes_accessed_per_device", "collective_bytes_per_device", "collectives",
            "collectives_by_axis", "compute_s", "memory_s", "collective_s", "bottleneck",
            "step_time_s", "model_flops", "mfu_bound", "kernels", "wall_s", "error")
    print(json.dumps({"dryrun_cell": dict(card=card, **{k: prod[k] for k in keys
                                                         if k in prod})}))
    check(launches == DRY_LAUNCHES,
          f"the dry run counts {launches} launches in phase 11's step, not {DRY_LAUNCHES}")
    check(one["step_time_s"] * 1e3 <= measured_ms,
          f"the dry run's roofline step {one['step_time_s'] * 1e3:.1f} ms is above the "
          f"measured {measured_ms:.1f} ms a step: the count is wrong")
    check(abs(peak_err) <= DRY_PEAK_RTOL,
          f"the dry run's peak {one['bytes_per_device']} B is {peak_err:+.1%} from the "
          f"allocator's {step['peak_bytes']} B over the step")
    check(prod["status"] == "ok", f"the dry run of {DRY_CELL}: {prod.get('error')}")
    for name, cell in cells.items():
        print(json.dumps({"dryrun_cell": dict(card=card, cell=name, **{
            k: cell[k] for k in keys if k in cell})}))
        check(cell["status"] == "ok", f"the dry run of {name}: {cell.get('error')}")
    multi = cells["/".join(DRY_CELL[:2] + ("multi",))]
    check(prod["bytes_per_device"] <= DRY_TRAIN_MAX_BYTES,
          f"the dry run of {DRY_CELL}: {prod['bytes_per_device']} B a rank, over "
          f"{DRY_TRAIN_MAX_BYTES:.0f}")
    check(multi["bytes_per_device"] <= prod["bytes_per_device"],
          f"the dry run of {DRY_CELL[:2]} on (64, 8): {multi['bytes_per_device']} B a rank, "
          f"more than on (32, 8) ({prod['bytes_per_device']})")
    print(json.dumps({"dryrun_path": dict(card=card, wait_s=time.perf_counter() - t0,
                                          wall_s=time.perf_counter() - job["t0"])}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh-worker", default=None,
                        help="run as one rank of phase 13's world (under torchrun)")
    parser.add_argument("--tp-worker", default=None,
                        help="run as one rank of a phase 14 world (under torchrun)")
    parser.add_argument("--tp-case", default="moe", choices=("moe", "hybrid", "danube"))
    parser.add_argument("--tp-train-worker", default=None,
                        help="run as one rank of phase 15's world (under torchrun)")
    parser.add_argument("--dryrun-worker", default=None,
                        help="run phase 16's dry-run counts on the CPU into this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if args.mesh_worker:
        return mesh_worker(args.mesh_worker, args.seed)
    if args.tp_worker:
        if args.tp_case == "danube":
            return tp_danube_worker(args.tp_worker)
        return tp_worker(args.tp_worker, args.tp_case, args.seed)
    if args.tp_train_worker:
        return tp_train_worker(args.tp_train_worker, args.seed)
    if args.dryrun_worker:
        return dryrun_worker(args.dryrun_worker)
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
    check_wide_kernels(dev, gen, flush, floor)
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
    lm_launches, lm_result = lm_train_path(dev, args.seed, card)
    for name, n in lm_launches.items():
        if name in launches:
            launches[name] += n
    for name, n in gemma2_train_path(dev, args.seed, card).items():
        launches[name] += n
    for name, n in backbone_path(dev, args.seed, card).items():
        launches[name] += n
    dryrun_job = start_dryrun()
    for name, n in mesh_path(dev, args.seed, card).items():
        launches[name] += n
    for name, n in sharded_trunk_path(dev, args.seed, card).items():
        launches[name] += n
    for name, n in tp_train_path(dev, args.seed, card).items():
        launches[name] += n
    dryrun_path(card, lm_result, dryrun_job)
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
