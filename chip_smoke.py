#!/usr/bin/env python3
"""Drives the PyTorch port's prediction path on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. report the card (nvidia-smi name and power limit) and the TF32 switches;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version at the shapes of the
     main path (full ``xc_linear`` width), time both, and check the path on a
     small input against the port's CPU run;
  4. the main path at full ``xc_linear`` width (C = 217,240, K = 512,
     k = 16, depth 18): 4 request batches of 256 queries through dense Eq. 5
     prediction and tree-beam top-k, launch counters reset just before and
     read just after; exhaustive beam against dense top-5 on 4 queries;
  5. print the ``kernels`` JSON line and, last, the device line.

Exits non-zero without a CUDA device, and prints no result then.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import xc_linear  # noqa: E402
from repro_torch.core import heads, tree as tree_lib  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

BATCH = 256                      # queries in one request batch
N_BATCHES = 4
BEAM = 64
TOPK = 5
GATHER_TOL = dict(atol=1e-5, rtol=1e-5)   # one K-term float32 dot, two orders
TREE_TOL = dict(atol=1e-4, rtol=1e-5)     # depth-term sums, two log_sigmoid forms
SCORE_TOL = dict(atol=1e-4, rtol=1e-5)    # beam scores against dense Eq. 5 scores
TIMING_ITERS = 20


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def close(got: torch.Tensor, want: torch.Tensor, tol: dict) -> bool:
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())


def time_ms(fn, flush: torch.Tensor, iters: int = TIMING_ITERS) -> float:
    """Mean device time of ``fn`` with CUDA events, L2 flushed before each
    call by reading ``flush`` (a read leaves no dirty lines to write back).
    A GPU-side spin ahead of each call lets the host enqueue the whole call
    before the device reaches it, so host overhead is not timed."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_gather(dev, gen, flush, cfg):
    c, kdim = cfg.num_labels, cfg.feature_dim
    w32 = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    h = torch.randn((BATCH, kdim), generator=gen, device=dev)
    ids = torch.randint(0, c, (BATCH, BEAM), generator=gen, device=dev)
    rows = torch.unique(ids).numel()
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        w, b = w32.to(dtype), b32.to(dtype)
        got = ops.gather_scores(w, b, h, ids)
        want = ref.gather_scores_ref(w, b, h, ids)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"gather_scores {str(dtype)[6:]}: T={BATCH} n={BEAM} K={kdim} C={c} "
              f"max_abs_err={err:.3e} tol={GATHER_TOL}")
        check(close(got, want, GATHER_TOL), f"gather_scores {dtype} disagrees")
        elt = w.element_size()
        n_bytes = (rows * kdim * elt + rows * elt + ids.numel() * 8
                   + h.numel() * 4 + ids.numel() * 4)
        bound, by = bound_ms(n_bytes, ids.numel() * (2 * kdim + 1))
        ms = time_ms(lambda: ops.gather_scores(w, b, h, ids), flush)
        plain = time_ms(lambda: ref.gather_scores_ref(w, b, h, ids), flush)
        print(f"gather_scores {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound:.4f} ms ({by}, {rows} distinct rows)")
        result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by)
    return result[torch.float32]


def check_tree(dev, gen, flush, cfg):
    tree = tree_lib.init_tree(gen, cfg.num_labels, cfg.gen_feature_dim,
                              scale=1.0, device=dev)
    x = torch.randn((BATCH, cfg.gen_feature_dim), generator=gen, device=dev)
    got = ops.tree_logprob_all(tree.w, tree.b, x)
    want = ref.tree_logprob_all_ref(tree.w, tree.b, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    pad = got[:, cfg.num_labels:]
    print(f"tree_logprob_all: B={BATCH} k={cfg.gen_feature_dim} depth={tree.depth} "
          f"C_pad={got.shape[1]} max_abs_err={err:.3e} tol={TREE_TOL} "
          f"padding leaves in [{float(pad.min()):.1f}, {float(pad.max()):.1f}]")
    check(bool(torch.isfinite(got).all()), "tree_logprob_all gives non-finite values")
    check(close(got, want, TREE_TOL), "tree_logprob_all disagrees")
    n_nodes, kg = tree.w.shape
    n_bytes = got.numel() * 4 + tree.w.numel() * 4 + tree.b.numel() * 4 + x.numel() * 4
    bound, by = bound_ms(n_bytes, BATCH * n_nodes * (2 * kg + 3))
    ms = time_ms(lambda: ops.tree_logprob_all(tree.w, tree.b, x), flush)
    plain = time_ms(lambda: ref.tree_logprob_all_ref(tree.w, tree.b, x), flush)
    print(f"tree_logprob_all: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)


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

    ops.gather_scores.launches = 0
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


def device_time_by_op(fn, top: int = 8) -> dict:
    """Device time of one warm call of ``fn`` by kernel (torch.profiler):
    the total, the kernels' count, and the ``top`` kernels by time."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(by_name.values()), "kernels": len(kernels),
            "top_ms": [[name[:60], ms] for name, ms in ranked]}


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
    gather = check_gather(dev, gen, flush, cfg)
    tree = check_tree(dev, gen, flush, cfg)
    del flush
    check_small_against_cpu(dev, args.seed)

    launches = main_path(dev, args.seed, cfg)
    src = "src/repro_torch/kernels/csrc"
    kernels = [
        dict(name="gather_scores", route="cuda", source=f"{src}/gather_scores.cu",
             replaces="src/repro/kernels/gather_scores.py:44", **gather),
        dict(name="tree_logprob_all", route="cuda", source=f"{src}/tree_logprob.cu",
             replaces="src/repro/kernels/tree_logprob.py:69", **tree),
    ]
    for k in kernels:
        k.update(launches=launches[k["name"]], library_ms=None,
                 max_err=k["max_abs_err"], kernel_ms=k["ms"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
