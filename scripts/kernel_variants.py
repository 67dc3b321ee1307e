#!/usr/bin/env python3
"""Device time of edited copies of the ``tree_logprob_all``, ``sampled_head_loss``
and ``gather_scores`` kernels, in turns on one card: what bounds each.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/kernel_variants.py [--seed N] [--out FILE] [--only PREFIX]
                                       [--plans] [--against DIR]

For each variant below the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, edits the copy of the kernel's source (the checkout is
never touched), builds it there and, in a child process, times the copy's
kernels alone (``chip_smoke.kernel_device_ms``: torch.profiler, L2 flushed
before each call) at chip_smoke.py's shapes: ``tree_logprob_all`` at the
prediction and LM-serving shapes, ``sampled_head_loss`` (adversarial_ns,
reg 1e-3) at T = 256, m = 2 and T = 2048, m = 17 in both table dtypes,
``gather_scores`` at ``chip_smoke.gather_shapes``' calls (also with its
launch, ``chip_smoke.time_ms``). The unedited kernels run first and last;
``--only`` keeps the variants, and times the kernel, whose name starts with
it (``tree``, ``sampled`` or ``gather``). An edited copy computes something
else: its times say what a part of the kernel costs, never that it is
right. Every time comes with the launches the profiler saw (of 20).

When the first thing a run times is ``gather_scores`` (``--only gather``),
it also prints each round of that first timing, the first one included,
after one untimed call that builds and loads the kernel: what the first
timing of a process reads, as ``chip_smoke.py``'s first timing did before
``time_ms`` left its first round untimed.

``--plans`` also times, in the unedited runs, ``gather_scores`` under the
plans next to its launch plan's (lanes and rows each doubled and halved).
``--against DIR`` runs no edited copy: it times the kernels of another
checkout's ``src/`` (for example the parent commit unpacked with ``git
archive``) through their public wrappers, in the order DIR, this checkout,
this checkout, DIR, with this checkout's shapes and timing. Prints one JSON
line per run (and appends it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")

LOG1P_POLYNOMIAL = (
    "  const float e = __expf(-fabsf(z));\n"
    "  float p = -0.0060747526586055756f;\n"
    "  p = fmaf(p, e, 0.03441791236400604f); p = fmaf(p, e, -0.09231230616569519f);\n"
    "  p = fmaf(p, e, 0.16478188335895538f); p = fmaf(p, e, -0.2391897290945053f);\n"
    "  p = fmaf(p, e, 0.3313336670398712f); p = fmaf(p, e, -0.4998010993003845f);\n"
    "  p = fmaf(p, e, 0.9999914765357971f); p = fmaf(p, e, 9.099033349002639e-08f);\n"
    "  return fminf(-z, 0.f) - p;")

# name: [(source file, text in it, its replacement), ...]
VARIANTS = {
    "none": [],
    # The tensor-core kernel writes nothing: its math and staging alone.
    "tree_without_stores": [
        ("tree_logprob.cu", "      if (row < B)\n        __stcs(",
         "      if (row < B && c_pad < 0)\n        __stcs(")],
    # Plain stores in place of streaming (evict-first) ones.
    "tree_plain_stores": [
        ("tree_logprob.cu", "        __stcs(reinterpret_cast<float4*>(out + row * c_pad",
         "        __stwb(reinterpret_cast<float4*>(out + row * c_pad")],
    # log(1 + e) by a degree-8 polynomial (max error 1.8e-7 on [0, 1]): one
    # transcendental a node and row instead of two, eight more FMAs.
    "tree_log1p_polynomial": [
        ("tree_logprob.cu", "  return fminf(-z, 0.f) - softplus_neg_abs(z);", LOG1P_POLYNOMIAL)],
    # gather_scores without its row loads (every chunk of w reads as zero):
    # the id and h round trip, the sums and the launch.
    "gather_without_row_loads": [
        ("gather_scores.cu", "      wv[r][v] = (ok[r] && c < chunks)",
         "      wv[r][v] = (ok[r] && c < chunks && K < 0)")],
    # gather_scores with each slot's id taken from its index, not read: the
    # rows no longer wait on a first round trip.
    "gather_without_id_read": [
        ("gather_scores.cu",
         "(int64_t)__ldg(reinterpret_cast<const long long*>(ids) + t * n + j0 + r)",
         "(t * n + j0 + r) % C")],
    # gather_scores without its h loads (h reads as zero).
    "gather_without_h_loads": [
        ("gather_scores.cu", "    const float4 v = live ? __ldg(",
         "    const float4 v = (live && h == nullptr) ? __ldg(")],
    # gather_scores returning at once: the launch of its grid alone.
    "gather_empty_body": [
        ("gather_scores.cu", "  const int tid = threadIdx.x;\n",
         "  if (K >= 0) return;\n  const int tid = threadIdx.x;\n")],
    "none_again": [],
}


def neighbour_plans(plan, n):
    """gather_scores plans with the lanes or the rows of ``plan`` doubled or
    halved, within the kernel's limits."""
    from repro_torch.kernels import gather_scores as gsc
    _, lanes, rows = plan
    out = []
    for la, ro in ((lanes * 2, rows), (lanes // 2, rows), (lanes, rows * 2), (lanes, rows // 2)):
        if gsc.MIN_LANES <= la <= gsc.THREADS and 1 <= ro <= min(gsc.MAX_ROWS, n):
            out.append((gsc.ROWS if la <= gsc.WARP else gsc.SPLIT, la, ro))
    return out


def child(seed: int, only: str, plans: bool) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import xc_linear
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops

    def alone(fn, name):
        ms, seen = cs.kernel_device_ms(fn, flush, name)
        return dict(device_ms=ms, seen=seen)

    dev = torch.device("cuda")
    cfg = xc_linear.config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    torch.cuda._sleep(500_000_000)
    out = {}
    for shape, c, kg, bsz, scale in (cs.tree_shapes(cfg) if "tree".startswith(only) else ()):
        tree = tree_lib.init_tree(gen, c, kg, scale=scale, device=dev)
        x = torch.randn((bsz, kg), generator=gen, device=dev)
        out[f"tree_logprob_all/{shape}"] = alone(
            lambda: ops.tree_logprob_all(tree.w, tree.b, x), "tree_logprob_tc_kernel")
    c, kdim = cfg.num_labels, cfg.feature_dim
    w32 = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    kw = dict(kind="adversarial_ns", num_labels=c, reg=cfg.head_reg)
    for shape, (t, m) in (cs.sampled_shapes(cfg).items() if "sampled".startswith(only)
                          else ()):
        h, ids, lp = cs.sampled_inputs(dev, gen, c, kdim, t, m)
        for dtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(dtype), b32.to(dtype)
            out[f"sampled_head_loss/{shape}/{str(dtype)[6:]}"] = alone(
                lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), "sampled_loss_kernel")
    del w32, b32
    for shape, c, kdim, t, n, scale, dtypes in (cs.gather_shapes(cfg)
                                                 if "gather".startswith(only) else ()):
        w32, b32, h, ids = cs.gather_inputs(dev, gen, c, kdim, t, n, scale)
        for dtype in dtypes:
            w, b = w32.to(dtype), b32.to(dtype)
            key = f"gather_scores/{shape}/{str(dtype)[6:]}"
            first = None
            if not out:   # the process's first timing, after one call that builds the kernel
                ops.gather_scores(w, b, h, ids)
                torch.cuda.synchronize()
                first = cs.round_times(lambda: ops.gather_scores(w, b, h, ids), flush,
                                       cs.TIMING_ITERS + 1)
            out[key] = alone(lambda: ops.gather_scores(w, b, h, ids), "gather_scores_kernel")
            if first is not None:
                out[key]["first_timing_rounds_ms"] = first
            out[key]["ms"] = cs.time_ms(lambda: ops.gather_scores(w, b, h, ids), flush)
            if plans:
                from repro_torch.kernels import gather_scores as gsc
                plan = gsc.launch_plan(t, n, kdim, w.element_size(),
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
                res = torch.empty((t, n), device=dev)
                out[key]["plan"] = list(plan)
                for other in neighbour_plans(plan, n):
                    out[f"{key}/plan={other[1]},{other[2]}"] = alone(
                        lambda: gsc._launch(w, b, h, ids, res, *other), "gather_scores_kernel")
        del w32, b32, h, ids, w, b
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=cs.card_line(), device_ms=out)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only", default="", help="keep the variants whose name starts with this")
    ap.add_argument("--plans", action="store_true",
                    help="also time gather_scores under the plans next to its own")
    ap.add_argument("--against", type=Path, default=None,
                    help="time another checkout's kernels beside this one's, no edits")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.seed, args.only, args.plans)
    if args.against is not None:
        other = args.against.resolve()
        runs = [("against", other, []), ("none", ROOT, []), ("none_again", ROOT, []),
                ("against_again", other, [])]
    else:
        runs = [(name, ROOT, edits) for name, edits in VARIANTS.items()
                if name.startswith(args.only) or name in ("none", "none_again")]
    for name, src_root, edits in runs:
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(src_root / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy2(ROOT / "chip_smoke.py", tmp)
            shutil.copy2(__file__, tmp)
            for source, old, new in edits:
                path = Path(tmp) / CSRC / source
                text = path.read_text()
                if text.count(old) != 1:
                    print(f"{name}: the text to edit is not in {source} once", file=sys.stderr)
                    return 1
                path.write_text(text.replace(old, new))
            run = subprocess.run(
                [sys.executable, str(Path(tmp) / Path(__file__).name), "--child",
                 "--seed", str(args.seed), "--only", args.only,
                 *(["--plans"] if args.plans and src_root == ROOT and not edits else [])],
                cwd=tmp, capture_output=True, text=True, check=False)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return 1
            line = json.dumps(dict(variant=name, src=str(src_root),
                                   **json.loads(run.stdout.splitlines()[-1])))
            print(line, flush=True)
            if args.out is not None:
                with args.out.open("a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
