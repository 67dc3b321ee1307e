#!/usr/bin/env python3
"""Device time of edited copies of the ``tree_logprob_all`` and
``sampled_head_loss`` kernels, in turns on one card: what bounds each.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/kernel_variants.py [--seed N] [--out FILE]

For each variant below the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, edits the copy of the kernel's source (the checkout is
never touched), builds it there and, in a child process, times the copy's
kernels alone (``chip_smoke.kernel_device_ms``: torch.profiler, L2 flushed
before each call) at chip_smoke.py's shapes: ``tree_logprob_all`` at the
prediction and LM-serving shapes, ``sampled_head_loss`` (adversarial_ns,
reg 1e-3) at T = 256, m = 2 and T = 2048, m = 17 in both table dtypes. The
unedited kernels run first and last. An edited copy computes something else:
its times say what a part of the kernel costs, never that it is right.
Prints one JSON line per variant (and appends it to ``--out``).
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
    "none_again": [],
}


def child(seed: int) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import xc_linear
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    cfg = xc_linear.config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    torch.cuda._sleep(500_000_000)
    out = {}
    for shape, c, kg, bsz, scale in cs.tree_shapes(cfg):
        tree = tree_lib.init_tree(gen, c, kg, scale=scale, device=dev)
        x = torch.randn((bsz, kg), generator=gen, device=dev)
        out[f"tree_logprob_all/{shape}"] = cs.kernel_device_ms(
            lambda: ops.tree_logprob_all(tree.w, tree.b, x), flush, "tree_logprob_tc_kernel")
    c, kdim = cfg.num_labels, cfg.feature_dim
    w32 = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    kw = dict(kind="adversarial_ns", num_labels=c, reg=cfg.head_reg)
    for shape, (t, m) in cs.sampled_shapes(cfg).items():
        h, ids, lp = cs.sampled_inputs(dev, gen, c, kdim, t, m)
        for dtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(dtype), b32.to(dtype)
            out[f"sampled_head_loss/{shape}/{str(dtype)[6:]}"] = cs.kernel_device_ms(
                lambda: ops.sampled_head_loss(w, b, h, ids, lp, **kw), flush,
                "sampled_loss_kernel")
    print(json.dumps(dict(card=cs.card_line(), device_ms=out)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.seed)
    for name, edits in VARIANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "src", Path(tmp) / "src",
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
                 "--seed", str(args.seed)],
                cwd=tmp, capture_output=True, text=True, check=False)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return 1
            line = json.dumps(dict(variant=name, **json.loads(run.stdout.splitlines()[-1])))
            print(line, flush=True)
            if args.out is not None:
                with args.out.open("a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
