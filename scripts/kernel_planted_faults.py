#!/usr/bin/env python3
"""What chip_smoke.py's checks of ``tree_logprob_all``, ``sampled_head_loss`` and
``gather_scores`` read on planted faults.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/kernel_planted_faults.py [--seed N]

For each fault below the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, edits the copy of the kernel's source (the checkout is
never touched), builds it there and, in a child process, holds the copy's
kernels against their plain versions with chip_smoke.py's shapes, inputs,
tolerances and bit-equality check: ``tree_logprob_all`` at the prediction
and the LM-serving shapes, ``sampled_head_loss`` for all 7 kinds, reg and
softcap off and on, both table dtypes, at T = 256, m = 2 and T = 2048,
m = 17; ``gather_scores`` at the prediction beam's and the LM-serving beam's
calls (``chip_smoke.gather_shapes``). "none" is the unedited kernels: the
largest error a sound kernel shows. Prints one JSON line per fault and
check: the largest ratio of an error to its tolerance (> 1 fails;
chip_smoke.py's ``close`` and ``dh_close``), whether two calls were
bit-equal and whether chip_smoke.py would pass it. Exits non-zero if the
sound kernels fail a check, a planted fault passes a check where it must
fail, or a fault in one kernel fails another kernel's check.
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
TREE_CHECKS = ("tree_logprob_all/prediction", "tree_logprob_all/serving_dense")
SAMPLED_CHECKS = tuple(f"sampled_head_loss/{shape}/{dtype}" for shape in ("main", "wide")
                       for dtype in ("float32", "bfloat16"))
GATHER_XC = ("gather_scores/xc_linear/float32", "gather_scores/xc_linear/bfloat16")
GATHER_SERVING = ("gather_scores/serving_beam/float32",)
KERNEL_OF = {"tree_logprob.cu": "tree_logprob_all/", "sampled_loss.cu": "sampled_head_loss/",
             "gather_scores.cu": "gather_scores/"}

# name: (source file, (text in it, its replacement), the checks that must fail).
FAULTS = {
    "none": (None, None, ()),
    # The tensor-core kernel turns the wrong way at local level 5 (the third
    # level above the leaves) on every path.
    "tree_turn_flipped_at_level_5": (
        "tree_logprob.cu", ("((t & 1) ? z5 : 0.f)", "((t & 1) ? 0.f : z5)"), TREE_CHECKS),
    # dh leaves out the last negative of every token.
    "dh_last_negative_dropped": (
        "sampled_loss.cu", ("const int j_end = ns;", "const int j_end = j0 + ns == m ? ns - 1 : ns;"),
        SAMPLED_CHECKS),
    # Each slot's score takes the bias of the next slot's id.
    "b_read_for_the_wrong_slot": (
        "sampled_loss.cu", ("b_s[j] = to_float(b[id_s[j]]);",
                            "b_s[j] = to_float(b[id_s[(j + 1) % m]]);"),
        SAMPLED_CHECKS),
    # The split variant's block sum leaves out the last warp's partial sum
    # of every row (a K-split partial dropped).
    "gather_last_warp_dropped": (
        "gather_scores.cu", ("for (int i = 0; i < warps; ++i)", "for (int i = 0; i < warps - 1; ++i)"),
        GATHER_SERVING),
    # The rows variant's shuffle sum stops one stage short: each row's score
    # is the sum of half its lanes.
    "gather_shuffle_stage_dropped": (
        "gather_scores.cu", ("for (int o = lanes / 2; o > 0; o >>= 1)",
                             "for (int o = lanes / 2; o > 1; o >>= 1)"),
        GATHER_XC),
    # Each slot's score takes the bias of the next slot's id (the id of
    # slot 0, a padding slot, where the group has one row).
    "gather_b_read_for_the_wrong_slot": (
        "gather_scores.cu", ("to_float(b[id[r]])", "to_float(b[id[(r + 1) % kMaxRows]])"),
        GATHER_XC + GATHER_SERVING),
}


def ratio(got, want, tol, scale=None) -> float:
    import torch
    scale = want.abs() if scale is None else scale
    r = (got - want).abs() / (tol["atol"] + tol["rtol"] * scale)
    return float(torch.nan_to_num(r, nan=float("inf")).max())


def child(seed: int) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import xc_linear
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    cfg = xc_linear.config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    for shape, c, kg, bsz, scale in cs.tree_shapes(cfg):
        tree = tree_lib.init_tree(gen, c, kg, scale=scale, device=dev)
        x = torch.randn((bsz, kg), generator=gen, device=dev)
        got = ops.tree_logprob_all(tree.w, tree.b, x)
        again = ops.tree_logprob_all(tree.w, tree.b, x)
        want = ref.tree_logprob_all_ref(tree.w, tree.b, x)
        r, equal = ratio(got, want, cs.TREE_TOL), torch.equal(got, again)
        print(json.dumps(dict(check=f"tree_logprob_all/{shape}", max_ratio=r,
                              bit_equal=equal, passes=r <= 1.0 and equal)))
        del tree, x, got, again, want
        torch.cuda.empty_cache()
    c, kdim = cfg.num_labels, cfg.feature_dim
    w32 = 0.05 * torch.randn((c, kdim), generator=gen, device=dev)
    b32 = 0.1 * torch.randn((c,), generator=gen, device=dev)
    for shape, (t, m) in cs.sampled_shapes(cfg).items():
        h, ids, lp = cs.sampled_inputs(dev, gen, c, kdim, t, m)
        for dtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(dtype), b32.to(dtype)
            worst, dh_worst, equal = 0.0, 0.0, True
            for kind in cs.SAMPLED_KINDS:
                for reg, softcap in ((0.0, 0.0), (cfg.head_reg, 25.0)):
                    kw = dict(kind=kind, num_labels=c, reg=reg, softcap=softcap)
                    got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
                    again = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
                    want = ref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
                    worst = max([worst] + [ratio(g, wn, cs.LOSS_TOL)
                                           for g, wn in zip(got[:3], want[:3])])
                    terms = torch.einsum("tn,tnk->tk", want[1].abs(), w[ids].float().abs())
                    dh_worst = max(dh_worst, ratio(got[3], want[3], cs.LOSS_TOL, terms))
                    equal &= all(torch.equal(g, a) for g, a in zip(got, again))
            print(json.dumps(dict(check=f"sampled_head_loss/{shape}/{str(dtype)[6:]}",
                                  max_ratio_loss_coeff_xi=worst, max_ratio_dh=dh_worst,
                                  bit_equal=equal,
                                  passes=max(worst, dh_worst) <= 1.0 and equal)))
    del w32, b32, w, b, h, ids, lp
    torch.cuda.empty_cache()
    for shape, c, kdim, t, n, scale, dtypes in cs.gather_shapes(cfg):
        w32, b32, h, ids = cs.gather_inputs(dev, gen, c, kdim, t, n, scale)
        for dtype in dtypes:
            w, b = w32.to(dtype), b32.to(dtype)
            got = ops.gather_scores(w, b, h, ids)
            again = ops.gather_scores(w, b, h, ids)
            want = ref.gather_scores_ref(w, b, h, ids)
            r, equal = ratio(got, want, cs.GATHER_TOL), torch.equal(got, again)
            print(json.dumps(dict(check=f"gather_scores/{shape}/{str(dtype)[6:]}",
                                  max_ratio=r, bit_equal=equal, passes=r <= 1.0 and equal)))
        del w32, b32, h, ids, w, b
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.seed)
    ok = True
    for fault, (source, edit, must_fail) in FAULTS.items():
        passes = {}
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy2(ROOT / "chip_smoke.py", tmp)
            shutil.copy2(__file__, tmp)
            if edit is not None:
                path = Path(tmp) / CSRC / source
                text = path.read_text()
                if text.count(edit[0]) != 1:
                    print(f"{fault}: the text to edit is not in {source} once", file=sys.stderr)
                    return 1
                path.write_text(text.replace(edit[0], edit[1]))
            out = subprocess.run(
                [sys.executable, str(Path(tmp) / Path(__file__).name), "--child",
                 "--seed", str(args.seed)],
                cwd=tmp, capture_output=True, text=True, check=False)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            for line in out.stdout.splitlines():
                row = json.loads(line)
                print(json.dumps(dict(fault=fault, **row)))
                passes[row["check"]] = row["passes"]
        # A fault fails the checks it must, and leaves the other kernels'
        # checks as they were.
        if edit is None:
            ok &= all(passes.values())
        else:
            ok &= not any(passes[check] for check in must_fail)
            ok &= all(v for check, v in passes.items()
                      if not check.startswith(KERNEL_OF[source]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
