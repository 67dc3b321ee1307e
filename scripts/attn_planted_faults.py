#!/usr/bin/env python3
"""What chip_smoke.py's bf16 check of ``flash_attention`` reads on planted faults.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/attn_planted_faults.py [--seed N]

For each fault below the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, edits the copy's ``flash_attention.cu`` (the checkout is
never touched), builds it there and, in a child process, holds the copy's
kernel against the plain version on chip_smoke.py's six bf16 shapes with
chip_smoke.py's own inputs and error measures. Three faults are planted in
the tensor-core kernel, which the three bf16 prefill shapes take, and three
in the decode kernel, which the three decode shapes take; each kernel's
shapes are the other's control. "none" is the unedited kernel: the largest
error a sound kernel shows. Prints one JSON line per fault and
shape: the largest error, the largest ratio of an error to its per-row bound
(> 1 fails), the relative RMS difference (> 2^-11 fails) and whether
chip_smoke.py would pass it. Exits non-zero if the sound kernel fails at a
shape or a planted fault passes at a shape where it must fail.
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
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention.cu")

DECODE_SHAPES = ("danube_decode", "gemma2_decode", "stablelm_decode")

# name: ((text in flash_attention.cu, its replacement), the shapes where the
# check must fail); the first three in the tensor-core kernel, the others in
# the decode kernel.
FAULTS = {
    "none": (None, ()),
    # P_lo dropped: P rounded to bf16 once before P.V, as the reference
    # model does.
    "p_lo_dropped": (
        ("const __nv_bfloat162 residual = __floats2bfloat162_rn(x - hf.x, y - hf.y);",
         "const __nv_bfloat162 residual = __floats2bfloat162_rn(0.f, 0.f);"),
        ("danube_prefill", "gemma2_softcap")),
    # The window's first visited key one KV tile (64 keys) too late.
    "window_start_one_tile_late": (
        ("if (p.window > 0) kv_lo = max((int64_t)0, first_q - p.window + 1);",
         "if (p.window > 0) kv_lo = max((int64_t)0, first_q - p.window + 1 + BK);"),
        ("danube_prefill",)),
    # The window one key wider than asked.
    "window_one_key_wider": (
        ("(p.window <= 0 || dq < p.window)", "(p.window <= 0 || dq <= p.window)"),
        ("danube_prefill",)),
    # The decode kernel drops the last key of each split of the band.
    "decode_last_key_of_a_split_dropped": (
        ("const int64_t kz_end = min(k_end, kz_begin + per);",
         "const int64_t kz_end = min(k_end, kz_begin + per) - 1;"),
        DECODE_SHAPES),
    # The decode kernel's window one key wider than asked (the band's first
    # key, for the range it visits and the per-row mask alike).
    "decode_window_one_key_wider": (
        ("return p.window > 0 ? qa - p.window + 1 : 0;",
         "return p.window > 0 ? qa - p.window : 0;"),
        ("danube_decode",)),
    # The decode kernel rounds P to bf16 before P.V, as the reference model
    # does.
    "decode_p_rounded_to_bf16": (
        ("const float pw = s[u][r];",
         "const float pw = __bfloat162float(__float2bfloat16(s[u][r]));"),
        DECODE_SHAPES),
}


def child(seed: int) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, b, h, kv, sq, skv, hd, causal, window, softcap, dtype, cache_len in cs.ATTN_SHAPES:
        if dtype != torch.bfloat16:
            continue
        q, k, v, scale = cs.attn_inputs(dev, gen, b, h, kv, sq, skv, hd, dtype, cache_len)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        errs = cs.attn_errors(got, want)
        print(json.dumps(dict(shape=name, passes=cs.attn_close(errs, dtype), **errs)))
        del q, k, v, got, want
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
    for fault, (edit, must_fail) in FAULTS.items():
        passes = {}
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(ROOT / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy2(ROOT / "chip_smoke.py", tmp)
            shutil.copy2(__file__, tmp)
            if edit is not None:
                path = Path(tmp) / KERNEL
                text = path.read_text()
                if text.count(edit[0]) != 1:
                    print(f"{fault}: the text to edit is not in {KERNEL} once", file=sys.stderr)
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
                passes[row["shape"]] = row["passes"]
        # A fault leaves the other kernel's shapes as they were, and a window
        # fault a shape whose window spans all its keys.
        ok &= (all(passes.values()) if edit is None
               else not any(passes[shape] for shape in must_fail))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
