#!/usr/bin/env python3
"""What chip_smoke.py's bf16 check of ``flash_attention`` reads on planted faults.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 scripts/attn_planted_faults.py [--seed N]

For each fault below the script copies ``src/`` and ``chip_smoke.py`` into a
temporary directory, edits the copy's ``flash_attention.cu`` (the checkout is
never touched), builds it there and, in a child process, holds the copy's
kernel against the plain version on chip_smoke.py's three bf16 shapes with
chip_smoke.py's own inputs and error measures. "none" is the unedited kernel:
the largest error a sound kernel shows. Prints one JSON line per fault and
shape: the largest error, the largest ratio of an error to its per-row bound
(> 1 fails), the relative RMS difference (> 2^-11 fails) and whether
chip_smoke.py would pass it. Exits non-zero if the sound kernel fails at a
shape or a planted fault passes at every shape.
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

# name: (text in flash_attention.cu, its replacement)
FAULTS = {
    "none": None,
    # P rounded to bf16 before P.V, as the reference model does.
    "p_rounded_to_bf16": (
        "Ps[(ty * RQ + i) * L::PLD + tx + kTx * j] = s[i][j];",
        "Ps[(ty * RQ + i) * L::PLD + tx + kTx * j] ="
        " __bfloat162float(__float2bfloat16(s[i][j]));"),
    # The window's first visited key one KV tile (64 keys) too late.
    "window_start_one_tile_late": (
        "k_begin = max((int64_t)0, qa_lo - p.window + 1);",
        "k_begin = max((int64_t)0, qa_lo - p.window + 1 + kBK);"),
    # The window one key wider than asked.
    "window_one_key_wider": (
        "(p.window <= 0 || delta < p.window)",
        "(p.window <= 0 || delta <= p.window)"),
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
    for fault, edit in FAULTS.items():
        passes = []
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
                passes.append(row["passes"])
        # A window fault leaves a shape whose window spans all its keys as it
        # was, so a fault need only fail somewhere.
        ok &= all(passes) if edit is None else not all(passes)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
