#!/usr/bin/env python3
"""Times ``flash_attention``'s bf16 decode kernel beside ``scaled_dot_product_attention``.

Run on a machine with one NVIDIA card, from the root of a checkout:

    python3 scripts/attn_decode_sweep.py [--root DIR] [--sweep] [--contiguous]

``--root`` times the kernels of another checkout (its ``src/``), so two
versions can be compared on one card in one session (run them in turns:
A, B, B, A). At the three decode shapes of ``chip_smoke.py`` (h2o-danube,
gemma2 and stablelm-3b geometry, B = 4, the model's cache layout) it prints
the kernel's mean time over 50 calls (CUDA events, L2 flushed before each),
its relative RMS difference from the plain version, the split count and,
where there is no softcap, the time of ``scaled_dot_product_attention`` with
a boolean band mask, and the device time of the decode kernel and of the
split merge (``combine_kernel``) in one call (torch.profiler). ``--sweep``
repeats the h2o-danube and stablelm shapes for several targets of blocks
per SM (``_DECODE_BLOCKS_PER_SM``, which sets ``decode_splits``).
``--contiguous`` passes K and V as contiguous (B, KV, Skv, hd) tensors
instead of the model's (B, Skv, KV, hd) cache views, a control for the
cost of the cache's layout.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

SHAPES = [  # (name, B, H, KV, Skv, hd, window, softcap), Sq = 1, causal
    ("danube_decode", 4, 32, 8, 4640, 120, 4096, 0.0),
    ("gemma2_decode", 4, 32, 16, 2080, 128, 4096, 50.0),
    ("stablelm_decode", 4, 32, 32, 2080, 80, 0, 0.0),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--contiguous", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("attn_decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    # ptxas's registers and spills of each decode kernel it compiles here.
    entry = ""
    for line in build.build(["flash_attention"]).get("flash_attention", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "decode" in line else ""
        elif entry and ("registers" in line or "spill" in line):
            print(f"{entry}: {line.strip()}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            flush.sum()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters

    def inputs(b, h, kv, skv, hd):
        q = torch.randn((b, 1, h, hd), generator=gen, device=dev).bfloat16()
        q = (q * torch.tensor(hd ** -0.5).bfloat16().item()).transpose(1, 2)
        k, v = (torch.randn((b, skv, kv, hd), generator=gen, device=dev).bfloat16()
                .transpose(1, 2) for _ in range(2))
        if args.contiguous:
            k, v = k.contiguous(), v.contiguous()
        return q, k, v

    def kernel_ms(fn) -> dict:
        """Device ms by kernel of one call (the decode kernel, the merge)."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = "decode" if "decode" in e.name else "combine" if "combine" in e.name \
                    else e.name[:30]
                out[name] = round(out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3, 4)
        return out

    def run(name, b, h, kv, skv, hd, window, softcap, tag=""):
        q, k, v = inputs(b, h, kv, skv, hd)
        kw = dict(causal=True, window=window, softcap=softcap, scale=1.0)
        got, want = ops.flash_attention(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
        rel = float((got.float() - want.float()).pow(2).mean().sqrt()
                    / want.float().pow(2).mean().sqrt())
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        sdpa = None
        if not softcap:
            delta = (skv - 1) - torch.arange(skv, device=dev)[None, :]
            band = (delta >= 0) & ((delta < window) if window else True)
            sdpa = round(time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, scale=1.0, enable_gqa=True)), 4)
        splits = fa.decode_splits(b, h, kv, 1, skv, True, window,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
        by_kernel = kernel_ms(lambda: ops.flash_attention(q, k, v, **kw))
        print(f"{args.root} {tag}{name}: kernel {ms:.4f} ms, sdpa {sdpa} ms, rel RMS {rel:.2e}, "
              f"splits {splits}, device ms {by_kernel}")

    for shape in SHAPES:
        run(*shape)
    if args.sweep:
        for per_sm in (2, 3, 4, 5, 6):
            fa._DECODE_BLOCKS_PER_SM = per_sm
            for shape in (SHAPES[0], SHAPES[2]):
                run(*shape, tag=f"blocks_per_sm={per_sm} ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
