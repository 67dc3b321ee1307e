"""Serving launcher: the lock-step decode with the paper's Eq. 5 bias
removal in the sampling path, as ``repro.launch.serve --lockstep``.

  PYTHONPATH=src python -m repro_torch.launch.serve --lockstep \
      --arch h2o-danube-3-4b --reduced --device cpu \
      --batch 4 --prompt-len 16 --gen 8 [--topk-beam 32]

Decode paths, selected by ``--topk-beam``:

- dense (default, ``--topk-beam 0``): every step computes all-C logits
  (O(C·K) matmul) plus the dense tree pass for log p_n (O(C·k), the
  ``tree_logprob_all`` kernel on the card). Exact argmax.
- beam (``--topk-beam B``, B > 0): beam search descends the adversarial
  generator tree to propose B candidates in O(B·k·log C), scores only those
  (the ``gather_scores`` kernel on the card), and applies Eq. 5 debiasing on
  the candidate set.

Attention runs through the ``flash_attention`` kernel on the card. The
weights are random from ``--seed`` and cast once to the config's dtype. The
continuous-batching engine (the reference's default path) is ROADMAP item
11: without ``--lockstep`` the launcher exits with status 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch import device as device_lib
from repro_torch.models import lm_head, transformer
from repro_torch.train import make_prefill, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lockstep(args, cfg, params, head_state, hcfg, dev: torch.device) -> dict:
    """Fixed-batch decode: one lock-step batch, no admission. Rows that emit
    ``--eos-id`` are frozen (their subsequent tokens pinned to EOS) and the
    loop exits early once every row has finished. Returns the prompts, the
    generated tokens (B, steps), the prefill ms and the decode ms, each on
    the host clock ending in a synchronize, and the cache and last token."""
    max_len = args.prompt_len + args.gen
    cache = transformer.init_cache(cfg, args.batch, max_len, device=dev)
    prefill = make_prefill(cfg)
    serve_step = make_serve_step(cfg, hcfg, topk_beam=args.topk_beam)

    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    _, cache = prefill(params, prompts, cache)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_ms:.0f} ms")

    token = prompts[:, -1:]
    finished = np.zeros((args.batch,), bool)
    toks = []
    steps = 0
    t0 = time.perf_counter()
    for t in range(args.gen):
        token, cache = serve_step(params, head_state, token, cache, args.prompt_len + t)
        steps += 1
        if args.eos_id >= 0:
            row = token[:, 0].cpu().numpy()
            row = np.where(finished, args.eos_id, row)
            finished |= row == args.eos_id
            token = torch.as_tensor(row[:, None], device=dev)
            toks.append(token)
            if finished.all():
                break
        else:
            toks.append(token)
    _sync(dev)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    out = torch.cat(toks, dim=1).cpu().numpy()
    if args.eos_id >= 0:
        # Real tokens only: everything after a row's first EOS is padding.
        hit = out == args.eos_id
        real = np.where(hit.any(1), hit.argmax(1) + 1, out.shape[1]).sum()
    else:
        real = out.size
    path = (f"beam={args.topk_beam}" if args.topk_beam
            else "dense debiased scores")
    print(f"decode {steps} steps: {decode_ms:.0f} ms "
          f"({1e3 * real / decode_ms:.1f} tok/s) [{path}, lock-step]")
    print("sample:", out[0].tolist())
    return dict(prompts=prompts, tokens=out, prefill_ms=prefill_ms,
                decode_ms=decode_ms, steps=steps, cache=cache, token=token)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b", choices=list(cfg_lib.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--head", default="adversarial_ns")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (the lock-step batch size)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8, help="max new tokens per request")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token id (-1 = disabled)")
    ap.add_argument("--topk-beam", type=int, default=0,
                    help="0 = dense O(C) scoring; B > 0 = tree-guided beam "
                         "search over B candidates, O(B k log C) per token")
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-batch decode (the only path the port has)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.lockstep:
        print("the continuous-batching engine is not ported yet (ROADMAP item "
              "11); pass --lockstep", file=sys.stderr)
        return 2
    dev = device_lib.resolve(args.device)
    cfg = (cfg_lib.reduced_config(args.arch) if args.reduced
           else cfg_lib.get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.cast_params(transformer.init_params(gen, cfg, device=dev), cfg)
    head_state = lm_head.default_head_state(gen, cfg, args.head, device=dev)
    hcfg = lm_head.head_config(cfg, args.head)
    run_lockstep(args, cfg, params, head_state, hcfg, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
