"""Serving launcher: the continuous-batching engine (default) or the
lock-step decode, with the paper's Eq. 5 bias removal in the sampling path,
as ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch h2o-danube-3-4b --reduced --device cpu \
      --batch 4 --prompt-len 16 --gen 8 [--topk-beam 32] [--lockstep]

Decode paths, selected by ``--topk-beam``:

- dense (default, ``--topk-beam 0``): every step computes all-C logits
  (O(C·K) matmul) plus the dense tree pass for log p_n (O(C·k), the
  ``tree_logprob_all`` kernel on the card). Exact argmax.
- beam (``--topk-beam B``, B > 0): beam search descends the adversarial
  generator tree to propose B candidates in O(B·k·log C), scores only those
  (the ``gather_scores`` kernel on the card), and applies Eq. 5 debiasing on
  the candidate set.

By default requests run through ``repro_torch.serve.Engine``: a paged KV
pool in bf16 (``--slots`` decode lanes, ``--page-len``/``--n-pages`` page
geometry — the defaults reproduce the one-buffer-per-lane capacity),
priority-class admission with batched multi-request prefill, per-request
EOS / max-length retirement (``--eos-id``) with page reclamation, the
prefix-keyed candidate cache on the beam path, and the opt-in multi-tenant
features (``--prefix-sharing``, ``--spec-decode``, ``--preemption``,
``--page-growth ondemand``, ``--max-queue``, ``--enforce-deadlines``).
``--lockstep`` runs the fixed-batch loop instead; the two emit identical
tokens. ``--shard-scores`` and ``--model-axis`` above 1 (mesh serving) are
ROADMAP item 12 and raise.

Attention runs through the ``flash_attention`` kernel on the card (paged in
the engine). The weights are random from ``--seed`` and cast once to the
config's dtype; the prompts are drawn from ``--seed`` with a torch
generator on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch import device as device_lib
from repro_torch.models import lm_head, transformer
from repro_torch.train import make_prefill, make_serve_step


def build(arch: str, *, reduced: bool, head: str, seed: int, device="cuda",
          num_layers: Optional[int] = None) -> tuple:
    """(cfg, params, head state, head config) of ``arch``: the full config,
    or the reduced one; ``num_layers`` cuts the depth. The weights are drawn
    from ``seed`` on ``device`` and each layer is cast to the config's dtype
    as it is drawn (``init_params(cast=True)``), so the model never exists
    whole in float32."""
    dev = device_lib.resolve(device)
    cfg = cfg_lib.reduced_config(arch) if reduced else cfg_lib.get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg, device=dev, cast=True)
    head_state = lm_head.default_head_state(gen, cfg, head, device=dev)
    return cfg, params, head_state, lm_head.head_config(cfg, head)


def _prompts(args, cfg, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=dev)


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

    prompts = _prompts(args, cfg, dev)
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


def run_engine(args, cfg, params, head_state, hcfg, dev: torch.device) -> dict:
    """The continuous-batching engine over ``--batch`` requests of
    ``--prompt-len`` tokens and ``--gen`` new tokens each, on ``--slots``
    lanes. Prints the run's throughput, the engine's stats, the latency
    percentiles and the console summary of its registry. Returns the
    engine, the handles, the prompts and the wall ms (host clock ending in a
    synchronize)."""
    from repro_torch.obs import JsonlExporter, console_summary, start_metrics_server
    from repro_torch.obs.trace import ProfileWindow
    from repro_torch.serve import Engine, Request, ServeConfig

    slots = args.slots or args.batch
    exporter = JsonlExporter(args.metrics_jsonl) if args.metrics_jsonl else None
    engine = Engine(cfg, hcfg, params, head_state, ServeConfig(
        n_slots=slots, max_len=args.prompt_len + args.gen,
        page_len=args.page_len, n_pages=args.n_pages,
        beam=args.topk_beam,
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        cache_dtype=torch.bfloat16,
        prefix_sharing=args.prefix_sharing,
        spec_decode=args.spec_decode, max_draft=args.max_draft,
        preemption=args.preemption, page_growth=args.page_growth,
        max_queue=args.max_queue,
        enforce_deadlines=args.enforce_deadlines),
        exporter=exporter, metrics_interval=args.metrics_interval)
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = start_metrics_server(engine.registry, args.metrics_port,
                                              health_fn=engine.health)
        print(f"metrics endpoint: http://0.0.0.0:{metrics_server.port}"
              "/metrics (+ /healthz, /readyz)")
    if args.profile_dir:
        engine.registry.annotate = True     # spans label the trace
    prompts = _prompts(args, cfg, dev).cpu().numpy()

    _sync(dev)
    t0 = time.perf_counter()
    handles = [engine.submit(Request(prompt=p, max_new_tokens=args.gen))
               for p in prompts]
    profiler = ProfileWindow(args.profile_dir, n_steps=10**9)
    profiler.tick(0)            # whole-run capture; bounded by --gen
    engine.run()
    profiler.stop()
    _sync(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    tokens = sum(len(h.tokens) for h in handles)
    path = (f"beam={args.topk_beam}" if args.topk_beam
            else "dense debiased scores")
    print(f"engine: {len(handles)} requests over {slots} slots in "
          f"{wall_ms:.0f} ms ({1e3 * len(handles) / wall_ms:.1f} req/s, "
          f"{1e3 * tokens / wall_ms:.1f} tok/s) [{path}]")
    stats = engine.stats()
    lat = stats["latency"]
    print("stats:", {k: v for k, v in stats.items() if k not in ("latency", "metrics")})
    for name in ("admission_wait", "ttft", "total"):
        s = lat[name]
        if s["count"]:
            print(f"  {name}: p50={s['p50'] * 1e3:.1f}ms "
                  f"p95={s['p95'] * 1e3:.1f}ms p99={s['p99'] * 1e3:.1f}ms "
                  f"(n={s['count']})")
    print(console_summary(engine.registry, title="serve metrics"))
    if exporter is not None:
        exporter.emit({"event": "summary", "metrics": engine.registry.snapshot()})
        exporter.close()
        print(f"metrics JSONL: {args.metrics_jsonl}")
    if metrics_server is not None:
        metrics_server.close()
    print("sample:", handles[0].result().tolist())
    return dict(engine=engine, handles=handles, prompts=prompts, wall_ms=wall_ms)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b", choices=list(cfg_lib.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--head", default="adversarial_ns")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (and the lock-step batch size)")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine decode lanes (0 = --batch)")
    ap.add_argument("--page-len", type=int, default=0,
                    help="KV page size in positions (0 = one max_len page "
                         "per request: one buffer a lane)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="KV arena capacity in pages (0 = full per-lane "
                         "reservation; smaller packs more lanes into the "
                         "same device bytes on mixed-length traffic)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8, help="max new tokens per request")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token id (-1 = disabled)")
    ap.add_argument("--topk-beam", type=int, default=0,
                    help="0 = dense O(C) scoring; B > 0 = tree-guided beam "
                         "search over B candidates, O(B k log C) per token")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="model-parallel mesh axis (above 1: ROADMAP item 12)")
    ap.add_argument("--shard-scores", action="store_true",
                    help="mesh-sharded candidate scoring (ROADMAP item 12)")
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-batch decode instead of the engine")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream request/serve_step JSONL events "
                         "(DESIGN.md §10) to this path (engine path only)")
    ap.add_argument("--metrics-interval", type=int, default=1,
                    help="emit a 'serve_step' event every N engine iterations")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the engine run "
                         "into this directory")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the engine registry as Prometheus text on "
                         "this port (/metrics, stdlib HTTP thread; 0 = "
                         "ephemeral port, engine path only)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="share identical prompt-prefix KV pages across "
                         "requests (radix trie + refcounts + COW tails)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decode with the fitted generator "
                         "tree as draft model (byte-identical outputs)")
    ap.add_argument("--max-draft", type=int, default=4,
                    help="draft chain cap per speculative verify step")
    ap.add_argument("--preemption", action="store_true",
                    help="allow higher-priority admissions to spill "
                         "lower-priority lanes (byte-exact restore)")
    ap.add_argument("--page-growth", default="reserve",
                    choices=["reserve", "ondemand"],
                    help="KV page policy: worst-case reservation at "
                         "admission vs on-demand growth at page boundaries")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed (reject with status='shed') submissions "
                         "once this many requests are pending (0 = "
                         "unbounded queue)")
    ap.add_argument("--enforce-deadlines", action="store_true",
                    help="abort queued/active requests whose deadline_s "
                         "expired (status='deadline'), reclaiming their "
                         "lanes and pages")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.shard_scores or args.model_axis > 1:
        raise NotImplementedError("mesh serving (--shard-scores, --model-axis) is "
                                  "not ported yet (ROADMAP item 12)")
    dev = device_lib.resolve(args.device)
    cfg, params, head_state, hcfg = build(args.arch, reduced=args.reduced, head=args.head,
                                          seed=args.seed, device=dev)
    with torch.no_grad():
        if args.lockstep:
            run_lockstep(args, cfg, params, head_state, hcfg, dev)
        else:
            run_engine(args, cfg, params, head_state, hcfg, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
