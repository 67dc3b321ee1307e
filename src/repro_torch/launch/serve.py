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
tokens.

Under ``torchrun`` every rank serves the same requests on a ("data",
"model") mesh of ``--model-axis`` model ranks (:mod:`repro_torch.launch.
mesh`); rank 0 alone prints:

  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.serve --model-axis 2 --shard-scores \
      --device cpu|cuda|cuda:0 ...

Each rank builds only its part of the model, as the reference's
``param_spec`` places it over ``model`` (``parallel.sharding``): the
embedding's and the head's rows, the attention heads, the MLP's and the
experts' ``d_ff`` or the experts themselves, the SSM heads; the KV cache
and the paged arena are split by KV heads where they divide. With more
than one ``data`` rank each trunk matrix is cut over ``data`` as well
(FSDP) and every step gathers each layer over ``data`` before it runs.
Each block's partial sums are reduced over ``model``; the beam path scores through
``sharded_candidate_scores`` and the dense path merges each rank's argmax.
The ``mesh:`` line gives every rank's parameter and trunk bytes beside the
one-rank trunk's, split over ``model``, whole, over ``data`` and over
both. ``--shard-scores`` selects the head's lowering, the only one the
port has, and is kept so that the reference's command lines run.
``--model-axis`` above 1 without ``torchrun`` raises. ``--report-dir``
makes each rank write its tokens, times, bytes, peak memory, kernel
launches and the trunk's collectives (``model``'s and FSDP's) to
``serve_rank<r>.json`` there;
``--time-collectives`` times those collectives (the device synchronized
around each), and ``--teacher-tokens`` makes a lock-step run decode its
prompts again fed the given tokens, writing the prefill's last hiddens and
each step's dense Eq. 5 scores (a rank's vocabulary rows) to
``serve_rank<r>.pt``; the engine writes there each prefilled row's last
hidden and each request's hidden at its first decode step
(:class:`HiddenTap`). These are what a sharded deployment is checked
against one rank with.

Attention runs through the ``flash_attention`` kernel on the card (paged in
the engine). The weights are random from ``--seed`` and cast once to the
config's dtype; the prompts are drawn from ``--seed`` with a torch
generator on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch import device as device_lib
from repro_torch.core.heads import HeadParams
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm_head, transformer
from repro_torch.parallel import collectives, sharding
from repro_torch.train import make_prefill, make_serve_step

KERNELS = ("flash_attention", "gather_scores", "tree_logprob_all")


def build(arch: str, *, reduced: bool, head: str, seed: int, device="cuda",
          num_layers: Optional[int] = None, mesh=None, dtype: Optional[str] = None) -> tuple:
    """(cfg, params, head state, head config) of ``arch``: the full config,
    or the reduced one; ``num_layers`` cuts the depth, ``dtype`` replaces the
    config's compute dtype (the same draws, unrounded in float32). The weights are drawn
    from ``seed`` on ``device`` and each layer is cast to the config's dtype
    as it is drawn (``init_params(cast=True)``), so the model never exists
    whole in float32. Under ``mesh`` the params are this rank's part, each
    layer cut as soon as it is drawn (``init_params(mesh=)``)."""
    dev = device_lib.resolve(device)
    cfg = cfg_lib.reduced_config(arch) if reduced else cfg_lib.get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg, device=dev, cast=True, mesh=mesh)
    head_state = lm_head.default_head_state(gen, cfg, head, device=dev)
    return cfg, params, head_state, lm_head.head_config(cfg, head)


def _prompts(args, cfg, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lockstep(args, cfg, params, head_state, hcfg, dev: torch.device,
                 mesh=None) -> dict:
    """Fixed-batch decode: one lock-step batch, no admission. Rows that emit
    ``--eos-id`` are frozen (their subsequent tokens pinned to EOS) and the
    loop exits early once every row has finished. Returns the prompts, the
    generated tokens (B, steps), the prefill ms and the decode ms, each on
    the host clock ending in a synchronize, the cache and last token, and
    the prefill's last hiddens (B, d) on the host.
    Under ``mesh`` the params are this rank's."""
    max_len = args.prompt_len + args.gen
    cache = transformer.init_cache(cfg, args.batch, max_len, device=dev, mesh=mesh)
    prefill = make_prefill(cfg, mesh=mesh)
    serve_step = make_serve_step(cfg, hcfg, topk_beam=args.topk_beam, mesh=mesh)

    prompts = _prompts(args, cfg, dev)
    _sync(dev)
    t0 = time.perf_counter()
    h, cache = prefill(params, prompts, cache)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_last = h[:, -1].float().cpu()
    del h
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
                decode_ms=decode_ms, steps=steps, cache=cache, token=token,
                prefill_last=prefill_last)


def teacher_forced(args, cfg, params, head_state, hcfg, dev: torch.device, tokens,
                   mesh=None, run: Optional[dict] = None) -> dict:
    """The lock-step decode of the run's prompts fed ``tokens`` (B, steps)
    instead of its own choices, as ``run_lockstep`` feeds them (the last
    prompt token first, at position ``prompt_len``): the prefill's last
    hiddens (B, d), each step's dense Eq. 5 scores (steps, B, n) of this
    rank's vocabulary rows [lo, lo + n), float32 on the host, and the
    decode's ms (host clock ending in a synchronize).

    ``run``, a ``run_lockstep`` result of an attention model, lends its
    prefill: its cache holds the prompts' K/V below ``prompt_len``, and
    each step writes its own position before it reads (an SSM's state is
    not positional, so there ``run`` raises)."""
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)
    steps = tokens.shape[1]
    prompts = _prompts(args, cfg, dev)
    lo = 0 if mesh is None else sharding.row_range(cfg.padded_vocab, mesh)[0]
    head = HeadParams(**params["head"])
    if run is not None:
        if cfg.block != "attn":
            raise ValueError("a recurrent state cannot be rewound: run the prefill again")
        cache, last = run["cache"], run["prefill_last"]
    else:
        cache = transformer.init_cache(cfg, args.batch, args.prompt_len + steps, device=dev,
                                       mesh=mesh)
        h, cache, _ = transformer.forward(params, cfg, prompts, cache=cache, cache_pos=0,
                                          mesh=mesh)
        last = h[:, -1].float().cpu()
    token, scores = prompts[:, -1:], []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(steps):
        h, cache, _ = transformer.forward(params, cfg, token, cache=cache,
                                          cache_pos=args.prompt_len + t, mesh=mesh)
        scores.append(lm_head.lm_predictive_scores(cfg, hcfg, head, head_state, h[:, -1],
                                                   lo=lo).float().cpu())
        token = tokens[:, t:t + 1]
    _sync(dev)
    return dict(prefill_last=last, scores=torch.stack(scores), lo=lo,
                decode_ms=1e3 * (time.perf_counter() - t0))


class HiddenTap:
    """Wraps an engine's prefill and decode steps so that they also keep,
    float32 on the host, what a sharded engine is held to one rank's with:
    each prefilled row's last hidden, in launch order, and each request's
    hidden at its first decode step (whose input is the prompt's last
    token, so no choice of the run has entered it yet), by request id."""

    def __init__(self, engine):
        self.prefill_last, self.decode_first = [], {}
        batched, paged, decode = engine._prefill, engine._paged_prefill, engine._decode

        def keep_last(h, lengths):
            n = np.asarray(lengths).astype(np.int64)
            rows = np.nonzero(n > 0)[0]
            self.prefill_last.append(h[torch.as_tensor(rows, device=h.device),
                                       torch.as_tensor(n[rows] - 1, device=h.device)]
                                     .float().cpu())

        def tapped_batched(params, tokens, lengths, lanes, arena, tables):
            h, arena = batched(params, tokens, lengths, lanes, arena, tables)
            keep_last(h, lengths)
            return h, arena

        def tapped_paged(params, tokens, start, lengths, arena, tables):
            h, arena = paged(params, tokens, start, lengths, arena, tables)
            keep_last(h, lengths)
            return h, arena

        def tapped_decode(params, token, arena, cache_pos, table):
            h, arena = decode(params, token, arena, cache_pos, table)
            for slot, st in engine._active.items():
                if not st.tokens and st.request_id not in self.decode_first:
                    self.decode_first[st.request_id] = h[slot].float().cpu()
            return h, arena

        engine._prefill, engine._decode = tapped_batched, tapped_decode
        if paged is not None:
            engine._paged_prefill = tapped_paged

    def tensors(self) -> dict:
        """``prefill_last`` (rows, d) and ``decode_first`` (requests, d)."""
        return dict(prefill_last=torch.cat(self.prefill_last),
                    decode_first=torch.stack([self.decode_first[i]
                                              for i in sorted(self.decode_first)]))


def run_engine(args, cfg, params, head_state, hcfg, dev: torch.device,
               mesh=None, tap: bool = False) -> dict:
    """The continuous-batching engine over ``--batch`` requests of
    ``--prompt-len`` tokens and ``--gen`` new tokens each, on ``--slots``
    lanes. Prints the run's throughput, the engine's stats, the latency
    percentiles and the console summary of its registry. Returns the
    engine, the handles, the prompts and the wall ms (host clock ending in a
    synchronize); with ``tap``, also the :class:`HiddenTap` tensors of the
    run (``hiddens``)."""
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
        enforce_deadlines=args.enforce_deadlines, mesh=mesh),
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
    hidden_tap = HiddenTap(engine) if tap else None

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
    out = dict(engine=engine, handles=handles, prompts=prompts, wall_ms=wall_ms)
    if hidden_tap is not None:
        out["hiddens"] = hidden_tap.tensors()
    return out


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
                    help="model ranks of the (data, model) mesh under torchrun; "
                         "the model's heads, d_ff, experts and vocab rows shard "
                         "over them")
    ap.add_argument("--shard-scores", action="store_true",
                    help="score beam candidates with sharded_candidate_scores: "
                         "the only lowering of a mesh, selected under one anyway")
    ap.add_argument("--report-dir", default=None,
                    help="each rank writes serve_rank<r>.json (tokens, ms, kernel "
                         "launches) into this directory, and the engine its prefill's "
                         "and first decode step's hiddens to serve_rank<r>.pt")
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-batch decode instead of the engine")
    ap.add_argument("--teacher-tokens", default=None,
                    help="a .npy of (batch, steps) token ids: after the lock-step run, "
                         "decode again fed them and write the prefill's last hiddens and "
                         "each step's dense scores to --report-dir/serve_rank<r>.pt")
    ap.add_argument("--time-collectives", action="store_true",
                    help="synchronize the device around each of the trunk's model "
                         "and FSDP collectives and report their host seconds")
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


def param_bytes(cfg, params, mesh) -> dict:
    """This process's parameter and trunk bytes, and the one-rank trunk's
    (from a meta-device build) split over ``model`` only, over ``data``
    only, over both, and whole, so that a rank of (dp, tp) should hold
    model / tp + data / dp + both / (dp·tp) + whole."""
    full = transformer.init_params(torch.Generator(), cfg, device="meta", cast=True)
    split = sharding.split_bytes({"layers": full["layers"]}, cfg,
                                 mesh if mesh is not None else (1, 1))
    return {"params": sharding.tree_bytes(params),
            "trunk": sharding.tree_bytes(params["layers"]),
            "trunk_one_rank": sharding.tree_bytes(full["layers"]),
            **{f"trunk_{k}": v for k, v in split._asdict().items()}}


def _mesh_line(mesh, nbytes: dict) -> str:
    """The ``mesh:`` line with every rank's parameter and trunk bytes."""
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, nbytes)
    return (f"{mesh_lib.describe(mesh)}; parameter bytes a rank "
            f"{[b['params'] for b in every]}, trunk bytes a rank "
            f"{[b['trunk'] for b in every]} (one rank's trunk {nbytes['trunk_one_rank']}: "
            f"{nbytes['trunk_model']} split over model, {nbytes['trunk_whole']} whole) + "
            f"({nbytes['trunk_data']} split over data, {nbytes['trunk_both']} over both)")


def _report(args, mesh, out: dict, tokens, launches: dict, nbytes: dict,
            dev: torch.device) -> None:
    """This rank's ``serve_rank<r>.json`` in ``--report-dir``: the tokens of
    each request, the kernel launches of the run, its host-clock times and
    its parameter bytes."""
    r = torch.distributed.get_rank() if mesh is not None else 0
    os.makedirs(args.report_dir, exist_ok=True)
    rec = {"rank": r, "path": "lockstep" if args.lockstep else "engine",
           "beam": args.topk_beam, "tokens": [[int(x) for x in row] for row in tokens],
           "launches": launches, "bytes": nbytes,
           "trunk_collectives": dataclasses.asdict(collectives.TRUNK),
           "fsdp_collectives": dataclasses.asdict(collectives.FSDP),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
           **{k: out[k] for k in ("prefill_ms", "decode_ms", "steps", "wall_ms") if k in out}}
    with open(os.path.join(args.report_dir, f"serve_rank{r}.json"), "w") as f:
        json.dump(rec, f)


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh = mesh_lib.launcher_mesh(args.model_axis, args.device, "repro_torch.launch.serve")
    dev = (mesh_lib.rank_device(args.device) if mesh is not None
           else device_lib.resolve(args.device))
    if not mesh_lib.is_lead(mesh):
        sys.stdout = open(os.devnull, "w")
    cfg, params, head_state, hcfg = build(args.arch, reduced=args.reduced, head=args.head,
                                          seed=args.seed, device=dev, mesh=mesh)
    nbytes = param_bytes(cfg, params, mesh)
    if mesh is not None:
        print(_mesh_line(mesh, nbytes))
    if args.teacher_tokens and not (args.lockstep and args.report_dir):
        raise ValueError("--teacher-tokens needs --lockstep and --report-dir")
    for name in KERNELS:
        getattr(ops, name).launches = 0
    for kind in (collectives.TRUNK, collectives.FSDP):
        kind.reset()
        kind.timed = args.time_collectives
    with torch.no_grad():
        if args.lockstep:
            out = run_lockstep(args, cfg, params, head_state, hcfg, dev, mesh=mesh)
            tokens = out["tokens"]
        else:
            out = run_engine(args, cfg, params, head_state, hcfg, dev, mesh=mesh,
                             tap=bool(args.report_dir))
            tokens = [h.tokens for h in out["handles"]]
    if args.report_dir:
        _report(args, mesh, out, tokens, {n: getattr(ops, n).launches for n in KERNELS},
                nbytes, dev)
        if "hiddens" in out:
            r = torch.distributed.get_rank() if mesh is not None else 0
            torch.save(out["hiddens"], os.path.join(args.report_dir, f"serve_rank{r}.pt"))
    if args.teacher_tokens:
        collectives.TRUNK.reset()
        with torch.no_grad():
            forced = teacher_forced(args, cfg, params, head_state, hcfg, dev,
                                    np.load(args.teacher_tokens), mesh=mesh,
                                    run=out if cfg.block == "attn" else None)
        forced["trunk_collectives"] = dataclasses.asdict(collectives.TRUNK)
        r = torch.distributed.get_rank() if mesh is not None else 0
        torch.save(forced, os.path.join(args.report_dir, f"serve_rank{r}.pt"))
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
