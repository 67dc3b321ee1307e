"""Training launcher: build the model, the step and the fault-tolerant loop,
as ``repro.launch.train`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --reduced --device cpu --steps 20 --head adversarial_ns --ckpt /tmp/ckpt

The step runs on ``--device`` (``cuda`` by default; a machine without CUDA
raises rather than falling back to the CPU). On the card the sparse head
path always runs the ``sampled_head_loss`` kernel, the generator fits sum
through ``segment_stats``, and attention is the plain differentiable one
(the ``flash_attention`` kernel is forward-only). The reference's
``--head-kernel`` switch has no counterpart, and ``--model-axis`` with the
mesh shardings waits for the parallel slice (ROADMAP item 12).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as cfg_lib
from repro_torch import device as device_lib
from repro_torch.data import lm_batch_fn
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.train import LoopConfig, init_train_state, make_train_step, run_loop
from repro_torch.train.generator_fit import fit_lm_sampler, make_gen_fit_fn

# The reference's PRNGKey(0) for the parameters and PRNGKey(1) for the loop.
PARAM_SEED, LOOP_SEED = 0, 1


def build(args):
    """(model config, head config, optimizer config) of the parsed flags."""
    cfg = (cfg_lib.reduced_config(args.arch) if args.reduced
           else cfg_lib.get_config(args.arch))
    hcfg = lm_head.head_config(cfg, args.head, n_neg=args.n_neg, reg=args.reg)
    opt = OptimizerConfig(name=args.optimizer, learning_rate=args.lr, clip_norm=1.0,
                          head_name=args.head_optimizer, state_dtype=args.state_dtype)
    return cfg, hcfg, opt


def batch_fn_for(make, dev: torch.device):
    """``batch_fn(step)``: the numpy batch of ``make(step)`` as tensors on
    ``dev``."""
    return lambda step: {k: torch.as_tensor(v).to(dev) for k, v in make(step).items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train an LM with the adversarial "
                                             "softmax head (the port, one device)")
    ap.add_argument("--arch", default="stablelm-3b", choices=list(cfg_lib.ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu for tests)")
    ap.add_argument("--head", default="adversarial_ns")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--reg", type=float, default=1e-4)
    ap.add_argument("--n-neg", type=int, default=1)
    ap.add_argument("--head-update", default="auto", choices=("auto", "dense", "sparse"),
                    help="head-gradient path: sparse = O(B·K·n_neg) touched-row "
                         "updates (default for sampled heads), dense = O(C·K) "
                         "autograd (default and required for softmax)")
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--head-optimizer", default=None,
                    choices=(None, "sgd", "adagrad", "adamw", "sm3"),
                    help="override the optimizer for head params only ('sm3' "
                         "keeps one row + one column cover instead of the (C, K) "
                         "slab)")
    ap.add_argument("--state-dtype", default="fp32", choices=("fp32", "bf16", "int8"),
                    help="storage dtype of the head optimizer accumulators "
                         "(compute stays fp32; int8 adds a per-row scale)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--gen-warmup", type=int, default=0)
    ap.add_argument("--gen-refresh", type=int, default=0,
                    help="refit the generator every N steps (0 = once)")
    ap.add_argument("--gen-async", action="store_true",
                    help="fit in a background thread; swap at the recorded step "
                         "(submit + --gen-swap-delay)")
    ap.add_argument("--gen-swap-delay", type=int, default=4)
    ap.add_argument("--gen-method", default="levelwise",
                    choices=("levelwise", "sequential", "sharded"))
    ap.add_argument("--sampler", default="config",
                    choices=("config", "uniform", "unigram", "lsh", "rff"),
                    help="negative-sampling proposal: 'config' derives it from "
                         "--head and the generator state (the tree for "
                         "adversarial_ns); the others are fitted once from a "
                         "model snapshot at startup and override it")
    ap.add_argument("--gen-refresh-mode", default="period", choices=("period", "snr"),
                    help="'period' refits every --gen-refresh steps; 'snr' refits "
                         "when the online gradient-SNR proxy degrades past "
                         "--snr-threshold x its post-install reference")
    ap.add_argument("--snr-threshold", type=float, default=0.85)
    ap.add_argument("--snr-patience", type=int, default=8)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write the obs JSONL event log (per-step samples and the "
                         "generator refresh lifecycle) to this path")
    ap.add_argument("--metrics-interval", type=int, default=1,
                    help="emit a 'step' JSONL event every N steps")
    ap.add_argument("--nonfinite-policy", default="skip", choices=("skip", "raise"),
                    help="on a non-finite loss: 'skip' drops the update before any "
                         "write and counts it (train/nonfinite_skipped), escalating "
                         "to rollback-restore after --max-consecutive-nonfinite "
                         "skips; 'raise' fails fast")
    ap.add_argument("--max-consecutive-nonfinite", type=int, default=3)
    ap.add_argument("--max-rollbacks", type=int, default=2,
                    help="rollback-restores allowed per run before the loop gives "
                         "up with FloatingPointError")
    ap.add_argument("--gen-fit-retries", type=int, default=2,
                    help="transient generator-fit failures absorbed by retry "
                         "(exponential backoff) before the loop keeps the stale "
                         "generator")
    ap.add_argument("--gen-fit-timeout", type=float, default=None,
                    help="watchdog seconds for a background fit; a hung fit is "
                         "abandoned and the stale generator kept")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of a few steady-state "
                         "steps into this directory")
    return ap


def loop_config(args) -> LoopConfig:
    return LoopConfig(total_steps=args.steps,
                      checkpoint_every=max(args.steps // 2, 1),
                      checkpoint_dir=args.ckpt,
                      gen_warmup_steps=args.gen_warmup,
                      gen_refresh_steps=args.gen_refresh,
                      gen_async=args.gen_async,
                      gen_swap_delay=args.gen_swap_delay,
                      gen_refresh_mode=args.gen_refresh_mode,
                      snr_threshold=args.snr_threshold,
                      snr_patience=args.snr_patience,
                      metrics_jsonl=args.metrics_jsonl,
                      metrics_interval=args.metrics_interval,
                      profile_dir=args.profile_dir,
                      nonfinite_policy=args.nonfinite_policy,
                      max_consecutive_nonfinite=args.max_consecutive_nonfinite,
                      max_rollbacks=args.max_rollbacks,
                      gen_fit_retries=args.gen_fit_retries,
                      gen_fit_timeout_s=args.gen_fit_timeout)


def setup(args):
    """Everything ``main`` runs: (cfg, hcfg, state, train_step, batch_fn,
    gen_fit_fn, loop config)."""
    dev = device_lib.resolve(args.device)
    cfg, hcfg, opt = build(args)
    state = init_train_state(torch.Generator(device=dev).manual_seed(PARAM_SEED), cfg,
                             opt, args.head, device=dev)
    make = lm_batch_fn(cfg.vocab_size, args.batch, args.seq, seed=0)
    batch_fn = batch_fn_for(make, dev)
    sampler = None
    if args.sampler != "config":
        # Fit the override proposal once from a startup snapshot, in the head
        # state's own feature space (x_gen = h @ proj), so sampling and the
        # Eq. 5 debias see the same features.
        sampler, _ = fit_lm_sampler(args.sampler, state.params, cfg,
                                    (batch_fn(10_000 + i) for i in range(4)),
                                    proj=state.head_state.proj)
        print(f"sampler: {type(sampler).__name__} (--sampler {args.sampler})")
    train_step = make_train_step(cfg, hcfg, opt, head_update=args.head_update,
                                 sampler=sampler,
                                 skip_nonfinite=args.nonfinite_policy == "skip")
    gen_cb = None
    if args.gen_warmup and args.head in ("adversarial_ns", "nce", "sampled_softmax",
                                         "freq_ns"):
        gen_cb = make_gen_fit_fn(cfg, batch_fn, kind=args.head, max_tokens=8192,
                                 method=args.gen_method)
    return cfg, hcfg, state, train_step, batch_fn, gen_cb, loop_config(args)


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, hcfg, state, train_step, batch_fn, gen_cb, loop = setup(args)
    print(f"model: {cfg.name} ({'reduced' if args.reduced else 'full'}), "
          f"{cfg.param_count() / 1e6:.1f}M params on {args.device}")
    from repro_torch.obs import Registry, console_summary
    registry = Registry() if (args.metrics_jsonl or args.profile_dir) else None
    state, hist = run_loop(
        state, train_step, batch_fn, loop, LOOP_SEED, gen_fit_fn=gen_cb,
        registry=registry,
        on_step=lambda s, m: print(f"step {s:4d} loss={m['loss']:.4f} "
                                   f"{m['step_time'] * 1e3:.0f}ms", flush=True))
    print(f"final loss {hist['loss'][-1]:.4f}; stragglers={hist['stragglers']}")
    if registry is not None:
        print(console_summary(registry, title="train metrics"))
        if args.metrics_jsonl:
            print(f"metrics JSONL: {args.metrics_jsonl}")
        if args.profile_dir:
            print(f"profile: {args.profile_dir} (a torch.profiler Chrome trace; host "
                  f"spans annotate it)")
    return state, hist


if __name__ == "__main__":
    main()
