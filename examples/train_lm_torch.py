"""End-to-end LM training with the adversarial softmax head, on the PyTorch
port: the counterpart of ``examples/train_lm.py``.

Pipeline: synthetic clustered-bigram token stream -> decoder LM ->
generator warmup fit (tree on a frozen hidden-state snapshot) ->
adversarial-NS training with checkpoints + straggler monitor ->
debiased eval (Eq. 5).

Profiles:
  demo  (default) — ~1M params, 150 steps
  100m           — ~100M params (d=768, 12L), a few hundred steps

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--device cuda|cpu]
      [--profile demo|100m] [--head adversarial_ns|softmax|uniform_ns|...]
      [--gen-refresh N] [--gen-async] [--gen-swap-delay D]

With ``--gen-refresh N`` the tree is refitted every N steps from a frozen
snapshot, warm-started from the previous tree after the first fit. In
blocking mode the loop stalls for each fit; with ``--gen-async`` the fit
runs in a background thread while training steps on the stale generator,
and the new tree is swapped in at the recorded step (submit + D).
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core.heads import resolve_head_update  # noqa: E402
from repro_torch.core.tree_fit import FitConfig  # noqa: E402
from repro_torch.data import lm_batch_fn  # noqa: E402
from repro_torch.launch.train import batch_fn_for  # noqa: E402
from repro_torch.models import lm_head  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import (LoopConfig, init_train_state, make_eval_step,  # noqa: E402
                               make_train_step, run_loop)
from repro_torch.train.generator_fit import make_gen_fit_fn  # noqa: E402

PROFILES = {
    "demo": dict(num_layers=2, d_model=128, d_ff=384, vocab_size=2048,
                 num_heads=4, num_kv_heads=2, seq=64, batch=8, steps=150,
                 gen_warmup=60),
    "100m": dict(num_layers=12, d_model=768, d_ff=2304, vocab_size=32_768,
                 num_heads=12, num_kv_heads=4, seq=512, batch=8, steps=300,
                 gen_warmup=50),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="demo", choices=PROFILES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--head", default="adversarial_ns")
    ap.add_argument("--head-update", default="auto", choices=("auto", "dense", "sparse"),
                    help="head-gradient path: sparse = O(B·K·n_neg) touched-row "
                         "updates, independent of vocab size; dense = O(C·K) "
                         "autograd. auto picks sparse for sampled heads.")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--gen-refresh", type=int, default=None,
                    help="refresh the generator every N steps (default: steps // 3)")
    ap.add_argument("--gen-async", action="store_true",
                    help="non-blocking refresh: fit in a background thread, swap "
                         "at the recorded step")
    ap.add_argument("--gen-swap-delay", type=int, default=8)
    args = ap.parse_args(argv)
    p = PROFILES[args.profile]
    steps = args.steps or p["steps"]
    dev = device_lib.resolve(args.device)

    cfg = ModelConfig(
        name=f"lm-{args.profile}", num_layers=p["num_layers"],
        d_model=p["d_model"], d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        vocab_pad_multiple=128, gen_feature_dim=16, dtype="float32",
        remat=False)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params, head={args.head}, on {dev}")

    hcfg = lm_head.head_config(cfg, args.head, n_neg=1, reg=1e-4)
    opt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opt,
                             args.head, device=dev)
    head_update = resolve_head_update(args.head_update, args.head)
    desc = ("O(B·K·n_neg) touched-row updates, independent of C"
            if head_update == "sparse" else "dense O(C·K) gradient + optimizer sweep")
    print(f"head update: {head_update} ({desc})")
    train_step = make_train_step(cfg, hcfg, opt, head_update=head_update)
    eval_step = make_eval_step(cfg, hcfg)
    batch_fn = batch_fn_for(lm_batch_fn(cfg.vocab_size, p["batch"], p["seq"], seed=0), dev)

    # Higher lambda_n than the paper's 0.1: LM hidden states drift, so a
    # conservative (better-calibrated) generator keeps the Eq. 5 correction
    # bounded. The first fit is full; later refreshes warm-start.
    base_fit = make_gen_fit_fn(cfg, batch_fn, kind=args.head, fit_config=FitConfig(reg=1.0),
                               max_tokens=16_384, n_batches=32)
    fit_log = []

    def gen_fit(st):
        t0 = time.perf_counter()
        head = base_fit(st)
        fit_log.append(time.perf_counter() - t0)
        return head

    with tempfile.TemporaryDirectory() as ckpt_dir:
        refresh = args.gen_refresh or max(steps // 3, 1)
        warmup = min(p["gen_warmup"], max(steps // 4, 1))
        # Async needs the swap to precede the next submit; with a 1-step
        # refresh period there is no room, so fall back to blocking.
        use_async = args.gen_async and refresh > 1
        loop = LoopConfig(total_steps=steps, checkpoint_every=max(steps // 4, 1),
                          checkpoint_dir=ckpt_dir, gen_warmup_steps=warmup,
                          gen_refresh_steps=refresh, gen_async=use_async,
                          gen_swap_delay=(min(args.gen_swap_delay, refresh - 1)
                                          if use_async else 0))
        gen_cb = gen_fit if args.head in ("adversarial_ns", "nce", "sampled_softmax",
                                          "freq_ns") else None
        print(f"generator refresh: every {refresh} steps "
              f"({'async' if use_async else 'blocking'})")
        state, hist = run_loop(
            state, train_step, batch_fn, loop, 1, gen_fit_fn=gen_cb,
            on_step=lambda s, m: (s % 10 == 0) and print(
                f"  step {s:4d} loss={m['loss']:.4f} ({m['step_time'] * 1e3:.0f} ms)"))
        print(f"stragglers flagged: {hist['stragglers']}")
        times = hist.get("step_times", [])
        if times:
            tail = times[len(times) // 2:]
            print(f"step time ({head_update} head update): "
                  f"{1e3 * sum(tail) / len(tail):.1f} ms "
                  f"(mean of the last {len(tail)} steps)")
        if fit_log:
            print(f"generator fits: {len(fit_log)} (first {fit_log[0] * 1e3:.0f} ms "
                  f"full, refresh {[f'{t * 1e3:.0f}' for t in fit_log[1:]]} ms warm)")
        for key in ("gen_submit_steps", "gen_swap_steps"):
            if key in hist:
                print(f"{key}: {hist[key]}")

        ev = eval_step(state, batch_fn(99_999))
        print(f"eval (debiased): loglik={float(ev['eval_loglik']):.4f} "
              f"acc={float(ev['eval_acc']):.4f}")
        first = sum(hist["loss"][:5]) / 5
        last = sum(hist["loss"][-5:]) / 5
        print(f"loss {first:.4f} -> {last:.4f}")
        assert last < first, "training must reduce the loss"
        print("OK")


if __name__ == "__main__":
    main()
