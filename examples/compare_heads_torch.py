"""Paper Figure 1 analog on the PyTorch port: all heads race on clustered
extreme classification. The counterpart of ``examples/compare_heads.py``.

Follows the paper's §5 protocol: each head's learning rate is tuned on a
validation split (Adagrad, Table 1 style), then trained for an equal step
budget; we report test accuracy + predictive log-likelihood. Expected
ordering (the paper's result): adversarial_ns leads the sampled heads and
approaches full softmax; NCE pays for re-learning the base distribution;
uniform NS trails.

Run:  PYTHONPATH=src python examples/compare_heads_torch.py [--steps 300]
      [--labels 2048] [--heads adversarial_ns uniform_ns ...] [--device cuda|cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import heads as heads_lib  # noqa: E402
from repro_torch.core.heads import Generator  # noqa: E402
from repro_torch.core.tree_fit import FitConfig, fit_tree, pca_projection  # noqa: E402
from repro_torch.core.xc_train import tune_and_train  # noqa: E402
from repro_torch.data.synthetic import ClusteredXCSpec, make_clustered_xc  # noqa: E402

HEADS = ["adversarial_ns", "uniform_ns", "freq_ns", "nce",
         "sampled_softmax", "ove", "augment_reduce", "softmax"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--labels", type=int, default=2048)
    ap.add_argument("--heads", nargs="*", default=HEADS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    c, kdim, k_gen = args.labels, 64, 8
    spec = ClusteredXCSpec(num_labels=c, feature_dim=kdim, seed=0)
    x_tr, y_tr, x_te, y_te = make_clustered_xc(spec, 42_000, 3_000)
    x_tr, x_val = x_tr[:40_000], x_tr[40_000:]
    y_tr, y_val = y_tr[:40_000], y_tr[40_000:]

    t0 = time.time()
    proj, mean = pca_projection(x_tr, k_gen)
    tree = fit_tree((x_tr - mean) @ proj, y_tr, c, config=FitConfig(reg=0.1, seed=0),
                    device=dev)
    tree_fit_s = time.time() - t0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    x, y, xg = t(x_tr), t(y_tr, torch.int64), t((x_tr - mean) @ proj)
    xv, yv, xgv = t(x_val), t(y_val, torch.int64), t((x_val - mean) @ proj)
    xte, yte, xgte = t(x_te), t(y_te, torch.int64), t((x_te - mean) @ proj)
    counts = torch.bincount(y, minlength=c).float()

    print(f"C={c} K={kdim} N={len(y_tr)} steps={args.steps} "
          f"(tree fit: {tree_fit_s:.1f}s; lr tuned per head, paper §5)")
    print(f"{'head':16s} {'lr*':>6s} {'train_s':>8s} {'test acc':>9s} {'loglik':>8s}")
    results = {}
    for kind in args.heads:
        gen = Generator()
        if kind in ("adversarial_ns", "nce", "sampled_softmax"):
            gen = Generator(tree=tree)
        elif kind == "freq_ns":
            gen = heads_lib.make_freq_generator(counts, device=dev)
        t0 = time.time()
        cfg, params, lr = tune_and_train(kind, gen, c, x, xg, y, xv, xgv, yv,
                                         steps=args.steps, device=dev)
        dt = time.time() - t0
        acc = float(heads_lib.predictive_accuracy(cfg, params, gen, xte, xgte, yte))
        ll = float(heads_lib.predictive_log_likelihood(cfg, params, gen, xte, xgte, yte))
        results[kind] = acc
        print(f"{kind:16s} {lr:6.2f} {dt:8.1f} {acc:9.3f} {ll:8.3f}")

    if {"adversarial_ns", "uniform_ns"} <= results.keys():
        assert results["adversarial_ns"] > results["uniform_ns"], \
            "paper claim: adversarial > uniform at equal budget"
        print("OK: adversarial negative sampling leads the sampled heads.")


if __name__ == "__main__":
    main()
