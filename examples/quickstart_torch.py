"""Quickstart on the PyTorch port: the paper, end to end, in under a minute.

The counterpart of ``examples/quickstart.py``: the paper's pipeline (§2.2
steps 1-3) on a synthetic clustered extreme-classification set (the regime
of §2.2's 'Boston Terrier vs French Bulldog' argument):

  1. fit the probabilistic decision tree to the data (paper §3);
  2. train a linear classifier with adversarial negative sampling (Eq. 6);
  3. predict with bias removal (Eq. 5) and compare against uniform negative
     sampling trained for the same number of steps.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import heads as heads_lib  # noqa: E402
from repro_torch.core.heads import Generator, HeadConfig  # noqa: E402
from repro_torch.core.tree_fit import FitConfig, fit_tree, pca_projection  # noqa: E402
from repro_torch.core.xc_train import train_linear_head  # noqa: E402
from repro_torch.data.synthetic import ClusteredXCSpec, make_clustered_xc  # noqa: E402


def train(kind, x, y, xg, gen, c, dev, steps=150, lr=0.1):
    """The port's ``train_linear_head``: minibatch Adagrad (batch 256), the
    paper's regime and ``tests/test_system.py``'s. (The JAX quickstart takes
    full-batch steps at lr 0.5; on the port that run's adversarial accuracy
    moved between 0.41 and 0.70 with the float32 summation order of its
    first steps, so the example keeps to the regime the port is tested in.)"""
    cfg = HeadConfig(num_labels=c, kind=kind, n_neg=1, reg=1e-4)
    return cfg, train_linear_head(cfg, gen, x, xg, y, lr=lr, steps=steps, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    c, kdim, k_gen = 256, 64, 8
    spec = ClusteredXCSpec(num_labels=c, feature_dim=kdim, seed=0)
    x_tr, y_tr, x_te, y_te = make_clustered_xc(spec, 8000, 2000)

    # -- Step 1: fit the adversarial generator tree (paper §3) --
    t0 = time.time()
    proj, mean = pca_projection(x_tr, k_gen)
    xg_tr = (x_tr - mean) @ proj
    xg_te = (x_te - mean) @ proj
    tree = fit_tree(xg_tr, y_tr, c, config=FitConfig(reg=0.1, seed=0), device=dev)
    print(f"[1] tree fitted in {time.time() - t0:.1f}s "
          f"(C={c}, k={k_gen}, depth={tree.depth})")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    x, y, xg = t(x_tr), t(y_tr, torch.int64), t(xg_tr)

    # -- Step 2: adversarial negative sampling (Eq. 6) --
    gen_tree = Generator(tree=tree)
    cfg_adv, p_adv = train("adversarial_ns", x, y, xg, gen_tree, c, dev)

    # Baseline: uniform negative sampling (Eq. 2), same budget.
    cfg_uni, p_uni = train("uniform_ns", x, y, xg, Generator(), c, dev)

    # -- Step 3: predictions with bias removal (Eq. 5) --
    xte, yte, xgte = t(x_te), t(y_te, torch.int64), t(xg_te)
    accs = {}
    for name, cfg, p, g in [("adversarial+debias", cfg_adv, p_adv, gen_tree),
                            ("uniform", cfg_uni, p_uni, Generator())]:
        accs[name] = float(heads_lib.predictive_accuracy(cfg, p, g, xte, xgte, yte))
        ll = float(heads_lib.predictive_log_likelihood(cfg, p, g, xte, xgte, yte))
        print(f"[3] {name:20s} test acc={accs[name]:.3f} loglik={ll:.3f}")

    assert accs["adversarial+debias"] > accs["uniform"], \
        "adversarial should beat uniform (paper Fig 1)"
    print("OK: adversarial negative sampling beats uniform at equal steps.")


if __name__ == "__main__":
    main()
