"""Training of the paper's linear extreme classifier (§5 protocol).

Minibatch Adagrad on the head loss, and per-head learning-rate selection on
a validation split — the paper's own protocol ('we tuned the
hyperparameters for each method individually using the validation set',
Table 1). Adversarial negatives carry a stronger gradient signal and want a
smaller rho than uniform ones; comparing at one shared rho mis-ranks the
methods in either direction.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import heads as heads_lib
from repro_torch.core.heads import Generator, HeadConfig, HeadParams
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state


def train_linear_head(cfg: HeadConfig, gen: Generator, x, xg, y,
                      lr: float, steps: int, seed: int = 0,
                      batch_size: int = 256, callback=None,
                      head_update: str = "auto", sampler=None,
                      device="cuda") -> HeadParams:
    """Minibatch Adagrad (eps = 1e-8) on the head loss from zero weights;
    returns the trained params, created on ``device``.

    ``x`` (N, K), ``xg`` (N, k) and ``y`` (N,) are arrays or tensors; they
    are moved to ``device`` once. Minibatch indices and negatives come from
    one ``torch.Generator`` on ``device`` seeded with ``seed``. Minibatching
    matters for fidelity: with full-batch steps every label receives uniform
    negatives each step and the SNR gap the paper exploits collapses.
    ``callback(step, params)`` is called every 10 steps if given.

    ``head_update``: ``sparse`` (the default for sampled heads) runs
    :func:`heads.sparse_head_loss` — the ``sampled_head_loss`` kernel on the
    card — and O(U·K) in-place Adagrad row updates, so a step costs the same
    whatever ``cfg.num_labels`` is; ``dense`` is the O(C·K) autograd path
    (and the only one for ``softmax``). Both run the same Adagrad math.
    ``sampler`` overrides the proposal ``cfg.kind``/``gen`` imply.
    """
    dev = device_lib.resolve(device)
    head_update = heads_lib.resolve_head_update(head_update, cfg.kind)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    xg = torch.as_tensor(xg, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    opt_cfg = OptimizerConfig(name="adagrad", learning_rate=lr, eps=1e-8)
    params = HeadParams(
        w=torch.zeros((cfg.num_labels, x.shape[-1]), dtype=torch.float32, device=dev),
        b=torch.zeros((cfg.num_labels,), dtype=torch.float32, device=dev))
    opt_state = init_opt_state(opt_cfg, params)
    generator = torch.Generator(device=dev).manual_seed(seed)
    n = x.shape[0]
    for s in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=generator, device=dev)
        xb, xgb, yb = x[idx], xg[idx], y[idx]
        if head_update == "sparse":
            _, _, grads, _ = heads_lib.sparse_head_loss(
                cfg, params, gen, xb, xgb, yb, generator, sampler=sampler)
        else:
            leaves = HeadParams(*(p.detach().requires_grad_() for p in params))
            loss, _ = heads_lib.head_loss(cfg, leaves, gen, xb, xgb, yb,
                                          generator, sampler=sampler)
            grads = HeadParams(*torch.autograd.grad(loss, leaves))
        params, opt_state, _ = apply_updates(opt_cfg, params, grads, opt_state)
        if callback is not None and (s + 1) % 10 == 0:
            callback(s + 1, params)
    return params


def tune_and_train(kind: str, gen: Generator, num_labels: int,
                   x, xg, y, x_val, xg_val, y_val, *,
                   lr_grid: Sequence[float] = (0.03, 0.1, 0.3),
                   steps: int = 300, tune_steps: Optional[int] = None,
                   reg: float = 1e-4, n_neg: int = 1, sampler=None,
                   device="cuda") -> Tuple[HeadConfig, HeadParams, float]:
    """Paper §5 protocol. Returns (cfg, params, best_lr).

    ``sampler`` overrides the negative proposal for both training and the
    Eq. 5 debias in the validation accuracy (the two must agree or the
    selection is biased)."""
    dev = device_lib.resolve(device)
    cfg = HeadConfig(num_labels=num_labels, kind=kind, n_neg=n_neg, reg=reg)
    tune_steps = tune_steps or max(steps // 3, 50)
    val = [torch.as_tensor(a, dtype=dt, device=dev) for a, dt in
           ((x_val, torch.float32), (xg_val, torch.float32), (y_val, torch.int64))]
    best_lr, best_acc = lr_grid[0], -1.0
    for lr in lr_grid:
        p = train_linear_head(cfg, gen, x, xg, y, lr, tune_steps,
                              sampler=sampler, device=dev)
        acc = float(heads_lib.predictive_accuracy(cfg, p, gen, *val,
                                                  sampler=sampler))
        if acc > best_acc:
            best_lr, best_acc = lr, acc
    params = train_linear_head(cfg, gen, x, xg, y, best_lr, steps,
                               sampler=sampler, device=dev)
    return cfg, params, best_lr
