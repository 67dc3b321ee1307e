"""Optimizers for the linear head, the Adagrad (paper §5) and SGD path:
global-norm clipping, LR schedules, and dense or sparse-row updates.

Params are a head ``{w (C, K), b (C,)}`` (:class:`~repro_torch.core.heads.
HeadParams`). Its gradient is either dense, a ``HeadParams`` of the same
shapes, or one :class:`~repro_torch.optim.sparse.SparseRows`. A sparse
gradient is applied as O(U·K) row updates: gather the touched rows of
params and accumulators, run the same per-leaf rule the dense path runs,
and write the rows back in place with ``index_copy_``. That in-place write
is the port's form of the JAX package's buffer donation: the step never
copies the (C, K) tables, so its cost does not depend on C. The dense path
returns new tensors. State is float32.

AdamW with its lazy catch-up, ``sm3``, compressed state (``state_dtype``)
and the ``mesh`` argument come with the head-math and parallel slices; they
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim import sparse as sparse_lib

_PORTED = ("adagrad", "sgd")
_LATER = "the head-math slice (ROADMAP Queue 1 item 7)"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adagrad"           # adagrad | sgd (adamw | sm3: later slice)
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    adagrad_init: float = 0.0       # initial accumulator (paper uses 0)
    clip_norm: float = 0.0          # 0 = off
    warmup_steps: int = 0
    decay_steps: int = 0            # cosine decay horizon; 0 = constant
    head_name: Optional[str] = None  # head-leaf rule override
    state_dtype: str = "fp32"       # head accumulator storage (fp32 only here)
    lazy_horizon: int = 0           # adamw catch-up replay cap (later slice)


class OptState(NamedTuple):
    step: int         # steps taken
    mu: Any           # 1st moment (adamw): always None here
    nu: Any           # adagrad accumulators as a HeadParams, or None (sgd)
    last: Any = None  # per-row last-touched step (adamw): always None here


def _rule(cfg: OptimizerConfig) -> str:
    """The head's update rule; every leaf of a standalone head is a head
    leaf, so ``head_name`` overrides ``name``."""
    name = cfg.head_name or cfg.name
    if name not in _PORTED:
        raise NotImplementedError(f"optimizer {name!r} comes with {_LATER}; "
                                  f"the port has {_PORTED}")
    if cfg.state_dtype != "fp32":
        raise NotImplementedError(f"state_dtype={cfg.state_dtype!r} comes with "
                                  f"{_LATER}; the port keeps fp32 state")
    return name


def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    """Zero step; Adagrad accumulators filled with ``adagrad_init``, on the
    params' device."""
    if _rule(cfg) == "sgd":
        return OptState(step=0, mu=None, nu=None)
    nu = type(params)(*(torch.full(p.shape, cfg.adagrad_init,
                                   dtype=torch.float32, device=p.device)
                        for p in params))
    return OptState(step=0, mu=None, nu=nu)


def schedule(cfg: OptimizerConfig, step: int) -> float:
    lr = cfg.learning_rate
    s = float(step)
    if cfg.warmup_steps:
        lr = lr * min(1.0, (s + 1.0) / cfg.warmup_steps)
    if cfg.decay_steps:
        frac = min(max((s - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0), 1.0)
        lr = lr * (0.5 * (1.0 + math.cos(math.pi * frac)))
    return lr


def _leaves(grads):
    """Dense tensors and SparseRows of a gradient: a tensor, a SparseRows,
    or a (nested) sequence or mapping of them."""
    if grads is None:
        return
    if isinstance(grads, torch.Tensor) or sparse_lib.is_sparse(grads):
        yield grads
    elif isinstance(grads, dict):
        for g in grads.values():
            yield from _leaves(g)
    else:
        for g in grads:
            yield from _leaves(g)


def global_norm(grads) -> torch.Tensor:
    """float32 global norm over dense and SparseRows leaves."""
    sq = [sparse_lib.sq_norm(g) if sparse_lib.is_sparse(g)
          else torch.square(g.float()).sum() for g in _leaves(grads)]
    return torch.sqrt(torch.stack(sq).sum())


def _scaled(grads, s):
    if isinstance(grads, torch.Tensor):
        return grads * s
    if sparse_lib.is_sparse(grads):
        return sparse_lib.scale(grads, s)
    if isinstance(grads, dict):
        return {k: _scaled(g, s) for k, g in grads.items()}
    if hasattr(grads, "_fields"):                  # a NamedTuple (HeadParams)
        return type(grads)(*(_scaled(g, s) for g in grads))
    return type(grads)(_scaled(g, s) for g in grads)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scl = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _scaled(grads, scl), norm


def _leaf_update(cfg: OptimizerConfig, name: str, lr: float, t: int, p, g, m, n):
    """The per-leaf update rule, shared by the dense path (whole tensors)
    and the sparse path (gathered rows): returns (p', m', n'). ``t`` is the
    1-based step, used by the moment rules of the later slice."""
    g32 = g.float()
    if name == "adagrad":
        n2 = n + torch.square(g32)
        u = -lr * g32 / (torch.sqrt(n2) + cfg.eps)
    elif name == "sgd":
        u = -lr * g32
        n2 = None
    else:
        raise NotImplementedError(f"optimizer {name!r} comes with {_LATER}")
    return (p.float() + u).to(p.dtype), None, n2


def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState,
                  mesh=None):
    """One optimizer step. Returns (params, state, metrics).

    ``grads`` is a dense ``HeadParams`` or one ``SparseRows`` for the whole
    head. A sparse step writes the touched rows of ``params`` and of the
    accumulators in place and returns those same tensors; a dense step
    returns new ones.
    """
    if mesh is not None:
        raise NotImplementedError("vocab-sharded row updates (mesh=) come with "
                                  "the parallel slice (ROADMAP Queue 1 item 12)")
    name = _rule(cfg)
    metrics = {}
    if cfg.clip_norm:
        grads, norm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = norm
    lr = schedule(cfg, state.step)
    metrics["lr"] = lr
    t = state.step + 1
    nus = state.nu if state.nu is not None else (None,) * len(params)
    with torch.no_grad():
        if sparse_lib.is_sparse(grads):
            ids = grads.ids
            for p, g, n in zip(params, (grads.dw, grads.db), nus):
                p2, _, n2 = _leaf_update(cfg, name, lr, t, p.index_select(0, ids), g,
                                         None, None if n is None else n.index_select(0, ids))
                p.index_copy_(0, ids, p2)
                if n2 is not None:
                    n.index_copy_(0, ids, n2)
            new_params, new_nu = params, state.nu
        else:
            out = [_leaf_update(cfg, name, lr, t, p, g, None, n)
                   for p, g, n in zip(params, grads, nus)]
            new_params = type(params)(*(o[0] for o in out))
            new_nu = (None if state.nu is None
                      else type(params)(*(o[2] for o in out)))
    return new_params, OptState(step=t, mu=None, nu=new_nu), metrics
