"""Carries weights across from the JAX package: numpy arrays in, the port's
parameters out.

Pass each of the JAX package's arrays as numpy (``np.asarray`` of a field);
this module never imports ``jax``. bfloat16 tables travel as float32 arrays
and are cast with ``dtype=``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.heads import Generator, HeadParams
from repro_torch.core.tree import Tree
from repro_torch.models.lm_head import LMHeadState
from repro_torch.optim.compression import QuantizedRows
from repro_torch.optim.optimizers import OptState, Sm3Cover


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype).contiguous()


def tree_from_numpy(w, b, label_to_leaf, leaf_to_label, device="cuda") -> Tree:
    """A :class:`~repro_torch.core.tree.Tree` from the fields of the JAX
    package's ``Tree`` (float32 tables, int64 label maps)."""
    dev = device_lib.resolve(device)
    return Tree(w=_tensor(w, torch.float32, dev), b=_tensor(b, torch.float32, dev),
                label_to_leaf=_tensor(label_to_leaf, torch.int64, dev),
                leaf_to_label=_tensor(leaf_to_label, torch.int64, dev))


def head_params_from_numpy(w, b, dtype=torch.float32, device="cuda") -> HeadParams:
    """:class:`~repro_torch.core.heads.HeadParams` from the JAX package's
    (C, K) ``w`` and (C,) ``b``."""
    dev = device_lib.resolve(device)
    return HeadParams(w=_tensor(w, dtype, dev), b=_tensor(b, dtype, dev))


def generator_from_numpy(tree: Optional[Sequence] = None, freq_log=None,
                         freq_cdf=None, device="cuda") -> Generator:
    """:class:`~repro_torch.core.heads.Generator` from the JAX package's
    fields. ``tree`` is the four tree arrays in the JAX ``Tree`` field order
    (w, b, label_to_leaf, leaf_to_label), or None."""
    dev = device_lib.resolve(device)
    return Generator(
        tree=None if tree is None else tree_from_numpy(*tree, device=dev),
        freq_log=None if freq_log is None else _tensor(freq_log, torch.float32, dev),
        freq_cdf=None if freq_cdf is None else _tensor(freq_cdf, torch.float32, dev))


def opt_state_from_numpy(step, nu: Optional[Sequence] = None,
                         device="cuda") -> OptState:
    """:class:`~repro_torch.optim.OptState` from the JAX package's Adagrad
    (or SGD) ``OptState`` of a head: ``step``, and the ``nu`` accumulators
    of ``w`` and ``b`` as (nu_w, nu_b), or None for SGD."""
    dev = device_lib.resolve(device)
    return OptState(step=int(np.asarray(step)), mu=None,
                    nu=None if nu is None else HeadParams(
                        *(_tensor(a, torch.float32, dev) for a in nu)))


def lm_params_from_numpy(params: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The port's LM parameters from the JAX package's ``init_params`` tree
    with every leaf as numpy (``jax.tree.map(np.asarray, params)``), float32.
    The reference stacks the layers on a leading L axis for its scan; they
    are unstacked into the port's list of per-layer dicts."""
    dev = device_lib.resolve(device)

    def tree(node, layer=None):
        if isinstance(node, dict):
            return {k: tree(v, layer) for k, v in node.items()}
        return _tensor(node if layer is None else np.asarray(node)[layer],
                       torch.float32, dev)

    stacked = params["layers"]
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return {"embed": tree(params["embed"]),
            "layers": [tree(stacked, i) for i in range(np.shape(first)[0])],
            "final_norm": tree(params["final_norm"]),
            "head": tree(params["head"])}


def lm_head_state_from_numpy(proj, tree: Sequence, device="cuda") -> LMHeadState:
    """:class:`~repro_torch.models.lm_head.LMHeadState` from the JAX
    package's ``proj`` (d_model, k) and the four tree arrays in the JAX
    ``Tree`` field order (w, b, label_to_leaf, leaf_to_label)."""
    dev = device_lib.resolve(device)
    return LMHeadState(gen=Generator(tree=tree_from_numpy(*tree, device=dev)),
                       proj=_tensor(proj, torch.float32, dev))


def _keep_dtype(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (which
    numpy holds through an extension dtype) come back as bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev).contiguous()


def _lm_tree(node, dev, n_layers: int, layer=None):
    """A params-shaped tree of the JAX package (its ``n_layers`` layers
    stacked on a leading axis) as the port's: ``layers`` unstacked into a
    list of per-layer trees, state boxes (``Sm3Cover``, ``QuantizedRows``, by
    their fields) rebuilt, None kept, every array in its own dtype."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: ([_lm_tree(v, dev, n_layers, i) for i in range(n_layers)]
                    if k == "layers" and layer is None else _lm_tree(v, dev, n_layers, layer))
                for k, v in node.items()}
    if hasattr(node, "_fields"):
        box = {("row", "col"): Sm3Cover, ("q", "scale"): QuantizedRows}[tuple(node._fields)]
        return box(*(_lm_tree(x, dev, n_layers, layer) for x in node))
    return _keep_dtype(node if layer is None else np.asarray(node)[layer], dev)


def train_state_from_numpy(state, device="cuda"):
    """The port's :class:`~repro_torch.train.state.TrainState` from the JAX
    package's ``TrainState`` with every leaf as numpy
    (``jax.tree.map(np.asarray, state)``): params and optimizer state (every
    rule and state dtype: mu, nu, last, SM3 covers, int8 rows) with the
    stacked layers unstacked, the head state (generator tree or unigram
    tables, and the projection), ``step``, ``gen_fit_step`` and the SNR
    pair. Fields are read by attribute, so any object with the JAX
    ``TrainState``'s fields will do."""
    from repro_torch.train.state import TrainState

    dev = device_lib.resolve(device)
    opt = state.opt_state
    hs = state.head_state
    gen = hs.gen
    n = np.shape(state.params["layers"]["norm_mix"]["scale"])[0]
    return TrainState(
        step=int(np.asarray(state.step)),
        params=_lm_tree(state.params, dev, n),
        opt_state=OptState(step=int(np.asarray(opt.step)), mu=_lm_tree(opt.mu, dev, n),
                           nu=_lm_tree(opt.nu, dev, n), last=_lm_tree(opt.last, dev, n)),
        head_state=LMHeadState(
            gen=generator_from_numpy(
                tree=None if gen.tree is None else [np.asarray(a) for a in gen.tree],
                freq_log=gen.freq_log, freq_cdf=gen.freq_cdf, device=dev),
            proj=None if hs.proj is None else _tensor(hs.proj, torch.float32, dev)),
        gen_fit_step=int(np.asarray(state.gen_fit_step)),
        snr_ewma=_tensor(state.snr_ewma, torch.float32, dev),
        snr_ref=_tensor(state.snr_ref, torch.float32, dev))
