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
from repro_torch.optim.optimizers import OptState


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
