"""Carries weights across from the JAX package: numpy arrays in, the port's
parameters out.

Pass each of the JAX package's arrays as numpy (``np.asarray`` of a field);
this module never imports ``jax``. bfloat16 tables travel as float32 arrays
and are cast with ``dtype=``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.heads import Generator, HeadParams
from repro_torch.core.tree import Tree
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
