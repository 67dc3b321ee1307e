"""Model configurations the port supports: ``get_config(name)`` /
``--arch <id>``, and the paper's own linear extreme classifier
(:mod:`repro_torch.configs.xc_linear`).

The registry names every architecture of the JAX package's
``repro.configs``; the port holds copies of the ``block="attn"`` configs
without experts, which its model runs. ``reduced_config(name)`` gives the
CPU-test shrink of the same family.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "mamba2-370m", "musicgen-medium", "stablelm-3b", "deepseek-7b",
    "gemma2-27b", "h2o-danube-3-4b", "qwen2-vl-7b", "deepseek-moe-16b",
    "mixtral-8x22b", "hymba-1.5b",
)

# Shape suite shared by every LM arch: (seq_len, global_batch, mode).
SHAPES: Dict[str, tuple] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# The archs whose blocks the port does not have yet, and why.
NOT_PORTED = {
    "mamba2-370m": "Mamba-2 SSD blocks",
    "hymba-1.5b": "parallel attention and SSM blocks",
    "mixtral-8x22b": "mixture-of-experts blocks",
    "deepseek-moe-16b": "mixture-of-experts blocks",
    "qwen2-vl-7b": "vision inputs and M-RoPE positions",
}


def _module(name: str):
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; expected one of {ARCHS}")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} needs {NOT_PORTED[name]}, which the port does not have yet "
            "(ROADMAP item 9)")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module("repro_torch.configs." + mod)


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def reduced_config(name: str) -> ModelConfig:
    """Small same-family config for CPU tests."""
    return _module(name).reduced()
