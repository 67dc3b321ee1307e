"""Model configurations the port supports: ``get_config(name)`` /
``--arch <id>``, and the paper's own linear extreme classifier
(:mod:`repro_torch.configs.xc_linear`).

One module per architecture, copies of the JAX package's
``repro.configs`` (sources cited in each file). ``reduced_config(name)``
gives the CPU-test shrink of the same family.
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

# long_500k needs sub-quadratic attention or a bounded state.
LONG_CONTEXT_OK = {
    "mamba2-370m": True, "hymba-1.5b": True, "h2o-danube-3-4b": True,
    "mixtral-8x22b": True, "gemma2-27b": True,
    "stablelm-3b": False, "deepseek-7b": False, "qwen2-vl-7b": False,
    "deepseek-moe-16b": False, "musicgen-medium": False,
}


def _module(name: str):
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; expected one of {ARCHS}")
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module("repro_torch.configs." + mod)


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def reduced_config(name: str) -> ModelConfig:
    """Small same-family config for CPU tests."""
    return _module(name).reduced()


def shape_cells(name: str):
    """The (shape_name -> spec) cells of this arch; a skipped cell is None."""
    cells = {}
    for shape, (seq, batch, mode) in SHAPES.items():
        if shape == "long_500k" and not LONG_CONTEXT_OK[name]:
            cells[shape] = None
        else:
            cells[shape] = {"seq_len": seq, "global_batch": batch, "mode": mode}
    return cells
