"""Meta-device stand-ins for every model entry point's inputs, the port of
``repro.models.specs``: tensors with shapes and dtypes and no storage, so a
full configuration's parameters, caches and batches can be sized without
allocating anything. For the vision arch the frontend is a stub: the specs
give precomputed patch embeddings and M-RoPE positions.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    """Inputs of the train step: token ids, labels (next tokens), mask."""
    specs = {
        "tokens": sds((batch, seq_len), torch.int32),
        "labels": sds((batch, seq_len), torch.int32),
        "mask": sds((batch, seq_len), torch.float32),
    }
    if cfg.modality == "vision":
        nv = cfg.num_vision_tokens
        if nv >= seq_len:
            raise ValueError(f"{nv} vision tokens leave no text in {seq_len}")
        specs["tokens"] = sds((batch, seq_len - nv), torch.int32)
        specs["vision_embeds"] = sds((batch, nv, cfg.d_model), torch.bfloat16)
        specs["positions"] = sds((3, batch, seq_len), torch.int32)
    return specs


def prefill_input_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    specs = {"tokens": sds((batch, seq_len), torch.int32)}
    if cfg.modality == "vision":
        nv = cfg.num_vision_tokens
        specs["tokens"] = sds((batch, seq_len - nv), torch.int32)
        specs["vision_embeds"] = sds((batch, nv, cfg.d_model), torch.bfloat16)
        specs["positions"] = sds((3, batch, seq_len), torch.int32)
    return specs


def decode_input_specs(cfg: ModelConfig, seq_len: int, batch: int) -> Dict[str, Any]:
    """The serve step: one new token against a cache of length seq_len."""
    specs = {
        "token": sds((batch, 1), torch.int32),
        "cache": transformer.init_cache(cfg, batch, seq_len, device=META),
        "cache_pos": sds((), torch.int32),
    }
    if cfg.mrope_sections:
        specs["positions"] = sds((3, batch, 1), torch.int32)
    return specs


def params_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of ``transformer.init_params``, on the meta
    device."""
    return transformer.init_params(torch.Generator(), cfg, device=META)
