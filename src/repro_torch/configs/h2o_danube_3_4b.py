"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        num_layers=24, d_model=3840, d_ff=10_240, vocab_size=32_000,
        num_heads=32, num_kv_heads=8,
        window_size=4096, window_pattern=1,
        block="attn", gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=160, vocab_size=97,
        num_heads=4, num_kv_heads=2, window_size=8, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
