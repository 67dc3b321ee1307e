"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        num_layers=32, d_model=2560, d_ff=6912, vocab_size=50_304,
        num_heads=32, num_kv_heads=32,
        block="attn", gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=160, vocab_size=97,
        num_heads=4, num_kv_heads=4, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
