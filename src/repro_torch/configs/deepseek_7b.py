"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954]."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        num_layers=30, d_model=4096, d_ff=11_008, vocab_size=102_400,
        num_heads=32, num_kv_heads=32,
        block="attn", gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=172, vocab_size=129,
        num_heads=4, num_kv_heads=4, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
