"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

Modality stub: the EnCodec frontend is external; ``input_specs`` provides
token ids over the codec vocabulary (single-stream; the 4-codebook delay
pattern is out of scope per the task statement)."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        num_layers=48, d_model=1536, d_ff=6144, vocab_size=2048,
        num_heads=24, num_kv_heads=24,
        block="attn", modality="audio",
        vocab_pad_multiple=256, gen_feature_dim=16,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=128, vocab_size=101,
        num_heads=4, num_kv_heads=4, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
