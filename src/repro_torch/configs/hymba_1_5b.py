"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads in every
block, outputs mean-fused [arXiv:2411.13676]. Attention is sliding-window
(the reference keeps 3 global layers; we window all layers and note the
deviation in DESIGN.md)."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        num_layers=32, d_model=1600, d_ff=5504, vocab_size=32_001,
        num_heads=25, num_kv_heads=5, head_dim=64,
        window_size=1024, window_pattern=1,
        block="hybrid", ssm_state=16, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=256,
        gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=128, vocab_size=97,
        num_heads=5, num_kv_heads=1, head_dim=16, window_size=8,
        ssm_state=8, ssm_head_dim=16, ssm_chunk=8, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
