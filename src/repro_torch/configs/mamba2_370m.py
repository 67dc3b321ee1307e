"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        num_layers=48, d_model=1024, d_ff=0, vocab_size=50_280,
        block="ssm", ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=256,
        num_heads=0, num_kv_heads=0,
        gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, vocab_size=97, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, vocab_pad_multiple=8,
        gen_feature_dim=8, remat=False)
