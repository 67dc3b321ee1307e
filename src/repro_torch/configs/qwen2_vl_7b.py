"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

Modality stub: the ViT frontend is external; ``input_specs`` provides
precomputed patch embeddings (B, n_vis, d_model) prepended to the text
stream. M-RoPE uses 3 position streams over head-dim sections (16, 24, 24)."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        num_layers=28, d_model=3584, d_ff=18_944, vocab_size=152_064,
        num_heads=28, num_kv_heads=4,
        mrope_sections=(16, 24, 24),
        block="attn", modality="vision", num_vision_tokens=1024,
        gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=128, vocab_size=97,
        num_heads=4, num_kv_heads=2, mrope_sections=(4, 2, 2),
        num_vision_tokens=4, vocab_pad_multiple=8, gen_feature_dim=8,
        remat=False)
