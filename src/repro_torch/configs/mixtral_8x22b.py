"""mixtral-8x22b [moe]: 56L d_model=6144 48H (kv=8) d_ff=16384/expert,
vocab=32768, 8 experts top-2, SWA [arXiv:2401.04088].
Router: top-k -> softmax (mistral convention)."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        num_layers=56, d_model=6144, d_ff=16_384, vocab_size=32_768,
        num_heads=48, num_kv_heads=8,
        window_size=4096, window_pattern=1,
        n_experts=8, n_shared_experts=0, top_k=2,
        router_norm="topk_softmax",
        block="attn", gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=96, vocab_size=97,
        num_heads=4, num_kv_heads=2, window_size=8, n_experts=4, top_k=2,
        vocab_pad_multiple=8, gen_feature_dim=8, remat=False)
