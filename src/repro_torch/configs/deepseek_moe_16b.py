"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408/expert,
vocab=102400, 64 routed experts top-6 + 2 shared, fine-grained
[arXiv:2401.06066]. Router: softmax -> top-k (deepseek convention).

Deviation noted in DESIGN.md: all layers MoE (reference model keeps layer 0
dense) to keep a single scanned body."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        num_layers=28, d_model=2048, d_ff=1408, vocab_size=102_400,
        num_heads=16, num_kv_heads=16,
        n_experts=64, n_shared_experts=2, top_k=6,
        router_norm="softmax_topk",
        block="attn", gen_feature_dim=32,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=32, vocab_size=97,
        num_heads=4, num_kv_heads=4, n_experts=8, n_shared_experts=1,
        top_k=2, vocab_pad_multiple=8, gen_feature_dim=8, remat=False)
