"""gemma2-27b [dense]: 46L d_model=4608 32H (kv=16) d_ff=36864
vocab=256000 — local+global alternating SWA(4096), attn softcap 50,
final logit softcap 30 [arXiv:2408.00118].

Deviations noted in DESIGN.md: pre-norm only (no sandwich post-norms),
untied embeddings (vocab-sharded head table)."""
import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        num_layers=46, d_model=4608, d_ff=36_864, vocab_size=256_000,
        num_heads=32, num_kv_heads=16, head_dim=128,
        window_size=4096, window_pattern=2,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        block="attn", gen_feature_dim=64,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, d_ff=192, vocab_size=203,
        num_heads=4, num_kv_heads=2, head_dim=16, window_size=8,
        vocab_pad_multiple=8, gen_feature_dim=8, remat=False)
