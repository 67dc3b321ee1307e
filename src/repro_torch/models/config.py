"""Model configuration covering all assigned architecture families.

A copy of ``repro.models.config`` (the port imports nothing of ``repro``):
one frozen dataclass describes dense GQA transformers, SWA / local-global
alternation (gemma2, mixtral, h2o-danube), logit softcaps (gemma2), M-RoPE
(qwen2-vl), MoE with shared + fine-grained routed experts (deepseek-moe,
mixtral), Mamba-2 SSD blocks (mamba2), and parallel attn∥SSM hybrid blocks
(hymba). The port's model (:mod:`repro_torch.models.transformer`) runs
them all; per-layer heterogeneity (e.g. alternating window sizes) is read
per layer with :meth:`window_for_layer`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "ssm", "hybrid")
MOE_SHARDINGS = ("expert", "ffn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0             # query heads (0 for pure-SSM archs)
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // num_heads
    window_size: int = 0           # sliding-window width; 0 = full attention
    window_pattern: int = 1        # every `p`-th layer is full attention
                                   # (1 = all layers use `window_size`;
                                   #  2 = gemma2-style local/global alternate)
    attn_logit_softcap: float = 0.0     # gemma2: 50.0
    final_logit_softcap: float = 0.0    # gemma2: 30.0
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE dims per section
    # --- block selection ---
    block: str = "attn"            # attn | ssm | hybrid
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_norm: str = "softmax_topk"   # deepseek | "topk_softmax" (mixtral)
    # --- embeddings / head ---
    vocab_pad_multiple: int = 512
    gen_feature_dim: int = 32      # k: generator-tree feature dim (paper §3)
    # --- modality frontend (stub per task statement) ---
    modality: str = "text"         # text | audio | vision
    num_vision_tokens: int = 0     # vision: prefix of precomputed embeddings
    # --- numerics / memory ---
    dtype: str = "bfloat16"
    softmax_dtype: str = "float32"   # attention logits/softmax precision;
                                     # bf16 halves the S^2 byte traffic and
                                     # is defensible under a logit softcap
                                     # (§Perf C2)
    remat: bool = True
    scan_layers: bool = True

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.block not in BLOCK_KINDS:
            raise ValueError(f"block {self.block!r} not in {BLOCK_KINDS}")
        if self.block in ("attn", "hybrid") and not (
                self.num_heads > 0 and self.num_kv_heads > 0
                and self.num_heads % self.num_kv_heads == 0):
            raise ValueError(f"{self.name}: num_heads {self.num_heads} must be a "
                             f"positive multiple of num_kv_heads {self.num_kv_heads}")
        if self.block in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: an SSM block needs ssm_state > 0")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def window_for_layer(self, layer: int) -> int:
        """Per-layer sliding window (0 = full). gemma2: even layers local."""
        if self.window_size == 0:
            return 0
        if self.window_pattern <= 1:
            return self.window_size
        return self.window_size if layer % self.window_pattern != \
            (self.window_pattern - 1) else 0

    def layer_windows(self):
        return [self.window_for_layer(i) for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Approximate trainable parameter count (for 6·N·D roofline)."""
        d, v = self.d_model, self.padded_vocab
        n = 2 * v * d                      # in-embed + head (untied)
        hd = self.resolved_head_dim
        per_layer = 0
        if self.block in ("attn", "hybrid"):
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            per_layer += q + kv + o
        if self.block in ("ssm", "hybrid"):
            di, ns = self.ssm_inner, self.ssm_state
            heads = self.ssm_heads
            conv_dim = di + 2 * ns
            per_layer += d * (2 * di + 2 * ns + heads)   # in_proj
            per_layer += conv_dim * self.ssm_conv_width  # conv1d
            per_layer += di * d                          # out_proj
            per_layer += 2 * heads + di                  # A, D, norm
        if self.is_moe:
            per_layer += d * self.n_experts              # router
            per_layer += 3 * d * self.d_ff * (self.n_experts
                                              + self.n_shared_experts)
        else:
            per_layer += 3 * d * self.d_ff               # SwiGLU
        per_layer += 2 * d                               # 2 RMSNorms
        return n + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = 3 * d * self.d_ff * (self.n_experts - self.top_k)
        return self.param_count() - self.num_layers * inactive
