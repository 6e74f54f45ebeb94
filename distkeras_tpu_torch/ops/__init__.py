"""Attention ops, the flash-attention kernel's wrapper and the switch-MoE
feed-forward (``ops.moe``)."""

from .flash_attention import flash_attention, flash_attention_lse  # noqa: F401
from .attention import (  # noqa: F401
    GlobalAvgPool1D,
    LayerNorm,
    MultiHeadAttention,
    PositionalEmbedding,
    apply_rope,
    dot_product_attention,
)
