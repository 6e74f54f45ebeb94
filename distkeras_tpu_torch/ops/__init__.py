"""Attention ops and the flash-attention kernel's wrapper."""

from .flash_attention import flash_attention, flash_attention_lse  # noqa: F401
from .attention import (  # noqa: F401
    GlobalAvgPool1D,
    LayerNorm,
    MultiHeadAttention,
    PositionalEmbedding,
    apply_rope,
    dot_product_attention,
)
