"""Model zoo — the port's share of ``distkeras_tpu.models.zoo``: the
transformer models (the causal language models and the encoder
classifier)."""

from __future__ import annotations

from ..ops.attention import (GlobalAvgPool1D, LayerNorm, MultiHeadAttention,
                             PositionalEmbedding)
from .layers import Dense, Embedding, Residual, Sequential
from .model import Model


def _ff_block(dim: int, ff_mult: int, moe_experts: int):
    """Transformer FF block: pre-LN residual around dense-gelu-dense."""
    if moe_experts:
        raise NotImplementedError(
            "moe_experts > 0 (the switch-MoE FF block) is not ported yet")
    return Residual(Sequential([LayerNorm(), Dense(dim * ff_mult, "gelu"),
                                Dense(dim)]))


def transformer_classifier(vocab_size: int = 20000, dim: int = 128,
                           num_heads: int = 4, num_blocks: int = 2,
                           seq_len: int = 200, num_classes: int = 2,
                           ff_mult: int = 4,
                           moe_experts: int = 0) -> Model:
    """Pre-LN transformer encoder classifier: blocks of (non-causal,
    dense) ``MultiHeadAttention`` + gelu FF, mean-pooled over time, ending
    in a softmax ``Dense`` (so the trainers pick the on-probs loss)."""
    layers = [Embedding(vocab_size, dim)]
    for _ in range(num_blocks):
        layers.append(Residual(Sequential([
            LayerNorm(), MultiHeadAttention(num_heads)])))
        layers.append(_ff_block(dim, ff_mult, moe_experts))
    layers += [LayerNorm(), GlobalAvgPool1D(),
               Dense(num_classes, "softmax")]
    return Model(Sequential(layers), input_shape=(seq_len,),
                 name="transformer_classifier")


def gpt_lm(vocab_size: int = 256, dim: int = 128, num_heads: int = 4,
           num_blocks: int = 2, seq_len: int = 256, ff_mult: int = 4,
           attention_impl: str = "dense", moe_experts: int = 0,
           num_kv_heads=None, positional: str = "learned") -> Model:
    """Decoder-only causal language model (GPT-style): pre-LN blocks of
    causal ``MultiHeadAttention`` + gelu FF, ending in a vocab-logits
    Dense.  ``attention_impl='flash'`` runs attention through
    ``ops.flash_attention`` (the CUDA kernel on the card)."""
    if positional not in ("learned", "rope"):
        raise ValueError(f"positional must be 'learned' or 'rope', got "
                         f"{positional!r}")
    rope = positional == "rope"
    layers = [Embedding(vocab_size, dim)]
    if not rope:  # rope lives inside the attention layers instead
        layers.append(PositionalEmbedding(seq_len))
    for _ in range(num_blocks):
        layers.append(Residual(Sequential([
            LayerNorm(),
            MultiHeadAttention(num_heads, causal=True, impl=attention_impl,
                               num_kv_heads=num_kv_heads, rope=rope)])))
        layers.append(_ff_block(dim, ff_mult, moe_experts))
    layers += [LayerNorm(), Dense(vocab_size)]
    return Model(Sequential(layers), input_shape=(seq_len,), name="gpt_lm")


def draft_lm(target: Model, dim: int = 32, num_heads: int = 2,
             num_blocks: int = 1, ff_mult: int = 4,
             positional: str = "learned") -> Model:
    """A small draft model shape-compatible with a ``gpt_lm`` target: the
    same vocab and ``seq_len``, everything else scaled down."""
    return gpt_lm(vocab_size=int(target.output_shape[-1]), dim=dim,
                  num_heads=num_heads, num_blocks=num_blocks,
                  seq_len=int(target.input_shape[0]), ff_mult=ff_mult,
                  positional=positional)

