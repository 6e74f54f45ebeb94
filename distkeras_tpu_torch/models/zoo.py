"""Model zoo — the port of ``distkeras_tpu.models.zoo``: the five
benchmark families of ``BASELINE.json`` (MLP and convnets on MNIST and
CIFAR-10, ResNet-20 and ResNet-50, the IMDB LSTM), NHWC and ending in
softmax (or sigmoid) as the JAX package's, and the transformer models
(the causal language models and the encoder classifier)."""

from __future__ import annotations

from ..ops.attention import (GlobalAvgPool1D, LayerNorm, MultiHeadAttention,
                             PositionalEmbedding)
from ..ops.moe import MoEDense
from .layers import (LSTM, Activation, BatchNorm, Conv2D, Dense, Dropout,
                     Embedding, Flatten, GlobalAvgPool2D, MaxPool2D,
                     Residual, Sequential, SpaceToDepth)
from .model import Model


def mlp_mnist(hidden: int = 500, num_classes: int = 10) -> Model:
    """MLP for flat 784-dim MNIST: two Dense(hidden, relu), softmax head."""
    return Model(Sequential([
        Dense(hidden, "relu"),
        Dense(hidden, "relu"),
        Dense(num_classes, "softmax"),
    ]), input_shape=(784,), name="mlp_mnist")


def convnet_mnist(num_classes: int = 10) -> Model:
    """Small convnet for 28×28×1 MNIST: conv-pool-conv-pool-dense."""
    return Model(Sequential([
        Conv2D(32, 3, activation="relu"),
        MaxPool2D(2),
        Conv2D(64, 3, activation="relu"),
        MaxPool2D(2),
        Flatten(),
        Dense(128, "relu"),
        Dense(num_classes, "softmax"),
    ]), input_shape=(28, 28, 1), name="convnet_mnist")


def convnet_cifar10(num_classes: int = 10) -> Model:
    """VGG-ish ConvNet for 32×32×3 CIFAR-10 (the ADAG config)."""
    return Model(Sequential([
        Conv2D(32, 3, activation="relu"),
        Conv2D(32, 3, activation="relu"),
        MaxPool2D(2),
        Conv2D(64, 3, activation="relu"),
        Conv2D(64, 3, activation="relu"),
        MaxPool2D(2),
        Flatten(),
        Dense(256, "relu"),
        Dropout(0.5),
        Dense(num_classes, "softmax"),
    ]), input_shape=(32, 32, 3), name="convnet_cifar10")


def _basic_block(filters: int, stride: int = 1, in_filters: int = None):
    """ResNet v1 basic block: conv-bn-relu-conv-bn (+shortcut) -relu."""
    inner = Sequential([
        Conv2D(filters, 3, strides=stride, use_bias=False),
        BatchNorm(),
        Activation("relu"),
        Conv2D(filters, 3, use_bias=False),
        BatchNorm(),
    ])
    shortcut = None
    if stride != 1 or (in_filters is not None and in_filters != filters):
        shortcut = Sequential([
            Conv2D(filters, 1, strides=stride, use_bias=False),
            BatchNorm(),
        ])
    return Residual(inner, shortcut, activation="relu")


def resnet20(num_classes: int = 10, width: int = 16) -> Model:
    """ResNet-20 for CIFAR-10 (3 stages × 3 basic blocks, widths
    ``[w, 2w, 4w]``; 16 is the standard model): the headline
    samples/s model."""
    layers = [Conv2D(width, 3, use_bias=False), BatchNorm(),
              Activation("relu")]
    in_f = width
    for si, f in enumerate([width, 2 * width, 4 * width]):
        for bi in range(3):
            stride = 2 if (si > 0 and bi == 0) else 1
            layers.append(_basic_block(f, stride, in_f))
            in_f = f
    layers += [GlobalAvgPool2D(), Dense(num_classes, "softmax")]
    return Model(Sequential(layers), input_shape=(32, 32, 3), name="resnet20")


def _bottleneck(filters: int, stride: int = 1, in_filters: int = None):
    """ResNet v1.5 bottleneck: 1×1 reduce, 3×3 (strided), 1×1 expand ×4."""
    out_f = filters * 4
    inner = Sequential([
        Conv2D(filters, 1, use_bias=False),
        BatchNorm(),
        Activation("relu"),
        Conv2D(filters, 3, strides=stride, use_bias=False),
        BatchNorm(),
        Activation("relu"),
        Conv2D(out_f, 1, use_bias=False),
        BatchNorm(),
    ])
    shortcut = None
    if stride != 1 or (in_filters is not None and in_filters != out_f):
        shortcut = Sequential([
            Conv2D(out_f, 1, strides=stride, use_bias=False),
            BatchNorm(),
        ])
    return Residual(inner, shortcut, activation="relu")


def resnet50(num_classes: int = 1000, input_size: int = 224,
             stem: str = "conv7") -> Model:
    """ResNet-50: a stem and [3, 4, 6, 3] bottleneck stages of widths
    64/128/256/512.  ``stem="conv7"`` is the 7×7/s2 conv and 3×3/s2
    max-pool; ``"s2d"`` a 4×4 ``SpaceToDepth`` feeding a stride-1 3×3
    conv (the same ×4 downsampling and output shape)."""
    if stem == "s2d":
        layers = [
            SpaceToDepth(4),
            Conv2D(64, 3, strides=1, use_bias=False),
            BatchNorm(),
            Activation("relu"),
        ]
    elif stem == "conv7":
        layers = [
            Conv2D(64, 7, strides=2, use_bias=False),
            BatchNorm(),
            Activation("relu"),
            MaxPool2D(3, strides=2, padding="SAME"),
        ]
    else:
        raise ValueError(f"stem must be 'conv7' or 's2d', got {stem!r}")
    in_f = 64
    for si, (f, blocks) in enumerate(zip([64, 128, 256, 512], [3, 4, 6, 3])):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            layers.append(_bottleneck(f, stride, in_f))
            in_f = f * 4
    layers += [GlobalAvgPool2D(), Dense(num_classes, "softmax")]
    return Model(Sequential(layers), input_shape=(input_size, input_size, 3),
                 name="resnet50")


def lstm_imdb(vocab_size: int = 20000, embed_dim: int = 128,
              lstm_units: int = 128, seq_len: int = 200) -> Model:
    """LSTM sentiment classifier for IMDB: embed → LSTM → dropout →
    dense sigmoid, on ``seq_len``-padded token ids."""
    return Model(Sequential([
        Embedding(vocab_size, embed_dim),
        LSTM(lstm_units),
        Dropout(0.5),
        Dense(1, "sigmoid"),
    ]), input_shape=(seq_len,), name="lstm_imdb")


def _ff_block(dim: int, ff_mult: int, moe_experts: int):
    """Transformer FF block: pre-LN residual around dense-gelu-dense, or a
    switch-MoE FF (``ops.moe.MoEDense``) when ``moe_experts > 0``."""
    if moe_experts:
        ff: list = [MoEDense(moe_experts, d_hidden=dim * ff_mult)]
    else:
        ff = [Dense(dim * ff_mult, "gelu"), Dense(dim)]
    return Residual(Sequential([LayerNorm(), *ff]))


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
    ``ops.flash_attention`` (the CUDA kernel on the card);
    ``moe_experts > 0`` swaps each dense FF block for a switch-MoE FF
    (``ops.moe.MoEDense``)."""
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

