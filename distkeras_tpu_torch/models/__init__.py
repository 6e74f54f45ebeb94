"""Layers, ``Model``, the model zoo and generation."""

from .layers import (  # noqa: F401
    LAYER_REGISTRY,
    LSTM,
    Activation,
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GlobalAvgPool2D,
    Layer,
    MaxPool2D,
    Reshape,
    Residual,
    Sequential,
    SpaceToDepth,
    commit_state,
    layer_from_config,
    register,
    set_generator,
)
from .model import Model  # noqa: F401
from . import zoo  # noqa: F401
from .generation import generate_beam, generate_tokens  # noqa: F401
