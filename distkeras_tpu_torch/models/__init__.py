"""Layers, ``Model``, the LM zoo and generation."""

from .layers import (  # noqa: F401
    LAYER_REGISTRY,
    Activation,
    Dense,
    Embedding,
    Layer,
    Residual,
    Sequential,
    layer_from_config,
    register,
)
from .model import Model  # noqa: F401
from . import zoo  # noqa: F401
from .generation import generate_tokens  # noqa: F401
