"""``Model``: a layer graph bound to its input shape (the port of
``distkeras_tpu.models.model.Model``), as an ``nn.Module``.

``Model.init(seed, device)`` creates every parameter (and buffer of
state) from an explicit ``torch.Generator`` and places the model on
``device`` (the card unless the caller names another).  A model is in
eval mode unless a training step switches it.  ``config()`` /
``from_config`` speak the JAX package's config JSON, so
``Model.from_config(jax_model.config())`` builds the same architecture
here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.device import DeviceLike, default_device
from .layers import Layer, Sequential, layer_from_config


class Model(nn.Module):
    def __init__(self, layer: Layer,
                 input_shape: Optional[Sequence[int]] = None,
                 name: str = "model"):
        super().__init__()
        if input_shape is None and isinstance(layer, Sequential):
            input_shape = layer.input_shape
        if input_shape is None:
            raise ValueError("Model needs an input_shape")
        self.layer = layer
        self.input_shape = tuple(input_shape)
        self.name = name
        self.output_shape = layer.out_shape(self.input_shape)
        # inference until a training step says otherwise (JAX's apply
        # defaults to train=False)
        self.train(False)

    def init(self, seed: int = 0, device: DeviceLike = None) -> "Model":
        """Create the parameters from ``seed`` (on the CPU generator, so
        the weights do not depend on the device) and move the model to
        ``device``.  Returns the model."""
        device = default_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.layer.build(self.input_shape, gen)
        return self.to(device)

    @property
    def device(self) -> Optional[torch.device]:
        """Where the parameters live (None before ``init``)."""
        return next((p.device for p in self.parameters()), None)

    def forward(self, x):
        return self.layer(x)

    def iter_layers(self):
        """All layers in the model, depth-first (``Layer.iter_layers``)."""
        return self.layer.iter_layers()

    # -- serde --------------------------------------------------------------
    def config(self) -> dict:
        return {"name": self.name, "input_shape": list(self.input_shape),
                "layer": self.layer.config()}

    @classmethod
    def from_config(cls, cfg: dict) -> "Model":
        # registers their layers
        from ..ops import attention, moe  # noqa: F401
        return cls(layer_from_config(cfg["layer"]),
                   input_shape=cfg["input_shape"],
                   name=cfg.get("name", "model"))
