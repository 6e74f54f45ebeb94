"""Layers as ``nn.Module``s — the port of ``distkeras_tpu.models.layers``.

The JAX package's layers are pure ``init``/``apply`` function pairs over
a variables tree.  Here each layer is a module that holds its own
parameters, with the same constructor arguments, class names and
``get_config()`` keys, so ``layer_from_config`` builds the port's layer
graph from the JAX package's config JSON unchanged.

Parameters are created by ``build(in_shape, generator)`` (shapes exclude
the batch axis, as in JAX's ``init``), which ``Model.init`` calls with an
explicit ``torch.Generator``.  Layouts stay the JAX package's: a
``Dense.kernel`` is (in, out), so ``utils.weights.load_jax_variables``
copies leaves across without a transpose.

The cached-decode protocol is the JAX package's, over tensors:
``init_cache(batch, in_shape)`` / ``apply_prefill(x, cache)`` /
``apply_decode(x, cache, pos)``.  Caches are updated in place (JAX
returns new arrays); every method still returns the cache, so callers
read the same either way.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LAYER_REGISTRY: Dict[str, type] = {}


def register(cls):
    """Register a layer class for config-based (de)serialization."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_config(cfg: dict) -> "Layer":
    cls = LAYER_REGISTRY[cfg["class"]]
    return cls.from_config(cfg["config"])


# ---------------------------------------------------------------------------
# initializers (the JAX package's distributions, from a torch.Generator)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, limit: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def glorot_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def uniform_scale(gen: torch.Generator, shape, scale: float = 0.05
                  ) -> torch.Tensor:
    return _uniform(gen, shape, scale)


ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x: x,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "elu": F.elu,
    "silu": F.silu,
    "leaky_relu": F.leaky_relu,
}


def get_activation(name_or_fn):
    if name_or_fn is None:
        return ACTIVATIONS["linear"]
    if callable(name_or_fn):
        return name_or_fn
    return ACTIVATIONS[name_or_fn]


def activation_config(name_or_fn):
    """Serializable form of an activation spec; refuses silent loss."""
    if name_or_fn is None or isinstance(name_or_fn, str):
        return name_or_fn
    for name, fn in ACTIVATIONS.items():
        if fn is name_or_fn:
            return name
    raise ValueError(
        f"cannot serialize custom activation {name_or_fn!r}; use a registered "
        f"name ({', '.join(ACTIVATIONS)})")


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """Base layer.  ``build(in_shape, gen) -> out_shape`` creates the
    parameters; ``forward(x)`` is the inference apply."""

    #: layers that mix information ACROSS the time axis set this True;
    #: the cached decode refuses a stack holding one without its own
    #: ``apply_decode`` (see ``models.generation._model_cache``)
    time_mixing = False

    def build(self, in_shape: tuple, gen: torch.Generator) -> tuple:
        return self.out_shape(in_shape)

    def out_shape(self, in_shape: tuple) -> tuple:
        return in_shape

    def forward(self, x):
        raise NotImplementedError

    # -- cached autoregressive decode (causal LMs) --------------------------
    def init_cache(self, batch: int, in_shape: tuple):
        """Decode cache for this layer (None for cache-free layers);
        ``in_shape`` includes the time axis, which bounds the cache."""
        return None

    def apply_decode(self, x, cache, pos):
        """One-token decode step at position ``pos`` (x has no time axis).
        Default: time-pointwise layers treat the token as a batch."""
        return self(x), cache

    def apply_prefill(self, x, cache):
        """Full-sequence forward that also fills the decode cache."""
        return self(x), cache

    def iter_layers(self):
        """This layer and every nested layer, depth first (``layers``,
        ``inner``, ``shortcut``)."""
        yield self
        for sub in getattr(self, "layers", None) or []:
            yield from sub.iter_layers()
        for attr in ("inner", "shortcut"):
            sub = getattr(self, attr, None)
            if isinstance(sub, Layer):
                yield from sub.iter_layers()

    # -- config serde -------------------------------------------------------
    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, cfg: dict) -> "Layer":
        return cls(**cfg)

    def config(self) -> dict:
        return {"class": type(self).__name__, "config": self.get_config()}


# ---------------------------------------------------------------------------
# core layers
# ---------------------------------------------------------------------------

@register
class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True):
        super().__init__()
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self._act = get_activation(activation)

    def build(self, in_shape, gen):
        d = in_shape[-1]
        self.kernel = nn.Parameter(glorot_uniform(gen, (d, self.units)))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.units))
        return self.out_shape(in_shape)

    def out_shape(self, in_shape):
        return (*in_shape[:-1], self.units)

    def forward(self, x):
        y = x @ self.kernel.to(x.dtype)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self._act(y)

    def get_config(self):
        return {"units": self.units,
                "activation": activation_config(self.activation),
                "use_bias": self.use_bias}


@register
class Activation(Layer):
    def __init__(self, activation: str):
        super().__init__()
        self.activation = activation
        self._act = get_activation(activation)

    def forward(self, x):
        return self._act(x)

    def get_config(self):
        return {"activation": self.activation}


@register
class Embedding(Layer):
    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)

    def build(self, in_shape, gen):
        self.table = nn.Parameter(
            uniform_scale(gen, (self.vocab_size, self.dim)))
        return self.out_shape(in_shape)

    def out_shape(self, in_shape):
        return (*in_shape, self.dim)

    def forward(self, x):
        return F.embedding(x, self.table)

    def get_config(self):
        return {"vocab_size": self.vocab_size, "dim": self.dim}


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

@register
class Residual(Layer):
    """``y = act(inner(x) + shortcut(x))``; ``shortcut`` None is identity."""

    def __init__(self, inner: Layer, shortcut: Optional[Layer] = None,
                 activation=None):
        super().__init__()
        self.inner = inner
        self.shortcut = shortcut
        self.activation = activation
        self._act = get_activation(activation)

    def build(self, in_shape, gen):
        out_shape = self.inner.build(in_shape, gen)
        if self.shortcut is not None:
            sc_shape = self.shortcut.build(in_shape, gen)
            if tuple(sc_shape) != tuple(out_shape):
                raise ValueError(
                    f"shortcut shape {sc_shape} != inner shape {out_shape}")
        elif tuple(out_shape) != tuple(in_shape):
            raise ValueError(
                f"identity shortcut needs matching shapes, got {in_shape} -> "
                f"{out_shape}; pass a projection shortcut")
        return out_shape

    def out_shape(self, in_shape):
        return self.inner.out_shape(in_shape)

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        return self._act(self.inner(x) + sc)

    def init_cache(self, batch, in_shape):
        cache = {"inner": self.inner.init_cache(batch, in_shape)}
        if self.shortcut is not None:
            cache["shortcut"] = self.shortcut.init_cache(batch, in_shape)
        return cache

    def apply_decode(self, x, cache, pos):
        y, ci = self.inner.apply_decode(x, cache["inner"], pos)
        new_cache = {"inner": ci}
        sc = x
        if self.shortcut is not None:
            sc, new_cache["shortcut"] = self.shortcut.apply_decode(
                x, cache["shortcut"], pos)
        return self._act(y + sc), new_cache

    def apply_prefill(self, x, cache):
        y, ci = self.inner.apply_prefill(x, cache["inner"])
        new_cache = {"inner": ci}
        sc = x
        if self.shortcut is not None:
            sc, new_cache["shortcut"] = self.shortcut.apply_prefill(
                x, cache["shortcut"])
        return self._act(y + sc), new_cache

    def get_config(self):
        return {"inner": self.inner.config(),
                "shortcut": self.shortcut.config() if self.shortcut else None,
                "activation": activation_config(self.activation)}

    @classmethod
    def from_config(cls, cfg):
        return cls(layer_from_config(cfg["inner"]),
                   layer_from_config(cfg["shortcut"])
                   if cfg["shortcut"] else None,
                   activation=cfg.get("activation"))


@register
class Sequential(Layer):
    """Keras-Sequential-style composition."""

    def __init__(self, layers: Sequence[Layer],
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.input_shape = tuple(input_shape) if input_shape is not None \
            else None

    def build(self, in_shape=None, gen=None):
        shape = tuple(in_shape) if in_shape is not None else self.input_shape
        if shape is None:
            raise ValueError("Sequential needs input_shape (constructor or "
                             "build arg)")
        for lyr in self.layers:
            shape = lyr.build(shape, gen)
        return shape

    def out_shape(self, in_shape):
        shape = tuple(in_shape)
        for lyr in self.layers:
            shape = lyr.out_shape(shape)
        return shape

    def forward(self, x):
        for lyr in self.layers:
            x = lyr(x)
        return x

    def init_cache(self, batch, in_shape):
        caches, shape = [], tuple(in_shape)
        for lyr in self.layers:
            caches.append(lyr.init_cache(batch, shape))
            shape = lyr.out_shape(shape)
        return caches

    def apply_decode(self, x, cache, pos):
        new_cache = []
        for lyr, c in zip(self.layers, cache):
            x, c = lyr.apply_decode(x, c, pos)
            new_cache.append(c)
        return x, new_cache

    def apply_prefill(self, x, cache):
        new_cache = []
        for lyr, c in zip(self.layers, cache):
            x, c = lyr.apply_prefill(x, c)
            new_cache.append(c)
        return x, new_cache

    def get_config(self):
        return {"layers": [lyr.config() for lyr in self.layers],
                "input_shape": list(self.input_shape)
                if self.input_shape else None}

    @classmethod
    def from_config(cls, cfg):
        return cls([layer_from_config(c) for c in cfg["layers"]],
                   input_shape=cfg.get("input_shape"))
