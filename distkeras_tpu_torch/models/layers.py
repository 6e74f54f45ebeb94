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

Train mode is the module's (``model.train()`` / ``model.eval()``; a
``Model`` starts in eval mode, as JAX's ``apply`` defaults to
``train=False``).  Non-trainable state lives in buffers (BatchNorm's
``mean`` and ``var``): a training forward records the new state in
``new_state`` and the training step copies it in with ``commit_state``
after the update, once, however often the forward ran (an activation
checkpoint runs it twice).  Dropout draws from the ``torch.Generator``
that ``set_generator`` hands it, never from the global RNG.  Image
layers keep the JAX package's NHWC layout and HWIO kernels at their
interface and compute through a channels-last view, so the permutes
cost no copy.

The cached-decode protocol is the JAX package's, over tensors:
``init_cache(batch, in_shape)`` / ``apply_prefill(x, cache)`` /
``apply_decode(x, cache, pos)``.  Caches are updated in place (JAX
returns new arrays); every method still returns the cache, so callers
read the same either way.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

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
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def he_normal(gen: torch.Generator, shape) -> torch.Tensor:
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return torch.randn(shape, generator=gen) * math.sqrt(
        2.0 / (shape[-2] * receptive))


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

    #: layers whose training forward draws random numbers (Dropout)
    rng_in_train = False

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
class Flatten(Layer):
    """(B, ...) → (B, prod); image inputs flatten in (H, W, C) order."""

    def out_shape(self, in_shape):
        return (math.prod(in_shape),)

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


@register
class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int]):
        super().__init__()
        self.target_shape = tuple(int(s) for s in target_shape)

    def out_shape(self, in_shape):
        return self.target_shape

    def forward(self, x):
        return x.reshape(x.shape[0], *self.target_shape)

    def get_config(self):
        return {"target_shape": list(self.target_shape)}


@register
class Dropout(Layer):
    """In training, ``where(mask, x / keep, 0)`` with ``mask`` drawn with
    probability ``keep = 1 - rate`` from ``self.generator`` (set by
    ``set_generator``); the identity in eval mode or at rate 0."""
    rng_in_train = True

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout needs a generator in training "
                             "(models.layers.set_generator)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    def get_config(self):
        return {"rate": self.rate}


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the total pad that gives
    ceil(size / stride) outputs, low = total // 2, high = the rest."""
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + window - size)
    return total // 2, total - total // 2


def _nchw(x):
    """An NHWC tensor as NCHW: a channels-last view, no copy."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


@register
class Conv2D(Layer):
    """NHWC convolution with an HWIO kernel (``padding`` "SAME" as XLA
    pads, or "VALID")."""
    time_mixing = True

    def __init__(self, filters: int, kernel_size, strides=1, padding="SAME",
                 activation=None, use_bias: bool = True):
        super().__init__()
        self.filters = int(filters)
        self.kernel_size = (kernel_size, kernel_size) \
            if isinstance(kernel_size, int) else tuple(kernel_size)
        self.strides = (strides, strides) if isinstance(strides, int) \
            else tuple(strides)
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias
        self._act = get_activation(activation)

    def build(self, in_shape, gen):
        c = in_shape[-1]
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(he_normal(gen, (kh, kw, c, self.filters)))
        if self.use_bias:
            self.bias = nn.Parameter(torch.zeros(self.filters))
        return self.out_shape(in_shape)

    def out_shape(self, in_shape):
        h, w, _ = in_shape
        sh, sw = self.strides
        if self.padding == "SAME":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            kh, kw = self.kernel_size
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return (oh, ow, self.filters)

    def forward(self, x):
        xc = _nchw(x)
        pad = (0, 0)
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (
                _same_pads(n, k, s) for n, k, s in
                zip(x.shape[1:3], self.kernel_size, self.strides))
            if pt == pb and pl == pr:
                pad = (pt, pl)
            else:  # the low side pads less: torch pads symmetrically
                xc = F.pad(xc, (pl, pr, pt, pb))
        if xc.device.type == "cpu":
            # oneDNN's channels-last conv backward crashes at small
            # batches on the CPU: hand it NCHW there
            xc = xc.contiguous()
        y = F.conv2d(xc, self.kernel.to(x.dtype).permute(3, 2, 0, 1),
                     stride=self.strides, padding=pad)
        y = _nhwc(y)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return self._act(y)

    def get_config(self):
        return {"filters": self.filters,
                "kernel_size": list(self.kernel_size),
                "strides": list(self.strides), "padding": self.padding,
                "activation": activation_config(self.activation),
                "use_bias": self.use_bias}


class _Pool2D(Layer):
    time_mixing = True

    def __init__(self, pool_size=2, strides=None, padding="VALID"):
        super().__init__()
        self.pool_size = (pool_size, pool_size) \
            if isinstance(pool_size, int) else tuple(pool_size)
        self.strides = self.pool_size if strides is None else (
            (strides, strides) if isinstance(strides, int)
            else tuple(strides))
        self.padding = padding

    def out_shape(self, in_shape):
        h, w, c = in_shape
        ph, pw = self.pool_size
        sh, sw = self.strides
        if self.padding == "SAME":
            return (-(-h // sh), -(-w // sw), c)
        return ((h - ph) // sh + 1, (w - pw) // sw + 1, c)

    def _pads(self, h, w):
        """(left, right, top, bottom) for ``F.pad`` on NCHW."""
        if self.padding != "SAME":
            return (0, 0, 0, 0)
        (pt, pb), (pl, pr) = (_same_pads(n, k, s) for n, k, s in
                              zip((h, w), self.pool_size, self.strides))
        return (pl, pr, pt, pb)

    def get_config(self):
        return {"pool_size": list(self.pool_size),
                "strides": list(self.strides), "padding": self.padding}


@register
class MaxPool2D(_Pool2D):
    """Max over each window; SAME pads with the dtype's most negative
    finite value, as the JAX package does."""

    def forward(self, x):
        xc = _nchw(x)
        pads = self._pads(x.shape[1], x.shape[2])
        if any(pads):
            xc = F.pad(xc, pads, value=torch.finfo(x.dtype).min)
        return _nhwc(F.max_pool2d(xc, self.pool_size, self.strides))


@register
class AvgPool2D(_Pool2D):
    """Mean over each window; SAME divides by the window's count of valid
    (unpadded) cells."""

    def forward(self, x):
        xc = _nchw(x)
        pads = self._pads(x.shape[1], x.shape[2])
        if not any(pads):
            return _nhwc(F.avg_pool2d(xc, self.pool_size, self.strides))
        ones = torch.ones((1, 1, *xc.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return _nhwc(F.avg_pool2d(F.pad(xc, pads), self.pool_size,
                                  self.strides) / F.avg_pool2d(
            F.pad(ones, pads), self.pool_size, self.strides))


@register
class SpaceToDepth(Layer):
    """(H, W, C) → (H/b, W/b, C·b²): each b×b patch becomes one pixel's
    channel stack, in the JAX package's (row, column, channel) order."""

    def __init__(self, block_size: int):
        super().__init__()
        self.block_size = int(block_size)

    def out_shape(self, in_shape):
        h, w, c = in_shape
        b = self.block_size
        if h % b or w % b:
            raise ValueError(f"spatial extent ({h}, {w}) not divisible by "
                             f"block_size {b}")
        return (h // b, w // b, c * b * b)

    def forward(self, x):
        n, h, w, c = x.shape
        b = self.block_size
        x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // b, w // b, b * b * c)

    def get_config(self):
        return {"block_size": self.block_size}


@register
class GlobalAvgPool2D(Layer):
    time_mixing = True

    def out_shape(self, in_shape):
        return (in_shape[-1],)

    def forward(self, x):
        return x.mean(dim=(1, 2))


@register
class BatchNorm(Layer):
    """Batch normalization over every axis but the last, the running
    statistics in the buffers ``mean`` and ``var`` (f32, whatever the
    activations' dtype).  Training normalizes by the batch's mean and
    biased variance max(E[x²] − E[x]², 0), accumulated in f32 (in f64
    for f64 activations, so a model in float64 is a float64 witness), and
    records ``momentum · old + (1 − momentum) · batch`` in ``new_state``
    for ``commit_state``; eval uses the buffers.  The affine folds into
    x·a + b with a and b cast to x's dtype."""

    def __init__(self, momentum: float = 0.9, epsilon: float = 1e-5,
                 axis_name: Optional[str] = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "BatchNorm(axis_name=...) (statistics summed across "
                "replicas) needs workers that run in lockstep, one per "
                "card; the one-card sync trainers step their workers one "
                "after another: ROADMAP Queue 1 item 8")
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.axis_name = axis_name
        self.new_state: Optional[dict] = None

    def build(self, in_shape, gen):
        c = in_shape[-1]
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        return in_shape

    def forward(self, x):
        # f32 for bf16 and f32 activations; f64 ones keep f64
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = torch.mean(x, dim=dims, dtype=acc)
            mean2 = torch.mean(x.square(), dim=dims, dtype=acc)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            m = self.momentum
            self.new_state = {
                "mean": (m * self.mean + (1 - m) * mean).detach(),
                "var": (m * self.var + (1 - m) * var).detach()}
        else:
            mean, var = self.mean, self.var
        scale = self.scale.to(acc)
        inv = torch.rsqrt(var.to(acc) + self.epsilon)
        a = (inv * scale).to(x.dtype)
        b = (self.bias.to(acc) - mean.to(acc) * inv * scale).to(x.dtype)
        return x * a + b

    def get_config(self):
        return {"momentum": self.momentum, "epsilon": self.epsilon,
                "axis_name": self.axis_name}


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


@register
class LSTM(Layer):
    """LSTM over the time axis: gates (i, f, g, o) from one fused
    (in, 4h) input projection, hoisted out of the loop, plus an (h, 4h)
    recurrent one per step; forget-gate bias 1.  Returns the last hidden
    state, or every step's with ``return_sequences``."""
    time_mixing = True

    def __init__(self, units: int, return_sequences: bool = False):
        super().__init__()
        self.units = int(units)
        self.return_sequences = bool(return_sequences)

    def build(self, in_shape, gen):
        _, d = in_shape
        h = self.units
        self.kernel = nn.Parameter(glorot_uniform(gen, (d, 4 * h)))
        self.recurrent = nn.Parameter(glorot_uniform(gen, (h, 4 * h)))
        bias = torch.zeros(4 * h)
        bias[h:2 * h] = 1.0
        self.bias = nn.Parameter(bias)
        return self.out_shape(in_shape)

    def out_shape(self, in_shape):
        t, _ = in_shape
        return (t, self.units) if self.return_sequences else (self.units,)

    def forward(self, x):
        b, t, _ = x.shape
        wr = self.recurrent.to(x.dtype)
        x_proj = x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)
        h = c = torch.zeros((b, self.units), dtype=x.dtype, device=x.device)
        hs = []
        for step in range(t):
            z = x_proj[:, step] + h @ wr
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1) if self.return_sequences else h

    def get_config(self):
        return {"units": self.units,
                "return_sequences": self.return_sequences}


# ---------------------------------------------------------------------------
# training helpers
# ---------------------------------------------------------------------------

def set_generator(model: nn.Module, gen: Optional[torch.Generator]) -> None:
    """Hand ``gen`` to every layer of ``model`` that draws random numbers
    in training (Dropout)."""
    for lyr in model.modules():
        if getattr(lyr, "rng_in_train", False):
            lyr.generator = gen


def commit_state(model: nn.Module) -> None:
    """Copy the state each layer recorded in its last training forward
    (``new_state``: {buffer name: value}) into its buffers, and clear the
    record, with any ``live_aux_loss`` a remat recompute in the backward
    wrote again after ``parallel.sync.aux_losses`` took the first."""
    with torch.no_grad():
        for lyr in model.modules():
            new = getattr(lyr, "new_state", None)
            if new is not None:
                for name, value in new.items():
                    getattr(lyr, name).copy_(value)
                lyr.new_state = None
            if getattr(lyr, "live_aux_loss", None) is not None:
                lyr.live_aux_loss = None


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
