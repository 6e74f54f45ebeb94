"""Inference-graph rewrites — the port of ``distkeras_tpu.models.
optimize``: BatchNorm folding and the zigzag stripe wrapper.

Eval-mode BatchNorm is a per-channel affine ``y = x·a + b`` with ``a =
scale/√(var+ε)``, ``b = bias − mean·a``, exactly absorbable into the
Conv2D or Dense right before it: ``conv(x; K)·a + b = conv(x; K·a) +
b``.  :func:`fold_batchnorm` removes every such BatchNorm from a serving
graph (the affine computed in float64, the folded leaves stored in
float32, as the JAX package does).  The training graph is untouched:
training BatchNorm uses batch statistics, where folding is not exact.

:func:`zigzag_wrap` runs sequence-parallel causal training with the
zigzag stripe paid once per batch (``parallel.ring``).

The port's models hold their weights, so ``fold_batchnorm(model)``
returns the folded model (the JAX function takes and returns a
``variables`` tree beside the model), and the wrapped model of
``zigzag_wrap`` runs the original's parameter tensors.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from .layers import (BatchNorm, Conv2D, Dense, Embedding, Layer, Residual,
                     Sequential, register)
from .model import Model

__all__ = ["fold_batchnorm", "zigzag_wrap", "ZigzagStripe"]


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _affine(bn: BatchNorm):
    inv = 1.0 / np.sqrt(_f64(bn.var) + bn.epsilon)
    a = _f64(bn.scale) * inv
    b = _f64(bn.bias) - _f64(bn.mean) * a
    return a, b


def _fold_into(lyr, a, b):
    """A new Conv2D / Dense (with bias) holding ``lyr``'s kernel times
    ``a`` (along its output channels) and bias ``lyr.bias·a + b``."""
    if isinstance(lyr, Conv2D):
        new = Conv2D(lyr.filters, lyr.kernel_size, lyr.strides,
                     lyr.padding, lyr.activation, use_bias=True)
    else:
        new = Dense(lyr.units, lyr.activation, use_bias=True)
    kernel = _f64(lyr.kernel) * a  # (..., I, O) · (O,)
    bias = (_f64(lyr.bias) if lyr.use_bias else 0.0) * a + b
    dev = lyr.kernel.device
    new.kernel = nn.Parameter(torch.from_numpy(
        kernel.astype(np.float32)).to(dev))
    new.bias = nn.Parameter(torch.from_numpy(
        np.asarray(bias, np.float32)).to(dev))
    return new


def _foldable(lyr) -> bool:
    # the affine must commute with everything between the kernel op and
    # the BN: only the directly adjacent pair, and only when the kernel op
    # applies no nonlinearity of its own
    return isinstance(lyr, (Conv2D, Dense)) and lyr.activation is None


def _fold_layer(lyr):
    if isinstance(lyr, Sequential):
        return _fold_sequential(lyr.layers)
    if isinstance(lyr, Residual):
        shortcut = None if lyr.shortcut is None \
            else _fold_layer(lyr.shortcut)
        return Residual(_fold_layer(lyr.inner), shortcut, lyr.activation)
    return lyr


def _fold_sequential(layers) -> Sequential:
    out, i = [], 0
    while i < len(layers):
        lyr = _fold_layer(layers[i])
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if _foldable(lyr) and isinstance(nxt, BatchNorm):
            lyr = _fold_into(lyr, *_affine(nxt))
            i += 2  # consume the BN
        else:
            i += 1
        out.append(lyr)
    return Sequential(out)


def fold_batchnorm(model: Model) -> Model:
    """``model`` with every BatchNorm that directly follows an
    activation-free Conv2D or Dense folded into it: the same eval-mode
    forward.  The folded model owns copies of the weights it keeps.
    Raises if the top layer is not ``Sequential``."""
    if not isinstance(model.layer, Sequential):
        raise ValueError("fold_batchnorm needs a Sequential model, got "
                         f"{type(model.layer).__name__}")
    src = copy.deepcopy(model)
    return Model(_fold_sequential(src.layer.layers),
                 input_shape=model.input_shape,
                 name=model.name + "_bnfold")


@register
class ZigzagStripe(Layer):
    """Re-stripe the token axis into the P-way zigzag ring layout (rank
    d's shard = chunks (d, 2P−1−d)); ``inverse=True`` restores natural
    order.  Parameter-free and shape-preserving: the once-per-batch
    boundary layers :func:`zigzag_wrap` inserts."""

    #: permutes the time axis: the cached decode must not apply it
    #: pointwise to per-token input
    time_mixing = True

    def __init__(self, p_size: int, inverse: bool = False):
        super().__init__()
        self.p_size = int(p_size)
        self.inverse = bool(inverse)

    def forward(self, x):
        from ..parallel.ring import zigzag_shuffle, zigzag_unshuffle
        f = zigzag_unshuffle if self.inverse else zigzag_shuffle
        return f(x, self.p_size)

    def get_config(self):
        return {"p_size": self.p_size, "inverse": self.inverse}


def _shallow(module: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose attribute, child and parameter
    maps are its own (the tensors are shared): setting an attribute or a
    child on the copy leaves ``module`` as it is."""
    clone = copy.copy(module)
    for key in ("_modules", "_parameters", "_buffers"):
        clone.__dict__[key] = dict(module.__dict__[key])
    return clone


def _clone_for_wrap(layer, mha_cls):
    """Shallow-copy ``layer`` iff it is (or holds) a ``mha_cls`` layer,
    rebuilding the container spine (``layers`` / ``inner`` /
    ``shortcut``) down to fresh attention objects; everything
    attention-free is shared.  The copies hold the original's parameter
    tensors."""
    if isinstance(layer, mha_cls):
        return _shallow(layer)
    if not any(isinstance(s, mha_cls) for s in layer.iter_layers()):
        return layer
    clone = _shallow(layer)
    if getattr(clone, "layers", None) is not None:
        clone.layers = nn.ModuleList(
            [_clone_for_wrap(lyr, mha_cls) for lyr in clone.layers])
    for attr in ("inner", "shortcut"):
        sub = getattr(clone, attr, None)
        if isinstance(sub, Layer):
            setattr(clone, attr, _clone_for_wrap(sub, mha_cls))
    return clone


class _ZigzagWrappedModel(Model):
    """A zigzag-wrapped model is a run-time artifact: its mesh attachment
    and ``ring_pre_shuffled`` flags are layer attributes that do not
    serialize — a config round trip would restore the stripe layers but
    run dense attention over the permuted order (silently wrong).
    Serialize the original model and wrap it again after loading."""

    def config(self) -> dict:
        raise ValueError(
            "cannot serialize a zigzag_wrap'ed model (its mesh "
            "attachment is runtime-only and a reload would compute "
            "wrong attention over the striped order); serialize the "
            "original model and re-apply zigzag_wrap after loading")


def zigzag_wrap(model: Model, mesh, *, axis: str = "sp", batch_axis=None,
                impl=None):
    """Sequence-parallel causal training with the zigzag stripe paid once
    per batch.

    A mesh on each ``MultiHeadAttention`` runs the balanced zigzag ring,
    but every attention call then stripes its inputs and un-stripes its
    output.  This returns a new model that stripes the token axis once
    after the position-dependent embedding layers and un-stripes it once
    at the output, every attention layer told its activations are
    already zigzag (``ring_pre_shuffled``): between the two boundary
    layers all other compute is token-pointwise.

    Returns ``(wrapped_model, insert_positions)``: the two parameter-free
    boundary layers' positions in the wrapped ``Sequential``.  The
    attention layers of the wrapped stack are shallow copies of the
    original's holding the same parameters: the mesh and the flag land on
    the copies only, so the original model keeps running dense attention
    in natural order; every other layer is shared."""
    from ..ops.attention import MultiHeadAttention, PositionalEmbedding
    if not isinstance(model.layer, Sequential):
        raise ValueError("zigzag_wrap needs a Sequential model")
    p = mesh.shape[axis]
    t = model.input_shape[0]
    if t % (2 * p):
        raise ValueError(f"sequence length {t} must be divisible by "
                         f"2×|{axis}| ({2 * p}) for the zigzag stripe")
    layers = list(model.layer.layers)
    mhas = [lyr for lyr in model.iter_layers()
            if isinstance(lyr, MultiHeadAttention)]
    if not mhas:
        raise ValueError("zigzag_wrap needs attention layers")
    for lyr in mhas:
        if not lyr.causal:
            raise ValueError("zigzag_wrap is for CAUSAL attention stacks "
                             "(non-causal rings don't use the stripe)")
        if lyr.rope:
            raise ValueError("rope positions are applied inside the "
                             "attention layer from PHYSICAL indices; "
                             "zigzag_wrap supports learned positional "
                             "embeddings only")
    # the stripe boundary: after the last position-sensitive layer (token
    # or positional embeddings, nested ones included); everything after
    # must be attention or token-pointwise
    emb_types = (Embedding, PositionalEmbedding)
    idx = [i for i, lyr in enumerate(layers)
           if any(isinstance(sub, emb_types) for sub in lyr.iter_layers())]
    start = (max(idx) + 1) if idx else 0
    for lyr in layers[:start]:
        if any(isinstance(sub, MultiHeadAttention)
               for sub in lyr.iter_layers()):
            raise ValueError(
                "attention appears before (or interleaved with) the "
                "embedding layers: the stripe boundary cannot sit after "
                "the embeddings without leaving that attention on "
                "un-striped input; zigzag_wrap cannot wrap this stack")
    for lyr in layers[start:]:
        for sub in lyr.iter_layers():
            if getattr(sub, "time_mixing", False) and \
                    not isinstance(sub, MultiHeadAttention):
                raise ValueError(
                    f"{type(sub).__name__} mixes the time axis and is "
                    f"not attention: it would read the striped order; "
                    f"zigzag_wrap cannot wrap this stack")
    if impl == "ulysses" or (impl is None and
                             any(lyr.ring_impl == "ulysses" for lyr in mhas)):
        raise ValueError("ulysses is the all-to-all formulation — "
                         "already balanced, no stripe to amortize; "
                         "zigzag_wrap is for the ring impls (unset "
                         "layer.ring_impl or pass impl='flash'/"
                         "'blockwise')")
    layers = [_clone_for_wrap(lyr, MultiHeadAttention) for lyr in layers]
    for lyr in (s for top in layers for s in top.iter_layers()
                if isinstance(s, MultiHeadAttention)):
        lyr.mesh = mesh
        lyr.ring_axis = axis
        if batch_axis is not None:
            lyr.batch_axis = batch_axis
        if impl is not None:
            lyr.ring_impl = impl
        lyr.ring_pre_shuffled = True
    wrapped = layers[:start] + [ZigzagStripe(p)] + layers[start:] \
        + [ZigzagStripe(p, inverse=True)]
    m2 = _ZigzagWrappedModel(Sequential(wrapped),
                             input_shape=model.input_shape,
                             name=model.name + "_zigzag")
    return m2, (start, len(wrapped) - 1)
