"""Loss functions — the port of ``distkeras_tpu.ops.losses``.

The same string surface (Keras loss names) resolving to
``loss(logits_or_probs, targets) -> scalar`` over tensors.  The named
crossentropies take logits (a log-softmax inside the loss); the
``*_from_probs`` variants take probabilities with a clipped log (Keras
semantics), for models ending in a softmax or sigmoid layer, which the
trainers detect and swap in.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


def categorical_crossentropy(logits, targets):
    """targets: one-hot (batch, classes); logits: (batch, classes)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(targets * logp, dim=-1))


def _gather_mean(logp, targets):
    """−mean of ``logp`` at the class ids ``targets`` (any leading shape:
    (batch,) for classifiers, (batch, seq) for per-token LM loss)."""
    return -torch.mean(torch.gather(
        logp, -1, targets.to(torch.int64)[..., None]))


def sparse_categorical_crossentropy(logits, targets):
    """targets: int class ids with logits' leading shape."""
    return _gather_mean(torch.log_softmax(logits, dim=-1), targets)


def binary_crossentropy(logits, targets):
    """targets in {0,1}, logits: raw scores (any shape)."""
    logits = logits.reshape(targets.shape)
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def mean_squared_error(preds, targets):
    return torch.mean((preds - targets) ** 2)


def mean_absolute_error(preds, targets):
    return torch.mean(torch.abs(preds - targets))


LOSSES: dict[str, Callable] = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
}


def get_loss(name_or_fn: Union[str, Callable]) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    return LOSSES[name_or_fn]


# -- on-probabilities variants (Keras semantics) ----------------------------

_EPS = 1e-7


def categorical_crossentropy_from_probs(probs, targets):
    p = torch.clamp(probs, _EPS, 1.0)
    return -torch.mean(torch.sum(targets * torch.log(p), dim=-1))


def sparse_categorical_crossentropy_from_probs(probs, targets):
    return _gather_mean(torch.log(torch.clamp(probs, _EPS, 1.0)), targets)


def binary_crossentropy_from_probs(probs, targets):
    p = torch.clamp(probs.reshape(targets.shape), _EPS, 1.0 - _EPS)
    return -torch.mean(targets * torch.log(p)
                       + (1 - targets) * torch.log1p(-p))


_PROBS_VARIANTS: dict[str, Callable] = {
    "categorical_crossentropy": categorical_crossentropy_from_probs,
    "sparse_categorical_crossentropy":
        sparse_categorical_crossentropy_from_probs,
    "binary_crossentropy": binary_crossentropy_from_probs,
}


def probs_loss_variant(name: str):
    """On-probs variant of a named loss, or None if not a crossentropy."""
    return _PROBS_VARIANTS.get(name)
