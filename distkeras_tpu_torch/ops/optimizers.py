"""Worker optimizers — the port of ``distkeras_tpu.ops.optimizers``.

The JAX package resolves the Keras-style names to optax transformations.
Here each is written out over a dict of tensors in optax's shape: an
``Optimizer`` of ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``, where ``params + updates`` is the next
step.  The rules and defaults are optax's (0.2.6, ``optax/_src/alias.py``
and ``transform.py``), which differ from ``torch.optim`` in places:
adagrad's accumulator starts at 0.1 with eps 1e-7 inside the rsqrt;
rmsprop decays at 0.9 with eps inside the rsqrt; adam's bias correction
is computed in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], Tuple[Params, dict]]


def _full(params: Params, value: float) -> Params:
    return {n: torch.full_like(p, value) for n, p in params.items()}


def _moment(g, t, decay: float, order: int):
    """optax's ``update_moment``: (1 − decay)·g^order + decay·t."""
    return (1 - decay) * g ** order + decay * t


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _scaled(updates: Params, lr: float) -> Params:
    """optax's ``scale_by_learning_rate``: descend by ``lr``."""
    return {n: u * -lr for n, u in updates.items()}


def sgd(lr: float, momentum=None, nesterov: bool = False) -> Optimizer:
    """optax.sgd: ``trace`` (t = g + m·t; nesterov g + m·t) then −lr."""
    def init(params):
        return {} if momentum is None else {"trace": _full(params, 0.0)}

    def update(grads, state, params=None):
        if momentum is None:
            return _scaled(grads, lr), state
        trace = {n: g + momentum * state["trace"][n]
                 for n, g in grads.items()}
        upd = {n: g + momentum * trace[n] for n, g in grads.items()} \
            if nesterov else trace
        return _scaled(upd, lr), {"trace": trace}
    return Optimizer(init, update)


def adagrad(lr: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    """optax.adagrad: ``scale_by_rss`` then −lr."""
    def init(params):
        return {"sum_of_squares": _full(params, initial_accumulator_value)}

    def update(grads, state, params=None):
        sos = {n: g * g + state["sum_of_squares"][n]
               for n, g in grads.items()}
        upd = {n: torch.where(sos[n] > 0, torch.rsqrt(sos[n] + eps),
                              torch.zeros_like(g)) * g
               for n, g in grads.items()}
        return _scaled(upd, lr), {"sum_of_squares": sos}
    return Optimizer(init, update)


def adadelta(lr: float, rho: float = 0.9, eps: float = 1e-6) -> Optimizer:
    """optax.adadelta: ``scale_by_adadelta`` then −lr."""
    def init(params):
        return {"e_g": _full(params, 0.0), "e_x": _full(params, 0.0)}

    def update(grads, state, params=None):
        e_g = {n: _moment(g, state["e_g"][n], rho, 2)
               for n, g in grads.items()}
        upd = {n: torch.sqrt(state["e_x"][n] + eps)
               / torch.sqrt(e_g[n] + eps) * g for n, g in grads.items()}
        e_x = {n: _moment(u, state["e_x"][n], rho, 2)
               for n, u in upd.items()}
        return _scaled(upd, lr), {"e_g": e_g, "e_x": e_x}
    return Optimizer(init, update)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """optax.rmsprop (uncentered, no momentum): ``scale_by_rms`` with eps
    inside the rsqrt, then −lr."""
    def init(params):
        return {"nu": _full(params, 0.0)}

    def update(grads, state, params=None):
        nu = {n: _moment(g, state["nu"][n], decay, 2)
              for n, g in grads.items()}
        upd = {n: torch.rsqrt(nu[n] + eps) * g for n, g in grads.items()}
        return _scaled(upd, lr), {"nu": nu}
    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """optax.adam: ``scale_by_adam`` (bias-corrected moments, eps outside
    the sqrt) then −lr.  The step count is a host int, so no step reads
    anything back from the device."""
    def init(params):
        return {"count": 0, "mu": _full(params, 0.0),
                "nu": _full(params, 0.0)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        mu = {n: _moment(g, state["mu"][n], b1, 1) for n, g in grads.items()}
        nu = {n: _moment(g, state["nu"][n], b2, 2) for n, g in grads.items()}
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        upd = {n: (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
               for n in grads}
        return _scaled(upd, lr), {"count": count, "mu": mu, "nu": nu}
    return Optimizer(init, update)


def get_optimizer(spec, learning_rate: float = 0.01) -> Optimizer:
    """Resolve an optimizer spec: an ``Optimizer`` (used as-is) or one of
    the Keras-style names ``sgd``, ``momentum``, ``nesterov``,
    ``adagrad``, ``adadelta``, ``rmsprop``, ``adam``."""
    if isinstance(spec, Optimizer):
        return spec
    name = spec.lower()
    if name == "sgd":
        return sgd(learning_rate)
    if name == "momentum":
        return sgd(learning_rate, momentum=0.9)
    if name == "nesterov":
        return sgd(learning_rate, momentum=0.9, nesterov=True)
    if name == "adagrad":
        return adagrad(learning_rate)
    if name == "adadelta":
        return adadelta(learning_rate)
    if name == "rmsprop":
        return rmsprop(learning_rate)
    if name == "adam":
        return adam(learning_rate)
    raise ValueError(f"unknown optimizer {spec!r}")
