"""The local minibatch step and the window loop — the port's share of
``distkeras_tpu.parallel.sync`` (``make_local_step``, ``make_window_fn``).

The JAX package scans a jit-compiled ``value_and_grad`` + optax update
over a window of batches, carrying a pure ``(variables, opt_state, rng)``
tree.  Here the parameters are the model's own ``nn.Parameter``s, keyed
by name (``model_params``); a step runs the forward, takes the gradients
with ``torch.autograd.grad`` and applies the optimizer's updates to the
parameters in place under ``torch.no_grad()`` (JAX donates the carry
buffers for the same effect).  The window is a Python loop over the
leading steps axis whose per-step losses stay on the device, stacked:
nothing in it reads a value back to the host.

The forward runs in train mode (the model is switched for the window and
back after it).  Where JAX carries an rng key, the port carries a
``torch.Generator`` on the model's device, handed to the layers that draw
(Dropout); where JAX returns a new ``state`` tree, each stateful layer
records its new state in the forward and ``commit_state`` copies it into
the buffers after the update, as the JAX step replaces ``state`` after
its update.

The window-edge communication rules (``AdagSync`` and the rest) come with
the sync distributed trainers.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models.layers import commit_state, set_generator
from ..utils.tree import tree_map

Params = Dict[str, torch.Tensor]


def model_params(model) -> Params:
    """The model's parameters by name: the tree the optimizer and the
    step update (in place)."""
    return dict(model.named_parameters())


def aux_losses(model) -> list:
    """Every ``aux_loss`` a layer of ``model`` recorded in its last forward
    (the JAX package's MoE router losses; no port layer records one yet)."""
    return [lyr.aux_loss for lyr in model.iter_layers()
            if getattr(lyr, "aux_loss", None) is not None]


def _replay(gen: Optional[torch.Generator]):
    """``context_fn`` for ``checkpoint``: the recompute in the backward
    draws from ``gen`` as the forward did (``preserve_rng_state`` covers
    the global generators only), and leaves ``gen`` where the forward
    left it."""
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    start = gen.get_state()

    @contextlib.contextmanager
    def recompute():
        after = gen.get_state()
        gen.set_state(start)
        try:
            yield
        finally:
            gen.set_state(after)

    return contextlib.nullcontext(), recompute()


def make_local_step(model, loss_fn: Callable, optimizer,
                    compute_dtype=None, remat: bool = False,
                    aux_weight: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """One minibatch of local optimization:
    ``step(params, opt_state, x, y) -> (opt_state, loss)``, with
    ``params`` (``model_params(model)``) updated in place, the layers'
    state committed after the update, and ``loss`` a 0-d tensor on the
    device.  The caller puts the model in train mode; ``generator``
    feeds the layers that draw random numbers.

    ``compute_dtype`` (mixed precision): the forward runs on cast copies
    of the floating parameters (and of a floating ``x``), made inside the
    autograd graph, so the gradients land on the f32 masters that the
    optimizer updates.  ``remat=True`` wraps the forward in a
    (non-reentrant) activation checkpoint: activations are recomputed in
    the backward instead of kept, with the same random draws, and state
    is committed once.  ``aux_weight > 0`` adds
    ``aux_weight * Σ aux_losses`` to the objective.
    """
    set_generator(model, generator)

    def forward(x):
        if compute_dtype is None:
            return model(x)
        cast = {n: p.to(compute_dtype) if p.is_floating_point() else p
                for n, p in model.named_parameters()}
        return functional_call(model, cast, (x,))

    def step(params: Params, opt_state, x, y):
        if compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        names = list(params)
        with torch.enable_grad():
            out = checkpoint(forward, x, use_reentrant=False,
                             context_fn=lambda: _replay(generator)) \
                if remat else forward(x)
            loss = loss_fn(out, y)
            if aux_weight:
                aux = aux_losses(model)
                if aux:
                    loss = loss + aux_weight * sum(aux)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
        # an unused parameter's gradient is zero, as JAX gives it
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        commit_state(model)
        return opt_state, loss.detach()

    return step


def make_window_fn(model, loss_fn, optimizer, compute_dtype=None,
                   remat: bool = False, aux_weight: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """The window loop: ``run(params, opt_state, xs, ys) -> (params,
    opt_state, losses)`` over the leading (steps) axis of ``xs``/``ys``,
    in train mode (eval mode again on return); ``losses`` is a (steps,)
    float32 tensor on the device."""
    step = make_local_step(model, loss_fn, optimizer, compute_dtype, remat,
                           aux_weight, generator)

    def run(params: Params, opt_state, xs, ys):
        losses = []
        model.train(True)
        try:
            for i in range(xs.shape[0]):
                opt_state, loss = step(params, opt_state, xs[i], ys[i])
                losses.append(loss)
        finally:
            model.train(False)
        return params, opt_state, torch.stack(losses).float()

    return run
