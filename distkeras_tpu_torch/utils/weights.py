"""Weights carried across from the JAX package.

``load_jax_variables(model, variables)`` takes the JAX ``variables`` tree
(``{"params": [...], "state": [...]}`` with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, v)`` gives it) and copies every
leaf into the matching parameter (``params``) or buffer (``state``:
BatchNorm's ``mean`` and ``var``) of a built port model, walking the
layers in the order ``Sequential`` and ``Residual`` nest them.  Layouts
are the JAX package's on both sides (a ``Dense.kernel`` is (in, out)),
so leaves copy without transposes.  ``to_numpy_variables`` is the inverse: a round trip
is bit-exact.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..models.layers import Layer, Residual, Sequential


def _walk(layer: Layer, params: Any, state: Any, path: str,
          leaf: Callable) -> None:
    """Visit ``layer``'s parameters and buffers beside the JAX trees'
    leaves, raising on any structure mismatch."""
    if isinstance(layer, Sequential):
        n = len(layer.layers)
        if not isinstance(params, (list, tuple)) or len(params) != n \
                or not isinstance(state, (list, tuple)) or len(state) != n:
            raise ValueError(f"{path}: expected {n}-entry params/state "
                             f"lists for a Sequential")
        for i, lyr in enumerate(layer.layers):
            _walk(lyr, params[i], state[i], f"{path}[{i}]", leaf)
        return
    if isinstance(layer, Residual):
        keys = {"inner"} | ({"shortcut"} if layer.shortcut is not None
                            else set())
        if not isinstance(params, dict) or set(params) != keys \
                or not isinstance(state, dict) or set(state) != keys:
            raise ValueError(f"{path}: expected params/state keys "
                             f"{sorted(keys)} for a Residual")
        for key in sorted(keys):
            _walk(getattr(layer, key), params[key], state[key],
                  f"{path}.{key}", leaf)
        return
    for kind, tree, names in (
            ("params", params,
             sorted(n for n, _ in layer.named_parameters(recurse=False))),
            ("state", state,
             sorted(n for n, _ in layer.named_buffers(recurse=False)))):
        if not isinstance(tree, dict) or sorted(tree) != names:
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path} ({type(layer).__name__}): {kind} "
                             f"{got} != {names}")
        for name in names:
            leaf(f"{path}.{name}", getattr(layer, name), tree[name])


def load_jax_variables(model, variables: dict) -> None:
    """Copy the JAX ``variables`` tree into ``model``'s parameters and
    buffers in place (the model must be built: ``model.init(...)``
    first)."""
    def copy(path, param, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr)))

    _walk(model.layer, variables["params"], variables["state"], "layer",
          copy)


def to_numpy_variables(model) -> dict:
    """``model``'s parameters and buffers as a JAX-shaped ``variables``
    tree of numpy arrays (the inverse of :func:`load_jax_variables`)."""
    def tree(layer):
        if isinstance(layer, Sequential):
            pairs = [tree(lyr) for lyr in layer.layers]
            return [p for p, _ in pairs], [s for _, s in pairs]
        if isinstance(layer, Residual):
            params, state = {}, {}
            for key in ("inner", "shortcut"):
                sub = getattr(layer, key)
                if sub is not None:
                    params[key], state[key] = tree(sub)
            return params, state
        return tuple({n: t.detach().cpu().numpy().copy() for n, t in it}
                     for it in (layer.named_parameters(recurse=False),
                                layer.named_buffers(recurse=False)))

    params, state = tree(model.layer)
    return {"params": params, "state": state}
