"""Weights carried across from the JAX package.

``load_jax_variables(model, variables)`` takes the JAX ``variables`` tree
(``{"params": [...], "state": [...]}`` with numpy leaves, as
``jax.tree_util.tree_map(np.asarray, v)`` gives it) and copies every
leaf into the matching parameter (``params``) or buffer (``state``:
BatchNorm's ``mean`` and ``var``) of a built port model, walking the
layers in the order ``Sequential`` and ``Residual`` nest them.  Layouts
are the JAX package's on both sides (a ``Dense.kernel`` is (in, out)),
so leaves copy without transposes.  ``to_numpy_variables`` is the
inverse: a round trip is bit-exact; ``jax_variables`` is the same tree
over the live tensors.  A ``utils.serde`` blob's variables
load the same way (its bfloat16 leaves are torch tensors).
``jax_leaf_names`` gives the JAX package's leaf order of a model's
parameters and buffers, which checkpoints and optax states follow.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from ..models.layers import Layer, Residual, Sequential
from .tree import tree_leaves


def _walk(layer: Layer, params: Any, state: Any, path: str,
          leaf: Callable) -> None:
    """Visit ``layer``'s parameters and buffers beside the JAX trees'
    leaves, raising on any structure mismatch."""
    if hasattr(layer, "jax_tree"):  # an ingested Keras model's layer
        want = layer.jax_tree(lambda t: t)
        for kind, ts, tree in (("params", want[0], params),
                               ("state", want[1], state)):
            if not isinstance(tree, (list, tuple)) or len(tree) != len(ts):
                raise ValueError(f"{path}: expected a {len(ts)}-entry "
                                 f"{kind} list")
            for i, (t, arr) in enumerate(zip(ts, tree)):
                leaf(f"{path}.{kind}[{i}]", t, arr)
        return
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

    def pair(want, tree, where, kind):
        if not isinstance(tree, dict) or sorted(tree) != sorted(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where} ({type(layer).__name__}): {kind} "
                             f"{got} != {sorted(want)}")
        for name in sorted(want):
            if isinstance(want[name], dict):
                pair(want[name], tree[name], f"{where}.{name}", kind)
            else:
                leaf(f"{where}.{name}", want[name], tree[name])

    for kind, tree in (("params", params), ("state", state)):
        pair(_module_tree(layer, kind, lambda t: t), tree, path, kind)


def load_jax_variables(model, variables: dict) -> None:
    """Copy the JAX ``variables`` tree into ``model``'s parameters and
    buffers in place (the model must be built: ``model.init(...)``
    first)."""
    def copy(path, param, arr):
        # a leaf is a numpy array, or a torch tensor (serde's bfloat16)
        src = arr.detach() if torch.is_tensor(arr) \
            else torch.from_numpy(np.array(arr))
        rows = getattr(param, "_ep_rows", None)
        if rows is not None and src.shape[0] == rows[2]:
            # a mesh-attached MoE layer keeps its rank's experts
            src = src[rows[0]:rows[1]]
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(src)

    _walk(model.layer, variables["params"], variables["state"], "layer",
          copy)


def _module_tree(module, kind: str, leaf: Callable) -> dict:
    """A leaf layer's ``params`` (or ``state``) dict: its own parameters
    (buffers) and, nested under their names, those of its child modules
    (the MoE layer's ``router`` and ``experts``), keys sorted; a child
    without any is left out, as the JAX layer's trees have no entry for
    it."""
    own = module.named_parameters(recurse=False) if kind == "params" \
        else module.named_buffers(recurse=False)
    out = {n: leaf(t) for n, t in own}
    for name, child in module.named_children():
        sub = _module_tree(child, kind, leaf)
        if sub:
            out[name] = sub
    return dict(sorted(out.items()))


def _jax_tree(layer, leaf: Callable):
    """``layer``'s (params, state) trees in the JAX package's shape, with
    ``leaf(tensor)`` at each leaf and every dict's keys sorted, as
    ``jax.tree_util`` orders (and rebuilds) them."""
    if hasattr(layer, "jax_tree"):  # an ingested Keras model's layer
        return layer.jax_tree(leaf)
    if isinstance(layer, Sequential):
        pairs = [_jax_tree(lyr, leaf) for lyr in layer.layers]
        return [p for p, _ in pairs], [s for _, s in pairs]
    if isinstance(layer, Residual):
        params, state = {}, {}
        for key in ("inner", "shortcut"):
            sub = getattr(layer, key)
            if sub is not None:
                params[key], state[key] = _jax_tree(sub, leaf)
        return params, state
    return (_module_tree(layer, "params", leaf),
            _module_tree(layer, "state", leaf))


def to_numpy_variables(model) -> dict:
    """``model``'s parameters and buffers as a JAX-shaped ``variables``
    tree of numpy arrays (the inverse of :func:`load_jax_variables`),
    its dicts in sorted key order as the JAX trainers' trees."""
    params, state = _jax_tree(
        model.layer, lambda t: t.detach().cpu().numpy().copy())
    return {"params": params, "state": state}


def jax_variables(model) -> dict:
    """``model``'s live parameters and buffers (the tensors themselves,
    not copies) in the JAX ``variables`` tree's shape — the tree an async
    worker pulls the center into and reads its window's result from."""
    params, state = _jax_tree(model.layer, lambda t: t)
    return {"params": params, "state": state}


def jax_leaf_names(model) -> Tuple[List[str], List[str]]:
    """The names (as ``named_parameters`` / ``named_buffers`` give them)
    of ``model``'s parameters and of its buffers, each list in the order
    ``jax.tree_util.tree_leaves`` visits the JAX package's ``params`` and
    ``state`` trees: the leaf order of its checkpoints and its optax
    states."""
    names = {id(t): n for n, t in model.named_parameters()}
    names.update({id(t): n for n, t in model.named_buffers()})
    params, state = _jax_tree(model.layer, lambda t: names[id(t)])
    return tree_leaves(params), tree_leaves(state)
