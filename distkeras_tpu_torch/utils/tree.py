"""Minimal trees of tensors: nested dicts, lists and tuples with tensor
(or None) leaves — the shape of the port's decode caches.  ``None``
leaves are kept in place (a cache-free layer's slot) and skipped by
``tree_leaves``, as JAX pytrees drop them.  ``tree_leaves`` visits dict
keys sorted, in ``jax.tree_util.tree_leaves``' order."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``;
    None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The non-None leaves of ``tree``, depth first, in
    ``jax.tree_util.tree_leaves`` order: dict keys sorted, lists and
    tuples in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_flatten(tree: Any, is_leaf: Callable = None):
    """``(leaves, unflatten)``: the non-None leaves of ``tree`` in
    ``tree_leaves`` order, and a function building the same structure
    around a new list of leaves — with every dict's keys sorted, as
    ``jax.tree_util.tree_unflatten`` builds them.  ``is_leaf(node)``
    True stops the walk at ``node`` (a codec stub dict)."""
    leaves: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return None, 1
        if t is None:
            return None, 0
        if isinstance(t, dict):
            return ("dict", [(k, walk(t[k])) for k in sorted(t)]), None
        if isinstance(t, (list, tuple)):
            return (type(t), [walk(x) for x in t]), None
        leaves.append(t)
        return None, 1

    spec = walk(tree)

    def unflatten(new_leaves):
        it = iter(new_leaves)

        def build(node):
            kind, leaf = node
            if leaf == 1:
                return next(it)
            if kind is None:
                return None
            if kind[0] == "dict":
                return {k: build(sub) for k, sub in kind[1]}
            return kind[0](build(sub) for sub in kind[1])

        return build(spec)

    return leaves, unflatten
