"""Checkpoint / resume — the port of ``distkeras_tpu.utils.checkpoint``, in
its file format.

A checkpoint is one v1 ``utils.serde`` blob, ``{"leaves": [...], "meta":
{...}}``: a tree's leaves in ``jax.tree_util.tree_leaves`` order (dict
keys sorted, lists and tuples in order, None an empty subtree), written
atomically (temp file, then ``os.replace``), with a rolling-keep manager
(``CheckpointManager``: ``step-N.ckpt``).  ``load_tree`` puts the leaves
back into the structure of a caller's tree (``like``); where ``like``
holds a tensor, the leaf lands on its device in its dtype.  The JAX package
allgathers leaves sharded over several processes before it saves; the
port runs on one card and has no such leaves.

The trainers' state follows the JAX trainers' trees, so a checkpoint
written by either package resumes in the other:

* ``SingleTrainer``: ``(variables, opt_state, rng)``;
* the sync distributed trainers: ``(center, local, opt_state, rngs)``,
  with ``local`` and the optimizer state stacked (W, …) over the
  workers, as ``jax.vmap(optimizer.init)`` stacks them.

``variables`` / ``center`` / ``local`` leaves come in the JAX model's
order (``utils.weights.jax_leaf_names``).  ``opt_state`` comes in
optax's leaf order (``opt_state_leaves``).  The rng leaf is a uint32
key of the reference's shape, (2,) for one trainer and (W, 2) for W
workers (``rng_key``).  The port's exact ``torch.Generator`` states go
into ``meta`` under ``GENERATORS``; the JAX trainer reads only
``meta["epoch"]``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from . import serde
from .tree import tree_leaves

Tree = Any

#: the ``meta`` key of the port's generator states: ``{"device": the
#: generators' device type, "states": [get_state() bytes, ...]}``
GENERATORS = "torch_generators"


def _like(ref, leaf):
    """``leaf`` on ``ref``'s device in its dtype where ``ref`` is a
    tensor; as decoded otherwise (numpy arrays), as the JAX package
    returns every leaf."""
    if not torch.is_tensor(ref):
        return leaf
    src = leaf if torch.is_tensor(leaf) else torch.from_numpy(np.array(leaf))
    if tuple(src.shape) != tuple(ref.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(src.shape)} "
                         f"where the tree has {tuple(ref.shape)}")
    return src.to(device=ref.device, dtype=ref.dtype)


def tree_unflatten(like: Tree, leaves: Sequence) -> Tree:
    """``like``'s structure holding ``leaves`` (in ``tree_leaves`` order),
    a tensor leaf of ``like`` taking its device and dtype (``_like``)."""
    it = iter(leaves)

    def build(ref):
        if ref is None:
            return None
        if isinstance(ref, dict):
            built = {k: build(ref[k]) for k in sorted(ref)}
            return {k: built[k] for k in ref}
        if isinstance(ref, (list, tuple)):
            out = [build(t) for t in ref]
            return out if isinstance(ref, list) else tuple(out)
        return _like(ref, next(it))

    return build(like)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def save_tree(path: str, tree: Tree, meta: Optional[dict] = None) -> None:
    """Atomically write ``tree``'s leaves (on the host) and ``meta``."""
    blob = serde.tree_to_bytes({"leaves": tree_leaves(tree),
                                "meta": meta or {}})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_tree(path: str, like: Tree) -> tuple:
    """``(tree, meta)``, ``tree`` shaped like ``like`` (see
    ``tree_unflatten``); a leaf count that differs from ``like``'s
    raises."""
    with open(path, "rb") as f:
        payload = serde.tree_from_bytes(f.read())
    leaves, want = payload["leaves"], len(tree_leaves(like))
    if len(leaves) != want:
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, reference tree has "
            f"{want} — structure mismatch")
    return tree_unflatten(like, leaves), payload["meta"]


class CheckpointManager:
    """Rolling checkpoints ``step-N.ckpt`` under a directory, keep last K."""

    _PAT = re.compile(r"^step-(\d+)\.ckpt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step}.ckpt")

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(
            self._PAT.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Tree, meta: Optional[dict] = None) -> str:
        meta = dict(meta or {})
        meta["step"] = int(step)
        path = self.path(step)
        save_tree(path, tree, meta)
        for old in self.steps()[: -self.keep]:
            try:
                os.unlink(self.path(old))
            except OSError:
                pass
        return path

    def restore(self, like: Tree, step: Optional[int] = None) -> tuple:
        """``(tree, meta)`` from ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_tree(self.path(step), like)


# ---------------------------------------------------------------------------
# the trainers' state in the reference's leaf order
# ---------------------------------------------------------------------------

def _scalar_leaf(x) -> np.ndarray:
    """A host scalar of an optimizer state (adam's step count) as the
    0-d array optax keeps: int32 for an int, float32 for a float."""
    return np.asarray(x, np.int32 if isinstance(x, int) else np.float32)


def opt_state_leaves(state: dict, names: Sequence[str]) -> list:
    """One port optimizer state in optax's ``tree_leaves`` order.  The
    port's states list their fields in the order of optax's state
    NamedTuples (``ops.optimizers``: adam ``count``, ``mu``, ``nu``;
    adadelta ``e_g``, ``e_x``; sgd with momentum ``trace``; plain sgd
    none); a per-parameter field contributes its tensors in ``names``
    order (``jax_leaf_names``), a scalar field one 0-d array."""
    out = []
    for value in state.values():
        if isinstance(value, dict):
            out += [value[n] for n in names]
        else:
            out.append(_scalar_leaf(value))
    return out


def stacked_opt_state_leaves(states: List[dict],
                             names: Sequence[str]) -> list:
    """W workers' optimizer states as ``jax.vmap(optimizer.init)`` stacks
    them: each leaf of ``opt_state_leaves`` with a leading (W,) axis."""
    per_worker = [opt_state_leaves(s, names) for s in states]
    return [torch.stack(col) if torch.is_tensor(col[0])
            else np.stack(col) for col in zip(*per_worker)]


def opt_state_from_leaves(like: dict, leaves: Sequence,
                          names: Sequence[str]) -> dict:
    """The inverse of :func:`opt_state_leaves`: ``like``'s fields holding
    ``leaves``; a scalar field takes its Python type back."""
    it = iter(leaves)
    out = {}
    for key, value in like.items():
        if isinstance(value, dict):
            out[key] = {n: next(it) for n in names}
        else:
            out[key] = type(value)(np.asarray(next(it)).item())
    return out


def unstacked_opt_states(likes: List[dict], leaves: Sequence,
                         names: Sequence[str]) -> List[dict]:
    """The inverse of :func:`stacked_opt_state_leaves`."""
    return [opt_state_from_leaves(like, [leaf[k] for leaf in leaves], names)
            for k, like in enumerate(likes)]


def rng_key(seed: int, workers: Optional[int] = None) -> np.ndarray:
    """The rng leaf: the 64-bit seed each of the port's generators was
    seeded with, as (high, low) uint32 words, the layout of a
    ``jax.random.PRNGKey``.  One trainer passes its generator's seed
    (``seed + 1``), shape (2,): ``PRNGKey(seed + 1)``, the key the JAX
    trainer starts from.  For W workers row k is worker k's ``seed +
    k·2³²`` (``SyncEngine.seed``), i.e. ``[k, seed]``, shape (W, 2)."""
    seeds = [int(seed)] if workers is None else \
        [int(seed) + (k << 32) for k in range(workers)]
    key = np.array([[(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF]
                    for s in seeds], np.uint32)
    return key[0] if workers is None else key


def generator_meta(generators: Sequence[torch.Generator]) -> dict:
    """``meta[GENERATORS]``: the generators' exact states."""
    return {"device": generators[0].device.type,
            "states": [bytes(g.get_state().numpy()) for g in generators]}


def restore_generators(generators: Sequence[torch.Generator],
                       meta: dict) -> bool:
    """Set ``generators`` to the states ``meta`` holds; False (and the
    generators left as they are) where it holds none for them: a file the
    JAX package wrote, or one saved on another device type."""
    saved = meta.get(GENERATORS)
    if not saved or saved["device"] != generators[0].device.type \
            or len(saved["states"]) != len(generators):
        return False
    for g, state in zip(generators, saved["states"]):
        g.set_state(torch.frombuffer(bytearray(state), dtype=torch.uint8))
    return True
