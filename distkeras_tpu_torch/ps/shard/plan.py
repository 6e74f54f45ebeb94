"""Shard placement plan — the port of ``distkeras_tpu.ps.shard.plan``:
deterministic per-tensor partitioning of the center tree across N
parameter-server shards.

The plan is a pure function of ``(tree structure, leaf sizes,
num_shards)``: leaves are enumerated in a canonical path order (dict keys
sorted, sequence indices in order) and placed with a greedy byte-balance
rule — largest tensors first, each onto the currently-lightest shard,
ties broken by shard index.  Workers and shards each build the plan from
their own copy of the tree and must agree; the :attr:`ShardPlan.digest`
(sha256 over the canonical assignment map) is exchanged in the ``hello``
negotiation, so a disagreement is caught at connect time.  The digest is
the JAX package's, byte for byte, for the same variables tree: a leaf's
size is its ``numel * element_size`` (a bfloat16 tensor counts 2 bytes an
element, as the JAX package's ml_dtypes arrays do, and a tensor on the
card is sized without a copy to the host), a numpy leaf's its ``nbytes``,
and a leaf that is neither 8 bytes.

A shard's slice of the tree is a **flat path-keyed dict**
(``{"params/0/kernel": ndarray, ...}``), a valid tree for every update
rule, so each shard hosts an unmodified ``ParameterServer`` over its
slice.  :meth:`ShardPlan.assemble` rebuilds the original structure from
the union of slices.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Any

SCHEMA = "dktpu-shard-plan/v1"


class _Slot:
    """Leaf placeholder in the structure skeleton (a plain string could
    collide with a genuine string leaf)."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Canonical-order ``(path, leaf)`` pairs: dicts by sorted key,
    sequences by index — the one leaf enumeration every participant
    (worker and shard host, in either package) shares."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(
                    f"shard plans need string dict keys, got {k!r}")
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}{i}/"))
        return out
    return [(prefix[:-1] if prefix else "", tree)]


def _skeleton(tree: Tree, prefix: str = "") -> Tree:
    """The tree with every leaf replaced by a :class:`_Slot` — assembly's
    structural template (empty containers survive verbatim)."""
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k], f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        seq = [_skeleton(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return seq if isinstance(tree, list) else tuple(seq)
    return _Slot(prefix[:-1] if prefix else "")


def _leaf_bytes(leaf: Any) -> int:
    """Placement weight of one leaf: a tensor's ``numel * element_size``,
    an array's ``nbytes``, 8 for anything else.  Reads dtype and shape
    only, never values."""
    if torch.is_tensor(leaf):
        return int(leaf.numel() * leaf.element_size())
    try:
        return int(np.asarray(leaf).nbytes)
    except (TypeError, ValueError):
        return 8


class ShardPlan:
    """Deterministic per-tensor placement of a tree across N shards."""

    def __init__(self, assignments: Dict[str, int], num_shards: int,
                 epoch: int, skeleton: Tree, leaf_bytes: Dict[str, int]):
        self.assignments = dict(assignments)
        self.num_shards = int(num_shards)
        #: plan generation: a re-sharded or restarted fleet bumps it, and
        #: the consistent-cut pull refuses to assemble slices from two
        #: different epochs
        self.epoch = int(epoch)
        self._skeleton = skeleton
        self.leaf_bytes = dict(leaf_bytes)
        self.digest = self._digest()

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, tree: Tree, num_shards: int, epoch: int = 0) -> "ShardPlan":
        """Greedy byte-balanced placement: leaves sorted by (bytes desc,
        path), each assigned to the lightest shard so far (ties -> lowest
        index)."""
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        leaves = _flatten(tree)
        if len(set(p for p, _ in leaves)) != len(leaves):
            raise ValueError("duplicate leaf paths (a dict key contains "
                             "'/' ambiguously)")
        sizes = {p: _leaf_bytes(v) for p, v in leaves}
        load = [0] * num_shards
        assignments: Dict[str, int] = {}
        for path, _ in sorted(leaves, key=lambda kv: (-sizes[kv[0]], kv[0])):
            shard = min(range(num_shards), key=lambda i: (load[i], i))
            assignments[path] = shard
            load[shard] += sizes[path]
        return cls(assignments, num_shards, epoch, _skeleton(tree), sizes)

    def _digest(self) -> str:
        doc = {"schema": SCHEMA, "num_shards": self.num_shards,
               "epoch": self.epoch,
               "assignments": {k: self.assignments[k]
                               for k in sorted(self.assignments)}}
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    # -- negotiation --------------------------------------------------------
    def descriptor(self) -> dict:
        """The compact agreement token the ``hello`` reply carries."""
        return {"num_shards": self.num_shards, "epoch": self.epoch,
                "digest": self.digest}

    # -- split / assemble ---------------------------------------------------
    def split(self, tree: Tree) -> List[Dict[str, Any]]:
        """Tree -> one flat ``{path: leaf}`` slice per shard.  The tree
        must have exactly the plan's leaf paths."""
        slices: List[Dict[str, Any]] = [{} for _ in range(self.num_shards)]
        paths = set()
        for path, leaf in _flatten(tree):
            shard = self.assignments.get(path)
            if shard is None:
                raise KeyError(f"leaf {path!r} is not in the shard plan")
            slices[shard][path] = leaf
            paths.add(path)
        missing = set(self.assignments) - paths
        if missing:
            raise KeyError(f"tree is missing planned leaves: "
                           f"{sorted(missing)[:4]}...")
        return slices

    def assemble(self, *slices: Dict[str, Any]) -> Tree:
        """Union of flat slices -> the original tree structure."""
        flat: Dict[str, Any] = {}
        for s in slices:
            flat.update(s)

        def fill(node):
            if isinstance(node, _Slot):
                if node.path not in flat:
                    raise KeyError(f"assembled center is missing leaf "
                                   f"{node.path!r}")
                return flat[node.path]
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, list):
                return [fill(v) for v in node]
            if isinstance(node, tuple):
                return tuple(fill(v) for v in node)
            return node

        return fill(self._skeleton)

    # -- documents ----------------------------------------------------------
    def doc(self, addresses=None) -> dict:
        """Plain-data plan document (the ``plan`` RPC reply body; with
        ``addresses`` it is also the plan file: one entry per shard with
        host, port and its leaves)."""
        shards = []
        for i in range(self.num_shards):
            paths = sorted(p for p, s in self.assignments.items() if s == i)
            entry = {"index": i,
                     "paths": paths,
                     "bytes": int(sum(self.leaf_bytes.get(p, 0)
                                      for p in paths))}
            if addresses is not None:
                entry["host"], entry["port"] = addresses[i]
            shards.append(entry)
        return {"schema": SCHEMA, "num_shards": self.num_shards,
                "epoch": self.epoch, "digest": self.digest,
                "shards": shards}
