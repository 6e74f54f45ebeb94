"""Utility surface — the port of ``distkeras_tpu.utils``' helpers
(parity with reference ``distkeras/utils.py``), device selection, cache
trees, weights carried across from JAX, serde and checkpoints."""

from __future__ import annotations

import numpy as np
import torch

from . import checkpoint, serde  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .device import default_device  # noqa: F401
from .tree import tree_map
from .serde import deserialize_model, serialize_model  # noqa: F401
from .weights import load_jax_variables, to_numpy_variables  # noqa: F401


def shuffle(dataset, seed=None):
    """Parity: ``distkeras/utils.py:shuffle(df)``."""
    return dataset.shuffle(seed)


def to_dense_vector(label, output_dim: int) -> np.ndarray:
    """Parity: ``distkeras/utils.py:to_dense_vector`` (one-hot a label)."""
    label, output_dim = int(label), int(output_dim)
    if not 0 <= label < output_dim:
        raise ValueError(f"label {label} out of range [0, {output_dim})")
    v = np.zeros((output_dim,), dtype=np.float32)
    v[label] = 1.0
    return v


def new_dataset_row(row: dict, col: str, value) -> dict:
    """Parity: ``distkeras/utils.py:new_dataframe_row`` (append a column)."""
    out = dict(row)
    out[col] = value
    return out


new_dataframe_row = new_dataset_row


def uniform_weights(variables: dict, seed: int = 0,
                    bound: float = 0.05) -> dict:
    """Re-initialize every param of a numpy ``variables`` tree uniformly
    in [-bound, bound] from a ``torch.Generator`` seeded with ``seed``
    (the draws differ from the JAX package's ``jax.random``); ``state``
    is kept.  Parity: ``distkeras/utils.py:uniform_weights``."""
    gen = torch.Generator().manual_seed(int(seed))

    def draw(leaf):
        leaf = np.asarray(leaf)
        u = torch.rand(leaf.shape, generator=gen, dtype=torch.float64)
        return ((u * 2.0 - 1.0) * bound).numpy().astype(leaf.dtype)

    return {"params": tree_map(draw, variables["params"]),
            "state": variables["state"]}


def history_average(history: list) -> float:
    """Average a loss history list (parity helper for the workflow
    plots)."""
    if not history:
        return float("nan")
    return float(np.mean([h["loss"] if isinstance(h, dict) else h
                          for h in history]))
