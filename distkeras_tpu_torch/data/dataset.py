"""Host-side partitioned dataset — the port's copy of
``distkeras_tpu.data.dataset.Dataset`` (numpy only, so the same calls give
the same arrays in both packages).

A column-oriented in-memory table with explicit partitions: partition k
feeds worker k, and ``stacked`` lays the partitions out as the leading
axis of one array per column, so a trainer moves an epoch's batches to
the device in one copy.  ``from_csv`` reads a numeric CSV with a numpy
parser of the same token rules as the JAX package's native one.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_SEPARATORS = re.compile(rb"[,\r\n \t]+")
_NUMERIC_PREFIX = re.compile(rb"[-+.]?[0-9]*\.?[0-9]*(?:[eE][-+]?[0-9]+)?")


def parse_csv(path: str) -> np.ndarray:
    """Every numeric value of a CSV file as one float32 vector (the caller
    reshapes).  Tokens split on ``,``, newlines, spaces and tabs; a token
    counts when it starts numeric (a digit, sign or point), and one that
    does not parse whole gives its leading numeric prefix (``strtof``'s
    rule)."""
    with open(path, "rb") as f:
        buf = f.read()
    vals = []
    for tok in _SEPARATORS.split(buf):
        if not tok or not (tok[0:1].isdigit() or tok[0:1] in b"-+."):
            continue
        try:
            vals.append(float(tok))
        except ValueError:
            m = _NUMERIC_PREFIX.match(tok)
            if m and m.group():
                try:
                    vals.append(float(m.group()))
                except ValueError:
                    pass
    return np.asarray(vals, dtype=np.float32)


class Dataset:
    """Column-oriented table with Spark-like partitioning semantics."""

    def __init__(self, columns: Dict[str, np.ndarray], num_partitions: int = 1):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        n = None
        self.columns: Dict[str, np.ndarray] = {}
        for k, v in columns.items():
            v = np.asarray(v)
            if n is None:
                n = v.shape[0]
            elif v.shape[0] != n:
                raise ValueError(f"column {k!r} has {v.shape[0]} rows, expected {n}")
            self.columns[k] = v
        self.num_rows = int(n)
        self.num_partitions = max(1, min(int(num_partitions), self.num_rows))

    # -- construction -------------------------------------------------------
    @classmethod
    def from_arrays(cls, **columns) -> "Dataset":
        return cls(columns)

    @classmethod
    def from_csv(cls, path: str, num_features: int,
                 label_col: str = "label", features_col: str = "features",
                 label_first: bool = True, nthreads: int = 0) -> "Dataset":
        """Load a numeric CSV of ``num_features + 1`` columns a row (label
        and flat pixels, the MNIST-CSV shape).  ``nthreads`` is accepted
        for parity with the JAX package's native parser and unused."""
        flat = parse_csv(path)
        width = num_features + 1
        if flat.size % width:
            raise ValueError(
                f"CSV value count {flat.size} not divisible by row width "
                f"{width}")
        rows = flat.reshape(-1, width)
        if label_first:
            labels, feats = rows[:, 0], rows[:, 1:]
        else:
            labels, feats = rows[:, -1], rows[:, :-1]
        return cls({features_col: np.ascontiguousarray(feats),
                    label_col: labels.astype(np.int64)})

    # -- Spark-surface ops --------------------------------------------------
    def repartition(self, n: int) -> "Dataset":
        """Parity: ``df.repartition(num_workers)``."""
        return Dataset(self.columns, num_partitions=n)

    def coalesce(self, n: int) -> "Dataset":
        return self.repartition(n)

    def shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Parity: ``distkeras/utils.py:shuffle(df)`` (random row order)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_rows)
        return Dataset({k: v[perm] for k, v in self.columns.items()},
                       self.num_partitions)

    def select(self, *cols: str) -> "Dataset":
        return Dataset({c: self.columns[c] for c in cols}, self.num_partitions)

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        cols = dict(self.columns)
        cols[name] = np.asarray(values)
        return Dataset(cols, self.num_partitions)

    def drop(self, *cols: str) -> "Dataset":
        return Dataset({k: v for k, v in self.columns.items() if k not in cols},
                       self.num_partitions)

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self.columns.items()},
                       self.num_partitions)

    def count(self) -> int:
        return self.num_rows

    def __len__(self) -> int:
        return self.num_rows

    @property
    def column_names(self) -> list:
        return list(self.columns)

    # -- partition access ---------------------------------------------------
    def _bounds(self) -> np.ndarray:
        return np.linspace(0, self.num_rows, self.num_partitions + 1).astype(int)

    def partition(self, i: int) -> Dict[str, np.ndarray]:
        """Columns of partition ``i`` (views, no copy)."""
        b = self._bounds()
        return {k: v[b[i]:b[i + 1]] for k, v in self.columns.items()}

    def partitions(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_partitions):
            yield self.partition(i)

    def partition_sizes(self) -> list:
        b = self._bounds()
        return [int(b[i + 1] - b[i]) for i in range(self.num_partitions)]

    def stacked(self, cols: Sequence[str], batch_size: int):
        """Partition-axis view for the trainers.

        Truncates each partition to a common multiple of ``batch_size`` and
        returns ``{col: array of shape (P, steps, batch, ...)}`` plus the
        step count.
        """
        per = min(self.partition_sizes())
        steps = per // batch_size
        if steps == 0:
            raise ValueError(
                f"batch_size {batch_size} larger than smallest partition {per}")
        out = {}
        for c in cols:
            parts = [p[c][: steps * batch_size] for p in
                     (self.partition(i) for i in range(self.num_partitions))]
            arr = np.stack(parts)  # (P, steps*batch, ...)
            out[c] = arr.reshape(self.num_partitions, steps, batch_size,
                                 *arr.shape[2:])
        return out, steps

    # -- row access ---------------------------------------------------------
    def rows(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_rows):
            yield {k: v[i] for k, v in self.columns.items()}

    def __getitem__(self, col: str) -> np.ndarray:
        return self.columns[col]

    def __repr__(self):
        cols = ", ".join(f"{k}:{v.shape[1:]}:{v.dtype}" for k, v in self.columns.items())
        return (f"Dataset(rows={self.num_rows}, partitions={self.num_partitions}, "
                f"cols=[{cols}])")
