"""Spark-ML-style data transformers — the port's copy of
``distkeras_tpu.data.transformers`` (numpy only): the same class names,
constructor arguments and ``.transform(dataset) -> dataset`` surface,
each a whole-column numpy op, so both packages give equal arrays.
"""

from __future__ import annotations

import numpy as np

from .dataset import Dataset


class Transformer:
    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class OneHotTransformer(Transformer):
    """Label index -> one-hot vector.

    Parity: reference ``distkeras/transformers.py:OneHotTransformer``
    (``to_dense_vector`` per row).
    """

    def __init__(self, output_dim: int, input_col: str = "label",
                 output_col: str = "label_encoded"):
        self.output_dim = int(output_dim)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        labels = dataset[self.input_col].astype(np.int64).reshape(-1)
        if labels.size and (labels.min() < 0 or labels.max() >= self.output_dim):
            raise ValueError(
                f"labels must be in [0, {self.output_dim}); got range "
                f"[{labels.min()}, {labels.max()}]")
        out = np.zeros((labels.shape[0], self.output_dim), dtype=np.float32)
        out[np.arange(labels.shape[0]), labels] = 1.0
        return dataset.with_column(self.output_col, out)


class MinMaxTransformer(Transformer):
    """Range renormalization (e.g. pixels 0..255 -> 0..1).

    Parity: reference ``distkeras/transformers.py:MinMaxTransformer``.
    """

    def __init__(self, n_min: float = 0.0, n_max: float = 1.0,
                 o_min: float = 0.0, o_max: float = 255.0,
                 input_col: str = "features", output_col: str = "features_normalized"):
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        scale = (self.n_max - self.n_min) / (self.o_max - self.o_min)
        return dataset.with_column(self.output_col,
                                   (x - self.o_min) * scale + self.n_min)


class ReshapeTransformer(Transformer):
    """Flat vector -> tensor shape (for convnets).

    Parity: reference ``distkeras/transformers.py:ReshapeTransformer``.
    """

    def __init__(self, input_col: str, output_col: str, shape):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(int(s) for s in shape)

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        return dataset.with_column(self.output_col,
                                   x.reshape(x.shape[0], *self.shape))


class DenseTransformer(Transformer):
    """Sparse -> dense vector.  Our columns are already dense ndarrays, so
    this is an (idempotent) dtype/densify pass kept for API parity.

    Parity: reference ``distkeras/transformers.py:DenseTransformer``.
    """

    def __init__(self, input_col: str = "features", output_col: str = "features_dense"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        return dataset.with_column(self.output_col, x)


class LabelIndexTransformer(Transformer):
    """Prediction vector -> argmax class index (float, like the reference).

    Parity: reference ``distkeras/transformers.py:LabelIndexTransformer``.
    """

    def __init__(self, output_dim: int = None, input_col: str = "prediction",
                 output_col: str = "prediction_index", activation_threshold: float = 0.55):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col
        self.activation_threshold = activation_threshold

    def transform(self, dataset: Dataset) -> Dataset:
        p = dataset[self.input_col]
        if p.ndim == 1 or p.shape[-1] == 1:
            idx = (p.reshape(-1) >= self.activation_threshold).astype(np.float32)
        else:
            idx = np.argmax(p, axis=-1).astype(np.float32)
        return dataset.with_column(self.output_col, idx)
