"""Batched inference — the port of ``distkeras_tpu.predictors``'
``Predictor`` and ``ModelPredictor`` (parity with reference
``distkeras/predictors.py``).

``ModelPredictor.predict(ds)`` appends a column holding the model's raw
output per row.  The rows go through the model in eval mode under
``torch.no_grad()``, in batches of one fixed size (the last padded by
repeating its final row, as the JAX package pads), on the model's
device.  ``StreamingPredictor.predict_stream`` maps the model over a
stream of rows and batches, in micro-batches of one padded shape.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .data.dataset import Dataset
from .models.model import Model
from .obs import RetraceSentinel
from .utils.weights import load_jax_variables


class Predictor:
    """Base predictor (reference ``distkeras/predictors.py:Predictor``).
    The port's model holds its own weights; ``variables`` (a numpy
    variables tree, as ``trained_variables`` gives it) is loaded into
    the model when passed."""

    def __init__(self, keras_model: Model, variables: Optional[dict] = None):
        self.model = keras_model
        if keras_model.device is None:
            raise ValueError("model has no variables; train it first or "
                             "init it before predicting")
        if variables is not None:
            load_jax_variables(keras_model, variables)

    def predict(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError


def _host_input(x: np.ndarray) -> np.ndarray:
    """float64 features as float32, as ``jnp.asarray`` takes them."""
    return x.astype(np.float32) if x.dtype == np.float64 else x


class ModelPredictor(Predictor):
    """Append a prediction column (reference ``ModelPredictor``):
    ``predict(ds)`` returns the dataset with ``output_col`` holding the
    raw model output per row, float32."""

    def __init__(self, keras_model: Model, features_col: str = "features",
                 output_col: str = "prediction",
                 variables: Optional[dict] = None,
                 batch_size: int = 512, devices=None):
        super().__init__(keras_model, variables)
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        #: kept as the JAX package keeps it; prediction runs on the
        #: model's device
        self._devices = devices
        # batches are padded to one shape: a second signature is a retrace
        self._sentinel = RetraceSentinel(f"{type(self).__name__}.predict")

    def predict(self, dataset: Dataset) -> Dataset:
        x = _host_input(dataset[self.features_col])
        n = x.shape[0]
        if n == 0:
            return dataset.with_column(
                self.output_col,
                np.zeros((0, *self.model.output_shape), np.float32))
        bs = min(self.batch_size, n)
        pad = (-n) % bs
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        xb = x.reshape(-1, bs, *x.shape[1:])
        device = self.model.device
        was_training = self.model.training
        self.model.eval()
        outs = []
        try:
            with torch.no_grad():
                for i in range(xb.shape[0]):
                    batch = torch.from_numpy(xb[i]).to(device)
                    self._sentinel.observe((batch,))
                    outs.append(self.model(batch).float())
        finally:
            self.model.train(was_training)
        preds = torch.cat(outs).cpu().numpy()[:n]
        return dataset.with_column(self.output_col, preds)


class StreamingPredictor(Predictor):
    """Online prediction over an unbounded stream (parity: the
    reference's Kafka + Spark-Streaming example, a trained model mapped
    over a stream of feature rows).

    ``predict_stream(feature_iter)`` takes any iterator of feature arrays,
    single rows or batches in any mix, and yields one prediction per
    input row, in order: a float32 tensor on the model's device.  Rows
    are micro-batched to ``batch_size`` and a short last micro-batch is
    padded (by repeating its final row), so the model sees one batch
    shape; a second shape is counted as a retrace.
    """

    def __init__(self, keras_model: Model, variables: Optional[dict] = None,
                 batch_size: int = 64):
        super().__init__(keras_model, variables)
        self.batch_size = int(batch_size)
        self._sentinel = RetraceSentinel(f"{type(self).__name__}.predict")

    def _predict_batch(self, rows: list) -> torch.Tensor:
        x = _host_input(np.stack(rows))
        k = x.shape[0]
        if k < self.batch_size:  # pad to the one batch shape
            x = np.concatenate(
                [x, np.repeat(x[-1:], self.batch_size - k, axis=0)])
        batch = torch.from_numpy(x).to(self.model.device)
        self._sentinel.observe((batch,))
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return self.model(batch).float()[:k]
        finally:
            self.model.train(was_training)

    def predict_stream(self, feature_iter):
        buf: list = []
        for item in feature_iter:
            item = np.asarray(item)
            if item.ndim == len(self.model.input_shape):  # a single row
                buf.append(item)
            else:  # a batch
                buf.extend(item)
            while len(buf) >= self.batch_size:
                batch, buf = buf[: self.batch_size], buf[self.batch_size:]
                yield from self._predict_batch(batch)
        if buf:
            yield from self._predict_batch(buf)
