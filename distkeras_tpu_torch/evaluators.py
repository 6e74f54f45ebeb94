"""Evaluation — the port of ``distkeras_tpu.evaluators`` (parity with
reference ``distkeras/evaluators.py``): numpy reductions over Dataset
columns with the ``.evaluate(ds) -> float`` surface; ``LossEvaluator``
runs the port's torch losses.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.dataset import Dataset


class Evaluator:
    """Base evaluator (reference ``distkeras/evaluators.py:Evaluator``).

    ``prediction_kind`` / ``label_kind`` disambiguate what the columns
    hold: ``"auto"`` (default — infer, see ``_to_class_index``),
    ``"ids"`` (class indices, any shape), ``"onehot"`` (one-hot or
    probability vectors, argmaxed on the last axis).  Pass an explicit
    kind when auto-inference is ambiguous — e.g. integer (B, T) per-token
    targets over a binary vocabulary, which value-based inference could
    misread as one-hot rows.  Integer one-hot labels with
    3+ columns and 8+ rows are read as one-hot silently (the
    per-token-ids reading would need every row of the eval set to hold
    exactly one 1-token — not a plausible coincidence at that size);
    only genuinely ambiguous shapes warn: 2-column arrays (``[0, 1]``
    rows are equally consistent with 2-class one-hot and 2-token binary
    ids) and tiny eval sets.  Pass ``label_kind='onehot'`` (or
    ``'ids'``) to state which reading applies and silence the
    warning."""

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label", prediction_kind: str = "auto",
                 label_kind: str = "auto"):
        self.prediction_col = prediction_col
        self.label_col = label_col
        for kind in (prediction_kind, label_kind):
            if kind not in ("auto", "ids", "onehot"):
                raise ValueError(
                    f"kind must be auto|ids|onehot, got {kind!r}")
        self.prediction_kind = prediction_kind
        self.label_kind = label_kind

    def evaluate(self, dataset: Dataset) -> float:
        raise NotImplementedError


def _to_class_index(a: np.ndarray, threshold: float = 0.5,
                    kind: str = "auto") -> np.ndarray:
    """Accept class indices (any shape — (B,) classifiers or (B, T)
    per-token LM targets), one-hot/probability vectors (argmaxed on the
    last axis), or (for the binary 1-column case) sigmoid probabilities
    thresholded at 0.5.  ``kind`` overrides the inference ("ids" /
    "onehot"); integer one-hot auto-detection is restricted to 2-D
    arrays, so (B, T, V) integer targets need the explicit kind."""
    a = np.asarray(a)
    if kind == "onehot":
        return np.argmax(a, axis=-1)
    if kind == "ids":
        if a.ndim >= 2 and a.shape[-1] == 1:
            a = a[..., 0]
        return a.astype(np.int64)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        if a.ndim >= 2 and a.shape[-1] == 1:
            a = a[..., 0]
        if a.ndim == 2 and a.shape[-1] > 1 and a.min() >= 0 \
                and a.max() <= 1 and np.all(a.sum(axis=-1) == 1):
            # every row holds exactly one 1: one-hot rows.  The competing
            # reading — (B, T) per-token ids over a binary vocabulary —
            # would require every row of the eval set to coincidentally
            # hold exactly one 1-token: at C >= 3 columns and B >= 8 rows
            # that chance is < (3/8)^8 ≈ 4e-4, so legitimate one-hot
            # evals read silently.  Genuinely ambiguous shapes still warn:
            # 2-column rows ([0, 1] reads both ways at ANY size) and
            # too-few-row arrays (the signature is weak evidence).
            if a.shape[-1] == 2 or a.shape[0] < 8:
                import warnings
                warnings.warn(
                    f"auto kind read a {a.shape} integer array whose rows "
                    "sum to 1 as one-hot rows and argmaxed it, but this "
                    "shape is also consistent with (B, T) per-token class "
                    "ids over a binary vocabulary; pass prediction_kind/"
                    "label_kind='ids' if the column holds per-token ids, "
                    "or 'onehot' to confirm one-hot rows and silence this "
                    "warning", stacklevel=3)
            return np.argmax(a, axis=-1)  # integer one-hot rows
        return a.astype(np.int64)         # class ids, (B,) or (B, T)
    if a.ndim >= 2 and a.shape[-1] > 1:
        return np.argmax(a, axis=-1)
    flat = a.reshape(a.shape[0])
    if np.issubdtype(flat.dtype, np.floating) and flat.size and \
            not np.all(flat == np.round(flat)):
        return (flat >= threshold).astype(np.int64)
    return flat.astype(np.int64)


class AccuracyEvaluator(Evaluator):
    """Classification accuracy.  Both columns may hold class indices,
    one-hot labels, or probability vectors (the reference pipeline first
    runs ``LabelIndexTransformer``; we accept raw vectors too)."""

    def evaluate(self, dataset: Dataset) -> float:
        pred = _to_class_index(dataset[self.prediction_col],
                               kind=self.prediction_kind)
        label = _to_class_index(dataset[self.label_col],
                                kind=self.label_kind)
        return float(np.mean(pred == label))


class F1Evaluator(Evaluator):
    """Macro-averaged F1 (the reference notebooks report Spark's F1 metric
    via ``MulticlassClassificationEvaluator``)."""

    def evaluate(self, dataset: Dataset) -> float:
        pred = _to_class_index(dataset[self.prediction_col],
                               kind=self.prediction_kind)
        label = _to_class_index(dataset[self.label_col],
                                kind=self.label_kind)
        classes = np.unique(np.concatenate([pred, label]))
        f1s = []
        for c in classes:
            tp = np.sum((pred == c) & (label == c))
            fp = np.sum((pred == c) & (label != c))
            fn = np.sum((pred != c) & (label == c))
            denom = 2 * tp + fp + fn
            f1s.append(2 * tp / denom if denom else 0.0)
        return float(np.mean(f1s))


class LossEvaluator(Evaluator):
    """Mean of a loss function over prediction/label columns.

    ``outputs`` says what the prediction column holds: ``"probs"`` (the
    default — ``ModelPredictor`` on the reference-style softmax-ending
    models yields probabilities) resolves crossentropy names to the on-probs
    variants; ``"logits"`` uses the logit forms.
    """

    def __init__(self, loss="categorical_crossentropy",
                 prediction_col: str = "prediction", label_col: str = "label",
                 outputs: str = "probs"):
        super().__init__(prediction_col, label_col)
        from .ops.losses import get_loss, probs_loss_variant
        self.loss_fn = None
        if outputs == "probs" and isinstance(loss, str):
            self.loss_fn = probs_loss_variant(loss)
        if self.loss_fn is None:
            self.loss_fn = get_loss(loss)

    def evaluate(self, dataset: Dataset) -> float:
        pred, label = (_tensor(dataset[c])
                       for c in (self.prediction_col, self.label_col))
        return float(self.loss_fn(pred, label))


def _tensor(a) -> torch.Tensor:
    """A column as a CPU tensor, float64 as float32 (as ``jnp.asarray``
    takes it)."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                            else a)
