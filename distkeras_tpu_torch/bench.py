"""Headline benchmark of the port on one card — the port of the JAX
package's ``bench.py:main``.

    python -m distkeras_tpu_torch.bench            # samples/s/chip, ResNet-20
    python -m distkeras_tpu_torch.bench --mnist    # time to 99% MNIST accuracy

Prints ONE JSON row on stdout.

Default: ``SingleTrainer(zoo.resnet20(width=16), "sgd", lr 0.1,
compute_dtype="bfloat16")`` at batch 1024 on the JAX bench's numpy data
(``default_rng(0)``: uniform 32×32×3 images, one-hot labels), 32 steps
an epoch, 2 warm-up and 4 timed epochs; the value is the timed epochs'
samples over their seconds (the trainer's CUDA-event epoch times, on the
device's timeline).

``--mnist``: ``SingleTrainer(zoo.mlp_mnist(), "sgd"...)`` in bf16 at
batch 128 on the 16,384-row MNIST surrogate (``load_mnist(n_train=
16384)``), trained one epoch per ``train()`` call, each continuing from
the weights the last one left (sgd keeps no state and the MLP draws no
random numbers, so k calls are the k-epoch run); the value is the
summed wall seconds of the calls up to the first epoch after which
``AccuracyEvaluator`` on the test split reads 0.99.

The row names the card and its power limit (nvidia-smi).  It writes no
file.  Without a card it raises: the entry points run on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .data import Dataset, load_mnist
from .evaluators import AccuracyEvaluator
from .models import zoo
from .predictors import ModelPredictor
from .trainers import SingleTrainer

BATCH = 1024
WIDTH = 16
LEARNING_RATE = 0.1
STEPS_PER_EPOCH = 32
WARMUP_EPOCHS = 2
TIMED_EPOCHS = 4

MNIST_ROWS = 16384
MNIST_BATCH = 128
MNIST_TARGET = 0.99
MNIST_MAX_EPOCHS = 10


def card() -> dict:
    """The card's name (torch) and name and power limit (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def resnet20_data(rows: int) -> Dataset:
    """The headline config's numpy data (the JAX package's
    ``bench.py:main``): uniform 32×32×3 images and one-hot labels from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, size=rows)
    return Dataset({
        "features": rng.random((rows, 32, 32, 3), dtype=np.float32),
        "label": np.eye(10, dtype=np.float32)[labels],
    })


def resnet20_trainer(epochs: int, device=None, **overrides) -> SingleTrainer:
    """The headline config's trainer: ``resnet20(width=WIDTH)``, sgd at
    ``LEARNING_RATE``, bf16, batch ``BATCH``; ``overrides`` replace any of
    the last three (or add other ``SingleTrainer`` arguments)."""
    kw = dict(batch_size=BATCH, learning_rate=LEARNING_RATE,
              compute_dtype="bfloat16")
    kw.update(overrides)
    return SingleTrainer(zoo.resnet20(width=WIDTH), "sgd",
                         "categorical_crossentropy", num_epoch=epochs,
                         device=device, **kw)


def resnet20_row(device=None) -> dict:
    """The headline config's row: samples/s per chip over the timed
    epochs."""
    trainer = resnet20_trainer(WARMUP_EPOCHS + TIMED_EPOCHS, device)
    trainer.train(resnet20_data(STEPS_PER_EPOCH * BATCH))
    epochs = [r for r in trainer.metrics.records if r["event"] == "epoch"]
    seconds = [r["epoch_seconds"] for r in epochs[WARMUP_EPOCHS:]]
    samples = STEPS_PER_EPOCH * BATCH * len(seconds)
    losses = trainer.get_averaged_history()
    return {"metric": "samples/sec/chip (CIFAR-10 ResNet-20)",
            "value": samples / sum(seconds), "unit": "samples/s",
            "config": {"model": f"resnet20(width={WIDTH})",
                       "batch_size": BATCH,
                       "steps_per_epoch": STEPS_PER_EPOCH,
                       "warmup_epochs": WARMUP_EPOCHS,
                       "timed_epochs": TIMED_EPOCHS, "optimizer": "sgd",
                       "learning_rate": LEARNING_RATE,
                       "compute_dtype": "bfloat16"},
            "timed_epoch_seconds": seconds,
            "step_ms": 1e3 * sum(seconds) / (STEPS_PER_EPOCH * len(seconds)),
            "epoch_mean_loss": losses.tolist(),
            "train_wall_s": trainer.get_training_time()}


def mnist_row(device=None) -> dict:
    """Time to ``MNIST_TARGET`` test accuracy: one epoch per ``train()``,
    the test split evaluated after each; the value is the summed training
    wall seconds up to the first epoch that reaches it."""
    train, test, meta = load_mnist(n_train=MNIST_ROWS)
    trainer = SingleTrainer(
        zoo.mlp_mnist(), "sgd", "sparse_categorical_crossentropy",
        num_epoch=1, batch_size=MNIST_BATCH, learning_rate=0.1,
        compute_dtype="bfloat16", device=device)
    model, wall, checks = trainer.model, 0.0, []
    for epoch in range(1, MNIST_MAX_EPOCHS + 1):
        trainer.train(train)
        # later calls continue from these weights (sgd has no state)
        model.init = lambda seed=0, device=None: model
        wall += trainer.get_training_time()
        acc = AccuracyEvaluator().evaluate(
            ModelPredictor(model).predict(test))
        checks.append({"epochs": epoch, "test_accuracy": acc,
                       "train_wall_s": wall,
                       "epoch_seconds": [
                           r for r in trainer.metrics.records
                           if r["event"] == "epoch"][-1]["epoch_seconds"]})
        if acc >= MNIST_TARGET:
            break
    reached = checks[-1]["test_accuracy"] >= MNIST_TARGET
    return {"metric": "time-to-99% MNIST accuracy (SingleTrainer MLP)",
            "value": wall if reached else None,
            "unit": "s", "reached": reached, "epochs": checks[-1]["epochs"],
            "config": {"model": "mlp_mnist(hidden=500)", "rows": MNIST_ROWS,
                       "batch_size": MNIST_BATCH, "optimizer": "sgd",
                       "learning_rate": 0.1, "compute_dtype": "bfloat16",
                       "synthetic": meta["synthetic"],
                       "target": MNIST_TARGET},
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mnist", action="store_true",
                    help="time to 99%% MNIST accuracy instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    row = mnist_row() if args.mnist else resnet20_row()
    row.update(card(), wall_s=time.perf_counter() - t0)
    print(json.dumps(row), flush=True)
    return 0 if row["value"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
