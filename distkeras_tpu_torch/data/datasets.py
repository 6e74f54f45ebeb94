"""Dataset loaders — the port of ``distkeras_tpu.data.datasets``: MNIST,
CIFAR-10, IMDB, the synthetic causal-LM corpus and the ImageNet subset.

Each loader reads the local Keras cache (``~/.keras/datasets``) when the
archive is there, and otherwise makes a deterministic synthetic surrogate
with the same shapes and dtypes and a learnable class structure
(class template + noise), flagged by ``meta["synthetic"]``.  Nothing is
downloaded.  The numpy draws are the JAX package's, call for call, so
both packages yield bit-identical arrays for the same arguments.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import Dataset

KERAS_CACHE = os.path.expanduser("~/.keras/datasets")


def _synthetic_images(n: int, shape: Tuple[int, ...], num_classes: int,
                      seed: int, noise: float = 0.35, split_seed: int = 0):
    """Class-template images: templates are smooth random fields; samples =
    template[label] + gaussian noise.  Linearly separable enough to train
    on, hard enough that accuracy tracks real optimization progress.

    ``seed`` fixes the class templates (MUST be shared by the train and
    test splits of one dataset, or test accuracy is chance);
    ``split_seed`` varies the sampled labels/noise per split.
    """
    rng = np.random.default_rng(seed)
    templates = rng.normal(0.5, 0.25, size=(num_classes, *shape)).astype(np.float32)
    srng = np.random.default_rng((seed, split_seed))
    labels = srng.integers(0, num_classes, size=n)
    x = templates[labels] + srng.normal(0, noise, size=(n, *shape)).astype(np.float32)
    return np.clip(x, 0.0, 1.0).astype(np.float32), labels.astype(np.int64)


def load_mnist(n_train: Optional[int] = None, flat: bool = True,
               seed: int = 0, noise: float = 0.35,
               label_noise: float = 0.0) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta).  Columns: ``features`` (784 flat or 28×28×1),
    ``label`` int.  Pixels already scaled to [0,1] (the reference pipeline
    does this with ``MinMaxTransformer``; loaders pre-scale so benchmarks
    measure training, not preprocessing).

    Difficulty levers (a surrogate every trainer aces cannot
    discriminate between them): ``noise`` is the
    synthetic surrogate's pixel-noise sigma; ``label_noise`` uniformly
    relabels that fraction of TRAIN rows (test labels stay clean, so test
    accuracy still measures what was actually learned).  Defaults keep
    the historical benchmark behavior."""
    path = os.path.join(KERAS_CACHE, "mnist.npz")
    meta = {"num_classes": 10, "synthetic": True}
    if os.path.exists(path):
        with np.load(path) as d:
            xtr, ytr = d["x_train"], d["y_train"]
            xte, yte = d["x_test"], d["y_test"]
        xtr = (xtr / 255.0).astype(np.float32)
        xte = (xte / 255.0).astype(np.float32)
        meta["synthetic"] = False
    else:
        xtr, ytr = _synthetic_images(n_train or 60000, (28, 28), 10, seed,
                                     split_seed=0, noise=noise)
        xte, yte = _synthetic_images(10000, (28, 28), 10, seed, split_seed=1,
                                     noise=noise)
    if n_train:
        xtr, ytr = xtr[:n_train], ytr[:n_train]
    if label_noise:
        nrng = np.random.default_rng((seed, 104))
        flip = nrng.random(len(ytr)) < label_noise
        ytr = np.where(flip, nrng.integers(0, 10, size=len(ytr)), ytr)
    if flat:
        xtr = xtr.reshape(len(xtr), 784)
        xte = xte.reshape(len(xte), 784)
    else:
        xtr = xtr.reshape(len(xtr), 28, 28, 1)
        xte = xte.reshape(len(xte), 28, 28, 1)
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}), meta)


def load_cifar10(n_train: Optional[int] = None, seed: int = 0
                 ) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta).  ``features`` 32×32×3 float32 in [0,1]."""
    path = os.path.join(KERAS_CACHE, "cifar-10-batches-py")
    meta = {"num_classes": 10, "synthetic": True}
    if os.path.isdir(path):
        import pickle
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(path, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        xtr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        xtr = (xtr / 255.0).astype(np.float32)
        ytr = np.asarray(ys, dtype=np.int64)
        with open(os.path.join(path, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xte = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        xte = (xte / 255.0).astype(np.float32)
        yte = np.asarray(d[b"labels"], dtype=np.int64)
        meta["synthetic"] = False
    else:
        xtr, ytr = _synthetic_images(n_train or 50000, (32, 32, 3), 10, seed,
                                     split_seed=0)
        xte, yte = _synthetic_images(10000, (32, 32, 3), 10, seed,
                                     split_seed=1)
    if n_train:
        xtr, ytr = xtr[:n_train], ytr[:n_train]
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}), meta)


def load_imdb(n_train: Optional[int] = None, seq_len: int = 200,
              vocab_size: int = 20000, seed: int = 0
              ) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta).  ``features`` int32 token ids padded/truncated
    to ``seq_len``; ``label`` in {0,1}.  Synthetic surrogate: two Zipfian
    token distributions with class-indicative marker tokens."""
    path = os.path.join(KERAS_CACHE, "imdb.npz")
    meta = {"num_classes": 2, "synthetic": True, "seq_len": seq_len}

    OOV = 2  # Keras imdb convention: oov_char=2

    def pad(seqs):
        out = np.zeros((len(seqs), seq_len), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = np.asarray(s[:seq_len], dtype=np.int32)
            s = np.where(s < vocab_size, s, OOV)
            out[i, : len(s)] = s
        return out

    if os.path.exists(path):
        with np.load(path, allow_pickle=True) as d:
            xtr, ytr = pad(d["x_train"]), d["y_train"].astype(np.int64)
            xte, yte = pad(d["x_test"]), d["y_test"].astype(np.int64)
        meta["synthetic"] = False
    else:
        def synth(n, s):
            rng = np.random.default_rng(s)
            labels = rng.integers(0, 2, size=n)
            # Zipf-ish body + class-marker tokens sprinkled in
            body = rng.zipf(1.3, size=(n, seq_len)).astype(np.int64)
            body = np.clip(body, 1, vocab_size - 1)
            markers = np.where(labels[:, None] == 1, 17, 23)
            mask = rng.random((n, seq_len)) < 0.08
            x = np.where(mask, markers, body).astype(np.int32)
            return x, labels.astype(np.int64)
        xtr, ytr = synth(n_train or 25000, seed)
        xte, yte = synth(5000, seed + 1)
    if n_train:
        xtr, ytr = xtr[:n_train], ytr[:n_train]
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}), meta)


def load_lm_corpus(n_train: int = 2048, seq_len: int = 256,
                   vocab_size: int = 64, seed: int = 0
                   ) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta) for the long-context causal-LM config
    (``zoo.gpt_lm``).  Synthetic
    counting corpus: token t+1 = (token t + 1) mod vocab.  ``features``
    int32 ``(seq_len,)`` token ids; ``label`` int64 ``(seq_len,)`` is the
    sequence shifted left by one (next-token targets)."""
    def split(n, s):
        start = np.random.default_rng(s).integers(0, vocab_size, size=n)
        seqs = (start[:, None] + np.arange(seq_len + 1)) % vocab_size
        return Dataset({"features": seqs[:, :-1].astype(np.int32),
                        "label": seqs[:, 1:].astype(np.int64)})
    meta = {"vocab_size": vocab_size, "seq_len": seq_len, "synthetic": True}
    return split(n_train, seed), split(max(n_train // 4, 1), seed + 1), meta


def load_imagenet_subset(n_train: int = 5000, num_classes: int = 100,
                         image_size: int = 224, seed: int = 0
                         ) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta) for the DynSGD ResNet-50 config.  Always
    synthetic in this environment (no ImageNet on disk): ``features``
    ``image_size²×3`` float32."""
    meta = {"num_classes": num_classes, "synthetic": True}
    xtr, ytr = _synthetic_images(n_train, (image_size, image_size, 3),
                                 num_classes, seed, split_seed=0)
    xte, yte = _synthetic_images(max(n_train // 10, num_classes),
                                 (image_size, image_size, 3), num_classes,
                                 seed, split_seed=1)
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}), meta)
