"""Dataset loaders — the port's share of
``distkeras_tpu.data.datasets``: the synthetic causal-LM corpus the
attention training slice trains on.  numpy ``default_rng`` throughout, so
the arrays equal the JAX package's for the same arguments.  The image and
IMDB loaders come with their models."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .dataset import Dataset


def load_lm_corpus(n_train: int = 2048, seq_len: int = 256,
                   vocab_size: int = 64, seed: int = 0
                   ) -> Tuple[Dataset, Dataset, dict]:
    """(train, test, meta) for the causal-LM config (``zoo.gpt_lm``).
    Synthetic counting corpus: token t+1 = (token t + 1) mod vocab.
    ``features`` int32 ``(seq_len,)`` token ids; ``label`` int64
    ``(seq_len,)`` is the sequence shifted left by one (next-token
    targets)."""
    def split(n, s):
        start = np.random.default_rng(s).integers(0, vocab_size, size=n)
        seqs = (start[:, None] + np.arange(seq_len + 1)) % vocab_size
        return Dataset({"features": seqs[:, :-1].astype(np.int32),
                        "label": seqs[:, 1:].astype(np.int64)})
    meta = {"vocab_size": vocab_size, "seq_len": seq_len, "synthetic": True}
    return split(n_train, seed), split(max(n_train // 4, 1), seed + 1), meta
