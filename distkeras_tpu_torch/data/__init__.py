"""The data layer: the partitioned ``Dataset``, the loaders and the
transformers."""

from .dataset import Dataset  # noqa: F401
from .datasets import (  # noqa: F401
    load_cifar10,
    load_imagenet_subset,
    load_imdb,
    load_lm_corpus,
    load_mnist,
)
