"""The data layer: the partitioned ``Dataset``, the loaders, the
transformers and the disk-streaming ``ShardedFileDataset``."""

from .dataset import Dataset  # noqa: F401
from .datasets import (  # noqa: F401
    load_cifar10,
    load_imagenet_subset,
    load_imdb,
    load_lm_corpus,
    load_mnist,
)
from .streaming import (  # noqa: F401
    ShardedFileDataset,
    window_batches,
    worker_window_factory,
    worker_windows_per_epoch,
)
