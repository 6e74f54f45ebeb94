"""The data layer: the partitioned ``Dataset`` and the loaders."""

from .dataset import Dataset  # noqa: F401
from .datasets import load_lm_corpus  # noqa: F401
