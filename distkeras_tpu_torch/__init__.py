"""distkeras_tpu_torch: the PyTorch/CUDA port of ``distkeras_tpu``.

A second package beside the JAX one, held against it module by module.
It imports ``torch`` and nothing of JAX or of ``distkeras_tpu``.  Its
entry points run on the card unless the caller passes ``device="cpu"``.
Ported so far: the serving slice — ``zoo.gpt_lm`` served by the
continuous-batching ``serve.DecodeEngine`` — with the flash-attention
forward and backward as hand-written CUDA kernels; ``SingleTrainer`` on
the in-memory ``Dataset`` for every ``BASELINE.json`` model (MLP,
convnets, ResNet-20/50, the IMDB LSTM) and the causal LMs, with the
loaders, transformers, ``ModelPredictor`` and the evaluators around it;
``python -m distkeras_tpu_torch.bench``, the headline benchmark; and the
sync distributed trainers (``ADAG``, ``DOWNPOUR``, ``DynSGD``,
``AEASGD``, ``EAMSGD``, ``AveragingTrainer``, ``EnsembleTrainer``), their
workers stepped one after another on one card; serde, checkpoints and
resume, and disk streaming (``ShardedFileDataset``,
``StreamingPredictor``), in the JAX package's byte formats.
"""

__version__ = "0.3.0"

from .utils.device import default_device  # noqa: F401
from . import data, models, obs, ops, parallel, serve, utils  # noqa: F401
from . import evaluators, predictors  # noqa: F401
from .data import Dataset, ShardedFileDataset  # noqa: F401
from .models import Model, generate_tokens, zoo  # noqa: F401
from .predictors import (  # noqa: F401
    ModelPredictor,
    Predictor,
    StreamingPredictor,
)
from .utils.checkpoint import CheckpointManager  # noqa: F401
from .trainers import (  # noqa: F401
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AveragingTrainer,
    DistributedTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    Trainer,
)
