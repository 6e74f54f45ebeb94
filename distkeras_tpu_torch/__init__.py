"""distkeras_tpu_torch: the PyTorch/CUDA port of ``distkeras_tpu``.

A second package beside the JAX one, held against it module by module.
It imports ``torch`` and nothing of JAX or of ``distkeras_tpu``.  Its
entry points run on the card unless the caller passes ``device="cpu"``.
Ported so far: the serving slice — ``zoo.gpt_lm`` served by the
continuous-batching ``serve.DecodeEngine``, with the flash-attention
forward as a hand-written CUDA kernel.
"""

__version__ = "0.1.0"

from .utils.device import default_device  # noqa: F401
from . import models, obs, ops, serve, utils  # noqa: F401
from .models import Model, generate_tokens, zoo  # noqa: F401
