"""Training steps: the local minibatch step and the window loop."""

from .sync import (  # noqa: F401
    make_local_step,
    make_window_fn,
    model_params,
)
