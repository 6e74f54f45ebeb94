"""Training steps and the sync engine: the local minibatch step, the
window loop, the window-edge rules and ``SyncEngine``."""

from .sync import (  # noqa: F401
    AdagSync,
    DownpourSync,
    DynSgdSync,
    EasgdSync,
    EpochResult,
    NoCommSync,
    SyncAlgorithm,
    SyncEngine,
    adopt_float_leaves,
    make_local_step,
    make_window_fn,
    model_params,
    tmap,
    tree_add,
    tree_scale,
    tree_sub,
)
