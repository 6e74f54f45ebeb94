"""Training steps, the sync engine and parallelism across processes: the
local minibatch step, the window loop, the window-edge rules and
``SyncEngine`` (``sync``); the mesh and its collectives (``mesh``),
multi-process bring-up (``multihost``), ring attention (``ring``), dp ×
mp training (``spmd``) and the GPipe pipeline (``pipeline``)."""

from .mesh import (Mesh, P, PartitionSpec, make_mesh,  # noqa: F401
                   shard_map)
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
