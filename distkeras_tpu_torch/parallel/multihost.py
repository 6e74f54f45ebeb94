"""Multi-process bring-up — the port of ``distkeras_tpu.parallel.
multihost``: ``torch.distributed`` in place of ``jax.distributed``.

The reference scales out by asking Spark for more executors; here one
identical process runs per rank (one per card, or several sharing one),
and :func:`initialize` forms the default process group from the JAX
package's environment names or from arguments::

    from distkeras_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize()                 # COORDINATOR_ADDRESS, ...
    ds = multihost.local_shard(dataset)    # this process's partitions
    ADAG(model, ..., num_workers=8, mesh=make_mesh(8)).train(ds)

Each rank's device is explicit: ``cuda:{local_rank % device_count}`` by
default, the CPU only when the caller names it; with no card and no
device named, ``initialize`` raises.  The backend follows one rule
(``mesh.choose_backend``), recorded with its reason.  The group has a
timeout, so a dead peer makes every rank raise instead of hang.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike

#: seconds a collective waits for a peer before every rank raises
DEFAULT_TIMEOUT_S = 300.0

_initialized = False
_STATE = {"device": None, "backend": None, "reason": None}


def _local_rank(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id))


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` when named, else the one
    :func:`initialize` gave it, else ``cuda:{local_rank % device_count}``
    (raises with no card)."""
    if device is not None:
        return torch.device(device)
    if _STATE["device"] is not None:
        return _STATE["device"]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; name this rank's device "
            "(device='cpu') to run on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _local_rank(rank)
                        % torch.cuda.device_count())


def backend_reason() -> Optional[str]:
    """Why the group's backend was chosen (None before
    :func:`initialize` formed one)."""
    return _STATE["reason"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Form the default process group.

    ``coordinator_address`` (``host:port`` of rank 0's store),
    ``num_processes`` and ``process_id`` as arguments, or from the
    environment (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``) when none is given.  A no-op when the group is
    already formed, or in auto mode with nothing configured (one
    process).  An explicit configuration that fails raises; so does a
    configured group that fails to come up — every process training the
    whole dataset on its own is never the quiet outcome.  ``device``:
    this rank's device (``rank_device``); the backend follows from it
    (``mesh.choose_backend``)."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        return
    explicit = {k: v for k, v in (("coordinator_address",
                                   coordinator_address),
                                  ("num_processes", num_processes),
                                  ("process_id", process_id))
                if v is not None}
    if explicit:
        if len(explicit) != 3:
            raise ValueError(
                f"initialize needs coordinator_address, num_processes and "
                f"process_id together, got {sorted(explicit)}")
        addr, n, pid = (coordinator_address, int(num_processes),
                        int(process_id))
    elif "COORDINATOR_ADDRESS" in os.environ:
        addr = os.environ["COORDINATOR_ADDRESS"]
        n = int(os.environ.get("NUM_PROCESSES", "1"))
        pid = int(os.environ.get("PROCESS_ID", "0"))
    else:
        return  # auto mode, nothing configured: one process
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} outside [0, {n})")
    from .mesh import choose_backend
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name this rank's device "
                "(device='cpu') to run on the CPU")
        device = torch.device("cuda", _local_rank(pid)
                              % torch.cuda.device_count())
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    backend, reason = choose_backend(device, n, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=float(timeout_s)),
        **({"device_id": device} if backend == "nccl" else {}))
    _STATE.update(device=device, backend=backend, reason=reason)
    _initialized = True


def shutdown() -> None:
    """Tear the default group down (after every rank's last
    collective)."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _STATE.update(device=None, backend=None, reason=None)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def local_shard(dataset):
    """This process's contiguous slice of a Dataset (one partition group
    per process): with P processes, process k takes rows
    ``np.array_split(range(n), P)[k]`` and ``max(1, partitions // P)``
    partitions of them — an empty shard, not a crash, when the dataset
    has fewer rows than processes."""
    import numpy as np

    from ..data.dataset import Dataset

    p = process_count()
    if p == 1:
        return dataset
    k = process_index()
    rows = np.array_split(np.arange(dataset.num_rows), p)[k]
    cols = {name: dataset[name][rows] for name in dataset.column_names}
    return Dataset(cols, num_partitions=max(1, dataset.num_partitions // p))
