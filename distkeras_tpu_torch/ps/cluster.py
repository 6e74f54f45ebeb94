"""Async parameter-server training across the processes of a
``torch.distributed`` group — the port of ``distkeras_tpu.ps.cluster``,
the multi-host deployment shape.

The reference runs its ``SocketParameterServer`` on the Spark driver and
workers on executors spread over machines.  Here, after
``parallel.multihost.initialize()`` forms the group, process 0 hosts the
TCP parameter server and every process (0 included) runs one async
worker on its own device over the existing wire — loopback within a host,
the network across hosts::

    multihost.initialize(...)
    trainer = DOWNPOUR(model, num_workers=multihost.process_count(), ...)
    model = run_cluster_async_training(trainer, dataset,
                                       ps_address=("host0", 7077))

Every process returns the same final model (the trained center is
broadcast from process 0); ``trainer.ps_stats`` is filled on process 0.
A worker that fails on any process raises on every process: each passes
the same barriers whatever its worker did, then the failure flags are
gathered.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch.distributed as dist

from ..parallel import multihost
from ..utils import serde
from ..utils.weights import load_jax_variables, to_numpy_variables
from .runner import _WORKER_CLASSES, _replica, _worker_seed, worker_parts
from .servers import SocketParameterServer
from .workers import ElasticWorker


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier() -> None:
    if _grouped():
        dist.barrier()


def run_cluster_async_training(trainer, dataset,
                               ps_address: Tuple[str, int],
                               fault_injector=None):
    """Async-PS training with one worker per process of the default
    group and the PS on process 0.

    ``trainer``: an async-capable DistributedTrainer with ``num_workers
    == multihost.process_count()``.  ``dataset``: the whole dataset,
    the same on every process (process k trains partition k).
    ``ps_address``: (host, port) of process 0's server, reachable from
    every process."""
    pid = multihost.process_index()
    nproc = multihost.process_count()
    if trainer.num_workers != nproc:
        raise ValueError(
            f"trainer.num_workers ({trainer.num_workers}) must equal the "
            f"group's process count ({nproc}): one async worker per "
            f"process")
    mode = getattr(trainer, "_async_mode", "pull_commit")
    worker_cls = _WORKER_CLASSES[mode]
    loss_fn, optimizer = trainer._resolve()

    # the same staging on every process; this one trains slice pid
    xs, ys, _ = trainer._stage_data(dataset, trainer.communication_window)
    trainer.model.init(trainer.seed, device=trainer.device)
    center = to_numpy_variables(trainer.model)

    host, port = ps_address
    server = ps = None
    if pid == 0:
        ps = trainer._ps_factory()(center, num_workers=nproc)
        server = SocketParameterServer(ps, host="0.0.0.0", port=int(port),
                                       fault_injector=fault_injector)
        server.start()
    _barrier()  # workers must not race the server's bind

    err = None
    try:
        kw = {"alpha": trainer.alpha} if worker_cls is ElasticWorker else {}
        window, variables, opt_state, gen = worker_parts(
            _replica(trainer, center), loss_fn, optimizer,
            _worker_seed(trainer, pid, 0), trainer.device,
            trainer.compute_dtype, trainer.remat, trainer.aux_weight)
        worker = worker_cls(
            pid, trainer._instrumented(window, "async_window"), variables,
            opt_state, gen, host if pid != 0 else "127.0.0.1",
            int(port) if server is None else server.port,
            trainer.num_epoch, device=trainer.device,
            metrics=trainer.metrics,
            comm_codec=getattr(trainer, "comm_codec", "none"),
            profile_memory=trainer.profile.memory, **kw)
        worker.set_data(xs[pid], ys[pid])
        worker.run()  # in this process's thread: it owns the device
        if worker.error is not None:
            err = worker.error
        else:
            trainer.history = list(worker.losses)
    except Exception as e:  # noqa: BLE001 — raised after the barriers
        err = e
    # every process passes this barrier whatever its worker did: raising
    # before it would leave the healthy ones waiting here
    _barrier()
    if server is not None:
        server.stop()
    flags = [err is not None] * nproc
    if _grouped():
        dist.all_gather_object(flags, err is not None)
    if err is not None:
        raise err
    if any(flags):
        raise RuntimeError(
            f"async PS worker failed on process(es) "
            f"{[k for k, f in enumerate(flags) if f]}; see their logs for "
            f"the underlying error")

    blob = [None]
    if pid == 0:
        trainer.ps_stats = {
            "num_updates": ps.num_updates,
            "commits_by_worker": dict(ps.commits_by_worker),
            "staleness_seen": list(getattr(ps, "staleness_seen", [])),
            "registry": ps.registry.snapshot()}
        trainer.metrics.log("ps_stats", num_updates=ps.num_updates,
                            commits_by_worker=dict(ps.commits_by_worker),
                            stats=ps.registry.snapshot())
        blob = [np.frombuffer(serde.tree_to_bytes(ps.get_model()),
                              np.uint8)]
    # the trained center from process 0 to every process
    if _grouped():
        dist.broadcast_object_list(blob, src=0)
    load_jax_variables(trainer.model,
                       serde.tree_from_bytes(blob[0].tobytes()))
    return trainer._finish()
