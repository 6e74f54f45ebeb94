"""OS-process async worker: ``python -m distkeras_tpu_torch.ps.worker_main
SPEC`` — the port of ``distkeras_tpu.ps.worker_main``.

The reference's workers are separate OS processes on separate machines
(Spark executor tasks).  This module is that process: it rebuilds the
model from a spec file on its device, loads its partition, connects to
the parameter server over TCP and runs the epochs × windows pull/commit
loop, then writes its loss history to the output file.

The spec is a ``utils.serde`` tree:

    {"model_blob": <serialize_model bytes>,
     "worker_optimizer": str, "loss": str, "learning_rate": float,
     "momentum": float|None (EAMSGD's Nesterov momentum),
     "compute_dtype": str|None, "remat": bool, "aux_weight": float,
     "mode": "pull_commit"|"staleness"|"elastic",
     "comm_codec": str, "comm_down": str, "ps_shm": bool,
     "pull_overlap": bool, "alpha": float,
     "worker_id": int, "host": str, "port": int or [int] (shard ports),
     "num_epoch": int, "seed": int,
     "device": str ("cuda", "cpu", ...; absent means the card, which
     must exist — ``utils.device.default_device``),
     "torch_threads": int|None, "start_window": int, "gen": int,
     "data_npz": path | "stream": {...}, "out_npz": path,
     "metrics_jsonl": path (optional — this process's own telemetry
     stream: heartbeats and ``ps.commit``/``ps.pull`` spans under trace
     id ``w<worker_id>``, and a final ``kernel_launches`` record with
     this process's K1–K3 launch counts, which the runner folds into
     the parent's)}

Used by ``ps.runner.run_async_training`` when the trainer asks for
``async_workers="processes"``; also runnable by hand for manual clusters
(one spec per host, all pointing at the same PS address).
"""

from __future__ import annotations

import sys
import traceback

import numpy as np


def run_spec(spec_path: str) -> None:
    import torch

    from ..ops.flash_attention import launch_counts
    from ..ops.optimizers import sgd
    from ..trainers import Trainer
    from ..utils import serde
    from ..utils.device import default_device
    from ..utils.weights import load_jax_variables
    from .runner import _WORKER_CLASSES, LAUNCH_EVENT, worker_parts

    with open(spec_path, "rb") as f:
        spec = serde.tree_from_bytes(f.read())
    device = default_device(spec.get("device"))
    if spec.get("torch_threads"):
        torch.set_num_threads(int(spec["torch_threads"]))

    model, center = serde.deserialize_model(spec["model_blob"])
    model.init(0, device=device)
    load_jax_variables(model, center)
    # borrow the Trainer's loss/optimizer resolution (probs-variant
    # detection included) so process workers train the same math as threads
    shim = Trainer(model, spec["worker_optimizer"], spec["loss"],
                   learning_rate=spec["learning_rate"],
                   compute_dtype=spec.get("compute_dtype"),
                   remat=bool(spec.get("remat", False)),
                   aux_weight=float(spec.get("aux_weight", 0.0)),
                   device=device)
    loss_fn, optimizer = shim._resolve()
    if spec.get("momentum") is not None:
        # EAMSGD's local optimizer, as its trainer resolves it
        optimizer = sgd(spec["learning_rate"],
                        momentum=float(spec["momentum"]), nesterov=True)
    window_fn, variables, opt_state, gen = worker_parts(
        model, loss_fn, optimizer, int(spec["seed"]), device,
        shim.compute_dtype, shim.remat, shim.aux_weight)

    worker_cls = _WORKER_CLASSES[spec["mode"]]
    kw = {"alpha": spec["alpha"]} if spec["mode"] == "elastic" else {}
    metrics = None
    if spec.get("metrics_jsonl"):
        from ..utils.metrics import MetricsLogger
        metrics = MetricsLogger(spec["metrics_jsonl"])
    # a LIST of ports is a shard fleet: the worker builds a
    # ShardedPSClient and fans its windows across every shard
    port = spec["port"]
    port = [int(p) for p in port] if isinstance(port, (list, tuple)) \
        else int(port)
    worker = worker_cls(
        int(spec["worker_id"]), window_fn, variables, opt_state, gen,
        spec["host"], port, int(spec["num_epoch"]),
        device=device, start_window=int(spec.get("start_window", 0)),
        comm_codec=spec.get("comm_codec", "none"), metrics=metrics,
        comm_down=spec.get("comm_down", "none"),
        shm=bool(spec.get("ps_shm", False)),
        pull_overlap=bool(spec.get("pull_overlap", False)),
        profile_memory=bool(spec.get("profile_memory", True)),
        generation=int(spec.get("gen", 0)), **kw)
    if "stream" in spec:
        # disk-streaming partition: this process reads ITS shards straight
        # from the (shared) dataset directory; ``data_worker`` decouples
        # the partition index from the PS identity
        from ..data.streaming import ShardedFileDataset, worker_window_factory
        s = spec["stream"]
        factory = worker_window_factory(
            ShardedFileDataset(s["dir"]), list(s["cols"]),
            int(s["batch_size"]),
            int(spec.get("data_worker", spec["worker_id"])),
            int(s["num_workers"]), int(s["window"]), int(s["base_seed"]),
            bool(s["shuffle"]))
        worker.set_stream(factory, int(s["n_windows"]))
    else:
        with np.load(spec["data_npz"]) as d:
            worker.set_data(d["xs"], d["ys"])
    worker.run()  # synchronously in THIS process (it is the worker process)
    # write the complete epochs this attempt produced BEFORE surfacing any
    # failure: the runner merges them with the retry's epochs
    np.savez(spec["out_npz"],
             **{f"epoch_{e}": l for e, l in worker.epoch_losses.items()})
    if metrics is not None:
        metrics.log(LAUNCH_EVENT, worker_id=int(spec["worker_id"]),
                    counts=launch_counts())
        metrics.close()
    if worker.error is not None:
        raise worker.error


def main(argv=None) -> int:
    from ..obs import emit
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        emit("usage: python -m distkeras_tpu_torch.ps.worker_main SPEC",
             err=True)
        return 2
    try:
        run_spec(argv[0])
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
