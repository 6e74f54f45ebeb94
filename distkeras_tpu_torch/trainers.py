"""Training orchestration — the port of ``distkeras_tpu.trainers``'
``Trainer``, ``SingleTrainer`` and the sync distributed trainers
(``DistributedTrainer``, ``AveragingTrainer``, ``EnsembleTrainer`` and
``ADAG`` / ``DOWNPOUR`` / ``DynSGD`` / ``AEASGD`` / ``EAMSGD``), on an
in-memory ``Dataset`` or streamed from disk (``ShardedFileDataset``),
with checkpoints and resume.

The dist-keras surface is unchanged: ``SingleTrainer(model, optimizer,
loss, ...).train(dataset) -> trained model``, with ``get_history()``,
``get_averaged_history()`` and ``get_training_time()``.  One epoch is
one call of the window loop (``parallel.sync.make_window_fn``) over the
epoch's batches, which are moved to the model's device once.  Epoch k's
losses are read back only after epoch k+1 is dispatched
(``_EpochPipeline``), so the host never waits on the card inside an
epoch.  A distributed trainer's epoch is ``parallel.sync.SyncEngine``'s:
W workers on one device, each on its partition, with the algorithm's
rule at every window edge; its history rows are (workers, steps).

A ``ShardedFileDataset`` streams window by window from disk: the host
stacks the next window (a prefetch thread reads the shards) and copies
it to the device, where the previous window's work may still run.
``checkpoint_dir`` saves the trainer's state after every epoch, in the
JAX trainers' leaf order (``utils.checkpoint``), and ``train(resume=
True)`` restarts after the latest saved epoch, from a file either
package wrote.  ``serialize()`` is the ``utils.serde`` model blob.

``mode="async"`` on ``DOWNPOUR``, ``ADAG``, ``DynSGD``, ``AEASGD`` and
``EAMSGD`` trains against the host parameter server (``ps.runner``):
thread or process workers, each with its own model replica on the
trainer's device, pull the center, train a window and commit, with
checkpoints of the center and exact per-worker resume; ``ps_shards > 1``
partitions the center across a fleet of shard servers (``ps.shard``).
``aux_weight`` folds the layers' auxiliary losses (the switch-MoE
router's, ``ops.moe.MoEDense``) into every trainer's objective.

Not ported yet, and raising where asked for: a ``mesh`` (workers across
cards), ROADMAP Queue 1 item 8.  The trainers run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .data.dataset import Dataset
from .data.streaming import (ShardedFileDataset, worker_window_factory,
                             worker_windows_per_epoch)
from .models.layers import Activation, Dense, Sequential
from .models.model import Model
from .obs import ProfileConfig, RetraceSentinel, SpanTracer, observe_memory
from .obs.logging import get_logger
from .obs.registry import default_registry
from .ops.losses import get_loss, probs_loss_variant
from .ops.optimizers import get_optimizer, sgd
from .ps import codecs
from .parallel.sync import (AdagSync, DownpourSync, DynSgdSync, EasgdSync,
                            NoCommSync, SyncEngine, _inexact, make_window_fn,
                            model_params, replicate, stack_trees, tmap,
                            variables_of)
from .utils import checkpoint, serde
from .utils.device import DeviceLike, default_device
from .utils.metrics import MetricsLogger
from .utils.weights import jax_leaf_names, to_numpy_variables

_LOG = "trainers"


class _EpochPipeline:
    """Deferred per-epoch loss readback.

    Reading an epoch's losses back as soon as it is dispatched would make
    the host wait for the card at every epoch edge and drain its queue.
    Instead ``push`` starts a non-blocking copy of epoch k's losses into
    pinned host memory, marks the device's timeline behind it, and only
    then waits for epoch k−1's mark, so the wait overlaps epoch k's
    compute.  ``flush()`` waits for the last epoch before the trainer
    returns.  An epoch's seconds run from the previous epoch's mark (the
    first from the loop's start) to its own, on the device's timeline
    (CUDA events), so they stay honest whether the host or the card is
    the slower; ``sum(epoch_seconds)`` spans loop start → last epoch's
    compute finished.
    """

    def __init__(self, trainer: "Trainer", samples: int, device):
        self.trainer = trainer
        self.samples = samples
        self.pending = None
        self.last_mark = _mark(device)

    def push(self, epoch: int, dev_losses: torch.Tensor) -> None:
        """Hand over an epoch's device losses; drains the previous epoch."""
        prev, self.pending = self.pending, (epoch, *_start_readback(
            dev_losses))
        self._drain(prev)

    def flush(self) -> None:
        self._drain(self.pending)
        self.pending = None

    def _drain(self, item) -> None:
        if item is None:
            return
        epoch, host, mark = item
        dt = _seconds_between(self.last_mark, mark)  # waits for the epoch
        self.last_mark = mark
        losses = host.numpy()
        self.trainer.history.append(losses)
        self.trainer._epoch_metrics(epoch, losses, dt, self.samples)


def _mark(device):
    """A point on ``device``'s timeline: a timing CUDA event recorded on
    the current stream, or the host clock on a CPU device (whose ops have
    finished when they return)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _seconds_between(a, b) -> float:
    """Seconds from mark ``a`` to mark ``b``, waiting until ``b`` is
    reached."""
    if isinstance(b, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def _start_readback(x: torch.Tensor):
    """(host tensor, mark): a copy of ``x`` to the host that does not
    block the caller on the card, and the mark of its completion."""
    if x.device.type != "cuda":
        return x.detach(), _mark(x.device)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host, _mark(x.device)


def _resolve_dtype(dtype) -> Optional[torch.dtype]:
    """None | str | torch.dtype -> torch.dtype (or None).  Accepts the
    common shorthands so ``compute_dtype="bf16"`` works."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = {"bf16": "bfloat16", "fp16": "float16", "f32": "float32",
                "fp32": "float32"}.get(dtype, dtype)
        resolved = getattr(torch, name, None)
        if isinstance(resolved, torch.dtype):
            return resolved
    raise TypeError(f"compute_dtype must be None, a dtype name or a "
                    f"torch.dtype, got {dtype!r}")


def _ends_in_prob_activation(model) -> bool:
    """Reference models end in a softmax (or sigmoid, for binary heads)
    layer and train with crossentropy on probabilities (Keras semantics).
    Detect that so the loss can use the on-probs variant."""
    layer = model.layer
    while isinstance(layer, Sequential) and len(layer.layers):
        layer = layer.layers[-1]
    return isinstance(layer, (Activation, Dense)) and \
        layer.activation in ("softmax", "sigmoid")


class Trainer:
    """Base trainer (reference ``distkeras/trainers.py:Trainer``): owns the
    model + optimizer + loss, records wall-clock training time and the
    per-iteration loss history.  ``device`` (default: the card) is where
    the model is initialised and trained."""

    def __init__(self, keras_model: Model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", features_col: str = "features",
                 label_col: str = "label", num_epoch: int = 1,
                 batch_size: int = 32, learning_rate: float = 0.01,
                 seed: int = 0, checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3, metrics=None,
                 compute_dtype=None, remat: bool = False,
                 aux_weight: float = 0.0, profile=None,
                 device: DeviceLike = None):
        self.model = keras_model
        self.worker_optimizer = worker_optimizer
        self.loss = loss
        self.features_col = features_col
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_keep = int(checkpoint_keep)
        #: mixed precision: the forward runs on copies of the parameters
        #: cast to this dtype; the optimizer keeps f32 masters
        self.compute_dtype = _resolve_dtype(compute_dtype)
        #: recompute the forward's activations in the backward
        self.remat = bool(remat)
        #: weight of the layers' ``aux_loss`` terms in the objective
        self.aux_weight = float(aux_weight)
        if metrics is None or isinstance(metrics, MetricsLogger):
            self.metrics = metrics or MetricsLogger(None)
        else:
            self.metrics = MetricsLogger(metrics)
        #: spans share the metrics' sink: one JSONL stream for both
        self.tracer = SpanTracer(self.metrics)
        self.profile = ProfileConfig.resolve(profile)
        self.device = default_device(device)
        #: per-(kind, config) retrace sentinels behind ``_instrumented``
        self._sentinels: dict = {}
        #: the training forward's random draws (Dropout), reseeded from
        #: ``seed + 1`` by every ``train()`` as the JAX trainer makes
        #: ``PRNGKey(seed + 1)``
        self.generator = torch.Generator(device=self.device)

        self.history: list = []
        self.training_time: float = 0.0
        self.trained_variables: Optional[dict] = None

    # -- parity helpers -----------------------------------------------------
    def get_training_time(self) -> float:
        """Parity: reference ``Trainer.get_training_time``."""
        return self.training_time

    def get_history(self) -> list:
        """Per-epoch arrays of per-iteration training loss."""
        return self.history

    def get_averaged_history(self) -> np.ndarray:
        """Mean loss per epoch."""
        return np.array([float(np.mean(h)) for h in self.history])

    def serialize(self) -> bytes:
        """Parity: reference ``Trainer.serialize`` (pickled model blob) —
        the ``utils.serde`` model + variables blob."""
        return serde.serialize_model(self.model, self.trained_variables)

    # -- shared plumbing ----------------------------------------------------
    def _resolve(self):
        loss_fn = get_loss(self.loss)
        if isinstance(self.loss, str) and _ends_in_prob_activation(self.model):
            loss_fn = probs_loss_variant(self.loss) or loss_fn
        optimizer = get_optimizer(self.worker_optimizer, self.learning_rate)
        return loss_fn, optimizer

    def _config_key(self) -> tuple:
        """Hashable fingerprint of everything the window program captures;
        the cache below rebuilds when it changes."""
        o, l = self.worker_optimizer, self.loss
        return (o if isinstance(o, str) else id(o),
                l if isinstance(l, str) else id(l),
                self.learning_rate, str(self.compute_dtype), self.remat,
                self.aux_weight)

    def _obs_registry(self):
        """Where this trainer's counters land: the tracer's registry when
        one is attached, else the process-wide default."""
        return self.tracer.registry if self.tracer.registry is not None \
            else default_registry()

    def _instrumented(self, run, kind: str = "window"):
        """Feed every call's argument signature to a retrace sentinel
        (``jit.compiles`` / ``jit.retraces``).  The first call of a
        signature is the port's "compile" (the kernels build at first use
        inside it): it runs under a ``jit_compile`` span, flagged
        ``retrace=True`` when it is a new signature after the first."""
        key = (kind, self._config_key())
        sentinel = self._sentinels.get(key)
        if sentinel is None:
            sentinel = self._sentinels[key] = RetraceSentinel(
                f"{type(self).__name__}.{kind}",
                registry=self._obs_registry, sink=self.metrics)

        def wrapped(*args):
            state = sentinel.observe(args)
            if state == "warm":
                return run(*args)
            with self.tracer.span("jit_compile", kind=kind,
                                  trainer=type(self).__name__,
                                  **({"retrace": True}
                                     if state == "retrace" else {})):
                return run(*args)
        return wrapped

    def _window_run(self):
        """The cached window program and its optimizer — rebuilt when a
        hyperparameter changed between ``train()`` calls."""
        key = self._config_key()
        cached = getattr(self, "_run_cache", None)
        if cached is None or cached[0] != key:
            loss_fn, optimizer = self._resolve()
            run = make_window_fn(self.model, loss_fn, optimizer,
                                 compute_dtype=self.compute_dtype,
                                 remat=self.remat,
                                 aux_weight=self.aux_weight,
                                 generator=self.generator)
            self._run_cache = (key, run, optimizer)
        _, run, optimizer = self._run_cache
        return self._instrumented(run), optimizer

    def _finish(self) -> Model:
        self.trained_variables = to_numpy_variables(self.model)
        return self.model

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False) -> Model:
        """Parity: reference ``Trainer.train(dataframe, shuffle)``.

        ``resume=True`` restarts after the latest checkpoint in
        ``checkpoint_dir``, if there is one."""
        self._resume = bool(resume)
        t0 = time.time()
        try:
            with self.tracer.span("train", trainer=type(self).__name__,
                                  epochs=self.num_epoch):
                return self._train(dataset, shuffle)
        finally:
            self.training_time = time.time() - t0

    def _train(self, dataset: Dataset, shuffle: bool) -> Model:
        raise NotImplementedError

    # -- checkpoint plumbing -------------------------------------------------
    def _ckpt_manager(self) -> Optional[checkpoint.CheckpointManager]:
        if not self.checkpoint_dir:
            return None
        return checkpoint.CheckpointManager(self.checkpoint_dir,
                                            keep=self.checkpoint_keep)

    def _state_tree(self, opt_state):
        """The trainer's state in the JAX trainer's tree (its leaves: the
        live tensors, not copies)."""
        raise NotImplementedError

    def _adopt_state(self, like, tree, opt_state):
        """Copy a restored ``tree`` (shaped like ``like``, the
        ``_state_tree``) into the live tensors; returns the optimizer
        state."""
        raise NotImplementedError

    def _generators(self) -> list:
        return [self.generator]

    def _save(self, ckpt, epoch: int, opt_state) -> None:
        """Checkpoint after ``epoch`` (its reads wait for the device)."""
        ckpt.save(epoch, self._state_tree(opt_state),
                  {"epoch": epoch, checkpoint.GENERATORS:
                   checkpoint.generator_meta(self._generators())})

    def _maybe_restore(self, ckpt, opt_state):
        """``(opt_state, start_epoch)``: the latest checkpoint's state
        copied into the live tensors iff resume was asked for and one
        exists, else ``opt_state`` as it is and epoch 0.  The generators
        take the saved states; a file without them (written by the JAX
        package) leaves them seeded as a fresh ``train()`` seeds them."""
        if ckpt is None or not getattr(self, "_resume", False) \
                or ckpt.latest_step() is None:
            return opt_state, 0
        like = self._state_tree(opt_state)
        tree, meta = ckpt.restore(like)
        opt_state = self._adopt_state(like, tree, opt_state)
        if not checkpoint.restore_generators(self._generators(), meta):
            get_logger(_LOG).info(
                "checkpoint in %s holds no generator states for this "
                "trainer's device; its generators are seeded as a fresh "
                "train() seeds them", self.checkpoint_dir)
        return opt_state, int(meta.get("epoch", -1)) + 1

    def _epoch_metrics(self, epoch: int, losses: np.ndarray, dt: float,
                       samples: int) -> None:
        extra = {}
        if self.profile.memory:
            snap = observe_memory(self.device, self._obs_registry())
            if snap is not None:
                extra["live_bytes"] = snap["live_bytes"]
        self.metrics.log("epoch", trainer=type(self).__name__, epoch=epoch,
                         mean_loss=float(np.mean(losses)),
                         epoch_seconds=dt,
                         samples_per_sec=samples / dt if dt > 0 else 0.0,
                         **extra)


def _variables_leaves(tree, names) -> list:
    """A ``{"params": {name: t}, "state": {name: t}}`` tree's leaves in
    the JAX ``variables`` tree's order (``names``: ``jax_leaf_names``)."""
    return [tree["params"][n] for n in names[0]] + \
        [tree["state"][n] for n in names[1]]


def _copy_into(dsts, srcs) -> None:
    with torch.no_grad():
        for d, s in zip(dsts, srcs):
            d.copy_(s)


def _to_device(batches, i: int, device) -> torch.Tensor:
    """Column ``i`` of host batch tuples, stacked, on ``device``."""
    return torch.from_numpy(np.stack([b[i] for b in batches])).to(device)


class SingleTrainer(Trainer):
    """Single-worker baseline (reference ``SingleTrainer``): the whole
    dataset on one device, one window loop over its batches per epoch.
    The conformance anchor the distributed trainers are compared with.

    A ``ShardedFileDataset`` streams from disk instead, ``stream_window``
    batches a window loop call, with bounded host memory."""

    #: batches per window loop call on the streaming path
    stream_window = 8

    def _state_tree(self, opt_state):
        names = jax_leaf_names(self.model)
        return (_variables_leaves(variables_of(self.model), names),
                checkpoint.opt_state_leaves(opt_state, names[0]),
                checkpoint.rng_key(self.seed + 1))

    def _adopt_state(self, like, tree, opt_state):
        _copy_into(like[0], tree[0])
        return checkpoint.opt_state_from_leaves(
            opt_state, tree[1], jax_leaf_names(self.model)[0])

    def _start(self, optimizer):
        """Initialise from ``seed`` and restore a checkpoint if asked:
        ``(params, opt_state, ckpt, start_epoch)``."""
        self.model.init(self.seed, device=self.device)
        params = model_params(self.model)
        self.generator.manual_seed(self.seed + 1)
        ckpt = self._ckpt_manager()
        opt_state, start = self._maybe_restore(ckpt, optimizer.init(params))
        return params, opt_state, ckpt, start

    def _train(self, dataset: Dataset, shuffle: bool) -> Model:
        if isinstance(dataset, ShardedFileDataset):
            return self._train_stream(dataset, shuffle)
        if not isinstance(dataset, Dataset):
            raise TypeError(f"SingleTrainer trains a Dataset or a "
                            f"ShardedFileDataset, got {type(dataset)}")
        if shuffle:
            dataset = dataset.shuffle(self.seed)
        run, optimizer = self._window_run()

        ds = dataset.coalesce(1)
        stacked, steps = ds.stacked([self.features_col, self.label_col],
                                    self.batch_size)
        # the epoch's batches move to the device once
        xs = torch.from_numpy(stacked[self.features_col][0]).to(self.device)
        ys = torch.from_numpy(stacked[self.label_col][0]).to(self.device)

        params, opt_state, ckpt, start = self._start(optimizer)
        samples = int(xs.shape[0]) * self.batch_size
        pipe = _EpochPipeline(self, samples, self.device)
        for epoch in range(start, self.num_epoch):
            params, opt_state, losses = run(params, opt_state, xs, ys)
            pipe.push(epoch, losses)
            if ckpt is not None:
                self._save(ckpt, epoch, opt_state)
        pipe.flush()
        return self._finish()

    def _train_stream(self, source: ShardedFileDataset,
                      shuffle: bool) -> Model:
        """Epochs streamed from disk: each window's batches are stacked on
        the host and copied to the device; the epoch takes the first
        ``steps // w`` whole windows (``w = stream_window``), and epoch
        e of a shuffled run reads in the order of seed ``seed + 1000 +
        e``."""
        run, optimizer = self._window_run()
        bs = self.batch_size
        steps = source.steps_per_epoch(bs)
        if steps == 0:
            raise ValueError(f"batch_size {bs} exceeds dataset rows "
                             f"{source.num_rows}")
        w = max(1, min(int(self.stream_window), steps))
        n_windows = steps // w

        params, opt_state, ckpt, start = self._start(optimizer)
        cols = [self.features_col, self.label_col]
        pipe = _EpochPipeline(self, n_windows * w * bs, self.device)
        for epoch in range(start, self.num_epoch):
            seed = (self.seed + 1000 + epoch) if shuffle else None
            it = source.batches(cols, bs, seed=seed)
            losses = []
            try:
                for _ in range(n_windows):
                    window = [next(it) for _ in range(w)]
                    params, opt_state, l = run(
                        params, opt_state, _to_device(window, 0, self.device),
                        _to_device(window, 1, self.device))
                    losses.append(l)
            finally:
                # the epoch takes exactly n_windows * w batches: release
                # the prefetch thread and its shard now
                it.close()
            pipe.push(epoch, torch.cat(losses))
            if ckpt is not None:
                self._save(ckpt, epoch, opt_state)
        pipe.flush()
        return self._finish()


# ---------------------------------------------------------------------------
# the sync distributed trainers
# ---------------------------------------------------------------------------

class DistributedTrainer(Trainer):
    """Base for multi-worker trainers (reference ``DistributedTrainer``):
    owns ``num_workers``, partitions the dataset one partition per worker
    and drives the epoch program.  Subclasses pick the communication
    rule.

    Sync mode: W workers run on the trainer's device, one after another,
    through ``parallel.sync.SyncEngine``.  ``mode="async"`` (the
    asynchronous family) runs ``ps.runner.run_async_training``: the
    async-mode arguments (``async_workers``, ``comm_codec``,
    ``comm_down``, ``ps_shm``, ``pull_overlap``, ``ps_shards``, the
    heartbeat knobs) act as in the JAX package; a ``mesh`` raises
    (ROADMAP Queue 1 item 8).  A ``ShardedFileDataset``
    streams each worker's shard partition from disk (sync: one window of
    every worker at a time, ``SyncEngine.window_fn``)."""

    #: default window when the algorithm has no explicit one
    _default_window = 1

    def __init__(self, keras_model: Model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", num_workers: int = 2,
                 features_col: str = "features", label_col: str = "label",
                 num_epoch: int = 1, batch_size: int = 32,
                 communication_window: Optional[int] = None,
                 learning_rate: float = 0.01, seed: int = 0,
                 mode: str = "sync", mesh=None,
                 async_workers: str = "threads",
                 comm_codec: str = "none",
                 comm_down: str = "none",
                 ps_shm: bool = False,
                 pull_overlap: bool = False,
                 ps_shards: int = 1,
                 heartbeat_hard_s: float = 30.0,
                 startup_grace_s: float = 300.0, **kw):
        super().__init__(keras_model, worker_optimizer, loss, features_col,
                         label_col, num_epoch, batch_size, learning_rate, seed,
                         **kw)
        self.num_workers = int(num_workers)
        #: fleet self-healing knobs (async mode): a worker whose
        #: commits/pulls stop reaching the PS for ``heartbeat_hard_s`` is
        #: evicted and respawned; ``startup_grace_s`` applies instead
        #: until an incarnation's first commit
        self.heartbeat_hard_s = float(heartbeat_hard_s)
        self.startup_grace_s = float(startup_grace_s)
        #: live fleet supervisor, set only while an async run is in
        #: flight — the ``add_worker`` elastic-join seam
        self._supervisor = None
        #: the PS's final counters and registry snapshot after an async
        #: run (``ps.runner``)
        self.ps_stats: Optional[dict] = None
        self.communication_window = int(
            communication_window if communication_window is not None
            else self._default_window)
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if async_workers not in ("threads", "processes"):
            raise ValueError(f"async_workers must be 'threads' or "
                             f"'processes', got {async_workers!r}")
        self.mode = mode
        self.mesh = mesh
        self.async_workers = async_workers
        self.ps_shards = int(ps_shards)
        if self.ps_shards < 1:
            raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
        codecs.get_codec(comm_codec)  # validate the spec at construction
        self.comm_codec = comm_codec
        self.comm_down = codecs.validate_down_spec(comm_down)
        self.ps_shm = bool(ps_shm)
        self.pull_overlap = bool(pull_overlap)
        if mesh is not None:
            raise NotImplementedError(
                "DistributedTrainer(mesh=...) (workers across cards) is not "
                "ported yet: ROADMAP Queue 1 item 8")

    # -- fleet elasticity -----------------------------------------------------
    def add_worker(self, worker_id=None) -> int:
        """Elastic join: add a worker to the LIVE async run (``train()``
        currently blocking on another thread).  The new worker pulls the
        current center and starts committing, fully accounted by the PS
        (``ps.joins``).  With no id, the next unused one is picked.
        Returns the worker id."""
        sup = self._supervisor
        if sup is None:
            raise RuntimeError(
                "no live async run to join — add_worker() is valid only "
                "while train(mode='async') is in flight")
        return sup.add_worker(worker_id)

    # -- algorithm hooks ------------------------------------------------------
    def _sync_algorithm(self):
        raise NotImplementedError

    def _ps_factory(self):
        """Async-mode parameter-server class; see ``ps.servers``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no async parameter-server mode")

    # -- data staging ---------------------------------------------------------
    def _stage_data(self, dataset: Dataset, window: int):
        """(P, n_windows, window, batch, ...) host arrays, one partition
        per worker, cut to whole windows."""
        ds = dataset.repartition(self.num_workers)
        stacked, steps = ds.stacked([self.features_col, self.label_col],
                                    self.batch_size)
        n_windows = steps // window
        if n_windows == 0:
            raise ValueError(
                f"communication_window {window} exceeds the {steps} "
                f"steps available per worker (decrease window/batch_size "
                f"or add data)")
        dropped = steps - n_windows * window
        if dropped:
            warnings.warn(
                f"{dropped} of {steps} per-worker batches don't fill a "
                f"communication_window of {window} and are dropped each "
                f"epoch (static shapes require whole windows); pick a "
                f"window dividing {steps} to use all data", stacklevel=3)

        def shape_windows(a):
            a = a[:, : n_windows * window]
            return a.reshape(a.shape[0], n_windows, window, *a.shape[2:])

        xs = shape_windows(stacked[self.features_col])
        ys = shape_windows(stacked[self.label_col])
        return xs, ys, n_windows

    # -- training -------------------------------------------------------------
    def _train(self, dataset: Dataset, shuffle: bool) -> Model:
        if isinstance(dataset, ShardedFileDataset):
            # every worker streams its own shard partition
            if self.mode == "async":
                return self._train_async(dataset, stream_shuffle=shuffle)
            return self._train_sync_stream(dataset, shuffle)
        if not isinstance(dataset, Dataset):
            raise TypeError(f"{type(self).__name__} trains a Dataset or a "
                            f"ShardedFileDataset, got {type(dataset)}")
        if shuffle:
            dataset = dataset.shuffle(self.seed)
        if self.mode == "async":
            return self._train_async(dataset)
        return self._train_sync(dataset)

    def _train_async(self, dataset, stream_shuffle: Optional[bool] = None):
        from .ps.runner import run_async_training
        return run_async_training(self, dataset,
                                  stream_shuffle=stream_shuffle)

    def _config_key(self) -> tuple:
        return super()._config_key() + (
            self.num_workers, self.communication_window,
            getattr(self, "rho", None), getattr(self, "momentum", None))

    def _engine(self, program: str):
        """The cached engine and its ``program`` ("epoch", or "window":
        the streaming path's), instrumented; the cache is rebuilt when a
        hyperparameter changed between ``train()`` calls."""
        key = self._config_key()
        cached = getattr(self, "_engine_cache", None)
        if cached is None or cached[0] != key:
            loss_fn, optimizer = self._resolve()
            engine = SyncEngine(self.model, loss_fn, optimizer,
                                self._sync_algorithm(), self.num_workers,
                                self.communication_window,
                                compute_dtype=self.compute_dtype,
                                remat=self.remat,
                                aux_weight=self.aux_weight)
            self._engine_cache = (key, engine,
                                  {"epoch": engine.epoch_fn(),
                                   "window": engine.window_fn()})
        _, engine, programs = self._engine_cache
        return engine, self._instrumented(programs[program], program)

    def _init_variables(self):
        """(center, local): the model initialised from ``seed`` (its own
        tensors are the center) and every worker starting from it.  Both
        the in-memory and the streaming path start here (the JAX
        package's ``_stream_locals``)."""
        self.model.init(self.seed, device=self.device)
        center = variables_of(self.model)
        return center, replicate(center, self.num_workers)

    def _state_tree(self, opt_state):
        names = jax_leaf_names(self.model)
        return (_variables_leaves(self.center, names),
                _variables_leaves(self.local, names),
                checkpoint.stacked_opt_state_leaves(opt_state, names[0]),
                checkpoint.rng_key(self.seed + 1, self.num_workers))

    def _adopt_state(self, like, tree, opt_state):
        _copy_into(like[0] + like[1], tree[0] + tree[1])
        return checkpoint.unstacked_opt_states(
            opt_state, tree[2], jax_leaf_names(self.model)[0])

    def _generators(self) -> list:
        return self._started_engine.rngs

    def _start(self, engine):
        """Initialise from ``seed`` and restore a checkpoint if asked:
        ``(opt_state, ckpt, start_epoch)``.  ``self.center`` and
        ``self.local`` are the (center, local) trees on the device, which
        every window updates in place."""
        self.center, self.local = self._init_variables()
        self._started_engine = engine
        engine.bind(self.local)
        opt_state = engine.init_opt_state()
        engine.seed(self.seed + 1)
        ckpt = self._ckpt_manager()
        opt_state, start = self._maybe_restore(ckpt, opt_state)
        return opt_state, ckpt, start

    def _train_sync(self, dataset: Dataset):
        engine, run = self._engine("epoch")
        P = self.num_workers

        xs, ys, _ = self._stage_data(dataset, self.communication_window)
        xs = torch.from_numpy(xs).to(self.device)
        ys = torch.from_numpy(ys).to(self.device)

        opt_state, ckpt, start = self._start(engine)
        center, local = self.center, self.local
        samples = int(xs.shape[1]) * int(xs.shape[2]) * self.batch_size * P
        pipe = _EpochPipeline(self, samples, self.device)
        for epoch in range(start, self.num_epoch):
            center, local, opt_state, losses = run(center, local, opt_state,
                                                   xs, ys)
            pipe.push(epoch, losses.reshape(P, -1))  # rows: (workers, steps)
            if ckpt is not None:
                self._save(ckpt, epoch, opt_state)
        pipe.flush()
        return self._collect(center, local)

    def _train_sync_stream(self, source: ShardedFileDataset,
                           shuffle: bool) -> Model:
        """Synchronous epochs streamed from disk: worker k reads only its
        shard partition (``worker_window_factory``: its own prefetch
        thread, the reference's per-worker seeds), and each step stacks
        one window of every worker, (W, window, batch, …), on the host,
        copies it to the device and runs it with the edge.  Host memory
        stays O(W × window × batch), never the epoch."""
        engine, run = self._engine("window")
        P, w, bs = self.num_workers, self.communication_window, \
            self.batch_size
        n_windows = worker_windows_per_epoch(source, bs, P, w)

        opt_state, ckpt, start = self._start(engine)
        center, local = self.center, self.local
        cols = [self.features_col, self.label_col]
        factories = [worker_window_factory(source, cols, bs, k, P, w,
                                           self.seed, shuffle)
                     for k in range(P)]
        pipe = _EpochPipeline(self, n_windows * w * bs * P, self.device)
        for epoch in range(start, self.num_epoch):
            its = [f(epoch) for f in factories]
            losses = []
            try:
                for _ in range(n_windows):
                    grp = [next(it) for it in its]
                    center, local, opt_state, l = run(
                        center, local, opt_state,
                        _to_device(grp, 0, self.device),
                        _to_device(grp, 1, self.device))
                    losses.append(l)  # (workers, window) on the device
            finally:
                for it in its:
                    it.close()
            pipe.push(epoch, torch.cat(losses, 1))
            if ckpt is not None:
                self._save(ckpt, epoch, opt_state)
        pipe.flush()
        return self._collect(center, local)

    def _collect(self, center, local):
        """Final model = the center variable (reference: trainers return
        ``PS.get_model()``); ``center`` is the model's own tensors."""
        return self._finish()


class AveragingTrainer(DistributedTrainer):
    """Model averaging (reference ``AveragingTrainer``): workers train
    completely independently on their partition; the final model is the
    plain average of all worker models."""

    def __init__(self, keras_model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", num_workers: int = 2,
                 **kw):
        super().__init__(keras_model, worker_optimizer, loss, num_workers,
                         **kw)

    def _sync_algorithm(self):
        return NoCommSync()

    def _collect(self, center, local) -> Model:
        with torch.no_grad():
            tmap(lambda c, l: c.copy_(l.mean(0)) if _inexact(l)
                 else c.copy_(l[0]), center, local)
        return self._finish()


class EnsembleTrainer(DistributedTrainer):
    """Ensemble training (reference ``EnsembleTrainer``): N independent
    models (different partitions AND different init seeds: member i from
    ``init(seed + i)``), all returned.  ``train`` returns a list of
    Models; ``trained_variables`` is member 0's."""

    def __init__(self, keras_model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", num_ensembles: int = 2,
                 **kw):
        super().__init__(keras_model, worker_optimizer, loss,
                         num_workers=num_ensembles, **kw)
        self.num_ensembles = int(num_ensembles)

    def _sync_algorithm(self):
        return NoCommSync()

    def _init_variables(self):
        # member i from init(seed + i); each init makes new tensors, so
        # the earlier members' stay as they were
        inits = []
        for i in range(self.num_workers):
            self.model.init(self.seed + i, device=self.device)
            inits.append(variables_of(self.model))
        local = stack_trees(inits)
        # the center is member 0's init, as the reference's
        self.model.init(self.seed, device=self.device)
        return variables_of(self.model), local

    def _collect(self, center, local):
        models = []
        for i in range(self.num_workers):
            m = type(self.model).from_config(self.model.config()).init(
                0, device=self.device)
            with torch.no_grad():
                tmap(lambda d, l: d.copy_(l[i]), variables_of(m), local)
            models.append(m)
        self.trained_variables = to_numpy_variables(models[0])
        return models


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Base for the asynchronous algorithm family (reference
    ``AsynchronousDistributedTrainer``).  In sync mode these run their
    synchronous limit; ``mode='async'`` gives faithful staleness semantics
    via the host PS."""


class DOWNPOUR(AsynchronousDistributedTrainer):
    """DOWNPOUR SGD (Dean et al. 2012; reference ``DOWNPOUR`` trainer)."""

    _default_window = 5
    _async_mode = "pull_commit"

    def _sync_algorithm(self):
        return DownpourSync()

    def _ps_factory(self):
        from .ps.servers import DeltaParameterServer
        return DeltaParameterServer


class ADAG(AsynchronousDistributedTrainer):
    """ADAG — asynchronous distributed adaptive gradients (reference
    ``ADAG`` trainer; the upstream README's recommended algorithm).  The
    synchronous limit is allreduce-mean windowed SGD."""

    _default_window = 12
    _async_mode = "pull_commit"

    def _sync_algorithm(self):
        return AdagSync()

    def _ps_factory(self):
        from .ps.servers import ADAGParameterServer
        return ADAGParameterServer


class DynSGD(AsynchronousDistributedTrainer):
    """DynSGD — staleness-aware dynamic SGD (reference ``DynSGD`` trainer +
    ``DynSGDParameterServer``): commits scaled by 1/(staleness+1)."""

    _default_window = 5
    _async_mode = "staleness"

    def _sync_algorithm(self):
        return DynSgdSync()

    def _ps_factory(self):
        from .ps.servers import DynSGDParameterServer
        return DynSGDParameterServer


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous elastic averaging SGD (Zhang et al. 2015; reference
    ``AEASGD`` trainer).  ``rho`` is the elastic force coefficient; the
    elastic alpha is ``rho * learning_rate`` as in the reference."""

    _default_window = 32
    _async_mode = "elastic"

    def __init__(self, keras_model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", num_workers: int = 2,
                 rho: float = 5.0, learning_rate: float = 0.01, **kw):
        super().__init__(keras_model, worker_optimizer, loss, num_workers,
                         learning_rate=learning_rate, **kw)
        self.rho = float(rho)

    @property
    def alpha(self) -> float:
        return self.rho * self.learning_rate

    def _sync_algorithm(self):
        return EasgdSync(self.alpha)

    def _ps_factory(self):
        from .ps.servers import DeltaParameterServer
        return DeltaParameterServer


class EAMSGD(AEASGD):
    """Elastic averaging with (Nesterov) momentum (reference ``EAMSGD``):
    identical elastic exchange, Nesterov momentum in the local optimizer."""

    def __init__(self, keras_model, worker_optimizer="sgd",
                 loss="categorical_crossentropy", num_workers: int = 2,
                 rho: float = 5.0, learning_rate: float = 0.01,
                 momentum: float = 0.9, **kw):
        if not (worker_optimizer == "sgd" or worker_optimizer is None):
            raise ValueError(
                "EAMSGD defines its own local optimizer (Nesterov-momentum "
                "SGD, per the algorithm); worker_optimizer must be left as "
                f"'sgd', got {worker_optimizer!r}")
        super().__init__(keras_model, "sgd", loss, num_workers,
                         rho=rho, learning_rate=learning_rate, **kw)
        self.momentum = float(momentum)

    def _resolve(self):
        loss_fn, _ = super()._resolve()
        optimizer = sgd(self.learning_rate, momentum=self.momentum,
                        nesterov=True)
        return loss_fn, optimizer
