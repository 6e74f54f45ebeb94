"""Async-mode training driver — the port of ``distkeras_tpu.ps.runner``: the
reference's ``DistributedTrainer.train`` orchestration (start PS → ship
workers → join → collect center), minus Spark.  The PS lives on the host
over localhost TCP (the same star topology), data slices come from the
partitioned ``Dataset`` (or a ``ShardedFileDataset`` streamed from disk),
and workers run as either

* **threads** (default): in-process, each with its own model replica on
  the trainer's device (on one card every thread worker shares it and its
  current stream, where the JAX package spreads them over
  ``jax.devices()``), or
* **processes** (``async_workers="processes"``): one OS process per worker
  (``python -m distkeras_tpu_torch.ps.worker_main``), the reference's
  deployment shape — full process isolation, commits over real TCP from
  real processes.  On the card each child holds its own CUDA context;
  the parent builds the kernel library before it spawns, so the children
  load it instead of compiling it several times over, and folds each
  child's kernel launch counts into its own after the run.

A ``FleetSupervisor`` watches every incarnation during the run: a worker
that dies or goes silent past ``heartbeat_hard_s`` is evicted (its late
commits tombstone) and respawned at the exact window its commits
reached; ``add_worker`` joins a new one into the live run.

``ps_shards > 1`` hosts the center as a fleet of shard servers
(``ps.shard``), each with its own lock, accept loop and registry; the
workers then connect to the list of shard ports through a
``ShardedPSClient``, and the supervisor polls the fleet's health, so a
dead shard fails the run by name.  A sharded run does not checkpoint its
center.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..obs.logging import get_logger
from ..obs.spans import SpanTracer
from ..parallel.sync import make_window_fn, model_params
from ..utils import serde
from ..utils.weights import jax_variables, load_jax_variables, \
    to_numpy_variables
from .networking import repo_env
from .servers import SocketParameterServer
from .shard import ShardedParameterServer
from .workers import ElasticWorker, PullCommitWorker, StalenessWorker

_WORKER_CLASSES = {
    "pull_commit": PullCommitWorker,
    "staleness": StalenessWorker,
    "elastic": ElasticWorker,
}

#: the record a worker process writes its kernel launch counts into
LAUNCH_EVENT = "kernel_launches"


# ---------------------------------------------------------------------------
# fleet supervision: detect -> evict -> respawn, DURING the run
# ---------------------------------------------------------------------------

class _ThreadHandle:
    """One thread-placement worker incarnation under supervision."""

    def __init__(self, worker, attempt: int):
        self.worker = worker
        self.worker_id = worker.worker_id
        self.generation = worker.generation
        self.start_window = worker.start_window
        self.attempt = int(attempt)
        self.started_mono = time.monotonic()

    def alive(self) -> bool:
        return self.worker.is_alive()

    def failure(self):
        return self.worker.error

    def evicted(self) -> bool:
        return self.worker.evicted

    def epoch_losses(self) -> dict:
        return self.worker.epoch_losses

    def reap(self, grace_s: float) -> None:
        self.worker.join(grace_s)

    def terminate(self) -> None:
        """Threads cannot be killed; they are daemons and die with the
        process (a tombstoned zombie exits at its next commit anyway)."""


class _ProcHandle:
    """One process-placement worker incarnation under supervision."""

    def __init__(self, worker_id: int, generation: int, start_window: int,
                 attempt: int, proc: subprocess.Popen, out_npz: str):
        self.worker_id = int(worker_id)
        self.generation = int(generation)
        self.start_window = int(start_window)
        self.attempt = int(attempt)
        self.proc = proc
        self.out_npz = out_npz
        self.started_mono = time.monotonic()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def failure(self):
        rc = self.proc.poll()
        return rc if rc not in (None, 0) else None

    def evicted(self) -> bool:
        # a tombstoned worker process winds down cleanly (rc 0); the
        # supervisor already moved it out of the live set at eviction
        return False

    def epoch_losses(self) -> dict:
        if not os.path.exists(self.out_npz):
            return {}
        with np.load(self.out_npz) as d:
            return {int(name.split("_", 1)[1]): d[name] for name in d.files}

    def reap(self, grace_s: float) -> None:
        try:
            self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class FleetSupervisor:
    """Live fleet watchdog.

    Watches every worker incarnation DURING the run — not after join —
    and acts on three liveness signals: incarnation death with an error
    (thread exception / nonzero process exit, which is also where
    repeated commit-RPC failures surface, since ``commit`` never
    auto-retries), and a heartbeat gap beyond the hard threshold (no
    commit OR pull reaching the PS — the SIGSTOP shape).  A bad worker is
    **evicted** (the PS bumps its commit generation, so the zombie's late
    commits tombstone) and **respawned** from the current center, at the
    exact window its commits reached (the PS per-worker counter).
    ``max_attempts`` incarnations per worker keep the reference's Spark
    semantics — retry once, a second failure is fatal.

    :meth:`add_worker` is the same path invoked for a worker id the PS
    has never seen: **elastic join** — a mid-run worker pulls the center
    and starts committing, fully accounted (``ps.joins``).

    The supervisor runs on the caller's thread (``run()`` blocks until
    the fleet finishes); ``add_worker`` may be called concurrently from
    any thread.
    """

    def __init__(self, ps, server, spawn, *, heartbeat_hard_s: float = 30.0,
                 startup_grace_s: float = 300.0, poll_s: float = 0.05,
                 max_attempts: int = 2, timeout: Optional[float] = None,
                 metrics=None, shard_watch=None):
        self.ps = ps
        self.server = server
        #: sharded-center health probe: called once per poll; raises
        #: ``ShardFleetError`` naming the dead shard (index, address, last
        #: commit counter), so the run fails at once instead of workers
        #: spinning in reconnect backoff.  None for the single server.
        self.shard_watch = shard_watch
        #: spawn(worker_id, start_window, generation, attempt) -> handle;
        #: the placement-specific closure (thread worker / worker process)
        self.spawn = spawn
        self.heartbeat_hard_s = float(heartbeat_hard_s)
        self.startup_grace_s = float(startup_grace_s)
        self.poll_s = float(poll_s)
        self.max_attempts = int(max_attempts)
        self.timeout = timeout
        self.metrics = metrics
        self._lock = threading.Lock()
        self.live: dict = {}        # worker_id -> current incarnation
        self.attempts: dict = {}    # worker_id -> incarnations used
        self.finished: dict = {}    # worker_id -> [retired handles]
        self.zombies: list = []     # evicted-but-alive old incarnations
        self._handles: list = []    # every handle ever spawned (cleanup)
        self._log = get_logger("ps.fleet")
        #: self-healing latency: eviction -> the replacement's FIRST
        #: commit landing, per recovery.  The sharded facade's registry is
        #: a read-only merged view with no instruments to write into, so
        #: a sharded fleet records no such histogram
        self._h_recovery = ps.registry.histogram("ps.recovery_seconds") \
            if hasattr(ps.registry, "histogram") else None
        self._evicted_at: dict = {}   # worker_id -> eviction monotonic
        self._recovering: dict = {}   # worker_id -> (t_evict, start_window)

    # -- spawning -----------------------------------------------------------
    def _spawn_into_live(self, k: int, start_window: int, generation: int,
                         attempt: int):
        h = self.spawn(k, start_window, generation, attempt)
        with self._lock:
            self.live[k] = h
            self.attempts[k] = self.attempts.get(k, 0) + 1
            self._handles.append(h)
        return h

    def add_initial(self, worker_id: int, start_window: int) -> None:
        """Start one of the run's configured workers (generation 0, or
        whatever the PS restored for it)."""
        with self.ps.mutex:
            gen = self.ps.generations.get(int(worker_id), 0)
        self._spawn_into_live(worker_id, start_window, gen, 0)

    def add_worker(self, worker_id: Optional[int] = None) -> int:
        """Elastic join: add a worker to the LIVE run.  With no id, picks
        the next unused one.  Returns the worker id."""
        with self._lock:
            known = set(self.live) | set(self.finished) | set(self.attempts)
            if worker_id is None:
                worker_id = max(known) + 1 if known else 0
            k = int(worker_id)
            if k in self.live:
                raise ValueError(f"worker {k} is already live")
            attempt = self.attempts.get(k, 0)
        window, gen = self.ps.register_join(k)
        self._log.info("elastic join: worker %d enters at window %d "
                       "(generation %d)", k, window, gen)
        self._event("join", k, window=window)
        self._spawn_into_live(k, window, gen, attempt)
        return k

    # -- liveness signals ---------------------------------------------------
    def _stall_reason(self, k: int, h) -> Optional[str]:
        """Non-None when incarnation ``h`` of worker ``k`` looks wedged:
        nothing from it (commit or pull) has reached the PS for longer
        than the hard threshold.  Before its first commit the startup
        grace applies instead — interpreter start and the first window's
        kernel builds must not read as a stall."""
        now = time.monotonic()
        seen = self.server.last_seen_age(k)
        since_start = now - h.started_mono
        # stamps older than this incarnation belong to its predecessor
        age = since_start if seen is None else min(seen, since_start)
        committed = self.ps.commits_by_worker.get(k, 0) > h.start_window
        limit = self.heartbeat_hard_s if committed \
            else max(self.heartbeat_hard_s, self.startup_grace_s)
        if age > limit:
            return (f"no PS traffic for {age:.1f}s "
                    f"(hard threshold {limit:.1f}s)")
        return None

    # -- evict / respawn ----------------------------------------------------
    def _event(self, kind: str, worker_id: int, **fields) -> None:
        if self.metrics is not None:
            self.metrics.log("fleet_event", kind=kind,
                             worker_id=int(worker_id), **fields)

    def _retire(self, k: int, h, reason: str) -> int:
        """Evict incarnation ``h``: bump the PS generation (its late
        commits now tombstone) and move it out of the live set.  Returns
        the window its commits reached."""
        window = self.ps.evict_worker(k)
        self._log.warning("evicting worker %d attempt %d (%s); commits "
                          "reached window %d", k, h.attempt, reason, window)
        self._event("evict", k, reason=reason, window=window)
        with self._lock:
            self._evicted_at[k] = time.monotonic()
            if self.live.get(k) is h:
                del self.live[k]
            if h.alive():
                self.zombies.append(h)   # losses collected when it dies
            else:
                self.finished.setdefault(k, []).append(h)
        return window

    def _respawn_or_raise(self, k: int, failed) -> None:
        with self._lock:
            used = self.attempts.get(k, 0)
        if used >= self.max_attempts:
            times = "twice" if used == 2 else f"{used} times"
            err = failed.failure() if failed is not None else None
            if isinstance(err, BaseException):
                raise RuntimeError(
                    f"async worker {k} failed {times}") from err
            if err is not None:  # a worker process's exit code
                raise RuntimeError(
                    f"async worker process {k} failed {times} (rc={err})")
            raise RuntimeError(
                f"async worker {k} failed {times} (last incarnation "
                f"evicted: stalled past the heartbeat hard threshold)")
        start, gen = self.ps.register_respawn(k)
        self._log.warning("respawning worker %d (attempt %d) from the "
                          "current center at window %d, generation %d",
                          k, used, start, gen)
        self._event("respawn", k, window=start, attempt=used)
        self._spawn_into_live(k, start, gen, used)
        with self._lock:
            t0 = self._evicted_at.pop(k, None)
            if t0 is not None:
                # recovery window open: closes at the replacement's first
                # commit past its start window
                self._recovering[k] = (t0, start)

    # -- the watch loop -----------------------------------------------------
    def run(self) -> dict:
        """Supervise until every live worker finishes; returns
        ``{worker_id: merged epoch_losses}`` across incarnations."""
        deadline = None if self.timeout is None \
            else time.monotonic() + float(self.timeout)
        while True:
            if self.shard_watch is not None:
                # a dead center shard is fatal for every worker at once:
                # surface it here, with its name
                self.shard_watch()
            with self._lock:
                live = dict(self.live)
            if not live:
                break
            for k, h in live.items():
                with self._lock:
                    if self.live.get(k) is not h:
                        continue  # replaced by a concurrent join
                if h.alive():
                    reason = self._stall_reason(k, h)
                    if reason is not None:
                        self._retire(k, h, reason)
                        self._respawn_or_raise(k, None)
                elif h.failure() is not None:
                    self._retire(k, h, f"failed: {h.failure()!r}")
                    self._respawn_or_raise(k, h)
                else:
                    # clean exit (evicted zombies never sit in live —
                    # _retire moved them out before the replacement spawn)
                    with self._lock:
                        del self.live[k]
                        self.finished.setdefault(k, []).append(h)
            self._poll_recovery()
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(
                    f"async fleet timed out after {self.timeout:.0f}s")
            time.sleep(self.poll_s)
        self._poll_recovery()   # a replacement may finish within one poll
        self._reap_zombies()
        return self._merged_losses()

    def _poll_recovery(self) -> None:
        """Close any open eviction->first-commit recovery windows."""
        if not self._recovering or self._h_recovery is None:
            return
        now = time.monotonic()
        with self._lock:
            open_windows = list(self._recovering.items())
        for k, (t0, start) in open_windows:
            if self.ps.commits_by_worker.get(k, 0) > start:
                with self._lock:
                    self._recovering.pop(k, None)
                self._h_recovery.observe(now - t0)
                self._event("recovered", k, seconds=now - t0)

    def _reap_zombies(self) -> None:
        """Give evicted-but-alive incarnations a short grace to wind down
        (a tombstoned commit exits them) and fold in whatever complete
        epochs they produced; one still wedged forfeits its losses — its
        replacement re-trained the windows that mattered."""
        with self._lock:
            zombies = list(self.zombies)
        for h in zombies:
            h.reap(2.0)
            if h.alive():
                self._log.warning(
                    "evicted worker %d attempt %d still wedged at fleet "
                    "shutdown; its local losses are forfeit", h.worker_id,
                    h.attempt)
                continue
            with self._lock:
                self.finished.setdefault(h.worker_id, []).append(h)

    def _merged_losses(self) -> dict:
        out = {}
        with self._lock:
            finished = {k: list(v) for k, v in self.finished.items()}
        for k, handles in finished.items():
            d: dict = {}
            for h in sorted(handles, key=lambda h: h.attempt):
                d.update(h.epoch_losses())
            out[k] = d
        return out

    def terminate_all(self) -> None:
        """Kill every process incarnation still running (the runner's
        finally — a hung worker must not orphan the run)."""
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            h.terminate()


class _StreamPlan:
    """Per-worker disk-streaming data plan (async counterpart of
    ``DistributedTrainer._train_sync_stream``): each worker iterates ITS
    shard partition of a ``ShardedFileDataset``; nothing is staged in RAM."""

    def __init__(self, trainer, source, shuffle: bool):
        from ..data.streaming import worker_windows_per_epoch
        self.source = source
        self.shuffle = bool(shuffle)
        self.P = trainer.num_workers
        self.bs = trainer.batch_size
        self.w = trainer.communication_window
        self.cols = [trainer.features_col, trainer.label_col]
        self.base_seed = trainer.seed
        self.n_windows = worker_windows_per_epoch(source, self.bs, self.P,
                                                  self.w)

    def factory(self, k: int):
        from ..data.streaming import worker_window_factory
        return worker_window_factory(self.source, self.cols, self.bs, k,
                                     self.P, self.w, self.base_seed,
                                     self.shuffle)


def run_async_training(trainer, dataset, fault_injector=None,
                       stream_shuffle=None):
    """Drive async-PS training for a DistributedTrainer subclass.

    The trainer supplies: model/loss/optimizer, ``num_workers``,
    ``communication_window``, epochs, the PS class (``_ps_factory``), the
    worker flavor (``_async_mode``), the worker placement
    (``async_workers``: threads or processes) and the device.  The center
    starts as the model's ``init(seed)`` in the JAX ``variables`` tree's
    shape (``utils.weights.to_numpy_variables``), so it, the wire and
    the PS checkpoints are the JAX package's.  ``dataset`` may be a
    disk-backed ``ShardedFileDataset`` — workers then stream their shard
    partitions instead of receiving staged arrays.  ``trainer.ps_shards >
    1`` hosts the center on a ``ShardedParameterServer``.
    """
    from ..data.streaming import ShardedFileDataset
    mode = getattr(trainer, "_async_mode", "pull_commit")
    placement = getattr(trainer, "async_workers", "threads")
    ps_shards = int(getattr(trainer, "ps_shards", 1))

    if isinstance(dataset, ShardedFileDataset):
        stream, xs, ys = _StreamPlan(trainer, dataset,
                                     bool(stream_shuffle)), None, None
    else:
        stream = None
        xs, ys, _ = trainer._stage_data(dataset,
                                        trainer.communication_window)

    trainer.model.init(trainer.seed, device=trainer.device)
    center = to_numpy_variables(trainer.model)
    ps_kwargs = {}
    ckpt = trainer._ckpt_manager()
    if ckpt is not None and ps_shards == 1:
        # checkpoint the center roughly once per worker round of commits
        ps_kwargs = {"checkpoint_manager": ckpt,
                     "checkpoint_every": trainer.num_workers}
    num_epoch = trainer.num_epoch
    start_windows = [0] * trainer.num_workers
    if ps_shards > 1:
        if ckpt is not None:
            get_logger("ps.shard").warning(
                "sharded PS (%d shards) does not checkpoint or restore the "
                "center; this run is checkpoint-free", ps_shards)
        # one update-rule server and front-end PER SHARD; every shard's
        # tracer shares the trainer's JSONL sink, so apply spans still
        # link to the worker windows that caused them
        ps = ShardedParameterServer(
            center, ps_shards, trainer._ps_factory(),
            num_workers=trainer.num_workers, fault_injector=fault_injector,
            tracer_factory=lambda reg: SpanTracer(trainer.metrics,
                                                  registry=reg))
        server = ps.start()
    else:
        ps = trainer._ps_factory()(center, num_workers=trainer.num_workers,
                                   **ps_kwargs)
        if ckpt is not None and getattr(trainer, "_resume", False):
            if ps.restore(ckpt):
                # EXACT resume: one commit per communication window, so
                # the snapshot's per-worker commit count IS the global
                # window index each worker continues from — mid-epoch
                # included
                start_windows = [ps.commits_by_worker.get(k, 0)
                                 for k in range(trainer.num_workers)]
                center = ps.get_model()  # workers start from the restored
        # server-side tracer shares the trainer's JSONL sink: every
        # commit's ``ps.apply`` span adopts the committing worker's trace
        # context; span durations also land in the PS registry
        server = SocketParameterServer(
            ps, fault_injector=fault_injector,
            tracer=SpanTracer(trainer.metrics, registry=ps.registry)).start()
    t_run0 = time.time()  # heartbeats at/after this instant belong to THIS run

    try:
        if placement == "processes":
            losses = _run_process_workers(trainer, ps, server, mode, center,
                                          xs, ys, num_epoch, start_windows,
                                          stream=stream)
        else:
            losses = _run_thread_workers(trainer, ps, server, mode, center,
                                         xs, ys, num_epoch, start_windows,
                                         stream=stream)
    finally:
        server.stop()

    # history: one row per epoch this run touched — (workers, steps) when
    # every worker trained that full epoch (the aligned fresh-run case),
    # else the available per-worker arrays (resumed runs may start
    # mid-epoch at per-worker offsets); only THIS run's heartbeats scope
    # the epochs' seconds
    heartbeats = [r for r in trainer.metrics.records
                  if r.get("event") == "heartbeat" and r["ts"] >= t_run0]
    for e in sorted(set().union(*[set(l) for l in losses])):
        rows = [l[e].reshape(-1) for l in losses if e in l]
        trainer.history.append(
            np.stack(rows) if len(rows) == trainer.num_workers else rows)
        # per-epoch record for the shared stream: loss from the merged
        # rows; wall seconds bounded by the epoch's heartbeat span (async
        # epochs overlap across workers — first-to-last commit is the
        # honest window)
        ts = [r["ts"] for r in heartbeats if r.get("epoch") == e]
        dt = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
        samples = sum(r.size for r in rows) * trainer.batch_size
        trainer.metrics.log(
            "epoch", trainer=type(trainer).__name__, epoch=int(e),
            mean_loss=float(np.mean(np.concatenate(rows))),
            epoch_seconds=dt,
            samples_per_sec=samples / dt if dt > 0 else 0.0)
    trainer.ps_stats = {"num_updates": ps.num_updates,
                        "commits_by_worker": dict(ps.commits_by_worker),
                        "staleness_seen": list(getattr(ps, "staleness_seen",
                                                       [])),
                        "registry": ps.registry.snapshot()}
    if ps_shards > 1:
        # per-shard accounting and the plan the fleet served
        trainer.ps_stats["shards"] = [s.registry.snapshot()
                                      for s in ps.shards]
        trainer.ps_stats["plan"] = ps.plan.doc()
    # final telemetry record into the run's JSONL stream: the registry
    # snapshot (staleness/apply-latency histograms, wire bytes, commit/pull
    # counters)
    trainer.metrics.log("ps_stats", num_updates=ps.num_updates,
                        commits_by_worker=dict(ps.commits_by_worker),
                        stats=ps.registry.snapshot())
    load_jax_variables(trainer.model, ps.get_model())
    return trainer._finish()


def _endpoint(server):
    """Worker-facing PS endpoint: the single server's port, or the shard
    fleet's port LIST (workers then build a ``ShardedPSClient``)."""
    ports = getattr(server, "ports", None)
    return list(ports) if ports is not None else server.port


def _supervisor_for(trainer, ps, server, spawn,
                    timeout: Optional[float] = None) -> FleetSupervisor:
    """Build the fleet supervisor from the trainer's knobs; a sharded
    center also wires its health probe in, so a dead shard fails the run
    by name."""
    return FleetSupervisor(
        ps, server, spawn, timeout=timeout,
        heartbeat_hard_s=getattr(trainer, "heartbeat_hard_s", 30.0),
        startup_grace_s=getattr(trainer, "startup_grace_s", 300.0),
        metrics=trainer.metrics,
        shard_watch=getattr(server, "raise_if_unhealthy", None))


def _supervise(trainer, sup: FleetSupervisor, start_windows) -> list:
    """Start the configured fleet, watch it to completion, return the
    per-worker merged epoch losses (sorted by worker id — elastic joins
    append after the configured ids)."""
    trainer._supervisor = sup
    try:
        for k in range(trainer.num_workers):
            sup.add_initial(k, start_windows[k])
        merged = sup.run()
    finally:
        trainer._supervisor = None
    return [merged[k] for k in sorted(merged)]


def _worker_seed(trainer, k: int, attempt: int) -> int:
    """The historical retry seed rule: seed+1+k, retries at +100 per
    attempt."""
    return trainer.seed + 1 + k + 100 * attempt


# ---------------------------------------------------------------------------
# thread placement (in-process, one model replica per worker)
# ---------------------------------------------------------------------------

def worker_parts(model, loss_fn, optimizer, seed: int, device,
                 compute_dtype=None, remat: bool = False,
                 aux_weight: float = 0.0) -> tuple:
    """``(window_fn, variables, opt_state, generator)`` of one worker
    incarnation over its own ``model`` replica: the window loop bound to
    the replica's parameters and a fresh generator seeded ``seed``, the
    replica's live JAX-shaped tensor tree and a fresh optimizer state —
    what an ``AsyncWorker`` takes, in threads and processes alike."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    run = make_window_fn(model, loss_fn, optimizer,
                         compute_dtype=compute_dtype, remat=remat,
                         aux_weight=aux_weight, generator=gen)
    params = model_params(model)

    def window(opt_state, wx, wy):
        _, opt_state, losses = run(params, opt_state, wx, wy)
        return opt_state, losses

    return window, jax_variables(model), optimizer.init(params), gen


def _replica(trainer, center):
    """A model of the trainer's architecture on its device holding
    ``center`` — one per worker incarnation, so no two threads share a
    module."""
    model = type(trainer.model).from_config(trainer.model.config())
    model.init(0, device=trainer.device)
    load_jax_variables(model, center)
    return model


def _run_thread_workers(trainer, ps, server, mode, center, xs, ys, num_epoch,
                        start_windows, stream=None):
    loss_fn, optimizer = trainer._resolve()
    worker_cls = _WORKER_CLASSES[mode]
    P = trainer.num_workers
    device = trainer.device

    def spawn(k: int, start_window: int, generation: int, attempt: int):
        """One worker incarnation: initial fleet, supervisor respawn, and
        elastic join all come through here — every incarnation starts
        from the CURRENT center (identical to the configured start for
        attempt 0: no commits have landed yet) with its own replica,
        window function, optimizer state and generator."""
        kw = {"alpha": trainer.alpha} if worker_cls is ElasticWorker else {}
        window, variables, opt_state, gen = worker_parts(
            _replica(trainer, ps.get_model()), loss_fn, optimizer,
            _worker_seed(trainer, k, attempt), device,
            trainer.compute_dtype, trainer.remat, trainer.aux_weight)
        w = worker_cls(
            k, trainer._instrumented(window, "async_window"), variables,
            opt_state, gen, "127.0.0.1", _endpoint(server), num_epoch,
            device=device,
            start_window=start_window, metrics=trainer.metrics,
            comm_codec=getattr(trainer, "comm_codec", "none"),
            comm_down=getattr(trainer, "comm_down", "none"),
            shm=getattr(trainer, "ps_shm", False),
            pull_overlap=getattr(trainer, "pull_overlap", False),
            profile_memory=trainer.profile.memory,
            generation=generation, **kw)
        if stream is not None:
            # elastic ids beyond the configured fleet share the partition
            # ring (worker P trains partition 0's slice alongside it)
            w.set_stream(stream.factory(k % stream.P), stream.n_windows)
        else:
            w.set_data(xs[k % P], ys[k % P])
        w.start()
        return _ThreadHandle(w, attempt)

    sup = _supervisor_for(trainer, ps, server, spawn)
    return _supervise(trainer, sup, start_windows)


# ---------------------------------------------------------------------------
# process placement (one OS process per worker — ps.worker_main)
# ---------------------------------------------------------------------------

def _spawn(spec: dict, td: str, k: int) -> subprocess.Popen:
    spec_path = os.path.join(td, f"worker_{k}_{spec['attempt']}.spec")
    with open(spec_path, "wb") as f:
        f.write(serde.tree_to_bytes(spec))
    return subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.ps.worker_main",
         spec_path], env=repo_env())


def _uses_flash(model) -> bool:
    return any(getattr(lyr, "impl", None) == "flash"
               for lyr in model.iter_layers())


def _run_process_workers(trainer, ps, server, mode, center, xs, ys,
                         num_epoch, start_windows, stream=None,
                         timeout: float = 1800.0):
    model_blob = serde.serialize_model(trainer.model, center)
    if not isinstance(trainer.worker_optimizer, str):
        # a process worker rebuilds its optimizer from the spec, so only
        # names ship — substituting a default would silently train
        # different math than the threads placement
        raise ValueError(
            "async_workers='processes' requires a string worker_optimizer "
            f"(got {type(trainer.worker_optimizer).__name__}); optimizer "
            "objects cannot be shipped to worker processes")
    if not isinstance(trainer.loss, str):
        raise ValueError(
            "async_workers='processes' requires a string loss (got "
            f"{type(trainer.loss).__name__}); loss callables cannot be "
            "shipped to worker processes")
    if trainer.device.type == "cuda" and _uses_flash(trainer.model):
        # build once here: the children then load the library, instead of
        # each compiling it
        from ..ops import _kernels
        _kernels.build()

    P = trainer.num_workers
    # the children share the host's cores with each other
    threads = max(1, torch.get_num_threads() // P) \
        if trainer.device.type == "cpu" else None

    def make_spec(k: int, blob: bytes, seed: int, td: str, attempt: int,
                  start_window: int, generation: int):
        if stream is not None:
            # streaming workers read their shard partition straight from
            # the dataset directory; elastic ids beyond the configured
            # fleet share the ring
            data_spec = {"stream": {
                "dir": stream.source.directory,
                "num_workers": stream.P, "batch_size": stream.bs,
                "window": stream.w, "n_windows": stream.n_windows,
                "cols": stream.cols, "shuffle": stream.shuffle,
                "base_seed": stream.base_seed},
                "data_worker": k % stream.P}
        else:
            data = os.path.join(td, f"data_{k % P}.npz")
            if not os.path.exists(data):
                np.savez(data, xs=xs[k % P], ys=ys[k % P])
            data_spec = {"data_npz": data}
        return {
            **data_spec,
            "model_blob": blob,
            "worker_optimizer": trainer.worker_optimizer,
            "loss": trainer.loss,
            "learning_rate": trainer.learning_rate,
            "compute_dtype": str(trainer.compute_dtype).removeprefix(
                "torch.") if trainer.compute_dtype is not None else None,
            "remat": bool(trainer.remat),
            "aux_weight": float(trainer.aux_weight),
            "momentum": getattr(trainer, "momentum", None),
            "mode": mode,
            "comm_codec": getattr(trainer, "comm_codec", "none"),
            "comm_down": getattr(trainer, "comm_down", "none"),
            "ps_shm": bool(getattr(trainer, "ps_shm", False)),
            "pull_overlap": bool(getattr(trainer, "pull_overlap", False)),
            "profile_memory": bool(trainer.profile.memory),
            "alpha": float(getattr(trainer, "alpha", 0.0)),
            "worker_id": k, "host": "127.0.0.1", "port": _endpoint(server),
            "num_epoch": num_epoch, "seed": seed,
            "device": str(trainer.device),
            "torch_threads": threads,
            "start_window": int(start_window),
            "gen": int(generation),
            "out_npz": os.path.join(td, f"out_{k}_{attempt}.npz"),
            # the worker process's OWN telemetry stream: heartbeats,
            # client-side wire spans under trace id w<k> and its kernel
            # launch counts, folded into the trainer's sink after join
            "metrics_jsonl": os.path.join(td,
                                          f"metrics_{k}_{attempt}.jsonl"),
            "attempt": attempt,
        }

    with tempfile.TemporaryDirectory() as td:
        def spawn(k: int, start_window: int, generation: int, attempt: int):
            """One worker-process incarnation (initial / respawn /
            elastic join): respawns and joins ship the CURRENT center;
            the configured fleet shares the one pre-serialized blob."""
            blob = model_blob if (attempt == 0 and ps.num_updates == 0) \
                else serde.serialize_model(trainer.model, ps.get_model())
            spec = make_spec(k, blob, _worker_seed(trainer, k, attempt),
                             td, attempt, start_window, generation)
            proc = _spawn(spec, td, k)
            return _ProcHandle(k, generation, start_window, attempt, proc,
                               spec["out_npz"])

        sup = _supervisor_for(trainer, ps, server, spawn, timeout=timeout)
        try:
            losses = _supervise(trainer, sup, start_windows)
        finally:
            # a hung/failed/wedged worker must not orphan its siblings
            sup.terminate_all()
            # fold every worker process's telemetry into the trainer's
            # sink (failure paths included) BEFORE the tempdir vanishes
            if getattr(trainer, "fold_worker_jsonl", True):
                _fold_worker_metrics(trainer, td)
    return losses


def _fold_worker_metrics(trainer, td: str) -> None:
    """Merge the worker processes' own JSONL streams (``metrics_jsonl``
    in the spec — heartbeats + client wire spans under trace id ``w<k>``)
    into the trainer's sink, original ``ts``/trace identity preserved.
    A ``kernel_launches`` record (each child's K1–K3 launch counts) is
    also added into this process's counts, so a run's launches include
    its worker processes'."""
    from ..ops.flash_attention import add_launches
    for path in sorted(glob.glob(os.path.join(td, "metrics_*.jsonl"))):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue  # worker died before its sink opened
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a killed worker's torn final line
            event = rec.pop("event", "record")
            if event == LAUNCH_EVENT:
                add_launches(rec.get("counts") or {})
            # re-log under the original event name; the record's own
            # ``ts`` overrides the fresh stamp, so timelines stay honest
            trainer.metrics.log(event, **rec)
