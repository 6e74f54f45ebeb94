"""ContinualTrainer — train forever on an unbounded stream, deploy
drift-gated checkpoints into a live decode service (the port of
``distkeras_tpu.continual.trainer``).

* **feed** — any iterator of ``(features, label)`` batch tuples, run
  through the ``data.streaming`` prefetch (producer thread + bounded
  queue: feed IO overlaps device compute) and grouped into static-shaped
  windows by ``window_batches``.  :func:`synthetic_lm_feed` simulates
  the unbounded live stream, with optional injected distribution drift
  (abrupt step or gradual ramp); its batches equal the JAX package's for
  the same seed.
* **training** — the window loop the epoch trainers run
  (``parallel.sync.make_window_fn``) over the model's own parameters,
  behind a ``RetraceSentinel`` that observes each window's arguments:
  one signature for the whole run, steady state ``jit.retraces == 0``.
* **observation** — per-step losses, window wall, and stream lag (time
  the trainer sat blocked on the feed) histogram into the trainer's
  registry; at every interval edge the registry snapshot is differenced
  against the previous edge (``obs.drift.snapshot_delta``).
* **gate** — the interval deltas roll through ``DeployGate``'s window;
  only a *stable* window (after ``min_history`` intervals) may deploy.
* **checkpoint** — every interval edge checkpoints the trainer's state in
  the JAX package's leaf order (``variables``, optimizer state, rng key;
  ``utils.checkpoint``) with exact-resume metadata (interval index and
  batches consumed: one interval is a fixed batch count, so a replayable
  feed can be fast-forwarded to the recorded offset).  A file either
  package wrote resumes in either.
* **deploy** — a clean checkpoint is promoted into the target between
  decode steps.  The promoted weights are a COPY: the trainer updates
  its parameters in place, and a served model that aliased them would
  follow training.  A ``serve.DecodeEngine`` takes a ``state_dict``
  (cloned tensors); a ``serve.ServeClient`` (the ``promote`` RPC), any
  other object with ``promote`` and a bare callable take the JAX
  ``variables`` tree of numpy arrays.

The port's layers hold their own parameters, so ``run`` starts from
``model.init(seed)`` on the trainer's device, as ``SingleTrainer`` does.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.streaming import _prefetched, window_batches
from ..obs import TIME_BUCKETS, Registry, drift
from ..obs.logging import get_logger
from ..obs.profile import RetraceSentinel
from ..ops.losses import get_loss
from ..ops.optimizers import get_optimizer
from ..parallel.sync import make_window_fn, model_params, variables_of
from ..utils import checkpoint
from ..utils.device import DeviceLike, default_device
from ..utils.weights import jax_leaf_names, to_numpy_variables
from .config import ContinualConfig
from .gate import DeployGate

_LOG = "continual.trainer"


def synthetic_lm_feed(vocab_size: int = 32, seq_len: int = 32,
                      batch_size: int = 16, seed: int = 0, step: int = 1,
                      drift_after: Optional[int] = None,
                      drift_step: int = 3,
                      drift_ramp: int = 0) -> Iterator[Tuple]:
    """Unbounded simulated live feed: counting-corpus LM batches (token
    t+1 = token t + ``step`` mod vocab — ``data.datasets.load_lm_corpus``'s
    rule) forever.

    ``drift_after`` injects a DISTRIBUTION CHANGE after that many
    batches: the generating rule switches to ``drift_step``.  With
    ``drift_ramp > 0`` the switch is gradual — the fraction of rows
    drawn from the new rule ramps 0 → 1 over that many batches (the
    windowed diff's *trend* shape); otherwise it is abrupt (the *step*
    shape)."""
    rng = np.random.default_rng(seed)
    arange = np.arange(int(seq_len) + 1)[None, :]
    b = 0
    while True:
        if drift_after is None or b < drift_after:
            frac = 0.0
        elif drift_ramp > 0:
            frac = min(1.0, (b - drift_after + 1) / float(drift_ramp))
        else:
            frac = 1.0
        start = rng.integers(0, vocab_size, size=batch_size)
        steps = np.where(rng.random(batch_size) < frac,
                         int(drift_step), int(step))
        seqs = (start[:, None] + arange * steps[:, None]) % vocab_size
        yield (seqs[:, :-1].astype(np.int32),
               seqs[:, 1:].astype(np.int64))
        b += 1


class ContinualTrainer:
    """Train-forever daemon: unbounded feed in, drift-gated checkpoint
    deploys out.

    ``run(feed)`` is the blocking loop (bounded via ``intervals`` /
    ``config.max_intervals`` for benches and tests); ``start(feed)`` /
    ``stop()`` wrap it in a daemon thread for the live-service shape.
    ``deploy_to`` is the promotion target: a ``serve.DecodeEngine``
    (in-process), a ``serve.ServeClient`` (the ``promote`` RPC), any
    object with a ``promote(variables)`` method, a bare callable, or None
    (decisions still gate + record; nothing is promoted).

    Share ``registry`` with the serving engine and the decode service's
    ``stats`` RPC carries the whole loop — training health, gate
    verdicts, deploy counts — next to the SLO histograms.  ``device``
    (default: the card) is where the model is initialised and trained."""

    def __init__(self, model, worker_optimizer="adam",
                 loss="sparse_categorical_crossentropy",
                 config: Optional[ContinualConfig] = None,
                 learning_rate: float = 1e-3, seed: int = 0,
                 compute_dtype=None,
                 registry: Optional[Registry] = None,
                 checkpoint_dir: Optional[str] = None,
                 baseline: Optional[dict] = None,
                 deploy_to=None, device: DeviceLike = None):
        from ..trainers import _resolve_dtype
        self.model = model
        self.config = config if config is not None else ContinualConfig()
        self.seed = int(seed)
        self.registry = registry if registry is not None else Registry()
        self.checkpoint_dir = checkpoint_dir
        self.deploy_to = deploy_to
        self.device = default_device(device)
        self._loss_fn = get_loss(loss)
        self._optimizer = get_optimizer(worker_optimizer,
                                        float(learning_rate))
        #: the training forward's random draws (Dropout), seeded from
        #: ``seed + 1`` as the JAX trainer makes ``PRNGKey(seed + 1)``
        self.generator = torch.Generator(device=self.device)
        self._run_fn = make_window_fn(
            model, self._loss_fn, self._optimizer,
            compute_dtype=_resolve_dtype(compute_dtype),
            generator=self.generator)

        reg = self.registry
        # pre-create the sentinel counters so a snapshot taken before
        # traffic carries an explicit 0 (a missing metric is only a
        # drift-gate NOTE; a present 0 -> 1 jump is gated)
        reg.counter("jit.compiles")
        reg.counter("jit.retraces")
        self._sentinel = RetraceSentinel("continual.window",
                                         registry=lambda: self.registry)
        self._c_windows = reg.counter("continual.windows")
        self._c_steps = reg.counter("continual.steps")
        self._c_samples = reg.counter("continual.samples")
        self._c_intervals = reg.counter("continual.intervals")
        self._c_checkpoints = reg.counter("continual.checkpoints")
        self._c_deploy_errors = reg.counter("continual.deploy_errors")
        self._c_restarts = reg.counter("continual.restarts")
        self._h_loss = reg.histogram("continual.loss",
                                     self.config.loss_buckets)
        self._h_window = reg.histogram("continual.window_seconds",
                                       TIME_BUCKETS)
        self._h_lag = reg.histogram("continual.stream_lag_seconds",
                                    TIME_BUCKETS)

        self.gate = DeployGate(history=self.config.history,
                               min_history=self.config.min_history,
                               baseline=baseline, registry=reg,
                               watch=self.config.watch)

        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: daemon self-healing: ``start(max_restarts=N, feed_factory=...)``
        #: lets a crashed loop restart from its latest checkpoint, the
        #: feed fast-forwarded to the exact recorded offset
        self._max_restarts = 0
        self._feed_factory = None
        #: latest trained variables (the JAX ``variables`` tree of numpy
        #: arrays, set on run exit) and the latest tree actually deployed
        self.variables = None
        self.deployed = None
        self.deployed_interval: Optional[int] = None
        self.intervals_done = 0
        #: exact stream position: batches consumed up to the latest
        #: CHECKPOINTED interval edge (restored on resume) — the offset a
        #: replayable feed fast-forwards to after a crash
        self.batches_consumed = 0
        self._end_interval: Optional[int] = None

    # -- deploy seam --------------------------------------------------------
    def _promote(self, host_vars) -> None:
        """Push a drift-clean checkpoint into the deploy target, in the
        form it takes: an engine's ``promote`` a ``state_dict`` of cloned
        tensors, anything else the ``variables`` tree ``host_vars``.  A
        refused RPC (``{"ok": False}``) raises — a rejected deploy must
        be recorded, never silently absorbed."""
        from ..serve.engine import DecodeEngine
        target = self.deploy_to
        if target is None:
            return
        if isinstance(target, DecodeEngine):
            reply = target.promote({k: v.detach().clone() for k, v in
                                    self.model.state_dict().items()})
        else:
            promote = getattr(target, "promote", None)
            reply = promote(host_vars) if callable(promote) \
                else target(host_vars)
        if isinstance(reply, dict) and not reply.get("ok", True):
            raise RuntimeError(f"promote refused: {reply.get('error')}")

    # -- checkpoint plumbing ------------------------------------------------
    def _state_tree(self, opt_state):
        """``(variables, opt_state, rng)`` as the JAX trainer checkpoints
        it: the model's live tensors in the JAX leaf order, the
        optimizer state in optax's, and ``PRNGKey(seed + 1)``."""
        names = jax_leaf_names(self.model)
        tree = variables_of(self.model)
        return ([tree["params"][n] for n in names[0]]
                + [tree["state"][n] for n in names[1]],
                checkpoint.opt_state_leaves(opt_state, names[0]),
                checkpoint.rng_key(self.seed + 1))

    def _restore(self, ckpt, opt_state) -> Tuple[dict, dict]:
        """Copy the latest checkpoint into the live tensors: ``(opt_state,
        meta)``.  The generator takes the saved state; a file without one
        (written by the JAX package) leaves it seeded from ``seed + 1``."""
        like = self._state_tree(opt_state)
        tree, meta = ckpt.restore(like)
        with torch.no_grad():
            for dst, src in zip(like[0], tree[0]):
                dst.copy_(src)
        opt_state = checkpoint.opt_state_from_leaves(
            opt_state, tree[1], jax_leaf_names(self.model)[0])
        checkpoint.restore_generators([self.generator], meta)
        return opt_state, meta

    # -- the loop -----------------------------------------------------------
    def _stream(self, feed: Iterable) -> Iterator:
        if self.config.prefetch > 0:
            return _prefetched(iter(feed), self.config.prefetch)
        return iter(feed)

    def run(self, feed: Iterable, intervals: Optional[int] = None,
            resume: bool = False):
        """The blocking continual loop: train on ``feed`` until
        ``stop()`` is called, the feed ends, or the interval bound
        (``intervals`` or ``config.max_intervals``) is reached.  Returns
        the final variables (the JAX ``variables`` tree, a host copy)."""
        cfg = self.config
        bound = intervals if intervals is not None else cfg.max_intervals
        w = int(cfg.window_steps)

        self.model.init(self.seed, device=self.device)
        params = model_params(self.model)
        opt_state = self._optimizer.init(params)
        self.generator.manual_seed(self.seed + 1)
        ckpt = checkpoint.CheckpointManager(self.checkpoint_dir,
                                            keep=cfg.checkpoint_keep) \
            if self.checkpoint_dir else None
        interval = 0
        if resume and ckpt is not None and ckpt.latest_step() is not None:
            opt_state, meta = self._restore(ckpt, opt_state)
            interval = int(meta.get("interval", -1)) + 1
            self.batches_consumed = int(meta.get("batches_consumed", 0))
            # exact stream resume: one interval is a FIXED batch count,
            # so meta["batches_consumed"] is the offset a replayable feed
            # fast-forwards to before calling run() again
            get_logger(_LOG).info(
                "resumed from interval %d (%s batches consumed)",
                interval - 1, meta.get("batches_consumed", "?"))
        end = None if bound is None else interval + int(bound)
        #: the run's global end interval — a self-healing restart aims at
        #: the SAME end, not `bound` more intervals
        self._end_interval = end

        prev_snap = self.registry.snapshot()
        wins = window_batches(self._stream(feed), w)
        try:
            while not self._stop_evt.is_set() and \
                    (end is None or interval < end):
                trained = 0
                exhausted = False
                for _ in range(cfg.snapshot_every):
                    if self._stop_evt.is_set():
                        break
                    t0 = time.perf_counter()
                    try:
                        wx, wy = next(wins)
                    except StopIteration:
                        exhausted = True  # a bounded "unbounded" feed
                        break
                    self._h_lag.observe(time.perf_counter() - t0)
                    wx = torch.from_numpy(wx).to(self.device)
                    wy = torch.from_numpy(wy).to(self.device)
                    self._sentinel.observe((params, opt_state, wx, wy))
                    t1 = time.perf_counter()
                    params, opt_state, losses = self._run_fn(
                        params, opt_state, wx, wy)
                    losses = losses.cpu().numpy()  # the per-window sync
                    self._h_window.observe(time.perf_counter() - t1)
                    self._c_windows.inc()
                    self._c_steps.inc(w)
                    self._c_samples.inc(w * int(cfg.batch_size))
                    for v in losses.ravel():
                        self._h_loss.observe(float(v))
                    trained += 1
                if trained < cfg.snapshot_every:
                    # a PARTIAL interval (stop() mid-interval / feed ran
                    # out) never reaches the gate: its thin loss delta
                    # would be skipped by min_count and the window could
                    # read stable — deploying unvetted mid-interval
                    # weights on the way out.  No edge, no verdict, no
                    # checkpoint for it.
                    if exhausted and self._c_windows.value == 0:
                        raise ValueError(
                            "feed ended before one full window "
                            f"({w} batches) — nothing was trained")
                    break
                # -- interval edge: snapshot -> gate -> checkpoint -> deploy
                cur = self.registry.snapshot()
                delta = drift.snapshot_delta(prev_snap, cur)
                prev_snap = cur
                verdict = self.gate.observe(delta)
                self._c_intervals.inc()
                self.intervals_done = interval + 1
                consumed = (interval + 1) * cfg.snapshot_every * w
                if ckpt is not None:
                    # edges only run on FULL intervals, so the global
                    # interval index (resume-restored) is the exact
                    # stream offset
                    ckpt.save(interval, self._state_tree(opt_state),
                              {"interval": interval,
                               "batches_consumed": consumed,
                               checkpoint.GENERATORS:
                                   checkpoint.generator_meta(
                                       [self.generator])})
                    self._c_checkpoints.inc()
                    self.batches_consumed = consumed
                entry = self.gate.decide(verdict, interval=interval)
                if entry["deploy"]:
                    # the deploy (and only the deploy) pays the copy off
                    # the live parameters; rejected intervals don't
                    host = to_numpy_variables(self.model)
                    try:
                        self._promote(host)
                        self.gate.record_deployed(entry)
                        self.deployed = host
                        self.deployed_interval = interval
                    except Exception as e:
                        # the gate said yes but the target refused/died:
                        # recorded loudly, training continues (the next
                        # clean interval retries)
                        self._c_deploy_errors.inc()
                        entry["reason"] = f"deploy failed: {e}"
                        get_logger(_LOG).warning(
                            "deploy of interval %d failed: %s", interval, e)
                interval += 1
        finally:
            if hasattr(wins, "close"):
                wins.close()  # release the prefetch producer
            self.variables = to_numpy_variables(self.model)
        return self.variables

    # -- daemon shape -------------------------------------------------------
    def start(self, feed: Iterable, intervals: Optional[int] = None,
              resume: bool = False, max_restarts: int = 0,
              feed_factory=None) -> "ContinualTrainer":
        """Run the loop on a daemon thread (the train-forever service
        shape); ``stop()`` ends it at the next window edge.

        Self-healing: ``max_restarts > 0`` lets the daemon survive a
        crash mid-stream — the loop restarts with ``resume=True``,
        picking up the weights, optimizer state and generator from the
        latest checkpoint (``checkpoint_dir`` required for an exact
        resume; without one a restart retrains from init), and
        ``feed_factory(batches_consumed)`` — when given — builds a fresh
        feed fast-forwarded to the exact recorded stream offset.  Every
        restart is a recorded ``continual.restarts`` metric."""
        if self._thread is not None:
            raise RuntimeError("continual trainer already started")
        self._max_restarts = int(max_restarts)
        self._feed_factory = feed_factory
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run_guarded, args=(feed, intervals, resume),
            daemon=True, name="continual-train")
        self._thread.start()
        return self

    def _run_guarded(self, feed, intervals, resume):
        restarts = 0
        while True:
            try:
                self.run(feed, intervals=intervals, resume=resume)
                return
            except Exception:
                # a dead training daemon must be loud: the serving side
                # keeps answering with the last deployed checkpoint
                # either way
                get_logger(_LOG).exception("continual trainer crashed")
                if restarts >= self._max_restarts or \
                        self._stop_evt.is_set():
                    return
                restarts += 1
                self._c_restarts.inc()
                # exact stream resume: restart from the latest
                # checkpoint; a replayable feed is rebuilt fast-forwarded
                # to the recorded batch offset, so no sample is trained
                # twice and none is skipped
                if self._feed_factory is not None:
                    feed = self._feed_factory(self.batches_consumed)
                resume = True
                end = self._end_interval
                if end is not None and self.checkpoint_dir:
                    # a checkpointed restart resumes the interval
                    # NUMBERING, so aim at the ORIGINAL end: remaining =
                    # end minus what already completed.  A crash on the
                    # final edge has nothing left to redo.
                    if end - self.intervals_done <= 0:
                        return
                    intervals = end - self.intervals_done
                # without a checkpoint_dir the restart retrains from
                # init at interval 0 — the original bound stands
                get_logger(_LOG).warning(
                    "restarting continual trainer (restart %d/%d) from "
                    "batch offset %d", restarts, self._max_restarts,
                    self.batches_consumed)

    def stop(self, timeout: float = 60.0):
        """Signal the loop to end and join it; returns the final
        variables (host copy)."""
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                get_logger(_LOG).warning(
                    "continual trainer still running after %.0fs stop "
                    "timeout", timeout)
            else:
                self._thread = None
        return self.variables
