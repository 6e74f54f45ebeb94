"""Async worker loops — the port of ``distkeras_tpu.ps.workers`` (parity with
reference ``distkeras/workers.py``).

Each worker owns a model replica on a device, runs the window loop
(``parallel.sync.make_window_fn`` over that replica) on its partition,
and talks to the parameter server at window boundaries:

* ``PullCommitWorker``  — DOWNPOUR / ADAG (reference ``DOWNPOURWorker`` /
  ``ADAGWorker``): pull center, train a window from it, commit the delta.
* ``StalenessWorker``   — DynSGD (reference ``DynSGDWorker``): same, but the
  commit carries the update counter seen at pull time so the server can
  compute staleness.
* ``ElasticWorker``     — AEASGD / EAMSGD (reference ``AEASGDWorker`` /
  ``EAMSGDWorker``): the local model persists across windows; the elastic
  force E = α(local − center) moves local toward center and is committed.

Where the JAX workers share one pure jitted window function over a
carried ``(variables, opt_state, rng)``, a port worker owns everything
its window touches: its own ``nn.Module`` replica (the window loop
updates its parameters in place, switches its train mode and commits
BatchNorm state into its buffers), its own window function bound to that
replica, its own optimizer state and its own ``torch.Generator``.  Two
threads therefore never share a module.  ``variables`` is the replica's
JAX-shaped tree of live tensors (``utils.weights.jax_variables``): a pull
copies the center's floating leaves into them, and the window's result
comes back to the host as a numpy tree of the same shape, the tree the
PS holds.  Integer and bool leaves keep their worker-local values
(``adopt_float_leaves``' rule).

Workers run as threads in this process (the reference's ran as Spark
executor tasks): torch releases the GIL inside its kernels and the card
runs them asynchronously, so windows overlap and commits interleave
nondeterministically — real asynchrony, real staleness.  On one card the
thread workers share its current stream.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..obs import profile as obs_profile
from ..obs.spans import SpanTracer
from ..parallel.sync import _inexact
from ..utils.tree import tree_flatten
from .client import PSClient, WorkerEvicted
from .shard import ShardedPSClient

Tree = Any

def _to_host(t) -> np.ndarray:
    """A tensor leaf as a numpy array the window cannot change later (a
    copy, also on a CPU device, whose tensors the next window updates in
    place)."""
    if torch.is_tensor(t):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def _host(tree):
    """The live tensor tree as a numpy tree of the same structure (dicts
    with sorted keys, as the PS and the JAX package hold them)."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([_to_host(t) for t in leaves])


def _load(live: Tree, tree: Tree, floats_only: bool = True) -> None:
    """Copy ``tree``'s leaves (numpy) into the ``live`` tensors, floating
    leaves only unless ``floats_only`` is False: integer/bool state stays
    worker-local (the sync engine's window-edge rule)."""
    dsts = tree_flatten(live)[0]
    srcs = tree_flatten(tree)[0]
    if len(dsts) != len(srcs):
        raise ValueError(f"center has {len(srcs)} leaves, the worker's "
                         f"model {len(dsts)}")
    with torch.no_grad():
        for d, s in zip(dsts, srcs):
            if floats_only and not _inexact(d):
                continue
            if not torch.is_tensor(s):
                s = np.asarray(s)
                # pulled leaves may be read-only views over the wire's
                # bytes; torch wraps only writable arrays
                s = torch.from_numpy(s if s.flags.writeable else s.copy())
            d.copy_(s.reshape(d.shape))


class AsyncWorker(threading.Thread):
    """Base: epochs × windows loop over this worker's partition slice.

    ``window_fn(opt_state, xs, ys) -> (opt_state, losses)`` runs one
    window on the replica whose live tensors ``variables`` holds;
    ``rng`` is the replica's ``torch.Generator`` (bound into
    ``window_fn``, kept here for inspection)."""

    def __init__(self, worker_id: int, window_fn: Callable,
                 variables: Tree, opt_state: Tree, rng,
                 host: str, port: int, num_epoch: int,
                 device=None, start_window: int = 0, metrics=None,
                 comm_codec: str = "none", profile_memory: bool = True,
                 generation: int = 0, comm_down: str = "none",
                 shm: bool = False, pull_overlap: bool = False):
        super().__init__(name=f"worker-{worker_id}", daemon=True)
        self.worker_id = worker_id
        #: commit generation this incarnation runs under: the supervisor
        #: bumps it on eviction, so a zombie predecessor's late commits
        #: tombstone instead of double-applying
        self.generation = int(generation)
        #: True when the PS evicted this incarnation (a replacement owns
        #: the id): a CLEAN exit, distinct from ``error``
        self.evicted = False
        self.window_fn = window_fn
        self.variables = variables
        self.opt_state = opt_state
        self.rng = rng
        self.ps_host = host
        self.ps_port = port
        self.num_epoch = num_epoch
        self.device = torch.device(device) if device is not None else None
        #: delta-compression codec spec (``ps.codecs``): the client built
        #: in ``run()`` owns the stateful error-feedback instance
        self.comm_codec = comm_codec
        #: DOWN pull-compression spec and same-host shm-transport opt-in;
        #: like the codec, the client owns the per-link state (reference
        #: epoch, adaptive policy, rings), so a respawned incarnation's
        #: fresh client starts reference-less and resyncs
        self.comm_down = comm_down
        self.shm = bool(shm)
        #: dispatch-ahead pulls: issue window k+1's pull right after
        #: window k's device work is queued, so the center transfer rides
        #: the wire while the card computes (recorded per pull as
        #: ``ps.pull.hidden_seconds`` / ``ps.pull.overlap_fraction``).
        #: Window k+1 then trains from a center pulled before commit k
        #: landed: one extra window of self-staleness, which the async
        #: rules absorb.  Pull-first workers only.
        self.pull_overlap = bool(pull_overlap)
        #: (center, seen_updates) collected by the previous window's
        #: overlapped pull
        self._next_center = None
        #: set per window by ``_train`` so the LAST window skips issuing
        #: a dispatch-ahead pull nothing will consume
        self._is_last_window = False
        #: optional shared JSONL sink (``MetricsLogger`` — thread-safe):
        #: one ``heartbeat`` record per committed window
        self.metrics = metrics
        #: exact resume: global window index to continue from (= this
        #: worker's commit count in the restored PS snapshot; one commit
        #: per window).  0 on a fresh run.
        self.start_window = int(start_window)
        self.losses: list = []          # one (n_windows, w) array per epoch
        self.epoch_losses: dict = {}    # absolute epoch -> (n_windows, w)
        #: flat (global_window_index, (w,) losses) pairs — the exact record
        self.window_losses: list = []
        self.error: Optional[BaseException] = None
        self.xs = self.ys = None        # (n_windows, w, batch, ...) numpy
        #: per-worker span tracer (built on the worker's own thread in
        #: ``run()``): trace id ``w<worker_id>``, sink shared with the
        #: heartbeats (its ``ps.pull`` / ``ps.commit`` spans are the round
        #: trips the worker sees)
        self.tracer: Optional[SpanTracer] = None
        #: monotonic clock of the previous commit — the heartbeat-gap
        #: source (``gap_s``)
        self._last_commit_mono: Optional[float] = None
        self._gap_s: Optional[float] = None
        #: memory-watermark sampling at the heartbeat points: ``mem.*``
        #: gauges + ``live_bytes`` on every heartbeat record (on a card)
        self.profile_memory = bool(profile_memory)

    def set_data(self, xs, ys):
        self.xs, self.ys = xs, ys

    def set_stream(self, factory: Callable, n_windows: int):
        """Disk-streaming data source: ``factory(epoch) -> iterator`` of
        ``(wx, wy)`` window tuples, each ``(window, batch, ...)``.  The
        worker streams its OWN shard partition instead of holding the
        epoch in RAM."""
        self._stream_factory = factory
        self._stream_windows = int(n_windows)

    def _put(self, x):
        """One window's host batch on the worker's device."""
        t = torch.from_numpy(np.asarray(x))
        return t.to(self.device) if self.device is not None else t

    def _make_client(self):
        """One PS connection — or, when ``port`` is a LIST of shard
        ports, a ``ShardedPSClient`` fanning this worker's traffic across
        the fleet with consistent-cut pulls (its plan derived from the
        replica's own tensors).  Either way the worker loop drives the
        same pull/commit surface."""
        if isinstance(self.ps_port, (list, tuple)):
            return ShardedPSClient(
                [(self.ps_host, p) for p in self.ps_port],
                template=self.variables, worker_id=self.worker_id,
                codec=self.comm_codec, tracer=self.tracer,
                generation=self.generation, down=self.comm_down,
                shm=self.shm or None)
        return PSClient(self.ps_host, self.ps_port, self.worker_id,
                        codec=self.comm_codec, tracer=self.tracer,
                        generation=self.generation, down=self.comm_down,
                        shm=self.shm or None)

    def run(self):
        try:
            # built HERE so the thread-local trace id binds to the worker's
            # own thread (__init__ runs on the spawning thread)
            self.tracer = SpanTracer(self.metrics)
            self.tracer.set_trace_id(f"w{self.worker_id}")
            self._last_commit_mono = time.monotonic()
            client = self._make_client()
            try:
                self._train(client)
            finally:
                client.close()
        except WorkerEvicted:
            # eviction notice, not a failure: the supervisor's replacement
            # owns this worker id — wind down without burning the slice
            self.evicted = True
        except BaseException as e:  # surfaced by the runner after join()
            self.error = e

    def _commit_gap(self) -> float:
        """Monotonic seconds since this worker's previous commit — the
        per-window heartbeat gap shipped on the commit RPC.  The first
        window measures from loop start."""
        now = time.monotonic()
        self._gap_s = now - self._last_commit_mono
        self._last_commit_mono = now
        return self._gap_s

    @staticmethod
    def _link_ewma(client) -> Optional[float]:
        """The client's link RTT EWMA — the largest across a sharded
        client's connections (the slowest link gates the fan-out)."""
        link = getattr(client, "link", None)
        if link is not None:
            return link.ewma
        subs = getattr(client, "clients", None)
        if subs:
            ewmas = [c.link.ewma for c in subs if c.link.ewma is not None]
            return max(ewmas) if ewmas else None
        return None

    def _train(self, client: PSClient):
        self._client = client
        stream = getattr(self, "_stream_factory", None)
        n_windows = self._stream_windows if stream is not None \
            else int(self.xs.shape[0])
        total = self.num_epoch * n_windows
        try:
            if stream is not None:
                self._stream_epochs(client, stream, n_windows, total)
            else:
                for gw in range(self.start_window, total):
                    wi = gw % n_windows  # window within the epoch
                    self._is_last_window = gw == total - 1
                    losses = self._window(client, self._put(self.xs[wi]),
                                          self._put(self.ys[wi]))
                    self.window_losses.append((gw, _to_host(losses)))
                    self._heartbeat(gw, n_windows)
        finally:
            # per-epoch view for the COMPLETE epochs this run covered —
            # built even on a crash so a retried worker's merge keeps the
            # epochs this attempt finished
            by_epoch: dict = {}
            for gw, l in self.window_losses:
                by_epoch.setdefault(gw // n_windows, []).append(l)
            self.epoch_losses = {e: np.stack(ls)
                                 for e, ls in by_epoch.items()
                                 if len(ls) == n_windows}
            self.losses = [self.epoch_losses[e]
                           for e in sorted(self.epoch_losses)]

    def _stream_epochs(self, client: PSClient, factory: Callable,
                       n_windows: int, total: int):
        """Epoch loop over streamed windows; a resumed worker fast-forwards
        its first epoch's iterator to the window its commits reached."""
        gw = self.start_window
        while gw < total:
            epoch = gw // n_windows
            it = factory(epoch)
            try:
                skip = gw % n_windows
                for _ in range(skip):
                    next(it)
                for _ in range(skip, n_windows):
                    wx, wy = next(it)
                    self._is_last_window = gw == total - 1
                    losses = self._window(client, self._put(wx),
                                          self._put(wy))
                    self.window_losses.append((gw, _to_host(losses)))
                    self._heartbeat(gw, n_windows)
                    gw += 1
            finally:
                if hasattr(it, "close"):
                    it.close()

    def _heartbeat(self, gw: int, n_windows: int) -> None:
        """One liveness record per committed window into the shared sink,
        with the window's mean loss and the monotonic ``gap_s``."""
        if self.metrics is None:
            return
        _, losses = self.window_losses[-1]
        extra = {}
        if self.profile_memory and self.device is not None:
            snap = obs_profile.observe_memory(self.device)
            if snap is not None:
                extra["live_bytes"] = snap["live_bytes"]
        link = self._link_ewma(getattr(self, "_client", None))
        if link is not None:
            extra["link_rtt_s"] = float(link)
        self.metrics.log("heartbeat", worker_id=self.worker_id, window=gw,
                         epoch=gw // n_windows, gap_s=self._gap_s,
                         mean_loss=float(np.mean(losses)), **extra)

    def _run_window(self, wx, wy):
        self.opt_state, losses = self.window_fn(self.opt_state, wx, wy)
        return losses

    def _window(self, client: PSClient, wx, wy):
        raise NotImplementedError


class _PullFirstWorker(AsyncWorker):
    """Shared loop shape of the pull-first family (DOWNPOUR / ADAG /
    DynSGD): pull center -> train a window from it -> commit the delta.

    With ``pull_overlap`` the loop becomes dispatch-ahead:

    1. queue window k's device work (the window loop reads nothing back);
    2. ``pull_begin()`` — window k+1's center transfer starts NOW;
    3. copy window k's result to the host (this waits for the card, the
       time that hides the transfer) and build the delta;
    4. ``pull_join()`` — the reply has usually landed by now;
    5. commit window k.

    The wire order per connection stays the strict split-phase contract
    (pull request, pull reply, commit request, commit reply); the cost is
    one window of self-staleness."""

    def _commit_kw(self, seen_updates) -> dict:
        """Extra commit kwargs derived from the pull (DynSGD's
        ``last_update``)."""
        return {}

    def _window(self, client, wx, wy):
        if self._next_center is not None:
            center, seen = self._next_center
            self._next_center = None
        else:
            pulled = client.pull()
            center, seen = pulled[0], pulled[1]
        _load(self.variables, center)
        losses = self._run_window(wx, wy)
        overlap = self.pull_overlap and not self._is_last_window
        if overlap:
            # window k+1's pull rides the wire while the card runs
            client.pull_begin()
        after = _host(self.variables)
        delta = _tree_sub(after, center)
        if overlap:
            nxt = client.pull_join()
            self._next_center = (nxt[0], nxt[1])
        client.commit(delta, **self._commit_kw(seen),
                      gap_s=self._commit_gap())
        return losses


def _tree_sub(after: Tree, center: Tree) -> Tree:
    """``after − center`` leafwise on the host (numpy)."""
    leaves, unflatten = tree_flatten(after)
    centers = tree_flatten(center)[0]
    return unflatten([a - np.asarray(c) for a, c in zip(leaves, centers)])


class PullCommitWorker(_PullFirstWorker):
    """DOWNPOUR / ADAG: local model is replaced by the pulled center each
    window; the commit is the accumulated local update Δ = θ_after −
    θ_pulled (the server's rule decides scaling)."""


class StalenessWorker(_PullFirstWorker):
    """DynSGD: like PullCommitWorker but the commit reports the server
    update counter observed at pull time (staleness bookkeeping)."""

    def _commit_kw(self, seen_updates):
        return {"last_update": seen_updates}


class ElasticWorker(AsyncWorker):
    """AEASGD / EAMSGD: local model persists (exploration); every window the
    elastic force E = α(local − center) is applied locally and committed."""

    def __init__(self, *args, alpha: float = 0.05, **kw):
        super().__init__(*args, **kw)
        self.alpha = float(alpha)

    def _window(self, client, wx, wy):
        losses = self._run_window(wx, wy)
        center, _ = client.pull()
        local = _host(self.variables)
        # elastic force on floating leaves only; integer/bool state
        # commits a zero delta (the server skips it anyway) and stays
        # worker-local, dtype intact
        leaves, unflatten = tree_flatten(local)
        centers = tree_flatten(center)[0]
        elastic = [self.alpha * (l - np.asarray(c)) if _inexact(l)
                   else np.zeros_like(l) for l, c in zip(leaves, centers)]
        _load(self.variables,
              unflatten([l - e for l, e in zip(leaves, elastic)]))
        client.commit(unflatten(elastic), gap_s=self._commit_gap())
        return losses
