"""Parameter servers — the port of ``distkeras_tpu.ps.servers`` (parity with
reference ``distkeras/parameter_servers.py``).

``SocketParameterServer`` owns the listen/accept loop (one handler thread
per connected worker, like the reference) and the mutex around commits; the
subclasses implement the per-commit update rules:

* ``DeltaParameterServer``   — center += delta (DOWNPOUR / AEASGD / EAMSGD)
* ``ADAGParameterServer``    — center += delta / num_workers
* ``DynSGDParameterServer``  — center += delta / (staleness + 1)

The center variable is a NumPy tree on the host (the reference's was a
Keras weight list) — the JAX ``variables`` tree's structure, so centers,
checkpoints and the wire are interchangeable with the JAX package's.  A ``fault_injector`` hook can drop or delay commits — the test
harness the reference never had (SURVEY.md §5.3).

Instrumented end to end: every server owns an ``obs.Registry``
(commit/pull counters, apply-latency histogram, per-worker staleness
histograms, connection/in-flight gauges, wire byte counts), and
``SocketParameterServer`` answers a ``stats`` action with a full registry
snapshot plus ground-truth counters — a running PS is pollable live
(``PSClient.stats()`` / ``scripts/obsview.py --ps host:port``).
"""

from __future__ import annotations

import collections
import contextlib
import socket
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ..obs import COUNT_BUCKETS, TIME_BUCKETS, Registry, StragglerDetector
from ..obs.spans import SpanTracer
from ..parallel.sync import _inexact
from ..utils.tree import tree_flatten
from ..utils import native
from . import codecs
from .networking import (MIN_STREAM_CHUNK_BYTES, REPLY_SENT,
                         STREAM_CHUNK_BYTES, WIRE_VERSION, FrameServer,
                         pack_stream, send_packed, send_stream)
from .state import DeltaDecoder, DownRefState, LivenessTable, PullCache

Tree = Any


def _tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` leafwise over same-structured trees, dicts rebuilt with
    sorted keys as ``jax.tree_util.tree_map`` builds them (so a pulled
    center's bytes match the JAX package's)."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])


def _tree_fused_add(center: Tree, delta: Tree, scale: float) -> Tree:
    """center + scale·delta leaf-wise via the native data plane
    (``native/dknative.cpp``) — one fused multithreaded pass per leaf, GIL
    released; NumPy fallback.  Returns NEW arrays (replace semantics keep
    the lock-free pull/checkpoint snapshots race-free).

    Floating leaves only: integer/bool variable state (e.g. Keras
    SeedGenerator counters) has no meaningful delta arithmetic — the
    center keeps its value (mirrors the sync engine's window-edge rule)."""
    return _tree_map(
        lambda c, d: native.fused_add(np.asarray(c), np.asarray(d), scale)
        if _inexact(c) else np.asarray(c),
        center, delta)


class ParameterServer:
    """Base (reference ``ParameterServer``): holds the center variable and
    the update counter.  Optionally checkpoints the center every
    ``checkpoint_every`` commits (SURVEY.md §5.4 — persistence the
    reference lacked).

    Fleet lifecycle: every worker id carries a **generation** —
    bumped by :meth:`evict_worker` when the supervisor declares the
    incarnation dead.  A commit stamped with a stale generation is
    **tombstoned**: counted (``ps.commits_tombstoned``), never applied —
    so a SIGCONT'd zombie or a delayed socket can never double-apply a
    window its replacement already re-trained.  Respawns and elastic
    joins register through :meth:`register_respawn` /
    :meth:`register_join`, which hand back the exact window (= the
    per-worker commit count) the new incarnation resumes from."""

    def __init__(self, center: Tree, num_workers: int = 1,
                 checkpoint_manager=None, checkpoint_every: int = 0,
                 registry: Optional[Registry] = None):
        self.center = _tree_map(np.asarray, center)
        self.num_workers = int(num_workers)
        self.num_updates = 0
        #: per-worker commit counts — exact resume bookkeeping: commit k of
        #: worker w IS window k of worker w (one commit per communication
        #: window), so a restored snapshot tells each worker exactly which
        #: window to continue from (SURVEY.md §5.4).
        self.commits_by_worker: dict = {}
        #: fleet lifecycle state, every touch under ``mutex``:
        #: worker -> current commit generation (evictions bump it) and the
        #: per-worker eviction/respawn/join/tombstone tallies the live
        #: ``stats`` RPC surfaces
        self.generations: dict = {}
        self.tombstoned_by_worker: dict = {}
        self.evictions_by_worker: dict = {}
        self.respawns_by_worker: dict = {}
        self.joins_by_worker: dict = {}
        self.mutex = threading.Lock()
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_every = int(checkpoint_every)
        #: component-scoped instruments: a ``stats`` snapshot describes
        #: exactly THIS server (a shared/default registry would fold every
        #: in-process component into the reply)
        self.registry = registry if registry is not None else Registry()
        self._c_commits = self.registry.counter("ps.commits")
        self._c_pulls = self.registry.counter("ps.pulls")
        self._c_tombstoned = self.registry.counter("ps.commits_tombstoned")
        self._c_evictions = self.registry.counter("ps.evictions")
        self._c_respawns = self.registry.counter("ps.respawns")
        self._c_joins = self.registry.counter("ps.joins")
        self._h_apply = self.registry.histogram("ps.apply_seconds",
                                                TIME_BUCKETS)
        #: time commits spend WAITING for the mutex: the
        #: single-lock convoy the contention sweep measures, directly —
        #: ``ps.apply_seconds`` is the hold time, this is the queue
        self._h_lock_wait = self.registry.histogram(
            "ps.lock_wait_seconds", TIME_BUCKETS)

    # -- update rule (subclass responsibility) ------------------------------
    def apply_commit(self, delta: Tree, meta: dict) -> None:
        """Apply one commit to the center.  Contract: ``handle_commit``
        calls this with ``self.mutex`` held — implementations read and
        replace shared state without re-locking.  Implementations fold
        :meth:`_commit_scale` into their update so a down-weighted
        straggler's delta lands scaled."""
        raise NotImplementedError

    @staticmethod
    def _commit_scale(meta: dict) -> float:
        """Flag-aware down-weighting multiplier the front-end attached
        (``commit_weight`` — 1.0 for healthy workers); every update rule
        multiplies its own scale by this."""
        return float(meta.get("commit_weight", 1.0))

    def handle_commit(self, delta: Tree, meta: dict) -> bool:
        """Apply one commit; returns True when applied, False when the
        commit's generation is stale (a tombstoned zombie commit)."""
        snapshot = None
        t0 = time.perf_counter()
        with self.mutex:
            self._h_lock_wait.observe(time.perf_counter() - t0)
            w = meta.get("worker_id")
            if w is not None:
                w = int(w)
                if int(meta.get("gen", 0)) < self.generations.get(w, 0):
                    # stale incarnation: its replacement already owns this
                    # window range — record, never apply
                    self.tombstoned_by_worker[w] = \
                        self.tombstoned_by_worker.get(w, 0) + 1
                    self._c_tombstoned.inc()
                    return False
            self.apply_commit(delta, meta)
            self.num_updates += 1
            if w is not None:
                self.commits_by_worker[w] = self.commits_by_worker.get(w, 0) + 1
            if (self.checkpoint_manager is not None and self.checkpoint_every
                    and self.num_updates % self.checkpoint_every == 0):
                # capture the reference only; commits replace (never mutate)
                # the center tree, so serializing outside the lock is safe
                # and pulls/commits don't stall on the disk write
                snapshot = (self.center, self.num_updates,
                            dict(self.commits_by_worker))
        # lock-held time IS the apply latency workers contend on
        self._h_apply.observe(time.perf_counter() - t0)
        self._c_commits.inc()
        if snapshot is not None:
            center, n, by_worker = snapshot
            self.checkpoint_manager.save(
                n, center, {"num_updates": n,
                            "commits_by_worker": by_worker})
        return True

    # -- fleet lifecycle ------------------------------------------
    def evict_worker(self, worker_id) -> int:
        """Declare worker ``worker_id``'s current incarnation dead: bump
        its generation so any late commit from it tombstones.  Returns the
        window its commits reached — the replacement's exact resume
        point."""
        w = int(worker_id)
        with self.mutex:
            self.generations[w] = self.generations.get(w, 0) + 1
            self.evictions_by_worker[w] = \
                self.evictions_by_worker.get(w, 0) + 1
            window = self.commits_by_worker.get(w, 0)
        self._c_evictions.inc()
        return window

    def register_respawn(self, worker_id) -> tuple:
        """A replacement incarnation for an evicted worker: returns
        ``(start_window, generation)`` it must run under."""
        w = int(worker_id)
        with self.mutex:
            self.respawns_by_worker[w] = self.respawns_by_worker.get(w, 0) + 1
            out = (self.commits_by_worker.get(w, 0),
                   self.generations.get(w, 0))
        self._c_respawns.inc()
        return out

    def register_join(self, worker_id) -> tuple:
        """Elastic join: a worker id joining the live run (never seen, or
        returning after a completed run).  Returns ``(start_window,
        generation)`` — the same resume contract as a respawn."""
        w = int(worker_id)
        with self.mutex:
            self.joins_by_worker[w] = self.joins_by_worker.get(w, 0) + 1
            out = (self.commits_by_worker.get(w, 0),
                   self.generations.get(w, 0))
        self._c_joins.inc()
        return out

    def fleet_snapshot(self) -> dict:
        """Plain-data fleet lifecycle state; caller holds ``mutex``."""
        return {"generations": dict(self.generations),
                "tombstoned_by_worker": dict(self.tombstoned_by_worker),
                "evictions_by_worker": dict(self.evictions_by_worker),
                "respawns_by_worker": dict(self.respawns_by_worker),
                "joins_by_worker": dict(self.joins_by_worker)}

    def restore(self, checkpoint_manager) -> bool:
        """Load the latest center checkpoint; returns True if restored."""
        if checkpoint_manager.latest_step() is None:
            return False
        with self.mutex:
            self.center, meta = checkpoint_manager.restore(self.center)
            self.num_updates = int(meta.get("num_updates", 0))
            self.commits_by_worker = {
                int(k): int(v)
                for k, v in (meta.get("commits_by_worker") or {}).items()}
        return True

    def pull(self) -> tuple:
        self._c_pulls.inc()
        with self.mutex:
            return self.center, self.num_updates

    def pull_versioned(self) -> tuple:
        """``(center, num_updates, commits_by_worker)`` captured under ONE
        mutex hold — the shard front-end's pull source: the per-worker
        commit counts are the **version vector** a sharded client compares
        across shards to detect a torn cut, so they must be atomic with
        the center they describe."""
        self._c_pulls.inc()
        with self.mutex:
            return (self.center, self.num_updates,
                    {int(k): int(v) for k, v in self.commits_by_worker.items()})

    def stats(self) -> dict:
        """Registry snapshot + ground-truth counters — the payload the
        socket front-end returns for a ``stats`` request."""
        with self.mutex:
            num_updates = self.num_updates
            by_worker = dict(self.commits_by_worker)
            fleet = self.fleet_snapshot()
        return {"stats": self.registry.snapshot(),
                "num_updates": num_updates,
                "commits_by_worker": by_worker,
                "fleet": fleet,
                "server": type(self).__name__,
                "num_workers": self.num_workers}

    def get_model(self) -> Tree:
        """Parity: reference ``ParameterServer.get_model``."""
        with self.mutex:
            return self.center


class DeltaParameterServer(ParameterServer):
    """center += delta.  Serves DOWNPOUR (delta = accumulated local update,
    i.e. θ_after − θ_pulled) and the EASGD family (delta = elastic force E).
    Parity: reference ``DeltaParameterServer``."""

    def apply_commit(self, delta, meta):
        self.center = _tree_fused_add(self.center, delta,
                                      self._commit_scale(meta))


class ADAGParameterServer(ParameterServer):
    """center += delta / num_workers — the accumulated-gradient commit
    normalized by worker count (parity: reference ``ADAGParameterServer``;
    upstream README's recommended algorithm)."""

    def apply_commit(self, delta, meta):
        self.center = _tree_fused_add(self.center, delta,
                                      self._commit_scale(meta)
                                      / self.num_workers)


class DynSGDParameterServer(ParameterServer):
    """Staleness-aware commits (parity: reference ``DynSGDParameterServer``):
    the worker reports the update counter it last pulled at; staleness =
    current counter − reported; center += delta / (staleness + 1).

    ``staleness_seen`` keeps the most recent commits' staleness (bounded —
    the unbounded list leaked on long-lived servers); the full-run
    distribution lives in the registry's merged ``ps.staleness`` histogram
    plus per-worker ``ps.staleness.worker<k>`` histograms (surfaced as
    ``trainer.ps_stats`` after training and via the ``stats`` RPC live)."""

    #: recent-commit window kept verbatim (tail inspection / tests); the
    #: histograms carry the complete, bounded-memory distribution
    staleness_keep = 4096

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.staleness_seen: collections.deque = collections.deque(
            maxlen=self.staleness_keep)
        self._h_staleness = self.registry.histogram("ps.staleness",
                                                    COUNT_BUCKETS)
        #: worker id -> Histogram, cached so the mutex-held apply path
        #: skips the registry's name-format + lock on every commit
        self._h_by_worker: dict = {}

    def _worker_hist(self, w: int):
        h = self._h_by_worker.get(w)
        if h is None:
            # labeled per-worker series; flattens to the
            # legacy ps.staleness.worker<k> name
            h = self._h_by_worker[w] = self.registry.histogram(
                "ps.staleness", COUNT_BUCKETS, labels={"worker": w})
        return h

    def apply_commit(self, delta, meta):
        staleness = max(0, self.num_updates - int(meta.get("last_update", 0)))
        self.staleness_seen.append(staleness)
        self._h_staleness.observe(staleness)
        w = meta.get("worker_id")
        if w is not None:
            self._worker_hist(int(w)).observe(staleness)
        # staleness- AND flag-aware: a flagged straggler's
        # commit is scaled by both rules at once
        self.center = _tree_fused_add(self.center, delta,
                                      self._commit_scale(meta)
                                      / (staleness + 1))


class SocketParameterServer(FrameServer):
    """TCP front-end: accept loop + one handler thread per worker connection
    (parity: reference ``SocketParameterServer.run``/``handle_connection``),
    on the shared ``networking.FrameServer`` frame.

    Protocol: each request is one framed msgpack map with an ``action`` key
    (``hello`` / ``pull`` / ``commit`` / ``stats`` / ``stop``); every
    request gets a response.  ``stats`` returns the PS registry snapshot +
    ground-truth counters without touching the center — the live-poll path
    (``PSClient.stats()``, ``scripts/obsview.py --ps``).

    Fast path: ``hello`` negotiates the frame format per
    connection (v2 zero-copy scatter-gather; clients that never say hello
    stay on v1, so old workers keep working); ``pull`` answers
    ``unchanged`` — no center payload — when the client already holds the
    current center, and otherwise serves a **pre-serialized center
    payload** cached per (update counter, wire version): the center is
    encoded once per commit, not once per pull (safe because commits
    replace, never mutate, the center arrays the cached v2 frames
    reference); ``commit`` decodes ``ps.codecs`` deltas statelessly.

    Observability: commits carrying a ``trace`` header get their
    ``ps.apply`` span parented on the committing worker's span (the
    cross-process timeline); commits carrying ``gap_s`` feed the
    heartbeat-gap straggler detector, whose ``ps.stragglers`` gauge and
    snapshot ride the ``stats`` reply.

    DOWN compression: a pull request carrying a ``down`` map
    (``{"codec": spec, "ref_epoch": held}``) gets the center as a
    quantized residual against the shared :class:`~.state.DownRefState`
    reference — ONE snapshot per ``down_ref_every`` counters, so the
    reference state stays O(1) per front-end however many connections
    pull.  An epoch mismatch (first pull, respawned incarnation,
    reference rolled) serves a full **resync** payload carrying the
    reference verbatim.  Encoded payloads cache under composite
    ``(ver, codec, epoch, resync)`` keys — anything that changes the
    bytes without bumping the counter is in the key, so an adaptive
    link switching codecs can never be served a stale pre-serialized
    payload.  Requests without ``down`` (v1 peers, ``comm_down="none"``)
    take the plain raw path, bit-identical on the wire.

    Streamed pulls: a pull request carrying a ``stream`` map on
    a stream-negotiated connection gets its reply as a ``DKW4`` chunk
    stream — the same reply document (raw or DOWN-compressed), split
    into plan-ordered leaf groups and cached as pre-serialized chunk
    payloads under a composite ``(ver, "stream", chunk_bytes, ...)`` key
    (single-flight per chunk shape), so a cold fleet pays one
    serialization per chunk.  The client decodes chunk k while chunk
    k+1 is on the wire and dispatches its window the moment the final
    chunk lands.  Requests without ``stream`` (v1 peers,
    stream-disabled clients or servers) take the
    exact monolithic path, bit-identical on the wire.
    """

    metric_prefix = "ps"

    def __init__(self, ps: ParameterServer, host: str = "127.0.0.1",
                 port: int = 0,
                 fault_injector: Optional[Callable[[str, dict], bool]] = None,
                 max_wire_version: int = WIRE_VERSION,
                 tracer: Optional[SpanTracer] = None,
                 straggler_detector: Optional[StragglerDetector] = None,
                 down_ref_every: int = 64,
                 stream: Optional[bool] = None):
        #: front-end instruments live in the PS's registry so one snapshot
        #: covers update rules AND wire traffic
        super().__init__(ps.registry, host=host, port=port,
                         max_wire_version=max_wire_version)
        self.ps = ps
        self.fault_injector = fault_injector
        #: server-side span tracer: when set, every commit apply
        #: runs inside a ``ps.apply`` span that ADOPTS the trace context a
        #: v2 client shipped in the request (``trace_id``/``parent_span``)
        #: — the cross-process link obsview's timeline renders.  None keeps
        #: the handler span-free (no sink, no overhead).
        self.tracer = tracer
        #: heartbeat-gap straggler detector fed from the commit RPC's
        #: ``gap_s`` field; publishes the ``ps.stragglers`` gauge into the
        #: PS registry so the live ``stats`` RPC carries it
        self.stragglers = straggler_detector if straggler_detector \
            is not None else StragglerDetector(registry=ps.registry)
        #: composable center-state layer (``ps.state``): pre-serialized
        #: pull cache,
        #: per-worker liveness stamps, codec decode — each a standalone
        #: component so a shard fleet hosts one SET per shard instead of
        #: N copies of this class's internals
        self._pull_cache = PullCache(ps.registry)
        self._liveness = LivenessTable()
        self._decode_delta = DeltaDecoder(ps.registry)
        #: DOWN-compression reference center: one shared
        #: epoch-stamped snapshot per ``down_ref_every`` counters
        self._down_ref = DownRefState(ps.registry,
                                      refresh_every=down_ref_every)
        self._h_down_encode = ps.registry.histogram(
            "ps.down.encode_seconds", TIME_BUCKETS)
        self._c_down_resyncs = ps.registry.counter("ps.down.resyncs_served")
        self._c_requests = ps.registry.counter("ps.commit_requests")
        self._c_dropped = ps.registry.counter("ps.commits_dropped")
        self._c_unchanged = ps.registry.counter("ps.pulls_unchanged")
        #: streamed-pull serving: opt-out per server; counters
        #: pre-created so 0 is present in every snapshot, streamed or not
        self.stream = True if stream is None else bool(stream)
        self._c_streams = ps.registry.counter("ps.pull.streams")
        self._c_stream_chunks = ps.registry.counter("ps.pull.stream_chunks")

    def _remote_span(self, name: str, msg: dict):
        """Server-side span adopting the requester's trace context (the
        ``trace`` header a v2 client ships on commit/pull).  No tracer —
        or an untraced request on ``serve_pull`` — means no span at all:
        v1 peers and span-free servers pay nothing."""
        if self.tracer is None:
            return contextlib.nullcontext()
        trace = msg.get("trace")
        if not isinstance(trace, dict):
            if name != "ps.apply":
                return contextlib.nullcontext()
            trace = {}
        fields = {"worker": msg.get("worker_id")}
        if trace.get("trace_id") is not None:
            fields["trace_id"] = trace["trace_id"]
        if trace.get("parent_span") is not None:
            fields["parent_span"] = trace["parent_span"]
        return self.tracer.span(name, **fields)

    def last_seen_age(self, worker_id) -> Optional[float]:
        """Seconds since this worker's last commit/pull; None if it never
        reached the server — the supervisor's liveness source."""
        return self._liveness.age(worker_id)

    def _commit_weight(self, worker_id) -> float:
        """Down-weighting multiplier for this commit (self-healing rung 1),
        every CHANGE recorded as a ``ps.commit_weight.worker<k>`` gauge —
        the restore to 1.0 when the flag clears included."""
        if worker_id is None:
            return 1.0
        w = int(worker_id)
        weight = self.stragglers.commit_weight(w)
        if self._liveness.weight_changed(w, weight):
            self.ps.registry.gauge("ps.commit_weight",
                                   labels={"worker": w}).set(weight)
        return weight

    # -- pull state seam -----------------------------------------
    def _pull_state(self) -> tuple:
        """``(center, updates, extra_reply_fields)`` for one pull.  The
        shard front-end overrides this to add its version vector and plan
        epoch — the consistent-cut pull's raw material — without
        re-implementing the cache/unchanged protocol."""
        center, updates = self.ps.pull()
        return center, updates, {}

    def hello_reply(self, msg: dict, ver: int) -> dict:
        """A DOWN-advertising hello is acked with the codec
        families this server can encode; v1 connections and plain hellos
        get the unchanged reply — the advertisement is the client's
        opt-in, so the default handshake stays byte-identical."""
        reply = super().hello_reply(msg, ver)
        if ver >= 2 and isinstance(msg.get("down"), dict):
            reply["down"] = {"ok": True, "codecs": list(codecs.DOWN_CODECS)}
        if ver >= 2 and self.stream and isinstance(msg.get("stream"), dict):
            reply["stream"] = {"ok": True}
        return reply

    def _pull_doc(self, msg: dict, ver: int, center, updates: int,
                  extra: dict) -> tuple:
        """``(shape_key, build)`` for one pull's reply document — the
        payload-shape suffix of the cache key plus the builder the cache
        calls on miss.  ``()`` + a raw center doc for the plain path; a
        DOWN-compressed pull gets the ``(spec, epoch,
        resync)`` shape and the residual/resync builder.  ONE definition
        so the monolithic and streamed reply paths can never
        disagree on the document they serialize."""
        req = msg.get("down") if ver >= 2 else None
        spec = req.get("codec") if isinstance(req, dict) else None
        if not spec or spec == "none":
            return (), lambda: {"center": center, "updates": updates,
                                **extra}
        spec = str(spec)
        epoch, ref = self._down_ref.for_pull(center, updates)
        resync = req.get("ref_epoch") is None \
            or int(req["ref_epoch"]) != epoch
        if resync:
            # counted per REQUEST (a cached resync payload still resyncs
            # the connection it is served to), not per cache build
            self._c_down_resyncs.inc()

        def build() -> dict:
            t0 = time.perf_counter()
            residual = codecs.encode_ref_delta(center, ref, spec)
            enc = codecs.tree_payload_bytes(residual)
            down = {"codec": spec, "ref_epoch": epoch, "residual": residual}
            if resync:
                # the peer holds no (or a stale) reference: ship it
                # verbatim next to the residual so this pull decodes
                # exactly and the connection is synced for the next one
                down["reference"] = ref
                enc += codecs.tree_payload_bytes(ref)
            codecs.count_codec_bytes(self.ps.registry,
                                     codecs.tree_payload_bytes(center), enc,
                                     prefix="ps.down")
            self._h_down_encode.observe(time.perf_counter() - t0)
            return {"down": down, "updates": updates, **extra}

        # composite key: every input to the serialized bytes
        # besides the counter — codec, reference epoch, resync shape —
        # so a codec-state change without a counter bump can never be
        # served a stale pre-serialized payload
        return (spec, epoch, resync), build

    def _pull_payloads(self, msg: dict, ver: int, center, updates: int,
                       extra: dict) -> tuple:
        """``(parts_or_payload, streamed)`` for one fresh pull — the
        streamed chunk list when this request negotiated + asked for
        streaming, else the monolithic pre-serialized payload
        (bit-identical to the pre-streaming wire)."""
        shape, build = self._pull_doc(msg, ver, center, updates, extra)
        req = msg.get("stream") if ver >= 2 and self.stream else None
        if isinstance(req, dict):
            cb = max(MIN_STREAM_CHUNK_BYTES,
                     int(req.get("chunk_bytes") or STREAM_CHUNK_BYTES))

            def build_parts() -> tuple:
                doc = build()
                down = doc.get("down") or {}
                return (pack_stream(doc, cb, version=ver),
                        doc.get("center", down.get("reference")))

            parts = self._pull_cache.payload_parts(
                (ver, "stream", cb, *shape), updates, build_parts,
                owner=self.ps)
            self._c_streams.inc()
            self._c_stream_chunks.inc(len(parts) - 1)
            return parts, True
        key = (ver, *shape) if shape else ver
        return self._pull_cache.payload(key, updates, build,
                                        owner=self.ps), False

    def handle_request(self, action, msg: dict, ver: int,
                       conn: socket.socket):
        """PS protocol body on the shared frame (``hello``/``stop``/
        errors live in ``FrameServer``)."""
        if action == "pull":
            with self._remote_span("ps.serve_pull", msg):
                self._liveness.touch(msg.get("worker_id"))
                have = msg.get("have")
                want = msg.get("min_updates")
                if want is not None:
                    # consistent-cut retry hint: the puller
                    # already knows the fleet has reached ``want``
                    # updates, so briefly wait for the in-flight applies
                    # to land HERE rather than shipping a slice the
                    # client will discard as torn and re-request
                    deadline = time.perf_counter() + 0.05
                    while (self.ps.num_updates < int(want)
                           and self._running.is_set()
                           and time.perf_counter() < deadline):
                        time.sleep(0.0005)
                center, updates, extra = self._pull_state()
                if have is not None and int(have) == updates:
                    self._c_unchanged.inc()
                    return {"unchanged": True, "updates": updates, **extra}
                payload, streamed = self._pull_payloads(msg, ver, center,
                                                        updates, extra)
                down_counter = f"{self.metric_prefix}.wire.bytes_down"
                if streamed:
                    send_stream(conn, payload, registry=self.ps.registry,
                                count_as=down_counter)
                else:
                    send_packed(conn, payload, registry=self.ps.registry,
                                count_as=down_counter)
                return REPLY_SENT
        if action == "commit":
            # every commit REQUEST counts before any outcome branches, so
            # requests == applied + dropped + tombstoned always holds
            self._c_requests.inc()
            self._liveness.touch(msg.get("worker_id"))
            # liveness first: a dropped commit is still a heartbeat — the
            # fault injector models a lost UPDATE, not a dead worker
            if msg.get("gap_s") is not None:
                self.stragglers.record(msg.get("worker_id"),
                                       msg.get("gap_s"))
            if msg.get("link_rtt_s") is not None:
                # per-link RTT EWMA shipped next to the heartbeat gap
                #: the link-quality half of the straggler
                # picture — a stretched gap whose link stretched equally
                # is wire-degraded, not compute-stuck
                self.stragglers.record_link(msg.get("worker_id"),
                                            msg.get("link_rtt_s"),
                                            msg.get("link_downshifts"))
            dropped = bool(self.fault_injector and
                           self.fault_injector("commit", msg))
            applied = True
            if not dropped:
                weight = self._commit_weight(msg.get("worker_id"))
                if weight != 1.0:
                    msg["commit_weight"] = weight
                delta = self._decode_delta(msg)
                with self._remote_span("ps.apply", msg):
                    applied = self.ps.handle_commit(delta, msg)
            else:
                self._c_dropped.inc()
            reply = {"ok": True, "dropped": dropped}
            if not applied:
                # stale generation: tell the zombie it was evicted so it
                # can wind down instead of burning its slice forever
                reply["tombstoned"] = True
                reply["evicted"] = True
            return reply
        if action == "stats":
            reply = self.ps.stats()
            reply["stragglers"] = self.stragglers.snapshot()
            reply.setdefault("fleet", {})["last_seen_age_s"] = \
                self._liveness.ages()
            return reply
        return None
