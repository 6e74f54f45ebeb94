"""Worker-side PS client: one persistent connection, pull/commit calls —
the port of ``distkeras_tpu.ps.client``, speaking the same wire.

Parity with the reference's worker-side socket usage (reference
``distkeras/workers.py:NetworkWorker.pull``/``commit``): full center down,
delta up, at communication-window boundaries — with the fast path
layered on:

* **wire negotiation** — a ``hello`` handshake on connect picks the
  newest frame format both ends speak (v2 zero-copy scatter-gather when
  the server is current, v1 msgpack blobs against old servers, which
  answer ``hello`` with an unknown-action error we treat as "v1 only");
* **pull caching** — ``pull`` reports the update counter of the center
  this client already holds; the server answers ``unchanged`` without
  re-shipping the center when no commits landed, and the cached copy is
  returned (the caller must treat pulled trees as read-only, which the
  workers' replace-style updates already do);
* **delta codecs** — an optional ``ps.codecs`` codec compresses commit
  payloads (int8/bf16/top-k with worker-side error feedback); encode
  latency and bytes saved land in this client's registry;
* **DOWN compression** — ``down=`` requests quantized pulls:
  the server encodes each center as a residual against a shared
  reference this connection acknowledges by epoch (full resync on the
  first pull, after an epoch roll, and for every fresh incarnation —
  a respawned worker's new client starts reference-less, so a stale
  reference can never decode garbage).  ``down="adaptive"`` runs a
  per-link :class:`~.codecs.AdaptiveDownPolicy` choosing the codec from
  this client's measured pull RTTs, with hysteresis and a recorded
  ``ps.codec.switches`` trail;
* **shared-memory transport** — ``shm=True`` offers a same-host data
  plane in the hello: this
  client creates one ring per direction and the server acks only if it
  can actually attach them; v2 tensor segments then skip TCP entirely.
  Refused negotiations (cross-host peers, old servers) silently stay on
  TCP; this end owns the rings and unlinks them on close/reconnect;
* **streamed pulls** — on by default when the server acks the
  hello offer (``stream=False`` opts out): a fresh
  pull's reply arrives as self-describing chunk frames decoded as they
  land, and the split-phase ``pull_begin``/``pull_join`` surface lets a
  dispatch-ahead worker hide the whole transfer behind its device step —
  measured per pull into ``ps.pull.hidden_seconds`` and the running
  ``ps.pull.overlap_fraction`` gauge;
* **link quality** — every fresh pull/commit RTT feeds a
  per-link :class:`~..obs.stragglers.LinkQuality` EWMA pair whose
  degradation edge drives the adaptive policy's codec downshifts
  (recorded ``ps.link.downshifts``) and rides each commit as
  ``link_rtt_s`` for the server-side straggler detector's link table;
* **trace propagation** — with a ``tracer``, pull/commit run
  inside ``ps.pull``/``ps.commit`` spans and, on v2 connections, ship the
  open span's ``(trace_id, parent_span)`` as a ``trace`` header so the
  server's apply span links back to the worker window that caused it;
  ``commit(gap_s=...)`` additionally carries the worker's heartbeat gap
  for the server-side straggler detector.

Instrumented: every RPC observes its round-trip latency into a
``ps.client.rtt_seconds`` histogram and reconnect events count under
``ps.client.reconnects`` (process-wide default registry unless one is
passed — worker threads share a process, so the default aggregates the
whole worker pool).  Idempotent reads (``pull``/``stats``) transparently
reconnect-and-retry once on a broken connection; ``commit`` does NOT
auto-retry (the server may have applied the delta before the connection
died — resending would double-apply; the worker-level retry-once policy
owns that failure, as in the reference's Spark task retry).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

from ..obs import TIME_BUCKETS, LinkQuality, Registry, default_registry
from ..obs.logging import get_logger
from ..obs.spans import SpanTracer
from . import codecs
from .networking import (STREAM_CHUNK_BYTES, ShmChannel,
                         ShmRing, client_handshake, connect,
                         recv_msg, recv_pull, retry_with_backoff,
                         send_msg, shm_ring_mb)

#: direction-tagged wire counters: on the worker side, sends
#: are UP (commits/requests) and receives are DOWN (pulled centers)
_UP = "ps.wire.bytes_up"
_DOWN = "ps.wire.bytes_down"

#: streamed-pull chunk-size histogram buckets (bytes)
_CHUNK_BUCKETS = (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 21,
                  1 << 22, 1 << 23, 1 << 24)


class WorkerEvicted(RuntimeError):
    """The PS tombstoned this incarnation's commit (its generation was
    superseded by an eviction): a supervisor-spawned replacement
    owns the worker id now.  The worker loop exits cleanly on this; it is
    an eviction notice, not a failure."""


class PSClient:
    def __init__(self, host: str, port: int, worker_id: int = 0,
                 registry: Optional[Registry] = None,
                 codec=None, wire_version: Optional[int] = None,
                 tracer: Optional[SpanTracer] = None,
                 generation: int = 0, down=None,
                 shm: Optional[bool] = None,
                 stream: Optional[bool] = None,
                 stream_chunk_bytes: Optional[int] = None):
        self.worker_id = int(worker_id)
        #: commit generation this incarnation runs under:
        #: stamped on every commit so a post-eviction zombie's deltas
        #: tombstone server-side instead of double-applying
        self.generation = int(generation)
        self.host = host
        self.port = port
        self.registry = registry if registry is not None \
            else default_registry()
        self._h_rtt = self.registry.histogram("ps.client.rtt_seconds",
                                              TIME_BUCKETS)
        self._h_encode = self.registry.histogram("ps.codec.encode_seconds",
                                                 TIME_BUCKETS)
        self._c_reconnects = self.registry.counter("ps.client.reconnects")
        self._c_reconnect_failures = self.registry.counter(
            "ps.client.reconnect_failures")
        self._c_unchanged = self.registry.counter(
            "ps.client.pulls_unchanged")
        #: delta codec (``ps.codecs``) — owned here because its
        #: error-feedback residual is per-worker state
        self.codec = codecs.get_codec(codec)
        #: span tracer for cross-process trace propagation: when
        #: set, pull/commit RPCs run inside ``ps.pull``/``ps.commit`` spans
        #: and — on a v2 connection — ship ``(trace_id, parent_span)`` in a
        #: ``trace`` header so the server's apply span links back here.
        #: v1 peers simply never see the header (protocol untouched).
        self.tracer = tracer
        #: ``None`` negotiates (the default); ``1`` pins the legacy wire
        self._want_version = wire_version
        self.wire_version = 1
        #: client-side center cache: (center_tree, server_update_counter,
        #: version_vector_or_None, plan_epoch_or_None)
        self._last_pull: Optional[tuple] = None
        #: shard placement descriptor from the server's hello reply
        #: — None against a plain (un-sharded) server or on a
        #: v1 connection (no hello is sent)
        self.shard_info: Optional[dict] = None
        #: DOWN pull compression: the requested spec, whether
        #: the server acked it, the per-link adaptive policy (when
        #: ``down="adaptive"``), and the (epoch, tree) reference this
        #: connection last acknowledged — reset on every (re)connect so
        #: a fresh incarnation always resyncs
        self.down_spec = codecs.validate_down_spec(down)
        self.down_enabled = False
        self._down_policy: Optional[codecs.AdaptiveDownPolicy] = None
        self._down_ref: Optional[tuple] = None
        self._down_req: Optional[str] = None
        self._c_resyncs = self.registry.counter("ps.down.resyncs")
        self._h_down_decode = self.registry.histogram(
            "ps.down.decode_seconds", TIME_BUCKETS)
        #: same-host shared-memory transport: requested via
        #: the ``shm`` arg; active only after the server proves it can
        #: attach this client's rings
        self.shm_requested = bool(shm)
        self.shm_mb = shm_ring_mb()
        self.shm_active = False
        #: streamed pulls: on by default (``stream=False`` opts out),
        #: active only after the server acks the hello offer —
        #: old/pinned/disabled peers keep the monolithic reply,
        #: bit-identical on the wire
        self.stream_requested = True if stream is None else bool(stream)
        self.stream_chunk_bytes = int(stream_chunk_bytes) \
            if stream_chunk_bytes is not None else STREAM_CHUNK_BYTES
        self.stream_enabled = False
        self._c_streams = self.registry.counter("ps.pull.streams")
        self._c_stream_chunks = self.registry.counter(
            "ps.pull.stream_chunks")
        self._h_chunk_bytes = self.registry.histogram(
            "ps.pull.chunk_bytes", _CHUNK_BUCKETS)
        #: overlap accounting: how much of each fresh pull's
        #: wall time passed BEFORE this end started waiting on the reply
        #: (= transfer hidden behind whatever the caller did between
        #: ``pull_send`` and ``pull_finish`` — the worker's device step)
        self._h_hidden = self.registry.histogram("ps.pull.hidden_seconds",
                                                 TIME_BUCKETS)
        self._g_overlap = self.registry.gauge("ps.pull.overlap_fraction")
        self._hidden_total = 0.0
        self._pull_wall_total = 0.0
        #: per-link RTT EWMAs with a degradation edge — feeds
        #: the adaptive DOWN policy's downshift/reprobe schedule and
        #: rides every commit as ``link_rtt_s`` for the server-side
        #: straggler detector's link table
        self.link = LinkQuality(registry=self.registry)
        #: bounded receive-arena pool for streamed pulls:
        #: steady state reuses the previous-but-one pull's arena once
        #: its leaves died, so a streaming client performs zero large
        #: allocations per pull
        self._pull_scratch: list = []
        self._chan = None
        self.sock = connect(host, port)
        self._handshake()

    def _make_rings(self) -> Optional[tuple]:
        """(c2s, s2c) rings for the shm offer, or None when creation
        fails (no /dev/shm, quota) — the connection then stays TCP."""
        try:
            size = max(1 << 20, int(self.shm_mb * (1 << 20)))
            c2s = ShmRing.create(size)
            try:
                s2c = ShmRing.create(size)
            except OSError:
                c2s.unlink()
                c2s.close()
                raise
            return c2s, s2c
        except OSError as e:
            get_logger("ps.client").warning(
                "cannot create shared-memory rings (%s); staying on TCP", e)
            return None

    def _handshake(self) -> None:
        """Negotiate the wire format for this connection (the shared
        ``networking.client_handshake`` seam — serve clients run the same
        exchange).  A shard front-end's hello reply additionally carries
        its placement descriptor (``shard``: index / num_shards / plan
        epoch / plan digest), captured here so the sharded
        client can verify agreement at negotiation time; plain servers
        leave it None.  The DOWN-codec advertisement
        and the shm ring offer — ride the same hello, included only when
        requested so the default handshake stays byte-identical."""
        extras: dict = {}
        if self.down_spec != "none":
            extras["down"] = {"codecs": list(codecs.DOWN_CODECS)}
        rings = None
        pinned = self._want_version
        if self.stream_requested and (pinned is None or pinned >= 2):
            extras["stream"] = {"chunk_bytes": self.stream_chunk_bytes}
        if self.shm_requested and (pinned is None or pinned >= 2):
            # a v1-pinned connection sends no hello: creating (and
            # immediately unlinking) 2 x shm_mb of /dev/shm per dial
            # would be pure waste
            rings = self._make_rings()
            if rings is not None:
                extras["shm"] = {"c2s": rings[0].name, "s2c": rings[1].name,
                                 "size": rings[0].size}
        info: dict = {}
        try:
            self.wire_version = client_handshake(
                self.sock, registry=self.registry, worker_id=self.worker_id,
                want=self._want_version, info=info,
                extras=extras or None)
        except BaseException:
            if rings is not None:
                for r in rings:
                    r.unlink()
                    r.close()
            raise
        self.shard_info = info.get("shard")
        self._down_ref = None
        self.down_enabled = (self.down_spec != "none"
                             and self.wire_version >= 2
                             and bool((info.get("down") or {}).get("ok")))
        self.stream_enabled = (self.stream_requested
                               and self.wire_version >= 2
                               and bool((info.get("stream") or {}).get("ok")))
        if self.down_enabled and self.down_spec == "adaptive" \
                and self._down_policy is None:
            # the policy survives reconnects: its EWMAs describe the
            # LINK, which is the same network path either way (the
            # LinkQuality edge rides along for the same reason)
            self._down_policy = codecs.AdaptiveDownPolicy(self.registry,
                                                          link=self.link)
        self.shm_active = False
        self._chan = self.sock
        if rings is not None:
            if (info.get("shm") or {}).get("ok"):
                self._chan = ShmChannel(self.sock, tx=rings[0], rx=rings[1])
                self.shm_active = True
            else:
                # refused (cross-host server, old server): this end owns
                # the segments — destroy them now, not at GC
                for r in rings:
                    r.unlink()
                    r.close()

    def _teardown_shm(self) -> None:
        if isinstance(self._chan, ShmChannel):
            self._chan.close_rings(unlink=True)
        self._chan = self.sock
        self.shm_active = False

    def reconnect(self, attempts: int = 6, base_delay: float = 0.1,
                  max_delay: float = 2.0) -> None:
        """Drop the (possibly broken) connection and dial again (the
        replacement server may be older/newer: re-negotiate).  The pull
        cache is dropped too — a RESTARTED server's update counter can
        coincide with the cached one while its center differs, and an
        ``unchanged`` answer would then silently serve the old server's
        center.

        Retries the whole dial + handshake up to ``attempts`` times with
        capped exponential backoff + jitter (a PS
        restart takes seconds, and a fleet re-dialing in lockstep is a
        thundering herd); each failed attempt counts under
        ``ps.client.reconnect_failures``, the final one re-raises."""
        self._teardown_shm()  # dead connection's rings: unlink now
        try:
            self.sock.close()
        except OSError:
            pass
        self._last_pull = None

        def dial():
            # one dial per attempt: the backoff (not connect's own
            # fixed-cadence retry loop) paces the re-dials
            self.sock = connect(self.host, self.port, retries=1)
            self._chan = self.sock
            self._handshake()

        retry_with_backoff(dial, attempts, base_delay, max_delay,
                           self._c_reconnect_failures.inc,
                           f"reconnect to {self.host}:{self.port}",
                           "ps.client")
        self._c_reconnects.inc()

    def _rpc(self, msg: dict, retry: bool = False) -> Any:
        """One framed request/response, rtt observed.  ``retry=True``
        reconnects and resends once on a dead connection — only safe for
        idempotent reads."""
        t0 = time.perf_counter()
        try:
            send_msg(self._chan, msg, registry=self.registry,
                     version=self.wire_version, count_as=_UP)
            resp = recv_msg(self._chan, registry=self.registry,
                            count_as=_DOWN)
        except (ConnectionError, OSError):
            if not retry:
                raise
            self.reconnect()
            send_msg(self._chan, msg, registry=self.registry,
                     version=self.wire_version, count_as=_UP)
            resp = recv_msg(self._chan, registry=self.registry,
                            count_as=_DOWN)
        self._h_rtt.observe(time.perf_counter() - t0)
        return resp

    @staticmethod
    def _raise_on_error(what: str, resp: dict) -> None:
        """Server error replies ({"ok": False, "error": ...} from a
        failed dispatch) raise instead of being misread as data."""
        if isinstance(resp, dict) and resp.get("error") is not None:
            raise RuntimeError(f"ps {what} failed on the server: "
                               f"{resp['error']}")

    def _span(self, name: str):
        """``ps.pull``/``ps.commit`` client span, or a no-op scope when no
        tracer is attached (spans must never be a hard dependency)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, worker=self.worker_id)

    def _trace_header(self) -> Optional[dict]:
        """``(trace_id, parent_span)`` of the currently-open client span —
        the cross-process link the server's apply span adopts.  Only on v2
        connections: the header is this build's protocol extension, and v1
        is the frozen legacy surface old servers parse."""
        if self.tracer is None or self.wire_version < 2:
            return None
        trace_id, span_id = self.tracer.context()
        hdr = {"trace_id": trace_id}
        if span_id is not None:
            hdr["parent_span"] = span_id
        return hdr

    def pull(self) -> tuple:
        """Returns ``(center_tree, server_update_counter)``.  Carries the
        counter of the center already held so an idle server answers
        ``unchanged`` instead of re-shipping megabytes."""
        center, updates, _, _ = self.pull_versioned()
        return center, updates

    # -- split-phase protocol ------------------------------------
    # The request/reply halves of pull and commit as separate calls, so a
    # sharded client PIPELINES a fan-out on one thread: send every
    # shard's request first (each shard starts decoding/applying while
    # the later sends are still in flight), then collect the replies.  A
    # thread-per-shard fan-out pays GIL contention and pool dispatch per
    # RPC; the pipeline pays one pass of sends and one of receives.

    def _pull_msg(self, have=None, min_updates=None) -> dict:
        # one assembly point so protocol keys (like the trace header)
        # can never be added to one request shape and missed on another
        msg = {"action": "pull", "worker_id": self.worker_id}
        trace = self._trace_header()
        if trace is not None:
            msg["trace"] = trace
        if have is not None:
            msg["have"] = have
        if min_updates is not None:
            msg["min_updates"] = int(min_updates)
        if self.down_enabled:
            codec = self._down_policy.next_codec() \
                if self._down_policy is not None else self.down_spec
            self._down_req = codec
            d: dict = {"codec": codec}
            if self._down_ref is not None:
                d["ref_epoch"] = int(self._down_ref[0])
            msg["down"] = d
        if self.stream_enabled:
            msg["stream"] = {"chunk_bytes": self.stream_chunk_bytes}
        return msg

    def pull_send(self, min_updates: Optional[int] = None) -> None:
        """Phase 1 of a pull: the request goes out (with the cached
        counter as ``have``); :meth:`pull_finish` must be the next call
        on this connection.  ``min_updates`` asks the server to briefly
        wait until its counter reaches that value before serving — the
        consistent-cut retry hint (old servers ignore it)."""
        self._t_pull = time.perf_counter()
        have = self._last_pull[1] if self._last_pull is not None else None
        send_msg(self._chan, self._pull_msg(have, min_updates),
                 registry=self.registry, version=self.wire_version,
                 count_as=_UP)

    def pull_finish(self) -> tuple:
        """Phase 2 of a pull: ``(center, updates, version_vector,
        plan_epoch)``.  Against a shard front-end the reply carries the
        shard's per-worker commit counts (the version vector a
        consistent-cut pull compares across shards) and its plan epoch;
        plain servers leave both None.  An ``unchanged`` answer reuses
        the cached center/vv/epoch — they can only change when the
        counter does.

        A streamed reply is auto-detected per message: the
        chunks decode as they land (into the same zero-copy ``recv_into``
        buffers a monolithic v2 frame uses) and the per-chunk sizes feed
        ``ps.pull.stream_chunks`` / ``ps.pull.chunk_bytes``.  Every
        fresh pull also records how much of its wall time passed before
        this call started waiting (``ps.pull.hidden_seconds`` — the
        transfer a dispatch-ahead worker hid behind its device step) and
        the running ``ps.pull.overlap_fraction`` gauge."""
        t_wait = time.perf_counter()
        resp, chunks = recv_pull(self._chan, registry=self.registry,
                                 count_as=_DOWN,
                                 scratch=self._pull_scratch)
        # rtt_seconds keeps its "what this RPC cost the caller" meaning
        # under overlap: measured from the WAIT start, not the send — an
        # overlapped pull's device step must not read as wire latency
        # (identical to the old span for sequential pulls, where the
        # wait starts right after the send)
        self._h_rtt.observe(time.perf_counter() - t_wait)
        self._raise_on_error("pull", resp)
        updates = int(resp["updates"])
        if resp.get("unchanged"):
            # unchanged replies are codec-free and near-instant: never
            # fold their RTT into the adaptive policy's per-codec EWMAs
            # (nor the link EWMA — a no-payload RTT would bias the
            # degradation baseline toward zero)
            if self._last_pull is not None:
                self._c_unchanged.inc()
                return (self._last_pull[0], updates,
                        self._last_pull[2], self._last_pull[3])
            # the cache was invalidated mid-exchange (a reconnect dropped
            # it, but a stale ``have`` was resent): ask again
            # unconditionally for the full center
            send_msg(self._chan, self._pull_msg(), registry=self.registry,
                     version=self.wire_version, count_as=_UP)
            resp, chunks = recv_pull(self._chan, registry=self.registry,
                                     count_as=_DOWN,
                                     scratch=self._pull_scratch)
            self._raise_on_error("pull", resp)
            updates = int(resp["updates"])
        center = self._decode_down(resp)
        t_done = time.perf_counter()
        if chunks is not None:
            self._c_streams.inc()
            self._c_stream_chunks.inc(len(chunks))
            for n in chunks:
                self._h_chunk_bytes.observe(n)
        # overlap accounting over fresh pulls only: hidden = in-flight
        # time before this end blocked on the reply
        hidden = max(0.0, t_wait - self._t_pull)
        total = max(t_done - self._t_pull, 1e-9)
        self._h_hidden.observe(hidden)
        self._hidden_total += hidden
        self._pull_wall_total += total
        self._g_overlap.set(self._hidden_total / self._pull_wall_total)
        # the link/codec EWMAs are fed the VISIBLE wait (blocked ->
        # decoded), never send->decoded: for a sequential pull the two
        # coincide, but an overlapped pull's span includes the caller's
        # whole device step — folding that in would read healthy links
        # as degraded, downshift codecs for no wire reason, and report
        # compute time as link RTT.  The visible wait is exactly the
        # pull's critical-path cost in either mode, so the EWMAs stay
        # comparable and a degraded link still shows (more bytes left
        # to drain after compute).
        wait_s = max(t_done - t_wait, 1e-9)
        self.link.observe_pull(wait_s)
        if self._down_policy is not None and self._down_req is not None:
            # measured to AFTER decode: the per-codec EWMAs must fold in
            # this end's decode cost, or a heavy-decode codec looks
            # cheaper than it is end to end
            self._down_policy.observe(
                (resp.get("down") or {}).get("codec", "none")
                if isinstance(resp.get("down"), dict) else "none",
                wait_s)
        vv = resp.get("vv")
        if isinstance(vv, dict):
            vv = {int(k): int(v) for k, v in vv.items()}
        epoch = resp.get("plan_epoch")
        self._last_pull = (center, updates, vv, epoch)
        return center, updates, vv, epoch

    def _decode_down(self, resp: dict):
        """The pulled center: raw (``center`` key — v1 peers, down
        disabled, or the adaptive policy picked "none") or decoded from
        the DOWN residual against this connection's acknowledged
        reference.  A ``reference``-carrying reply is a full
        resync: adopt it AND the epoch; a residual-only reply for an
        epoch this connection does not hold is a protocol desync and
        fails loudly rather than decode against the wrong reference."""
        down = resp.get("down")
        if not isinstance(down, dict):
            return resp["center"]
        t0 = time.perf_counter()
        epoch = int(down["ref_epoch"])
        ref = down.get("reference")
        if ref is not None:
            self._down_ref = (epoch, ref)
            self._c_resyncs.inc()
        elif self._down_ref is None or self._down_ref[0] != epoch:
            raise RuntimeError(
                f"ps pull: server encoded against reference epoch "
                f"{epoch} but this connection holds "
                f"{None if self._down_ref is None else self._down_ref[0]}")
        center = codecs.apply_ref_delta(self._down_ref[1], down["residual"])
        codecs.count_codec_bytes(
            self.registry, codecs.tree_payload_bytes(center),
            codecs.tree_payload_bytes(down["residual"])
            + (codecs.tree_payload_bytes(ref) if ref is not None else 0),
            prefix="ps.down")
        self._h_down_decode.observe(time.perf_counter() - t0)
        return center

    def pull_versioned(self) -> tuple:
        """The full pull protocol in one call (transparently reconnects
        and retries once on a dead connection — an idempotent read)."""
        with self._span("ps.pull"):
            try:
                self.pull_send()
                return self.pull_finish()
            except (ConnectionError, OSError):
                self.reconnect()
                self.pull_send()
                return self.pull_finish()

    # -- overlapped pulls ----------------------------------------
    def pull_begin(self, min_updates: Optional[int] = None) -> None:
        """Phase 1 of an OVERLAPPED pull, with the idempotent-read
        reconnect: the dispatch-ahead worker issues this right after its
        device step is dispatched, so the center transfer rides the wire
        while the device computes; :meth:`pull_join` collects it."""
        try:
            self.pull_send(min_updates)
        except (ConnectionError, OSError):
            self.reconnect()
            self.pull_send(min_updates)

    def pull_join(self) -> tuple:
        """Phase 2 of an overlapped pull (same return shape as
        :meth:`pull_finish`); a connection that died mid-flight — a
        mid-stream reset included — reconnects via the standard backoff
        and re-pulls: a pull is an idempotent read, so the retry can
        never double-apply anything."""
        try:
            return self.pull_finish()
        except (ConnectionError, OSError):
            self.reconnect()
            self.pull_send()
            return self.pull_finish()

    def commit_send(self, delta: Any, last_update: Optional[int] = None,
                    gap_s: Optional[float] = None) -> None:
        """Phase 1 of a commit: codec-encode and ship the delta;
        :meth:`commit_finish` must be the next call on this
        connection."""
        if not self.codec.is_identity:
            t0 = time.perf_counter()
            raw = codecs.tree_payload_bytes(delta)
            delta = self.codec.encode(delta)
            codecs.count_codec_bytes(self.registry, raw,
                                     codecs.tree_payload_bytes(delta))
            self._h_encode.observe(time.perf_counter() - t0)
        msg = {"action": "commit", "worker_id": self.worker_id,
               "gen": self.generation,
               "delta": delta, "codec": self.codec.name}
        trace = self._trace_header()
        if trace is not None:
            msg["trace"] = trace
        if gap_s is not None:
            msg["gap_s"] = float(gap_s)
        link_rtt = self.link.ewma
        if link_rtt is not None:
            # the link half of the straggler picture:
            # harmless extra keys to old servers, like gap_s
            msg["link_rtt_s"] = float(link_rtt)
            if self._down_policy is not None and \
                    self._down_policy.downshifts:
                msg["link_downshifts"] = int(self._down_policy.downshifts)
        if last_update is not None:
            msg["last_update"] = int(last_update)
        self._t_commit = time.perf_counter()
        send_msg(self._chan, msg, registry=self.registry,
                 version=self.wire_version, count_as=_UP)

    def commit_finish(self) -> bool:
        """Phase 2 of a commit: True when applied, False when a fault
        injector dropped it; an eviction notice raises
        :class:`WorkerEvicted`."""
        resp = recv_msg(self._chan, registry=self.registry, count_as=_DOWN)
        dt = time.perf_counter() - self._t_commit
        self._h_rtt.observe(dt)
        self.link.observe_commit(dt)
        # a server-side apply failure answers {"ok": False, "error"}
        # (it did NOT apply the delta) — that must surface as a
        # failure to the worker's retry policy, never as success
        self._raise_on_error("commit", resp)
        if resp.get("evicted"):
            # the PS tombstoned this commit: a newer incarnation owns
            # the worker id — this one's loop must wind down
            raise WorkerEvicted(
                f"worker {self.worker_id} generation "
                f"{self.generation} evicted by the PS")
        return not resp.get("dropped", False)

    def commit(self, delta: Any, last_update: Optional[int] = None,
               gap_s: Optional[float] = None) -> bool:
        """Commit a delta; returns False if a fault injector dropped it.
        A non-identity codec compresses the payload here (error-feedback
        residual updated as a side effect) — the server decodes
        statelessly from the per-leaf stubs.  Never auto-retries (the
        server may have applied the delta before a connection died).

        ``gap_s`` is the worker's monotonic gap since its previous window
        commit — the heartbeat signal the server-side straggler detector
        folds in; harmless extra key to old servers."""
        with self._span("ps.commit"):
            self.commit_send(delta, last_update=last_update, gap_s=gap_s)
            return self.commit_finish()

    def invalidate(self) -> None:
        """Drop the client-side center cache: the next pull ships a full
        center even at an unchanged counter (reconnect does this
        implicitly; callers use it after out-of-band center changes —  a
        restored checkpoint — and the pull-heavy bench phase uses it to
        measure fresh-pull RTTs).  The DOWN reference is kept: it is
        per-connection wire state, still valid for residual decode."""
        self._last_pull = None

    def stats(self) -> dict:
        """Poll the server's live telemetry: ``{"stats": <registry
        snapshot>, "num_updates": int, "commits_by_worker": dict, ...}`` —
        no center transfer, safe to call while training runs."""
        return self._rpc({"action": "stats", "worker_id": self.worker_id},
                         retry=True)

    def ship_telemetry(self, delta: dict, *, source: str) -> dict:
        """Push one ``snapshot_delta`` increment frame to the server's
        telemetry aggregator.  Never auto-retries: a frame
        the server may already have folded would double-count on replay
        — the shipper keeps unacked increments in its next frame
        instead."""
        return self._rpc({"action": "telemetry",
                          "worker_id": self.worker_id,
                          "source": str(source), "delta": delta},
                         retry=False)

    def close(self) -> None:
        try:
            # over the negotiated channel: a shm server answers even the
            # stop ack on the ring
            send_msg(self._chan, {"action": "stop"},
                     registry=self.registry, version=self.wire_version)
            recv_msg(self._chan, registry=self.registry)
        except (ConnectionError, OSError):
            pass
        finally:
            # this end created the shm segments: destroy them on the
            # shutdown path, after the stop
            # exchange so the server's handler is already done with them
            self._teardown_shm()
            try:
                self.sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
