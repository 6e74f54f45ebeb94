"""Client for the decode service (the port of
``distkeras_tpu.serve.client``) — one persistent connection speaking the
shared PS wire framing, hello-negotiated v1/v2 per connection exactly
like ``PSClient`` (the ``networking.client_handshake`` seam).  A wire
version is pinned only by the ``wire_version`` argument: the port reads
no environment override.

``generate()`` returns the server's reply dict verbatim — ``ok`` True
with an int32 ``tokens`` array (zero-copy on v2 connections) and the
server-side timings, or ``ok`` False with either ``rejected`` (the
admission controller load-shed — an OPERATIONAL outcome the caller
handles, not an exception) or ``error`` (a malformed request).  The
client observes its own SLO view: ``serve.client.e2e_seconds`` per
generate round-trip, ``serve.client.requests`` / ``serve.client.rejected``
counters.

``stats()`` transparently reconnects-and-retries once (idempotent read);
``generate`` does NOT auto-retry — the server may have admitted (and be
decoding) the request even though the connection died, and a resend
would double-spend slots.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np

from ..obs import TIME_BUCKETS, Registry, default_registry
from ..ps.networking import (client_handshake, connect, recv_msg,
                             recv_pull, retry_with_backoff, send_msg)


class ServeClient:
    def __init__(self, host: str, port: int,
                 registry: Optional[Registry] = None,
                 wire_version: Optional[int] = None,
                 connect_retries: int = 20,
                 connect_timeout: float = 30.0):
        self.host = host
        self.port = port
        #: dial retries / per-attempt connect timeout before the
        #: constructor raises — the router dials with small values so a
        #: dead engine costs milliseconds per probe and a PARTITIONED
        #: one (SYNs blackholed) seconds, not the default client
        #: patience
        self.connect_retries = max(1, int(connect_retries))
        self.connect_timeout = float(connect_timeout)
        self.registry = registry if registry is not None \
            else default_registry()
        self._h_e2e = self.registry.histogram("serve.client.e2e_seconds",
                                              TIME_BUCKETS)
        self._c_requests = self.registry.counter("serve.client.requests")
        self._c_rejected = self.registry.counter("serve.client.rejected")
        self._c_reconnects = self.registry.counter(
            "serve.client.reconnects")
        self._c_reconnect_failures = self.registry.counter(
            "serve.client.reconnect_failures")
        #: ``None`` negotiates; ``1`` pins the legacy frame
        self._want_version = wire_version
        self.sock = connect(host, port, timeout=self.connect_timeout,
                            retries=self.connect_retries)
        self.wire_version = client_handshake(self.sock,
                                             registry=self.registry,
                                             want=self._want_version)
        #: pooled receive arenas for streamed ``kv_fetch`` replies (the
        #: DKW4 pull path) — steady-state fabric transfers
        #: reuse one buffer instead of allocating multi-MB per fetch
        self._kv_scratch: list = []

    def reconnect(self, attempts: int = 6, base_delay: float = 0.1,
                  max_delay: float = 2.0) -> None:
        """Re-dial + re-negotiate with capped exponential backoff +
        jitter (the same policy as ``PSClient``): a
        draining/restarting service takes seconds to come back, and a
        client pool re-dialing in lockstep is a thundering herd.  Each
        failed attempt counts under ``serve.client.reconnect_failures``;
        the final one re-raises."""
        try:
            self.sock.close()
        except OSError:
            pass

        def dial():
            self.sock = connect(self.host, self.port, retries=1)
            self.wire_version = client_handshake(
                self.sock, registry=self.registry,
                want=self._want_version)

        retry_with_backoff(dial, attempts, base_delay, max_delay,
                           self._c_reconnect_failures.inc,
                           f"reconnect to {self.host}:{self.port}",
                           "serve.client")
        self._c_reconnects.inc()

    def _rpc(self, msg: dict, retry: bool = False) -> Any:
        try:
            send_msg(self.sock, msg, registry=self.registry,
                     version=self.wire_version)
            return recv_msg(self.sock, registry=self.registry)
        except (ConnectionError, OSError):
            if not retry:
                raise
            self.reconnect()
            send_msg(self.sock, msg, registry=self.registry,
                     version=self.wire_version)
            return recv_msg(self.sock, registry=self.registry)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> dict:
        """One generation round-trip; blocks until the server finishes
        (or load-sheds) the request.  Returns the reply dict — check
        ``reply["ok"]``; on success ``reply["tokens"]`` holds the
        generated int32 ids.

        ``temperature`` / ``top_k`` / ``top_p`` ride the request and
        override the engine's defaults for THIS generation only;
        omitted params keep the service defaults.  Extra msgpack keys —
        old servers ignore them (and sample at their configured
        defaults), per the wire's extension contract."""
        msg: dict = {"action": "generate",
                     "prompt": np.asarray(prompt, np.int32).reshape(-1)}
        if max_new_tokens is not None:
            msg["max_new_tokens"] = int(max_new_tokens)
        if temperature is not None:
            msg["temperature"] = float(temperature)
        if top_k is not None:
            msg["top_k"] = int(top_k)
        if top_p is not None:
            msg["top_p"] = float(top_p)
        self._c_requests.inc()
        t0 = time.perf_counter()
        reply = self._rpc(msg)
        self._h_e2e.observe(time.perf_counter() - t0)
        if not reply.get("ok") and reply.get("rejected"):
            self._c_rejected.inc()
        return reply

    def stats(self, retry: bool = True) -> dict:
        """Poll the service's live telemetry (registry snapshot + queue/
        slot state) — no decode work, safe under load.  ``retry=False``
        skips the reconnect-and-retry (idempotent-read) path — the
        router's health poller probes with it so a dead engine costs one
        failed read, not a full backoff ladder."""
        return self._rpc({"action": "stats"}, retry=retry)

    def promote(self, variables) -> dict:
        """Hot-swap the service's serving weights with ``variables`` —
        the cross-process deploy seam: ``variables`` is the JAX
        package's tree of numpy arrays (``utils.to_numpy_variables``
        gives it for a port model), riding the v2 zero-copy tensor
        frame.  Returns the reply dict —
        ``{"ok": True, "promotions": n}`` or ``{"ok": False, "error"}``
        when the tree does not match the serving model.  No auto-retry:
        like ``generate``, the server may have adopted the tree even
        though the connection died, and a resend would double-promote."""
        return self._rpc({"action": "promote", "variables": variables})

    def kv_fetch(self, prompt=None, hottest: Optional[int] = None,
                 budget_bytes: Optional[int] = None) -> dict:
        """Pull cached prefix KV from the service for the fleet fabric:
        the longest cached entry matching ``prompt``
        (replication-on-spill), or the ``hottest`` MRU entries bounded
        by ``budget_bytes`` (migration off a draining engine).  Returns
        ``{"ok", "found", "entries", "version"}`` — on a v2 connection
        the reply arrives as a DKW4 chunked stream, its tensor leaves
        decoded zero-copy into this client's pooled receive arena
        (``recv_pull``, exactly the PS streamed-pull path).  No
        auto-retry: the fabric re-fetches on its next spill instead."""
        msg: dict = {"action": "kv_fetch"}
        if hottest is not None:
            msg["hottest"] = int(hottest)
            if budget_bytes is not None:
                msg["budget_bytes"] = int(budget_bytes)
        else:
            if prompt is None:
                raise ValueError("kv_fetch needs a prompt or hottest")
            msg["prompt"] = np.asarray(prompt, np.int32).reshape(-1)
        send_msg(self.sock, msg, registry=self.registry,
                 version=self.wire_version)
        doc, _ = recv_pull(self.sock, registry=self.registry,
                           scratch=self._kv_scratch)
        return doc

    def kv_push(self, entries, version: int) -> dict:
        """Push exported KV ``entries`` (``kv_fetch`` documents) to the
        service, stamped with the checkpoint ``version`` they were
        computed under.  The service joins each through its
        version-guarded fabric seam or refuses it — reply carries
        ``joined`` / ``refused_stale`` / ``refused`` counts.  No
        auto-retry (a reconnect-resend could double-push)."""
        return self._rpc({"action": "kv_push", "entries": list(entries),
                          "version": int(version)})

    def drain(self, timeout_s: Optional[float] = None,
              engine: Optional[str] = None) -> dict:
        """Ask the server to drain gracefully (idempotent).  Against a
        ``ServeRouter``, ``engine="host:port"`` names ONE backend for a
        planned drain (its hot KV migrates to survivors, then the
        victim drains and leaves rotation — the fleet keeps serving);
        without it the whole front door drains."""
        msg: dict = {"action": "drain"}
        if timeout_s is not None:
            msg["timeout_s"] = float(timeout_s)
        if engine is not None:
            msg["engine"] = str(engine)
        return self._rpc(msg)

    def undrain(self, engine: Optional[str] = None) -> dict:
        """Reopen admission on a parked (drained-but-running) service —
        the scale-UP seam, the inverse of single-engine
        ``drain``.  Against a ``ServeRouter``, ``engine="host:port"``
        names the parked backend to un-drain and re-adopt into
        rotation; against an engine server it un-drains that engine."""
        msg: dict = {"action": "undrain"}
        if engine is not None:
            msg["engine"] = str(engine)
        return self._rpc(msg)

    def close(self) -> None:
        try:
            send_msg(self.sock, {"action": "stop"}, registry=self.registry,
                     version=self.wire_version)
            recv_msg(self.sock, registry=self.registry)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
