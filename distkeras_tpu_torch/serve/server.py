"""TCP front-end for the decode service (the port of
``distkeras_tpu.serve.server``: the same actions, replies and wire, so a
client of either package drives a server of either package).

Speaks the PS wire (``ps.networking`` framing — v2 zero-copy tensor
segments with per-connection v1/v2 hello negotiation) on the shared
``networking.FrameServer`` frame (the accept loop, handler-thread
bookkeeping and stop sequencing).  Every request is one framed msgpack
map with an ``action`` key:

* ``hello``    — wire-format negotiation (``FrameServer``).
* ``generate`` — ``{"prompt": int32 array, "max_new_tokens": int?,
  "temperature": float?, "top_k": int?, "top_p": float?}`` ->
  ``{"ok": True, "tokens": int32 array, ...timings}`` or a load-shed
  ``{"ok": False, "rejected": True, "reason": ...}`` (admission control)
  or ``{"ok": False, "error": ...}`` for malformed requests.  Prompt and
  tokens ride as tensors — zero-copy on v2 connections.  The sampling
  keys are per-request overrides of the engine defaults; old servers
  ignore them, per the wire's extension contract.
* ``stats``    — live registry snapshot + queue/slot state, no decode
  work: the poll path of the router's health checks.
* ``promote``  — ``{"variables": tree}`` -> checkpoint hot-swap via
  ``engine.promote()``: the JAX package's ``variables`` tree of numpy
  arrays (the cross-process deploy seam; the tree rides the v2
  zero-copy frame), turned into the engine's weights through
  ``utils.weights.load_jax_variables``.  A tree that does not match the
  serving model's answers ``{"ok": False, "error": ...}`` — the decode
  loop never sees it.
* ``drain``    — start a graceful drain (admission closes, in-flight
  completes); idempotent.  ``undrain`` reopens admission.
* ``kv_fetch`` / ``kv_push`` — the fleet KV fabric's export and import
  of cached prefix KV (``serve/kvfabric.py``).
* ``stop``     — close THIS connection (``FrameServer``).

``stop(drain=True)`` (default, also the context-manager exit) closes the
listener, drains the engine — every in-flight request completes, every
request refused after the drain began is a recorded rejection — then
closes live connections.
"""

from __future__ import annotations

import copy
import socket
import time
from typing import Optional

import numpy as np

from ..utils.weights import load_jax_variables
from ..ps.networking import (REPLY_SENT, STREAM_CHUNK_BYTES,
                             WIRE_VERSION, FrameServer, pack_stream,
                             send_stream)
from .engine import DecodeEngine, ServeRejected


class ServeServer(FrameServer):
    """Accept loop + per-connection handlers over a ``DecodeEngine``,
    on the shared TCP front-end frame.

    The engine's registry is the server's too (``serve.connections`` and
    the wire byte counts land beside the SLO histograms), so one
    ``stats`` reply describes the whole service."""

    metric_prefix = "serve"

    def __init__(self, engine: DecodeEngine, host: str = "127.0.0.1",
                 port: int = 0, max_wire_version: int = WIRE_VERSION):
        super().__init__(engine.registry, host=host, port=port,
                         max_wire_version=max_wire_version)
        self.engine = engine
        # stop() parameters stashed for the frame's drain hook
        self._stop_drain = True
        self._stop_timeout: Optional[float] = None

    # -- lifecycle hooks ----------------------------------------------------
    def _on_start(self) -> None:
        if self.engine._thread is None:
            self.engine.start()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Shut down: close the listener first (no NEW connections), then
        drain the engine (in-flight generates complete and their replies
        go out), then unblock idle handlers by closing live sockets."""
        self._stop_drain = bool(drain)
        self._stop_timeout = timeout
        super().stop()

    def _before_close_connections(self) -> None:
        self.engine.stop(drain=self._stop_drain, timeout=self._stop_timeout)
        # let handlers flush replies for requests the drain just
        # completed before their sockets are pulled out from under them
        deadline = time.monotonic() + 5.0
        while self._g_inflight.value > 0 and time.monotonic() < deadline:
            time.sleep(0.01)

    # -- request handlers ---------------------------------------------------
    def _stats_reply(self) -> dict:
        eng = self.engine
        with eng._lock:
            queued = len(eng._queue)
            draining = eng._draining
        return {"stats": self.registry.snapshot(),
                "server": type(self).__name__,
                "model": getattr(eng.model, "name", "?"),
                "slots": eng._b,
                "seq_len": eng._t,
                "prefill_buckets": list(eng._buckets),
                "queue_depth": queued,
                "active_slots": eng._active_count(),
                "draining": bool(draining)}

    def _handle_generate(self, msg: dict) -> dict:
        prompt = msg.get("prompt")
        if prompt is None:
            return {"ok": False, "error": "generate needs a prompt"}
        try:
            req = self.engine.submit(np.asarray(prompt),
                                     msg.get("max_new_tokens"),
                                     temperature=msg.get("temperature"),
                                     top_k=msg.get("top_k"),
                                     top_p=msg.get("top_p"))
        except ServeRejected as e:
            return {"ok": False, "rejected": True, "reason": e.reason}
        except (ValueError, TypeError) as e:
            return {"ok": False, "error": str(e)}
        req.wait()
        if req.error is not None:
            # aborted mid-flight (hard stop): already counted under
            # serve.rejected by the engine
            return {"ok": False, "rejected": True, "reason": req.error}
        reply = {"ok": True,
                 "tokens": np.asarray(req.tokens, np.int32),
                 "e2e_s": req.done_t - req.submit_t}
        if req.admit_t is not None:
            reply["queue_wait_s"] = req.admit_t - req.submit_t
        if req.first_token_t is not None:
            reply["ttft_s"] = req.first_token_t - req.submit_t
        if req.warm is not None:
            # the admit-time prefix-cache outcome: the router
            # splits its spill TTFT histograms on this — a spill that
            # warm-joined proves the fabric replicated in time.  Old
            # clients ignore the key, per the wire's extension contract
            reply["warm"] = bool(req.warm)
        return reply

    def _handle_promote(self, msg: dict) -> dict:
        """Checkpoint hot-swap over the wire — the deploy seam a
        cross-process continual trainer promotes through.  The JAX
        ``variables`` tree loads into a copy of the serving model
        (``load_jax_variables`` checks its structure and shapes), whose
        state dict the engine validates and adopts."""
        variables = msg.get("variables")
        if variables is None:
            return {"ok": False, "error": "promote needs a variables tree"}
        try:
            shadow = copy.deepcopy(self.engine.model)
            load_jax_variables(shadow, variables)
            self.engine.promote(shadow.state_dict())
        except (ValueError, TypeError, KeyError) as e:
            # a mismatched tree is a BAD REQUEST: answer it, don't hand
            # the decode thread state it would crash on
            return {"ok": False, "error": str(e)}
        return {"ok": True,
                "promotions":
                    int(self.engine._c_promotions.value)}

    def _handle_kv_fetch(self, msg: dict, ver: int, conn) -> object:
        """Export cached prefix KV for the fleet fabric: the longest
        entry matching ``prompt`` (replication-on-spill), or the
        ``hottest`` MRU entries within ``budget_bytes`` (migration).  On
        a v2 connection the reply — megabytes of KV — rides the ``DKW4``
        chunked stream frame (the PS's streamed pull path, reused): the
        peer decodes chunk k while k+1 is in flight, landing the leaves
        in its pooled receive arena.  v1 peers get the same document
        monolithic."""
        if not self.engine.config.kv_fabric:
            return {"ok": False, "error": "kv fabric disabled"}
        hottest = msg.get("hottest")
        if hottest is not None:
            doc = self.engine.kv_export_hottest(
                int(hottest),
                int(msg.get("budget_bytes") or 64 * 1024 * 1024))
        else:
            prompt = msg.get("prompt")
            if prompt is None:
                return {"ok": False,
                        "error": "kv_fetch needs a prompt or hottest"}
            doc = self.engine.kv_export(np.asarray(prompt))
        reply = {"ok": True, "found": doc is not None,
                 "entries": (doc or {}).get("entries", []),
                 "version": (doc or {}).get(
                     "version", self.engine.kv_version)}
        if ver >= 2 and doc is not None:
            send_stream(
                conn, pack_stream(reply, STREAM_CHUNK_BYTES, version=ver),
                registry=self.registry,
                count_as=f"{self.metric_prefix}.wire.bytes_down",
                action="kv_fetch_stream")
            return REPLY_SENT
        return reply

    def _handle_kv_push(self, msg: dict) -> dict:
        """Admit peer-exported KV entries stamped with a checkpoint
        ``version``.  Every entry either joins through the
        version-guarded ``serve.kvfabric`` seam or is refused with a
        reason — a stale stamp is refused, never joined."""
        if not self.engine.config.kv_fabric:
            return {"ok": False, "error": "kv fabric disabled"}
        entries = msg.get("entries")
        if not entries:
            return {"ok": False, "error": "kv_push needs entries"}
        version = msg.get("version")
        if version is None:
            return {"ok": False,
                    "error": "kv_push needs a version stamp"}
        joined = refused_stale = refused_other = 0
        reason = None
        for doc in entries:
            ok, why = self.engine.kv_import(doc, int(version))
            if ok:
                joined += 1
            elif why == "stale":
                refused_stale += 1
            else:
                refused_other += 1
                reason = why
        reply = {"ok": True, "joined": joined,
                 "refused_stale": refused_stale,
                 "refused": refused_stale + refused_other}
        if reason is not None:
            reply["reason"] = reason
        return reply

    def handle_request(self, action, msg: dict, ver: int,
                       conn: socket.socket):
        """Serve protocol body on the shared frame (``hello``/``stop``/
        errors live in ``FrameServer``)."""
        if action == "generate":
            return self._handle_generate(msg)
        if action == "stats":
            return self._stats_reply()
        if action == "promote":
            return self._handle_promote(msg)
        if action == "drain":
            drained = self.engine.drain(timeout=msg.get("timeout_s"))
            return {"ok": True, "drained": drained}
        if action == "undrain":
            # scale-up seam: reopen admission on a parked
            # (drained-but-running) engine
            try:
                was = self.engine.undrain()
            except RuntimeError as e:
                return {"ok": False, "error": str(e)}
            return {"ok": True, "was_draining": was}
        if action == "kv_fetch":
            return self._handle_kv_fetch(msg, ver, conn)
        if action == "kv_push":
            return self._handle_kv_push(msg)
        return None
