"""Composable center-state components for PS front-ends — the port of
``distkeras_tpu.ps.state``: the pieces ``SocketParameterServer`` composes
instead of carrying them inline.

* :class:`PullCache` — pre-serialized pull replies keyed by **payload
  shape** — ``(wire version, DOWN codec, ref-epoch, resync)`` — built
  once per commit and served to every puller, with the never-regress
  rule (a racing handler must not replace a newer center with an older
  snapshot).  Anything that changes the payload without a counter bump
  (an adaptive link switching codec, a reference epoch rolling) lands
  on a different key, so a stale pre-serialized payload is never
  served.  The cache is the **publish point** of the lock-free
  pull-snapshot contract: once a center tree's buffers are handed to a
  cached v2 frame, commits must replace — never mutate — those arrays.
  :func:`set_publish_hook` lets a race checker observe every publish.
* :class:`DownRefState` — the DOWN-compression **reference center**:
  ONE shared snapshot per K counters (holding a center tree is free
  because commits replace, never mutate, its arrays), epoch-stamped so
  a peer holding a stale or absent reference is detected by epoch
  comparison and resynced with a full reference payload.
* :class:`LivenessTable` — monotonic last-seen stamps per worker (commit
  AND pull traffic both count) plus the last commit-weight gauge value,
  the supervisor's liveness source.
* :class:`DeltaDecoder` — stateless ``ps.codecs`` decode with the
  latency/byte accounting, per front-end.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..obs import TIME_BUCKETS
from . import codecs
from .networking import pack_msg

# ---------------------------------------------------------------------------
# publish-hook seam (a race checker's write-after-publish detector)
# ---------------------------------------------------------------------------

#: called as ``hook(owner, center_tree)`` every time a center tree's
#: buffers are handed to the pull cache (``owner`` identifies the
#: ParameterServer whose state was published).  None (the default) costs
#: one global read per cache build.
_publish_hook: Optional[Callable[[Any, Any], None]] = None


def set_publish_hook(hook):
    """Install (or clear, with None) the pull-cache publish observer;
    returns the previous hook so a checker can nest/restore."""
    global _publish_hook
    prev = _publish_hook
    _publish_hook = hook
    return prev


class PullCache:
    """Pre-serialized pull replies: payload-shape key -> ``(updates,
    payload)``.

    ``key`` is any hashable describing every input to the serialized
    bytes BESIDES the update counter — the wire version alone for raw
    pulls, ``(ver, codec, ref_epoch, resync)`` for DOWN-compressed ones
    (anything that changes the payload without bumping the
    counter MUST be in the key, or a stale pre-serialized payload gets
    served).  The payload is encoded OUTSIDE the cache lock so a slow
    big-model serialization never serializes concurrent pulls of an
    already-cached center; the never-regress rule keeps a racing handler
    from replacing a NEWER cached center with an older snapshot (which
    would hand a committed worker a pre-commit center on its next pull).
    A STREAMED pull's chunk payloads cache the same way —
    :meth:`payload_parts` stores the whole prologue+chunks list under
    one composite key (chunk bound included), single-flight across the
    shape's chunks, so a cold fleet pays one serialization per chunk.
    """

    def __init__(self, registry, prefix: str = "ps"):
        self._cache: dict = {}
        self._lock = threading.Lock()
        self._c_hits = registry.counter(f"{prefix}.pull_cache_hits")

    def payload(self, key, updates: int, doc_builder: Callable[[], dict],
                owner: Any = None):
        """The cached ``pack_msg`` payload for this (counter, payload
        shape), building (and publishing) it on miss.  ``doc_builder``
        returns the reply document — called only when the cache misses,
        so versioned extras (a shard's version vector) are captured
        exactly once per counter.

        Builds are **single-flight per key**: the first miss claims the
        key (an Event placeholder) and encodes outside the lock; racing
        pullers of the same (key, counter) wait on the claim and serve
        the finished payload as a hit — a cold fleet pays ONE multi-MB
        serialization per payload shape, not one per puller.  Builds for
        DIFFERENT keys still overlap."""
        ver = key[0] if isinstance(key, tuple) else key

        def build():
            doc = doc_builder()
            down = doc.get("down") or {}
            return (pack_msg(doc, version=ver),
                    doc.get("center", down.get("reference")))

        return self._cached(key, updates, build, owner)

    def payload_parts(self, key, updates: int,
                      parts_builder: Callable[[], tuple],
                      owner: Any = None):
        """Like :meth:`payload` but for a STREAMED pull reply:
        the cached value is the ordered LIST of packed payloads —
        prologue + one per chunk (``networking.pack_stream``'s output) —
        under ONE composite key, so the single-flight claim covers every
        chunk of the shape at once: a cold fleet pays one serialization
        per chunk, never one per puller per chunk.  ``parts_builder``
        returns ``(packed_parts, publish_tree)`` — the chunk payloads
        alias the center's buffers, so the publish contract is the same
        as :meth:`payload`'s."""
        return self._cached(key, updates, parts_builder, owner)

    def _cached(self, key, updates: int, build: Callable[[], tuple],
                owner: Any):
        """The single-flight / never-regress cache body both payload
        shapes share; ``build()`` returns ``(value, publish_tree)``."""
        my_evt = None
        while True:
            with self._lock:
                ent = self._cache.get(key)
                if ent is not None and ent[0] == updates and \
                        not isinstance(ent[1], threading.Event):
                    self._c_hits.inc()
                    return ent[1]
                if ent is not None and ent[0] == updates:
                    waiter = ent[1]  # same counter mid-build: wait
                else:
                    if ent is None or updates >= ent[0]:
                        # claim the build (never-regress holds: the
                        # placeholder carries OUR counter)
                        my_evt = threading.Event()
                        self._cache[key] = (updates, my_evt)
                    # else: an entry NEWER than this capture exists (a
                    # commit raced the pull) — build this handler's own
                    # snapshot uncached, claiming would regress
                    break
            # the timeout is a liveness backstop only (a builder thread
            # killed uncleanly); the loop re-reads either way
            waiter.wait(timeout=30.0)
        try:
            payload, publish_tree = build()
        except BaseException:
            if my_evt is not None:
                with self._lock:
                    cur = self._cache.get(key)
                    if cur is not None and cur[1] is my_evt:
                        del self._cache[key]  # waiters re-claim, rebuild
                    my_evt.set()
            raise
        hook = _publish_hook
        if hook is not None:
            # the doc's center arrays are now referenced by wire buffers:
            # this is the publish instant the racecheck contract guards.
            # DOWN docs publish their reference tree instead — the one
            # center-owned buffer set a resync payload shares.
            hook(owner, publish_tree)
        with self._lock:
            cur = self._cache.get(key)
            if cur is None or updates >= cur[0] or cur[1] is my_evt:
                self._cache[key] = (updates, payload)
                # prune entries serialized at OLDER counters (stale
                # wire versions, rolled ref-epochs, retired codecs):
                # they would miss and rebuild on their next pull anyway,
                # and each holds a full center payload — without this
                # the composite keys grow the cache per epoch
                # roll instead of per live payload shape.  In-flight
                # claims (Events) are left to finish their own insert.
                stale = [k for k, ent in self._cache.items()
                         if ent[0] < updates
                         and not isinstance(ent[1], threading.Event)]
                for k in stale:
                    del self._cache[k]
            if my_evt is not None:
                # wake OUR waiters under the same hold that made the
                # payload (or this claim's removal) visible — a woken
                # racer can never re-read the still-pending placeholder
                my_evt.set()
        return payload


class DownRefState:
    """The DOWN-compression reference center.

    One shared snapshot per ``refresh_every`` counters: rolling the
    reference is O(1) — commits replace (never mutate) center arrays, so
    "snapshot" means holding the tree — and every peer decodes against
    the SAME reference, identified by a monotonically increasing
    **epoch**.  A pull request declares the epoch its connection holds;
    a mismatch (first pull, respawned incarnation, epoch rolled, server
    restarted) serves a **resync** payload carrying the reference
    verbatim next to the residual, so a stale reference can never decode
    garbage — the epoch comparison catches it first.
    """

    def __init__(self, registry, refresh_every: int = 64):
        if int(refresh_every) < 1:
            raise ValueError(f"down_ref_every must be >= 1, "
                             f"got {refresh_every}")
        self.refresh_every = int(refresh_every)
        self._epoch = 0
        self._counter = -1
        self._tree = None
        self._lock = threading.Lock()
        self._g_epoch = registry.gauge("ps.down.ref_epoch")

    def for_pull(self, center, updates: int) -> tuple:
        """``(epoch, reference_tree)`` for a pull serving ``center`` at
        counter ``updates`` — rolling the reference to THIS (center,
        counter) capture when none exists yet or the current one is
        ``refresh_every`` counters old (residual magnitude, and with it
        quantization error, grows with reference age)."""
        with self._lock:
            if self._tree is None or \
                    updates - self._counter >= self.refresh_every:
                self._epoch += 1
                self._counter = int(updates)
                self._tree = center
                self._g_epoch.set(self._epoch)
            return self._epoch, self._tree


class LivenessTable:
    """Per-worker liveness stamps + commit-weight memo, every touch under
    one lock (written by handler threads, read by the supervisor)."""

    def __init__(self):
        self._last_seen: dict = {}
        self._weights: dict = {}
        self._lock = threading.Lock()

    def touch(self, worker_id) -> None:
        """Refresh this worker's liveness stamp (commit AND pull traffic
        both count: a worker blocked in compute still pulled recently;
        one truly wedged — SIGSTOP, dead socket — goes silent on both)."""
        if worker_id is None:
            return
        now = time.monotonic()
        with self._lock:
            self._last_seen[int(worker_id)] = now

    def age(self, worker_id) -> Optional[float]:
        """Seconds since this worker's last commit/pull; None if it never
        reached the server — the supervisor's liveness source."""
        with self._lock:
            t = self._last_seen.get(int(worker_id))
        return None if t is None else time.monotonic() - t

    def ages(self) -> dict:
        """{worker: seconds since last seen} — the ``stats`` reply's
        fleet-liveness section."""
        now = time.monotonic()
        with self._lock:
            seen = dict(self._last_seen)
        return {w: now - t for w, t in seen.items()}

    def weight_changed(self, worker_id: int, weight: float) -> bool:
        """Record the latest commit weight; True when it differs from the
        last one seen (the gauge-update edge)."""
        with self._lock:
            changed = self._weights.get(worker_id) != weight
            self._weights[worker_id] = weight
        return changed


class DeltaDecoder:
    """Stateless commit-delta decode (``ps.codecs`` stubs) with the
    latency + byte accounting in the owning front-end's registry."""

    def __init__(self, registry):
        self.registry = registry
        self._h_decode = registry.histogram("ps.codec.decode_seconds",
                                            TIME_BUCKETS)

    def __call__(self, msg: dict):
        delta = msg.get("delta")
        if msg.get("codec") in (None, "none"):
            return delta
        t0 = time.perf_counter()
        enc_bytes = codecs.tree_payload_bytes(delta)
        delta = codecs.decode_tree(delta)
        codecs.count_codec_bytes(self.registry,
                                 codecs.tree_payload_bytes(delta), enc_bytes)
        self._h_decode.observe(time.perf_counter() - t0)
        return delta
