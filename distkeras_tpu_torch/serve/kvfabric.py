"""Fleet KV fabric: cached prefix KV as a FLEET resource (the port of
``distkeras_tpu.serve.kvfabric``).

The ``PrefixCache`` makes one engine warm, and the affinity router keeps
each prefix's traffic on the engine that holds its KV.  But the cache is
engine-local: when the affine owner's in-flight bound fills, overflow
spills to a COLD sibling and pays the full cold-prefill
time-to-first-token, and a drain/evict throws the victim's warm set
away.  This module moves the KV instead of recomputing it, over the
``kv_fetch``/``kv_push`` RPC pair on the serve wire (the ``kv_fetch``
reply rides the ``DKW4`` chunked zero-copy stream frame of
``ps.networking``):

* **Replication on spill** — when the router routes a request to a
  non-owner of its longest affinity prefix, it enqueues a fabric job:
  fetch the owner's longest matching cache entry, push it to the spill
  target.  Jobs are single-flight per (target, prefix-key), bounded per
  link (``kv_link_inflight`` queued-or-running jobs per (owner, target)
  pair) and by an in-flight byte budget (``kv_fabric_mb``), and run on
  ONE background worker thread.  A completed replication registers the
  target as a SECONDARY owner in the router's affinity table, so repeat
  overflow routes warm without re-fetching.
* **Migration on planned transitions** — a planned single-engine drain
  (and, best-effort, a router evict) first pulls the victim's hottest
  entries (MRU side of its LRU, entry- and byte-bounded) and pushes them
  to the least-loaded survivors, re-pointing the victim's affinity keys
  at the recipients.

**The version-stamp refusal rule.**  Cached KV is a pure function of
(tokens, weights), and ``promote()`` flushes it on every checkpoint
swap.  Every export is stamped with the source engine's ``kv_version``
(bumped by the decode thread at promotion ADOPTION).
:func:`admit_remote_entry` — the ONE code path that calls
``PrefixCache.insert_remote`` — checks the stamp against the importing
engine's version before the insert AND re-checks it after: a promotion
racing the import flushes the cache and answers "stale" instead of ever
letting foreign-generation KV serve a token.  A refused push costs one
cold prefill, never correctness.

The documents are the JAX package's (``DecodeEngine._entry_doc``), so an
entry exported by an engine of either package joins an engine of the
other.  Metrics land in the ROUTER registry: counters
``serve.router.kv_replications`` / ``kv_migrations`` /
``kv_push_bytes`` / ``kv_refused_stale``, plus the spill TTFT split
(``serve.router.ttft_spill_warm_seconds`` / ``ttft_spill_cold_seconds``)
the router's forward path attributes.
"""

from __future__ import annotations

import collections
import socket
import threading
from typing import Optional

import numpy as np

from ..obs.logging import get_logger
from ..utils.tree import tree_leaves

_LOG = "serve.kvfabric"


def entries_nbytes(entries) -> int:
    """Total tensor bytes across a list of wire entry docs (host_tokens
    + cache/draft_cache leaves) — the fabric's budget/telemetry unit."""
    return sum(int(np.asarray(leaf).nbytes)
               for doc in entries for leaf in tree_leaves(doc))


def admit_remote_entry(engine, entry, version: int):
    """Insert one validated peer-exported ``PrefixEntry`` into
    ``engine``'s cache iff its checkpoint ``version`` stamp matches the
    engine's current ``kv_version`` — the version-guarded fabric seam,
    the ONLY ``PrefixCache.insert_remote`` caller.  Returns ``(joined, reason)``.

    The stamp is checked before the insert and RE-checked after: the
    engine's decode thread bumps ``kv_version`` with its adoption-time
    flush (flush -> bump -> weight swap, all on the one inserting
    thread), so a promotion that lands between this thread's pre-check
    and its insert is always visible to the post-check — the entry may
    have slipped into the post-flush cache, and the second flush here
    drops it before the new weights could ever serve it."""
    if int(version) != engine.kv_version:
        return False, "stale"
    engine._prefix.insert_remote(entry)
    if engine.kv_version != int(version):
        # a promotion adopted between the pre-check and the insert: the
        # entry may have landed after the adoption flush, inside the
        # new-generation cache — flush again so old-weight KV can never
        # serve under the promoted checkpoint
        engine._prefix.flush()
        return False, "stale"
    return True, "joined"


class KVFabric:
    """The router-side transfer engine: one worker thread draining a
    bounded job queue of replications (spill-triggered) and migrations
    (drain/evict-triggered), moving KV between engines over the
    router's own pooled ``ServeClient`` connections — engines never
    dial each other, the fabric topology is exactly the routing
    topology.

    Every fabric failure is best-effort-silent by design (logged,
    counted nowhere fatal): a failed transfer costs one cold prefill,
    and liveness verdicts stay with the health poller — the fabric
    never evicts."""

    def __init__(self, router):
        self.router = router
        cfg = router.config
        self._budget = int(float(cfg.kv_fabric_mb) * 1024 * 1024)
        self._max_link = int(cfg.kv_link_inflight)
        self._migrate_entries = int(cfg.kv_migrate_entries)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._jobs: collections.deque = collections.deque()
        #: single-flight keys: ("replicate", target_idx, prefix_key) /
        #: ("migrate", victim_idx) queued or running right now
        self._inflight: set = set()
        self._link_jobs: dict = {}   # (owner_idx, target_idx) -> count
        self._inflight_bytes = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "KVFabric":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="serve-kv-fabric")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- job intake ---------------------------------------------------------
    def note_spill(self, key, owner_idx: int, target_idx: int,
                   prompt: np.ndarray) -> bool:
        """Enqueue a replication for a spill the router just routed:
        ``target`` should fetch the owner's entry for affinity ``key``.
        Returns False (no job) when single-flight already covers the
        (target, key) pair, the link is at its job cap, or the fabric
        is stopping — dedup IS the spill-storm defense."""
        fkey = ("replicate", int(target_idx), key)
        link = (int(owner_idx), int(target_idx))
        with self._lock:
            if self._stop_evt.is_set() or fkey in self._inflight:
                return False
            if self._link_jobs.get(link, 0) >= self._max_link:
                return False
            self._inflight.add(fkey)
            self._link_jobs[link] = self._link_jobs.get(link, 0) + 1
            self._jobs.append((fkey, link, key, int(owner_idx),
                               int(target_idx),
                               np.array(prompt, np.int32)))
            self._work.notify()
        return True

    def note_eviction(self, victim_idx: int) -> bool:
        """Enqueue a best-effort migration for an engine the router is
        evicting.  The victim is usually already dead (that is why it
        is being evicted) — the fetch then fails fast on the router's
        small dial budget and the job ends silently; a victim that
        wedged-but-answers still gets its warm set out."""
        fkey = ("migrate", int(victim_idx))
        with self._lock:
            if self._stop_evt.is_set() or fkey in self._inflight:
                return False
            self._inflight.add(fkey)
            self._jobs.append((fkey, None, None, int(victim_idx), None,
                               None))
            self._work.notify()
        return True

    def migrate_now(self, victim_idx: int) -> int:
        """Synchronous migration — the PLANNED drain path: the caller
        (the router's single-engine ``drain`` handler) needs the warm
        set copied out BEFORE it drains the victim and marks it dark.
        Returns the number of entries that joined a survivor."""
        return self._run_migrate(int(victim_idx))

    # -- worker -------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._jobs and not self._stop_evt.is_set():
                    self._work.wait(0.1)
                if self._stop_evt.is_set():
                    # pending jobs die with the fabric: replication is
                    # an optimization, and the planned-drain migration
                    # path is synchronous — nothing correctness-bearing
                    # is queued here
                    self._inflight.clear()
                    self._link_jobs.clear()
                    self._jobs.clear()
                    return
                job = self._jobs.popleft()
            fkey, link = job[0], job[1]
            try:
                if fkey[0] == "replicate":
                    self._run_replicate(job[2], job[3], job[4], job[5])
                else:
                    self._run_migrate(job[3])
            except Exception:
                # a fabric job must never kill the worker: the cost of
                # any failure here is one cold prefill, already paid
                get_logger(_LOG).exception("kv fabric job failed")
            finally:
                with self._lock:
                    self._inflight.discard(fkey)
                    if link is not None:
                        left = self._link_jobs.get(link, 1) - 1
                        if left > 0:
                            self._link_jobs[link] = left
                        else:
                            self._link_jobs.pop(link, None)

    # -- transfers ----------------------------------------------------------
    def _rpc(self, be, fn, what: str):
        """One client round-trip against backend ``be`` on the router's
        pool; socket failures log-and-return-None (best-effort: the
        poller owns liveness, the fabric never evicts)."""
        r = self.router
        try:
            client = r._acquire(be)
            try:
                reply = fn(client)
            except BaseException:
                client.close()
                raise
            be.release(client)
            return reply
        except (ConnectionError, OSError, socket.timeout) as e:
            get_logger(_LOG).info("kv fabric %s via %s failed: %s",
                                  what, be.addr, e)
            return None

    def _run_replicate(self, key, owner_idx: int, target_idx: int,
                       prompt: np.ndarray) -> None:
        r = self.router
        owner, target = r.backends[owner_idx], r.backends[target_idx]
        with r._lock:
            if not (owner.alive and target.alive):
                return
        doc = self._rpc(owner,
                        lambda c: c.kv_fetch(prompt=prompt),
                        "kv_fetch")
        if not doc or not doc.get("ok") or not doc.get("entries"):
            return
        entries = doc["entries"]
        nbytes = entries_nbytes(entries)
        with self._lock:
            if self._inflight_bytes + nbytes > self._budget:
                get_logger(_LOG).info(
                    "kv replication %s -> %s skipped: %d bytes would "
                    "exceed the kv_fabric_mb in-flight budget",
                    owner.addr, target.addr, nbytes)
                return
            self._inflight_bytes += nbytes
        try:
            reply = self._rpc(
                target,
                lambda c: c.kv_push(entries, doc.get("version")),
                "kv_push")
        finally:
            with self._lock:
                self._inflight_bytes -= nbytes
        if not reply:
            return
        stale = int(reply.get("refused_stale", 0) or 0)
        if stale:
            r._c_kv_refused_stale.inc(stale)
        if int(reply.get("joined", 0) or 0) > 0:
            r._c_kv_replications.inc()
            r._c_kv_push_bytes.inc(nbytes)
            r._add_secondary(key, target_idx)

    def _run_migrate(self, victim_idx: int) -> int:
        r = self.router
        victim = r.backends[victim_idx]
        with r._lock:
            survivors = [be for be in r.backends
                         if be.alive and be.idx != victim_idx]
            # least-loaded first: migrated KV should land where spilled
            # traffic will be routed
            survivors.sort(key=lambda be: (be.inflight + be.queue_depth
                                           + be.active_slots, be.idx))
        if not survivors:
            return 0
        doc = self._rpc(
            victim,
            lambda c: c.kv_fetch(hottest=self._migrate_entries,
                                 budget_bytes=self._budget),
            "kv_fetch(hottest)")
        if not doc or not doc.get("ok") or not doc.get("entries"):
            return 0
        version = doc.get("version")
        moved = 0
        for i, entry_doc in enumerate(doc["entries"]):
            target = survivors[i % len(survivors)]
            nbytes = entries_nbytes([entry_doc])
            reply = self._rpc(
                target, lambda c: c.kv_push([entry_doc], version),
                "kv_push")
            if not reply:
                continue
            stale = int(reply.get("refused_stale", 0) or 0)
            if stale:
                r._c_kv_refused_stale.inc(stale)
            if int(reply.get("joined", 0) or 0) > 0:
                moved += 1
                r._c_kv_migrations.inc()
                r._c_kv_push_bytes.inc(nbytes)
                r._reown_affinity(
                    np.asarray(entry_doc.get("host_tokens"),
                               np.int32).reshape(-1),
                    victim_idx, target.idx)
        if moved:
            get_logger(_LOG).warning(
                "migrated %d hot KV entr%s off %s to %d survivor(s)",
                moved, "y" if moved == 1 else "ies", victim.addr,
                len(survivors))
        return moved
