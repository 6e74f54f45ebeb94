"""Engine-fleet front door — ``ServeRouter`` (the port of
``distkeras_tpu.serve.router``: the same routing, accounting, metric
names and wire actions).

One engine on one host is the throughput ceiling.  The router turns N
engines into ONE service: it terminates client connections on the
shared ``ps.networking.FrameServer`` frame speaking the same
hello-negotiated v1/v2 wire every serve client already speaks, and
forwards each ``generate`` to one backend engine over pooled persistent
``ServeClient`` connections.

**Routing is two-tier:**

1. **Prefix-affinity first.**  The router hashes the request's leading
   ``affinity_block``-aligned token blocks (one incremental pass, the
   ``PrefixCache`` idiom) and prefers the engine that served this
   prefix before — that engine's ``PrefixCache`` likely holds the KV,
   so the request warm-joins instead of re-prefilling.  The affinity
   table is maintained from ROUTED HISTORY (every routed request
   registers its block keys against its engine, bounded LRU) and
   VALIDATED against each engine's live ``serve.prefix.hits`` counter:
   the health poller compares the hits an engine actually scored with
   the affinity-routed requests it was sent, and when the ratio
   collapses (a promote flushed the cache, an entry was evicted, the
   table is stale) the engine's affinity entries are dropped —
   misrouted affinity DECAYS instead of pinning traffic to a cold
   engine (``serve.router.affinity_decays``).
2. **Least-loaded otherwise.**  Non-affine requests (and affine
   requests whose engine is at its in-flight bound) go to the
   admissible engine with the lowest load — router-tracked in-flight
   plus the queue-depth/occupancy from the engine's last ``stats``
   poll.  ``max_inflight`` bounds per-engine in-flight admission, so
   one hot prefix cannot wedge an engine: overflow spills to the
   least-loaded survivor, and only a fleet-wide full house load-sheds.

**Fleet semantics:**

* ``stats`` merges every engine's registry snapshot plus the router's
  own into one SLO view (``Registry.merge_snapshots`` — the same
  primitive the telemetry store folds with) and carries a per-engine
  balance list.
* ``promote`` fans ONE checkpoint (the JAX ``variables`` tree of numpy
  arrays) out to every engine; partial failure is reported
  per engine in the reply, and the router keeps the latest tree —
  an engine that was down (or failed the push) is ROLLED FORWARD the
  moment the poller sees it healthy again
  (``serve.router.promote_rollforwards``), so the fleet converges on
  the deployed version without operator action.
* A dead or wedged engine is EVICTED the way ``FleetSupervisor``
  handles workers: a ``generate`` whose connection dies (or times out —
  the wedge detector) is re-queued to a surviving engine, never
  silently dropped; the evicted engine's affinity entries are purged
  and the poller keeps probing it, re-admitting it on recovery
  (``serve.router.evictions`` / ``requeues`` / ``rejoins``).  The
  router-level accounting stays exact:
  ``serve.router.requests == completed + rejected``.

**KV fabric:** the affinity table holds up to TWO owners per
prefix (primary + replicated secondary).  A routed request whose
longest mapped prefix belongs to a live engine it was NOT sent to is a
**spill** — the router enqueues a ``serve.kvfabric.KVFabric``
replication (fetch the owner's cache entry, push it to the spill
target, single-flight + budget-bounded), records the target as a
secondary owner on completion so repeat overflow routes warm
(``serve.router.affinity_secondary_hits``), and splits the spilled
request's engine-reported TTFT into
``serve.router.ttft_spill_warm_seconds`` /
``ttft_spill_cold_seconds`` by the engine's prefix-cache outcome — the
warm-vs-cold spill proof pair.  Planned transitions migrate instead of
discard: ``drain`` with an ``engine`` address migrates the victim's
hottest entries to survivors before draining it, and a router evict
enqueues the same migration best-effort.

Metrics (router registry, all pre-created): counters
``serve.router.{requests,completed,rejected}`` (rejected split
``_no_backend`` / ``_backend`` / ``_error`` / ``_draining``),
``serve.router.{requeues,evictions,rejoins}``,
``serve.router.affinity_{hits,misses,decays,secondary_hits}``,
``serve.router.{promotes,promote_failures,promote_rollforwards}``,
``serve.router.kv_{replications,migrations,push_bytes,refused_stale}``;
histograms ``serve.router.e2e_seconds`` / ``route_seconds`` /
``ttft_spill_warm_seconds`` / ``ttft_spill_cold_seconds``; gauges
``serve.router.engines_alive`` / ``affinity_entries`` /
``affinity_hit_rate`` (the fleet-wide engine-measured prefix hit rate).
Every health-poll reply also folds into the router's telemetry store
(``FrameServer.enable_telemetry``) as source ``engine:<host:port>``;
with ``enable_alerts(rules)`` the router's alert engine (``alerts``)
evaluates after each poll.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs import Registry, TIME_BUCKETS
from ..obs.logging import get_logger
from ..ps.networking import WIRE_VERSION, FrameServer
from .client import ServeClient
from .kvfabric import KVFabric

_LOG = "serve.router"


def _parse_targets(engines) -> List[Tuple[str, int]]:
    """Accept ``[(host, port), ...]`` or ``["host:port", ...]`` (or a
    mix); at least one engine is required."""
    targets = []
    for e in engines or ():
        if isinstance(e, str):
            host, _, port = e.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"engine target {e!r} is not HOST:PORT")
            targets.append((host, int(port)))
        else:
            host, port = e
            targets.append((str(host), int(port)))
    if not targets:
        raise ValueError("ServeRouter needs at least one engine target")
    return targets


@dataclasses.dataclass
class RouterConfig:
    """Knobs for the fleet front door.

    * ``affinity_block`` — affinity-hash granularity in tokens; match
      the engines' ``ServeConfig.prefix_block`` so an affinity hit lands
      on an engine whose cache can actually serve the prefix.
    * ``affinity_max_blocks`` — boundaries hashed per prompt (caps the
      per-request hashing; the LONGEST registered boundary wins).
    * ``affinity_max`` — affinity-table bound (LRU beyond it).
    * ``max_inflight`` — per-engine in-flight admission bound: an affine
      engine at the bound spills to least-loaded, a fleet at the bound
      load-sheds with a recorded rejection.
    * ``stats_interval_s`` — health/occupancy poll cadence.
    * ``evict_failures`` — consecutive poll failures before a quiet
      engine is evicted (a failed ``generate`` forward evicts
      immediately — the wedge/death signal is unambiguous there).
    * ``decay_ratio`` / ``decay_min_routed`` — affinity validation: in a
      poll window where an engine received ``decay_min_routed``+
      affinity-routed requests AND its admit-time lookups kept pace
      with everything routed to it (queued traffic never reads as
      misses), scoring hits for under ``decay_ratio`` of the
      affinity-routed count drops its affinity entries (the cache no
      longer holds what the table says); cold lookups from
      least-loaded-routed NEW prefixes never condemn the table.
    * ``request_timeout_s`` — per-forward socket timeout: the WEDGED-
      engine detector (None keeps the client default of 30s).
    * ``connect_retries`` / ``dial_timeout_s`` — backend dial attempts
      and per-attempt connect timeout (both small: a partitioned host
      blackholing SYNs must cost the router seconds, not client-grade
      patience — the sequential health poller and any in-flight forward
      wait behind the dial).
    * ``kv_fabric`` — run the fleet KV fabric (hot-prefix
      replication on spill, KV migration on planned drain/evict).  Off
      keeps routing identical but every spill cold-prefills and every
      evict discards its cache.
    * ``kv_fabric_mb`` — in-flight transfer budget: the fabric never
      holds more than this many MB of fetched-but-not-yet-pushed KV
      (a fetch that would exceed it is skipped, retried on the next
      spill).
    * ``kv_link_inflight`` — per ``(owner, target)`` link cap on
      queued+running replication jobs: a spill storm between two
      engines collapses to this many transfers, the rest dedup away.
    * ``kv_migrate_entries`` — how many MRU entries a planned
      drain/evict migrates off the victim (still bounded by
      ``kv_fabric_mb`` bytes).
    """

    affinity_block: int = 16
    affinity_max_blocks: int = 8
    affinity_max: int = 4096
    max_inflight: int = 32
    stats_interval_s: float = 0.25
    evict_failures: int = 2
    decay_ratio: float = 0.5
    decay_min_routed: int = 8
    request_timeout_s: Optional[float] = None
    connect_retries: int = 2
    dial_timeout_s: float = 2.0
    kv_fabric: bool = True
    kv_fabric_mb: float = 64.0
    kv_link_inflight: int = 1
    kv_migrate_entries: int = 8

    def __post_init__(self):
        if not float(self.kv_fabric_mb) > 0:
            raise ValueError(f"kv_fabric_mb must be > 0, got "
                             f"{self.kv_fabric_mb}")
        for name in ("affinity_block", "affinity_max_blocks",
                     "affinity_max", "max_inflight", "evict_failures",
                     "connect_retries", "kv_link_inflight",
                     "kv_migrate_entries"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if not float(self.stats_interval_s) > 0:
            raise ValueError(f"stats_interval_s must be > 0, got "
                             f"{self.stats_interval_s}")
        if not 0.0 <= float(self.decay_ratio) <= 1.0:
            raise ValueError(f"decay_ratio must be in [0, 1], got "
                             f"{self.decay_ratio}")
        if self.request_timeout_s is not None and \
                not float(self.request_timeout_s) > 0:
            raise ValueError(f"request_timeout_s must be > 0 (or None), "
                             f"got {self.request_timeout_s}")
        if not float(self.dial_timeout_s) > 0:
            raise ValueError(f"dial_timeout_s must be > 0, got "
                             f"{self.dial_timeout_s}")


class _Backend:
    """Router-side state for one engine: address, a pool of idle
    persistent ``ServeClient`` connections, and the load/affinity
    bookkeeping.  The bookkeeping fields are guarded by the ROUTER's
    ``_lock``; the connection pool has its own lock (a dial must not
    stall routing decisions)."""

    def __init__(self, host: str, port: int, idx: int):
        self.host = host
        self.port = int(port)
        self.idx = int(idx)
        self.addr = f"{host}:{port}"
        # guarded by ServeRouter._lock --------------------------------
        self.alive = True
        self.inflight = 0
        self.fails = 0
        self.queue_depth = 0
        self.active_slots = 0
        self.requests = 0
        self.completed = 0
        self.affinity_routed = 0     # since the last poll window
        self.window_routed = 0       # ALL routed since the last poll
        self.prefix_hits = 0         # engine counters at the last poll
        self.prefix_misses = 0
        self.promote_version = 0
        # pool ---------------------------------------------------------
        self._pool_lock = threading.Lock()
        self._idle: list = []

    def acquire(self, registry, wire_version, retries: int,
                dial_timeout: float,
                timeout: Optional[float]) -> ServeClient:
        """An idle pooled connection, or a fresh dial (raises
        ConnectionError when the engine is unreachable)."""
        with self._pool_lock:
            if self._idle:
                return self._idle.pop()
        client = ServeClient(self.host, self.port, registry=registry,
                             wire_version=wire_version,
                             connect_retries=retries,
                             connect_timeout=dial_timeout)
        # the dial timeout persists on the socket but must not bound
        # the FORWARD (a generate legitimately blocks for the whole
        # decode): past the handshake the connection adopts
        # request_timeout_s — the wedge budget — defaulting to the
        # historical 30s client patience
        client.sock.settimeout(30.0 if timeout is None
                               else float(timeout))
        return client

    def release(self, client: ServeClient) -> None:
        with self._pool_lock:
            self._idle.append(client)

    def close_pool(self) -> None:
        with self._pool_lock:
            idle, self._idle[:] = list(self._idle), []
        for client in idle:
            client.close()


class ServeRouter(FrameServer):
    """The fleet front door: a third ``FrameServer`` subclass routing
    ``generate`` across N engines with prefix-affinity + least-loaded
    placement, fleet-merged ``stats``, fan-out ``promote``, and
    evict/requeue/rejoin failure handling (module docstring).

    ``engines`` is a sequence of ``(host, port)`` tuples or
    ``"host:port"`` strings — the backend ``ServeServer`` addresses.
    ``engine_wire_version`` pins the BACKEND connections' frame format
    (None negotiates per engine, so a v1-pinned legacy engine simply
    interops at v1 while its siblings ride v2)."""

    metric_prefix = "serve.router"

    def __init__(self, engines: Sequence[Union[str, Tuple[str, int]]],
                 host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[Registry] = None,
                 config: Optional[RouterConfig] = None,
                 max_wire_version: int = WIRE_VERSION,
                 engine_wire_version: Optional[int] = None):
        registry = registry if registry is not None else Registry()
        super().__init__(registry, host=host, port=port,
                         max_wire_version=max_wire_version)
        self.config = config if config is not None else RouterConfig()
        self._engine_wire_version = engine_wire_version
        self.backends = [_Backend(h, p, i)
                         for i, (h, p) in
                         enumerate(_parse_targets(engines))]
        #: routing state lock: backend bookkeeping + the affinity table.
        #: Values are OWNER LISTS: up to two engine idxs per
        #: prefix key, primary first — the secondary is a fabric
        #: replication target that now holds the same KV
        self._lock = threading.Lock()
        self._affinity: "OrderedDict[tuple, list]" = OrderedDict()
        self._draining = False
        #: serializes promote fan-outs and guards the roll-forward tree
        self._promote_lock = threading.Lock()
        self._promote_version = 0
        self._promote_tree = None
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None

        reg = registry
        self._c_requests = reg.counter("serve.router.requests")
        self._c_completed = reg.counter("serve.router.completed")
        self._c_rejected = reg.counter("serve.router.rejected")
        self._c_rej_nobackend = reg.counter(
            "serve.router.rejected_no_backend")
        self._c_rej_backend = reg.counter("serve.router.rejected_backend")
        self._c_rej_error = reg.counter("serve.router.rejected_error")
        self._c_rej_drain = reg.counter("serve.router.rejected_draining")
        self._c_requeues = reg.counter("serve.router.requeues")
        self._c_evictions = reg.counter("serve.router.evictions")
        self._c_rejoins = reg.counter("serve.router.rejoins")
        self._c_aff_hits = reg.counter("serve.router.affinity_hits")
        self._c_aff_misses = reg.counter("serve.router.affinity_misses")
        self._c_aff_decays = reg.counter("serve.router.affinity_decays")
        self._c_aff_secondary = reg.counter(
            "serve.router.affinity_secondary_hits")
        self._c_kv_replications = reg.counter(
            "serve.router.kv_replications")
        self._c_kv_migrations = reg.counter("serve.router.kv_migrations")
        self._c_kv_push_bytes = reg.counter("serve.router.kv_push_bytes")
        self._c_kv_refused_stale = reg.counter(
            "serve.router.kv_refused_stale")
        self._c_promotes = reg.counter("serve.router.promotes")
        self._c_promote_failures = reg.counter(
            "serve.router.promote_failures")
        self._c_promote_rollforwards = reg.counter(
            "serve.router.promote_rollforwards")
        self._h_e2e = reg.histogram("serve.router.e2e_seconds",
                                    TIME_BUCKETS)
        self._h_route = reg.histogram("serve.router.route_seconds",
                                      TIME_BUCKETS)
        self._h_ttft_spill_warm = reg.histogram(
            "serve.router.ttft_spill_warm_seconds", TIME_BUCKETS)
        self._h_ttft_spill_cold = reg.histogram(
            "serve.router.ttft_spill_cold_seconds", TIME_BUCKETS)
        self._g_alive = reg.gauge("serve.router.engines_alive")
        self._g_alive.set(len(self.backends))
        self._g_aff_entries = reg.gauge("serve.router.affinity_entries")
        self._g_aff_rate = reg.gauge("serve.router.affinity_hit_rate")

        #: the fleet KV fabric (replication on spill,
        #: migration on drain/evict); None when configured off
        self._kv_fabric: Optional[KVFabric] = \
            KVFabric(self) if self.config.kv_fabric else None

    # -- backend connections ------------------------------------------------
    def _acquire(self, be: _Backend) -> ServeClient:
        return be.acquire(self.registry, self._engine_wire_version,
                          self.config.connect_retries,
                          float(self.config.dial_timeout_s),
                          self.config.request_timeout_s)

    # -- affinity -----------------------------------------------------------
    def _affinity_keys(self, prompt: np.ndarray) -> list:
        """Block-boundary keys for ``prompt``, LONGEST first — one
        incremental hash pass (the ``PrefixCache`` idiom), capped at
        ``affinity_max_blocks`` boundaries."""
        block = int(self.config.affinity_block)
        nblocks = min(int(prompt.shape[0]) // block,
                      int(self.config.affinity_max_blocks))
        if nblocks < 1:
            return []
        data = np.ascontiguousarray(prompt[:nblocks * block]).tobytes()
        keys = []
        h = hashlib.sha1()
        for i in range(nblocks):
            h.update(data[i * block * 4:(i + 1) * block * 4])
            keys.append(((i + 1) * block, h.copy().digest()))
        keys.reverse()
        return keys

    def _admissible(self, be: _Backend, exclude) -> bool:
        # caller holds _lock
        return be.alive and be.idx not in exclude \
            and be.inflight < int(self.config.max_inflight)

    def _route(self, prompt: np.ndarray, exclude=frozenset(),
               spill_out: Optional[list] = None):
        """Pick a backend for ``prompt``: affinity first, least-loaded
        otherwise; registers the routed keys and takes an in-flight
        slot.  Returns ``(backend, was_affine)`` or ``(None, False)``
        when no engine is admissible.

        Overflow routes report to ``spill_out`` (when given).
        A pick that is NOT an owner of the longest mapped prefix while
        a live owner exists appends ``("spill", key, owner_idx,
        target_idx)`` — the fabric's replication trigger; a pick that is
        the replicated SECONDARY owner appends ``("secondary", ...)`` —
        already-replicated overflow, no new transfer, but still spill
        traffic for the warm-vs-cold TTFT split."""
        t0 = time.perf_counter()
        keys = self._affinity_keys(prompt)
        with self._lock:
            target, affine, sec_spill = None, False, None
            for key in keys:
                owners = self._affinity.get(key)
                if not owners:
                    continue
                for rank, idx in enumerate(owners):
                    if self._admissible(self.backends[idx], exclude):
                        target, affine = self.backends[idx], True
                        if rank > 0:
                            sec_spill = ("secondary", key, owners[0],
                                         idx)
                        self._affinity.move_to_end(key)
                        break
                if target is not None:
                    break
            if target is None:
                cands = [be for be in self.backends
                         if self._admissible(be, exclude)]
                if not cands:
                    return None, False
                # least-loaded: router-tracked in-flight (exact) plus
                # the engine's last-polled queue/occupancy (near-live);
                # ties break by fewest-routed so an idle fleet SPREADS
                # new prefixes instead of pinning them all to engine 0
                target = min(cands,
                             key=lambda be: (be.inflight + be.queue_depth
                                             + be.active_slots,
                                             be.requests, be.idx))
            (self._c_aff_hits if affine else self._c_aff_misses).inc()
            if sec_spill is not None:
                self._c_aff_secondary.inc()
            spill = None
            seen_mapped = False
            for key in keys:
                owners = self._affinity.get(key)
                if not owners:
                    self._affinity[key] = [target.idx]
                    self._affinity.move_to_end(key)
                    continue
                longest_mapped = not seen_mapped
                seen_mapped = True
                if target.idx in owners:
                    self._affinity.move_to_end(key)
                    continue
                live = [i for i in owners if self.backends[i].alive]
                if live:
                    # a LIVE engine already owns this prefix: a
                    # transient spill (owner at its in-flight bound)
                    # must not steal the mapping and strand the owner's
                    # warm KV — the owner serves the prefix again the
                    # moment it is admissible.  Dead owners' keys were
                    # purged at eviction; stale live mappings decay.
                    # The LONGEST foreign-owned mapped key is the KV
                    # fabric's replication trigger — shorter keys under
                    # a target-owned longer one are not (the target
                    # already holds a covering entry).  Only a SINGLY-
                    # owned prefix replicates: once a replica exists
                    # (two live owners) a further overflow means the
                    # whole fleet is saturated, and shipping a third
                    # copy would evict the second and thrash transfer
                    # bandwidth without adding warm capacity
                    if longest_mapped and spill is None \
                            and len(live) == 1:
                        spill = ("spill", key, live[0], target.idx)
                    continue
                self._affinity[key] = [target.idx]
                self._affinity.move_to_end(key)
            if spill_out is not None:
                if spill is not None:
                    spill_out.append(spill)
                elif sec_spill is not None:
                    spill_out.append(sec_spill)
            while len(self._affinity) > int(self.config.affinity_max):
                self._affinity.popitem(last=False)
            self._g_aff_entries.set(len(self._affinity))
            target.inflight += 1
            target.requests += 1
            target.window_routed += 1
            if affine:
                target.affinity_routed += 1
        self._h_route.observe(time.perf_counter() - t0)
        return target, affine

    def _add_secondary(self, key, idx: int) -> None:
        """Record engine ``idx`` as a secondary owner of affinity
        ``key`` — the fabric's post-replication hook, bounding each
        prefix to TWO owners (primary + the freshest replica; a third
        replication replaces the older secondary)."""
        with self._lock:
            owners = self._affinity.get(key)
            if owners is None:
                # the key aged out of the LRU while the transfer ran:
                # the replica is real, so re-map it as primary
                self._affinity[key] = [int(idx)]
                self._g_aff_entries.set(len(self._affinity))
                return
            if int(idx) in owners:
                return
            if len(owners) >= 2:
                owners[-1] = int(idx)
            else:
                owners.append(int(idx))

    def _reown_affinity(self, host_tokens: np.ndarray, victim_idx: int,
                        new_idx: int) -> None:
        """Re-point a migrated entry's affinity keys from ``victim_idx``
        at its recipient ``new_idx`` (the fabric's post-migration hook):
        traffic for the moved prefix follows the KV to the survivor
        instead of cold-starting wherever least-loaded lands it."""
        keys = self._affinity_keys(
            np.asarray(host_tokens, np.int32).reshape(-1))
        with self._lock:
            for key in keys:
                owners = self._affinity.get(key)
                if owners is None:
                    self._affinity[key] = [int(new_idx)]
                elif int(new_idx) in owners:
                    if int(victim_idx) in owners:
                        owners.remove(int(victim_idx))
                elif int(victim_idx) in owners:
                    owners[owners.index(int(victim_idx))] = int(new_idx)
                elif len(owners) < 2:
                    owners.append(int(new_idx))
            self._g_aff_entries.set(len(self._affinity))

    def _drop_affinity(self, idx: int) -> int:  # caller holds _lock
        dropped = 0
        for k in [k for k, owners in self._affinity.items()
                  if idx in owners]:
            owners = self._affinity[k]
            owners.remove(idx)
            dropped += 1
            if not owners:
                # a surviving co-owner keeps the key: its replica of
                # the prefix is still warm and still routable
                del self._affinity[k]
        self._g_aff_entries.set(len(self._affinity))
        return dropped

    # -- eviction / rejoin --------------------------------------------------
    def _evict(self, be: _Backend, reason: str,
               migrate: bool = True) -> None:
        with self._lock:
            if not be.alive:
                return
            be.alive = False
            be.fails = 0
            self._c_evictions.inc()
            dropped = self._drop_affinity(be.idx)
            self._g_alive.set(sum(b.alive for b in self.backends))
        be.close_pool()
        if migrate and self._kv_fabric is not None:
            # best-effort KV rescue: a DEAD victim fails the
            # fabric's fetch fast and the job ends silently; a wedged-
            # but-answering one still gets its warm set copied to
            # survivors.  The planned-drain path passes migrate=False —
            # it already migrated synchronously, before the drain
            self._kv_fabric.note_eviction(be.idx)
        get_logger(_LOG).warning(
            "evicted engine %s (%s); %d affinity entries dropped, "
            "traffic re-queued to survivors", be.addr, reason, dropped)

    def _note_poll_failure(self, be: _Backend, err) -> None:
        with self._lock:
            be.fails += 1
            evict = be.alive and \
                be.fails >= int(self.config.evict_failures)
        if evict:
            self._evict(be, f"stats poll failed x{be.fails}: {err}")

    def _adopt_stats(self, be: _Backend, reply: dict) -> None:
        """Fold one engine's ``stats`` reply into the routing state:
        occupancy for least-loaded, prefix counters for affinity
        validation/decay, liveness (a dead engine answering again is a
        REJOIN — rolled forward onto the fleet's promoted version)."""
        stats = reply.get("stats", {}) or {}

        def _v(name):
            return int(stats.get(name, {}).get("value", 0) or 0)

        hits, misses = _v("serve.prefix.hits"), _v("serve.prefix.misses")
        rejoined = False
        with self._lock:
            be.fails = 0
            if not be.alive:
                if reply.get("draining"):
                    # a planned-drained engine still answers stats but
                    # admits NOTHING — rejoining it would only bounce
                    # traffic off its "draining" rejection.  It stays
                    # evicted until it answers un-draining (a restart)
                    return
                be.alive = True
                rejoined = True
                self._c_rejoins.inc()
                self._g_alive.set(sum(b.alive for b in self.backends))
            be.queue_depth = int(reply.get("queue_depth", 0) or 0)
            be.active_slots = int(reply.get("active_slots", 0) or 0)
            d_hits = hits - be.prefix_hits
            d_looked = d_hits + (misses - be.prefix_misses)
            routed_aff = be.affinity_routed
            routed_total = be.window_routed
            be.affinity_routed = 0
            be.window_routed = 0
            be.prefix_hits, be.prefix_misses = hits, misses
            # affinity validation: the engine was sent `routed_aff`
            # requests BECAUSE its cache supposedly held their prefixes;
            # scoring hits for under decay_ratio of them means the table
            # is stale (promote flush, LRU eviction) — decay it.  Two
            # guards keep the signal honest: the window must have
            # admitted at least what was routed (a routed-but-still-
            # QUEUED request has not done its admit-time lookup and must
            # not read as a miss), and hits are compared against the
            # AFFINITY-routed count, not all lookups — least-loaded-
            # routed new prefixes necessarily cold-miss and must not
            # condemn a perfectly accurate table
            if routed_aff >= int(self.config.decay_min_routed) and \
                    d_looked >= routed_total and \
                    d_hits < float(self.config.decay_ratio) * routed_aff:
                self._drop_affinity(be.idx)
                self._c_aff_decays.inc()
            looked = sum(b.prefix_hits + b.prefix_misses
                         for b in self.backends)
            if looked:
                self._g_aff_rate.set(
                    sum(b.prefix_hits for b in self.backends) / looked)
        if rejoined:
            get_logger(_LOG).warning("engine %s rejoined the fleet",
                                     be.addr)

    # -- health poller ------------------------------------------------------
    def _poll_once(self) -> None:
        for be in self.backends:
            try:
                client = self._acquire(be)
                try:
                    # retry=False: a dead engine must cost ONE failed
                    # read, not the client's full reconnect-backoff
                    # ladder — the poll loop is sequential, and every
                    # other engine's occupancy refresh waits behind it
                    reply = client.stats(retry=False)
                except BaseException:
                    client.close()
                    raise
                be.release(client)
            except (ConnectionError, OSError, socket.timeout) as e:
                self._note_poll_failure(be, e)
                continue
            self._adopt_stats(be, reply)
            # telemetry plane: the poll this router already runs IS the
            # fleet's engine-stats source — fold each reply into the
            # aggregator so consumers read one live series instead of
            # adding their own N poll loops
            stats = reply.get("stats")
            if isinstance(stats, dict):
                store = self.telemetry or self.enable_telemetry()
                store.ingest_total(f"engine:{be.addr}", stats)
            self._rollforward(be)
        if self.alerts is not None:
            self.alerts.evaluate()

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(float(self.config.stats_interval_s)):
            try:
                self._poll_once()
            except Exception:
                # the poller must outlive any single bad reply; the
                # failure is recorded per backend above
                get_logger(_LOG).exception("router poll iteration failed")

    # -- promote fan-out ----------------------------------------------------
    def _rollforward(self, be: _Backend) -> None:
        """Push the fleet's promoted checkpoint to an engine that is
        behind (it was down — or failed the push — during the fan-out):
        the partial-failure repair that makes a fleet promote converge."""
        with self._promote_lock:
            ver, tree = self._promote_version, self._promote_tree
            if tree is None:
                return
            with self._lock:
                if not be.alive or be.promote_version >= ver:
                    return
            try:
                client = self._acquire(be)
                try:
                    reply = client.promote(tree)
                except BaseException:
                    client.close()
                    raise
                be.release(client)
            except (ConnectionError, OSError, socket.timeout) as e:
                get_logger(_LOG).warning(
                    "promote roll-forward to %s failed (%s); will retry "
                    "on the next poll", be.addr, e)
                return
            if reply.get("ok"):
                with self._lock:
                    be.promote_version = ver
                self._c_promote_rollforwards.inc()
                get_logger(_LOG).warning(
                    "rolled engine %s forward to promoted version %d",
                    be.addr, ver)

    def _handle_promote(self, msg: dict) -> dict:
        variables = msg.get("variables")
        if variables is None:
            return {"ok": False, "error": "promote needs a variables tree"}
        with self._promote_lock:
            self._promote_version += 1
            ver = self._promote_version
            self._promote_tree = variables
            results = {}
            n_ok = 0
            for be in self.backends:
                with self._lock:
                    alive = be.alive
                if not alive:
                    results[be.addr] = {
                        "ok": False,
                        "error": "engine evicted; rolls forward on "
                                 "rejoin"}
                    self._c_promote_failures.inc()
                    continue
                try:
                    client = self._acquire(be)
                    try:
                        reply = client.promote(variables)
                    except BaseException:
                        client.close()
                        raise
                    be.release(client)
                except (ConnectionError, OSError, socket.timeout) as e:
                    self._c_promote_failures.inc()
                    results[be.addr] = {"ok": False, "error": str(e)}
                    continue
                if reply.get("ok"):
                    with self._lock:
                        be.promote_version = max(be.promote_version, ver)
                    n_ok += 1
                    results[be.addr] = {"ok": True}
                else:
                    self._c_promote_failures.inc()
                    results[be.addr] = {
                        "ok": False, "error": reply.get("error", "?")}
            self._c_promotes.inc()
        return {"ok": n_ok == len(self.backends), "promoted": n_ok,
                "failed": len(self.backends) - n_ok, "version": ver,
                "engines": results}

    # -- generate forwarding ------------------------------------------------
    def _forward(self, be: _Backend, msg: dict,
                 prompt: np.ndarray) -> dict:
        """One forward on a pooled connection; releases the in-flight
        slot whatever happens.  A connection that errored mid-request is
        CLOSED, never pooled (its stream state is unknown)."""
        try:
            client = self._acquire(be)
            try:
                reply = client.generate(
                    prompt, msg.get("max_new_tokens"),
                    temperature=msg.get("temperature"),
                    top_k=msg.get("top_k"), top_p=msg.get("top_p"))
            except BaseException:
                client.close()
                raise
            be.release(client)
            return reply
        finally:
            with self._lock:
                be.inflight -= 1

    def _handle_generate(self, msg: dict) -> dict:
        prompt = msg.get("prompt")
        if prompt is None:
            return {"ok": False, "error": "generate needs a prompt"}
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._c_requests.inc()
        with self._lock:
            draining = self._draining
        if draining:
            self._c_rejected.inc()
            self._c_rej_drain.inc()
            return {"ok": False, "rejected": True, "reason": "draining"}
        t0 = time.perf_counter()
        tried: set = set()
        while True:
            spill: list = []
            be, _affine = self._route(
                prompt, exclude=tried,
                spill_out=spill if self._kv_fabric is not None else None)
            if be is None:
                self._c_rejected.inc()
                self._c_rej_nobackend.inc()
                reason = "no admissible engine" if not tried else \
                    f"engines {sorted(tried)} failed or shed; no " \
                    f"admissible survivor"
                return {"ok": False, "rejected": True, "reason": reason}
            try:
                reply = self._forward(be, msg, prompt)
            except (ValueError, TypeError) as e:
                # a malformed FIELD (e.g. a non-numeric max_new_tokens
                # or temperature riding the wire) fails client-side
                # serialization: answer it like the engine front-end
                # would AND count it, so requests == completed +
                # rejected stays exact
                self._c_rejected.inc()
                self._c_rej_error.inc()
                return {"ok": False, "error": str(e)}
            except (ConnectionError, OSError, socket.timeout) as e:
                # the engine died or wedged mid-request: evict it and
                # RE-QUEUE the request on a survivor — never silently
                # dropped.  (The dead engine cannot double-serve the
                # request; a wedged one may eventually finish a decode
                # nobody reads — wasted compute, never wrong output.)
                self._evict(be, f"generate forward failed: {e}")
                tried.add(be.idx)
                self._c_requeues.inc()
                continue
            with self._lock:
                be.fails = 0
                if reply.get("ok"):
                    be.completed += 1
            if reply.get("ok"):
                self._c_completed.inc()
                self._h_e2e.observe(time.perf_counter() - t0)
                if spill and reply.get("ttft_s") is not None \
                        and reply.get("warm") is not None:
                    # the warm-vs-cold spill TTFT split: the
                    # engine reports its admit-time prefix outcome, so
                    # a spill that landed AFTER the fabric replicated
                    # reads warm — the fabric's payoff, measured
                    (self._h_ttft_spill_warm if reply["warm"]
                     else self._h_ttft_spill_cold).observe(
                        float(reply["ttft_s"]))
            else:
                if reply.get("rejected") and \
                        reply.get("reason") in ("queue full", "draining"):
                    # the ENGINE load-shed, but that is its own
                    # admission verdict, not the fleet's: a sibling may
                    # have capacity (the affinity path admits up to
                    # max_inflight regardless of the engine's queue
                    # bound).  Re-queue on the survivors — only a
                    # fleet-wide full house reaches the client, and it
                    # is counted exactly once, on the final outcome
                    tried.add(be.idx)
                    self._c_requeues.inc()
                    continue
                self._c_rejected.inc()
                if reply.get("rejected"):
                    self._c_rej_backend.inc()
                else:
                    # a malformed request the engine answered with
                    # "error": counted here so the router's
                    # requests == completed + rejected stays exact
                    self._c_rej_error.inc()
            if spill and spill[0][0] == "spill":
                # the pick was NOT an owner of this prompt's longest
                # mapped prefix: replicate the owner's KV to it so the
                # NEXT overflow of this prefix lands warm.  Triggered
                # AFTER this request's reply so the transfer can never
                # race its admission (the spilled request is cold by
                # construction — the proof split stays exact) and the
                # fetch never steals CPU from the very prefill it is
                # trying to make unnecessary.  ("secondary" overflow
                # already holds the replica — no new transfer, just
                # the TTFT attribution above)
                _kind, key, owner_idx, target_idx = spill[0]
                self._kv_fabric.note_spill(key, owner_idx, target_idx,
                                           prompt)
            reply["engine"] = be.addr
            return reply

    # -- fleet stats --------------------------------------------------------
    def _handle_stats(self) -> dict:
        """One merged fleet SLO view (``Registry.merge_snapshots`` over
        every live engine's snapshot plus the router's own) + the
        per-engine balance list."""
        parts = []
        engines = []
        slots = queue_depth = active = 0
        fleet_hits = fleet_misses = 0
        model = seq_len = buckets = None
        for be in self.backends:
            with self._lock:
                entry = {"addr": be.addr, "alive": be.alive,
                         "inflight": be.inflight,
                         "requests": be.requests,
                         "completed": be.completed,
                         "promote_version": be.promote_version}
                alive = be.alive
            if alive:
                try:
                    client = self._acquire(be)
                    try:
                        reply = client.stats(retry=False)
                    except BaseException:
                        client.close()
                        raise
                    be.release(client)
                except (ConnectionError, OSError, socket.timeout) as e:
                    entry["error"] = str(e)
                else:
                    stats = reply.get("stats", {}) or {}
                    parts.append(stats)
                    model = model or reply.get("model")
                    seq_len = seq_len or reply.get("seq_len")
                    buckets = buckets or reply.get("prefill_buckets")
                    slots += int(reply.get("slots", 0) or 0)
                    queue_depth += int(reply.get("queue_depth", 0) or 0)
                    active += int(reply.get("active_slots", 0) or 0)

                    def _v(name):
                        return stats.get(name, {}).get("value", 0)

                    fleet_hits += int(_v("serve.prefix.hits") or 0)
                    fleet_misses += int(_v("serve.prefix.misses") or 0)
                    entry.update(
                        queue_depth=reply.get("queue_depth"),
                        active_slots=reply.get("active_slots"),
                        slots=reply.get("slots"),
                        draining=reply.get("draining"),
                        engine_requests=_v("serve.requests"),
                        engine_completed=_v("serve.completed"),
                        prefix_hits=_v("serve.prefix.hits"),
                        prefix_misses=_v("serve.prefix.misses"),
                        stats=stats)
            engines.append(entry)
        with self._lock:
            draining = self._draining
            alive_n = sum(b.alive for b in self.backends)
        if fleet_hits + fleet_misses:
            # the fleet's prefix hit rate — refreshed here from
            # the counters just fetched, so a stats poll never reads a
            # stale poller tick
            self._g_aff_rate.set(fleet_hits / (fleet_hits + fleet_misses))
        merged = Registry.merge_snapshots(self.registry.snapshot(),
                                          *parts)
        return {"stats": merged, "server": type(self).__name__,
                "model": model, "seq_len": seq_len,
                "prefill_buckets": buckets, "engines": engines,
                "num_engines": len(self.backends),
                "engines_alive": alive_n,
                "slots": slots, "queue_depth": queue_depth,
                "active_slots": active, "draining": draining}

    def _drain_engine(self, addr: str, timeout_s) -> dict:
        """Planned SINGLE-engine drain: migrate the victim's
        hottest KV entries to survivors synchronously — the warm set
        crosses the wire while the victim still answers — THEN drain it
        and take it out of rotation.  The fleet keeps serving; the
        victim's prefixes keep hitting, now on the recipients."""
        be = next((b for b in self.backends if b.addr == addr), None)
        if be is None:
            return {"ok": False, "error": f"unknown engine {addr!r}"}
        with self._lock:
            alive = be.alive
        if not alive:
            return {"ok": False, "engine": be.addr,
                    "error": "engine already evicted"}
        migrated = 0
        if self._kv_fabric is not None:
            migrated = self._kv_fabric.migrate_now(be.idx)
        try:
            client = self._acquire(be)
            try:
                result = client.drain(timeout_s)
            except BaseException:
                client.close()
                raise
            be.release(client)
        except (ConnectionError, OSError, socket.timeout) as e:
            result = {"ok": False, "error": str(e)}
        self._evict(be, "planned drain", migrate=False)
        reply = {"ok": bool(result.get("ok")), "engine": be.addr,
                 "migrated": migrated,
                 "drained": result.get("drained")}
        if result.get("error"):
            reply["error"] = result["error"]
        return reply

    def _handle_drain(self, msg: dict) -> dict:
        """Fleet drain: stop admitting at the front door, then fan the
        drain to every live engine (idempotent, like the engine's).
        With an ``engine`` address it is instead a PLANNED
        single-engine drain — migrate-then-drain, fleet stays up."""
        addr = msg.get("engine")
        if addr is not None:
            return self._drain_engine(str(addr), msg.get("timeout_s"))
        with self._lock:
            self._draining = True
        results = {}
        for be in self.backends:
            with self._lock:
                alive = be.alive
            if not alive:
                results[be.addr] = {"ok": False, "error": "evicted"}
                continue
            try:
                client = self._acquire(be)
                try:
                    results[be.addr] = client.drain(msg.get("timeout_s"))
                except BaseException:
                    client.close()
                    raise
                be.release(client)
            except (ConnectionError, OSError, socket.timeout) as e:
                results[be.addr] = {"ok": False, "error": str(e)}
        return {"ok": True, "engines": results}

    # -- scaling seam -------------------------------------------------------
    def scale_down(self, addr: str,
                   timeout_s: Optional[float] = None) -> dict:
        """Take one engine out of rotation — an alias for the planned
        single-engine drain (migrate hot KV to survivors → drain →
        evict).  The drained engine PARKS: its server keeps answering
        stats (refusing rejoin while draining) with the warm-compiled
        model intact, so :meth:`scale_up` can re-admit it without a
        recompile."""
        return self._drain_engine(str(addr), timeout_s)

    def scale_up(self, addr: str) -> dict:
        """Re-admit a parked engine: send ``undrain`` to reopen its
        admission, then probe stats and re-adopt it through the SAME
        rejoin path a recovered engine takes (synchronously — the
        caller must not wait a poller tick for capacity it just
        asked for).  Roll-forward runs too, so an engine parked across
        a promote rejoins on the fleet's current version."""
        be = next((b for b in self.backends if b.addr == addr), None)
        if be is None:
            return {"ok": False, "error": f"unknown engine {addr!r}"}
        with self._lock:
            if be.alive:
                return {"ok": True, "engine": be.addr,
                        "already_alive": True}
        try:
            client = self._acquire(be)
            try:
                result = client.undrain()
                reply = client.stats(retry=False)
            except BaseException:
                client.close()
                raise
            be.release(client)
        except (ConnectionError, OSError, socket.timeout) as e:
            return {"ok": False, "engine": be.addr, "error": str(e)}
        if not result.get("ok"):
            return {"ok": False, "engine": be.addr,
                    "error": result.get("error", "undrain refused")}
        self._adopt_stats(be, reply)
        self._rollforward(be)
        with self._lock:
            alive = be.alive
        return {"ok": alive, "engine": be.addr,
                "was_draining": bool(result.get("was_draining"))}

    def _handle_undrain(self, msg: dict) -> dict:
        addr = msg.get("engine")
        if addr is None:
            return {"ok": False,
                    "error": "router undrain needs an engine address"}
        return self.scale_up(str(addr))

    # -- FrameServer plumbing -----------------------------------------------
    def handle_request(self, action, msg: dict, ver: int,
                       conn: socket.socket):
        if action == "generate":
            return self._handle_generate(msg)
        if action == "stats":
            return self._handle_stats()
        if action == "promote":
            return self._handle_promote(msg)
        if action == "drain":
            return self._handle_drain(msg)
        if action == "undrain":
            return self._handle_undrain(msg)
        return None

    def _on_start(self) -> None:
        self._poll_stop.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, daemon=True,
            name="serve-router-poll")
        self._poll_thread.start()
        if self._kv_fabric is not None:
            self._kv_fabric.start()

    def _before_close_connections(self) -> None:
        # let handler threads flush replies for forwards that are about
        # to complete before their sockets are closed under them
        deadline = time.monotonic() + 5.0
        while self._g_inflight.value > 0 and time.monotonic() < deadline:
            time.sleep(0.01)

    def stop(self) -> None:
        if self._kv_fabric is not None:
            # before the poller and listener: in-flight transfers
            # finish or die with their sockets, no new jobs enqueue
            self._kv_fabric.stop()
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)
            self._poll_thread = None
        super().stop()
        for be in self.backends:
            be.close_pool()
