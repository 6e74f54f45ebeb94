"""Worker-side sharded PS client — the port of
``distkeras_tpu.ps.shard.client``: pipelined fan-out with consistent-cut
pulls.

``ShardedPSClient`` keeps one :class:`~..client.PSClient` per shard (so
each connection negotiates its own wire version, owns its own
error-feedback codec residual and reuses the per-shard pull cache) and
presents the ``PSClient`` surface the workers drive — ``ps_shards=1``
fleets keep using ``PSClient`` itself.

**Pipelined fan-out.**  A logical pull or commit uses the split-phase
primitives (``pull_send``/``pull_finish``, ``commit_send``/
``commit_finish``): every shard's request goes out first, then the
replies are collected — all on the worker's own thread, so the shards'
applies overlap under their own locks and the worker's trace identity
and spans propagate as on the single-server path.

**Consistent-cut pull.**  Each shard's pull reply carries its per-worker
commit counts — a version vector captured atomically with the center
slice.  A logical commit lands once on EVERY shard, so a cut is
consistent exactly when all shards report the SAME vector.  The pull
fans out, compares vectors, and re-pulls only the shards that disagree
until the vectors match (bounded rounds; every retry is a recorded
``ps.shard.torn_pulls``).  If the vectors stop moving while still
unequal — a committer died mid-fan-out, leaving a permanently torn
commit — the pull accepts the freshest cut and records
``ps.shard.cut_incomplete`` instead of spinning forever.

Plan agreement is verified at connect time: v2 connections check the
shard descriptor from the ``hello`` reply, v1-pinned connections (no
hello) fetch it through the ``plan`` RPC — either way a digest, index or
epoch mismatch raises :class:`ShardPlanMismatch` before any traffic.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, List, Optional, Sequence, Tuple

from ...obs import TIME_BUCKETS, Registry, default_registry
from ...obs.logging import get_logger
from ..client import PSClient, WorkerEvicted
from .plan import ShardPlan

Tree = Any

#: pull rounds a consistent cut may take before :class:`ConsistentCutError`
MAX_CUT_ROUNDS = 100


def merge_fleet_stats(replies: Sequence[dict]) -> dict:
    """The consistent merged view over a shard fleet's per-shard ``stats``
    replies — ONE definition shared by :meth:`ShardedPSClient.stats` and
    ``obsview --ps``: registry counters/histograms fold via
    ``Registry.merge_snapshots``, per-worker commits take the
    element-wise MIN (the fully-committed prefix — a commit counts once
    every shard applied it), ``num_updates`` the MAX (the in-flight
    edge)."""
    merged = Registry.merge_snapshots(*[r.get("stats", {})
                                        for r in replies])
    by_worker: dict = {}
    for r in replies:
        for w, c in (r.get("commits_by_worker") or {}).items():
            w = int(w)
            by_worker[w] = c if w not in by_worker \
                else min(by_worker[w], c)
    return {"stats": merged,
            "num_updates": max((int(r.get("num_updates") or 0)
                                for r in replies), default=0),
            "commits_by_worker": by_worker}


class ShardPlanMismatch(RuntimeError):
    """A shard's placement descriptor disagrees with this client's plan —
    assembling centers across it would silently interleave two different
    partitionings."""


class ConsistentCutError(RuntimeError):
    """The version vectors kept moving without ever agreeing within the
    round budget — the fleet is committing faster than this client can
    snapshot it."""


class ShardedPSClient:
    """Fan commits/pulls across a shard fleet over the existing v2 wire.

    ``template`` (any tree with the center's structure — the worker's own
    live tensors or a numpy tree) derives the plan locally; every shard's descriptor is then
    verified against it.  All of ``worker_id`` / ``codec`` /
    ``wire_version`` / ``tracer`` / ``generation`` / ``down`` / ``shm``
    mean exactly what they mean on ``PSClient``; the codec SPEC is shared
    but each shard connection builds its own instance (per-shard
    error-feedback isolation — one shard's residual never leaks into
    another's), and likewise each connection owns its own DOWN reference
    epoch, adaptive policy, and shm rings — a mixed fleet
    where only SOME shards can attach the rings simply runs those
    connections on TCP, per-link.  Streamed pulls negotiate
    per-connection the same way: a shard that refused (or predates) the
    ``stream`` offer answers monolithically while its siblings stream,
    and the assembled center is identical either way."""

    def __init__(self, addrs: Sequence[Tuple[str, int]], template: Tree,
                 worker_id: int = 0, registry: Optional[Registry] = None,
                 codec=None, wire_version: Optional[int] = None,
                 tracer=None, generation: int = 0, plan_epoch: int = 0,
                 down=None, shm: Optional[bool] = None):
        addrs = [(h, int(p)) for h, p in addrs]
        if not addrs:
            raise ValueError("ShardedPSClient needs at least one shard")
        self.worker_id = int(worker_id)
        self.registry = registry if registry is not None \
            else default_registry()
        self.plan = ShardPlan.build(template, len(addrs), epoch=plan_epoch)
        self.tracer = tracer
        self._log = get_logger("ps.shard")
        self._c_rounds = self.registry.counter("ps.shard.pull_rounds")
        self._c_torn = self.registry.counter("ps.shard.torn_pulls")
        self._c_incomplete = self.registry.counter("ps.shard.cut_incomplete")
        self._c_repairs = self.registry.counter("ps.shard.commit_repairs")
        self._h_assemble = self.registry.histogram(
            "ps.shard.assemble_seconds", TIME_BUCKETS)
        self.clients: List[PSClient] = []
        try:
            for host, port in addrs:
                self.clients.append(PSClient(
                    host, port, worker_id, registry=self.registry,
                    codec=codec, wire_version=wire_version, tracer=tracer,
                    generation=generation, down=down, shm=shm))
            self._verify_plan()
        except BaseException:
            self.close()
            raise
        self.wire_version = min(c.wire_version for c in self.clients)
        #: per-shard update counters from the most recent pull — the
        #: split of the scalar ``last_update`` workers hand back to
        #: ``commit`` (staleness is a per-shard quantity)
        self._pull_counters = [0] * len(self.clients)
        self._warned_incomplete = False
        #: True while an overlapped pull's round-1 requests are in
        #: flight (``pull_begin`` sent, ``pull_join`` pending)
        self._begun = False

    # -- plan agreement -----------------------------------------------------
    def _verify_plan(self) -> None:
        for i, c in enumerate(self.clients):
            info = c.shard_info
            if info is None:
                # v1 connection (no hello) or a pre-shard server: the
                # ``plan`` RPC is the wire-version-independent source
                resp = c._rpc({"action": "plan",
                               "worker_id": self.worker_id}, retry=True)
                if not isinstance(resp, dict) or not resp.get("ok"):
                    raise ShardPlanMismatch(
                        f"shard {i} at {c.host}:{c.port} does not speak "
                        f"the shard protocol (reply: {resp!r}) — is a "
                        "plain parameter server listening there?")
                info = resp.get("shard") or {}
            mine = self.plan.descriptor()
            theirs = {k: info.get(k) for k in
                      ("num_shards", "epoch", "digest")}
            if theirs != mine or int(info.get("index", -1)) != i:
                raise ShardPlanMismatch(
                    f"shard {i} at {c.host}:{c.port} disagrees on the "
                    f"placement plan (mine {mine} / index {i}, theirs "
                    f"{theirs} / index {info.get('index')}) — refusing "
                    "to interleave two partitionings")

    # -- the consistent-cut pull -------------------------------------------
    @staticmethod
    def _norm_vv(vv) -> dict:
        return {int(k): int(v) for k, v in vv.items()} \
            if isinstance(vv, dict) else {}

    def _span(self, name: str):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, worker=self.worker_id)

    def _pull_round(self, pending, min_updates=None,
                    presend: bool = True) -> dict:
        """One pipelined pull round over the ``pending`` shard indices:
        all requests out, then all replies in.  A dead connection gets
        one reconnect per phase (a pull is an idempotent read).  On
        retry rounds ``min_updates`` carries the cut target's total
        commit count: the lagging shard WAITS for its in-flight applies
        instead of shipping a slice the cut check would discard.
        ``presend=False`` skips the send phase — an overlapped pull
        (:meth:`pull_begin`) already fanned round 1's requests out."""
        if presend:
            for i in pending:
                c = self.clients[i]
                try:
                    c.pull_send(min_updates)
                except (ConnectionError, OSError):
                    c.reconnect()
                    c.pull_send(min_updates)
        out = {}
        for i in pending:
            c = self.clients[i]
            try:
                out[i] = c.pull_finish()
            except (ConnectionError, OSError):
                c.reconnect()
                c.pull_send(min_updates)
                out[i] = c.pull_finish()
        return out

    def pull(self) -> tuple:
        """Assembled ``(center, total_updates)`` from a consistent cut:
        no shard's slice reflects a commit any other shard's slice is
        missing."""
        with self._span("ps.shard.pull"):
            return self._pull_cut()

    # -- overlapped pulls ---------------------------------------------------
    def pull_begin(self, min_updates=None) -> None:
        """Phase 1 of an overlapped consistent-cut pull: round 1's
        requests go to every shard (pipelined, reconnect-once like any
        idempotent read); the dispatch-ahead worker computes its window
        while every shard's slice rides the wire, then
        :meth:`pull_join` collects round 1 and runs the cut protocol."""
        for c in self.clients:
            try:
                c.pull_send(min_updates)
            except (ConnectionError, OSError):
                c.reconnect()
                c.pull_send(min_updates)
        self._begun = True

    def pull_join(self) -> tuple:
        """Phase 2 of an overlapped pull: ``(center, total_updates,
        None, None)`` — the same leading shape as
        ``PSClient.pull_finish`` so the worker loop drives either client
        identically."""
        with self._span("ps.shard.pull"):
            try:
                center, total = self._pull_cut(first_sent=self._begun)
            finally:
                self._begun = False
            return center, total, None, None

    def _pull_cut(self, first_sent: bool = False) -> tuple:
        n = len(self.clients)
        results: List[Optional[tuple]] = [None] * n
        pending = list(range(n))
        min_updates = None
        prev_vvs = None
        stable = 0
        for rnd in range(MAX_CUT_ROUNDS):
            self._c_rounds.inc()
            replies = self._pull_round(
                pending, min_updates,
                presend=not (first_sent and rnd == 0))
            for i, r in replies.items():
                results[i] = r
            for i, (_, _, _, epoch) in enumerate(results):
                if epoch is not None and epoch != self.plan.epoch:
                    raise ShardPlanMismatch(
                        f"shard {i} serves plan epoch {epoch}, this "
                        f"client holds epoch {self.plan.epoch} — the "
                        "fleet was re-sharded under us")
            vvs = [self._norm_vv(r[2]) for r in results]
            target = {}
            for vv in vvs:
                for w, c in vv.items():
                    target[w] = max(target.get(w, 0), c)
            pending = [i for i, vv in enumerate(vvs) if vv != target]
            if not pending:
                return self._assemble(results)
            # a lagging shard's counter must reach the target's total
            # before its vector can possibly match — let the server wait
            # for its in-flight applies instead of re-shipping stale
            # slices round after round
            min_updates = sum(target.values())
            self._c_torn.inc()
            if vvs == prev_vvs:
                stable += 1
                if stable >= 2:
                    # no movement across three rounds: a committer died
                    # mid-fan-out and left a permanently torn commit.
                    # Serve the freshest cut rather than spin forever —
                    # recorded, and warned once per client.
                    self._c_incomplete.inc()
                    if not self._warned_incomplete:
                        self._warned_incomplete = True
                        self._log.warning(
                            "consistent-cut pull gave up waiting on a "
                            "permanently torn commit (shards %s lag the "
                            "fleet maximum); serving the freshest cut — "
                            "recorded as ps.shard.cut_incomplete", pending)
                    return self._assemble(results)
            else:
                stable = 0
            prev_vvs = vvs
            time.sleep(0.001)  # yield: let in-flight applies land
        raise ConsistentCutError(
            f"no consistent cut within {MAX_CUT_ROUNDS} pull rounds "
            f"(shards still torn: {pending}) — the fleet is committing "
            "faster than this client can snapshot it")

    def _assemble(self, results) -> tuple:
        t0 = time.perf_counter()
        self._pull_counters = [int(r[1]) for r in results]
        center = self.plan.assemble(*[r[0] for r in results])
        self._h_assemble.observe(time.perf_counter() - t0)
        return center, sum(self._pull_counters)

    # -- commit -------------------------------------------------------------
    def commit(self, delta: Tree, last_update: Optional[int] = None,
               gap_s: Optional[float] = None) -> bool:
        """Split the delta along the plan and commit every slice — one
        logical commit, one counter bump per shard, pipelined: every
        slice is on the wire before the first reply is read, so the
        shards' applies overlap under their own locks.
        ``last_update`` (DynSGD) is resolved to the PER-SHARD counters of
        the most recent pull: staleness is measured against each shard's
        own clock, which matches the single-server math because shard
        counters move in lockstep.  Never auto-retries a dead connection —
        it surfaces to the worker's retry policy with the other shards'
        replies drained.

        A fault-injector drop is handled by SHAPE: every shard dropped is
        the single-server lost-update (return False, vectors still
        aligned); SOME shards dropped is a torn logical commit — left
        alone the version vectors never re-agree and every future pull
        degrades to the ``cut_incomplete`` fallback — so the dropped
        slices are re-sent (bounded, each a recorded
        ``ps.shard.commit_repairs``) until the commit landed everywhere.
        Only identity codecs can re-send: an error-feedback codec's
        residual already absorbed the first encode, so re-encoding would
        double-count the delta — there the torn commit stands (the
        documented degraded path) and the commit reports False."""
        with self._span("ps.shard.commit"):
            slices = self.plan.split(delta)

            def _send(i: int) -> None:
                self.clients[i].commit_send(
                    slices[i],
                    last_update=self._pull_counters[i]
                    if last_update is not None else None,
                    gap_s=gap_s)

            def _finish(idxs) -> list:
                errs = []
                for i in idxs:
                    try:
                        ok[i] = self.clients[i].commit_finish()
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        errs.append(e)
                for e in errs:
                    if isinstance(e, WorkerEvicted):
                        raise e  # clean wind-down signal outranks faults
                if errs:
                    raise errs[0]
                return errs

            ok = [False] * len(self.clients)
            for i in range(len(self.clients)):
                _send(i)
            _finish(range(len(self.clients)))
            for _ in range(2):
                dropped = [i for i, o in enumerate(ok) if not o]
                if not dropped or not any(ok):
                    break  # landed everywhere, or a clean full drop
                if not all(self.clients[i].codec.is_identity
                           for i in dropped):
                    break  # EF residual already spent — can't re-send
                self._c_repairs.inc(len(dropped))
                for i in dropped:
                    _send(i)
                _finish(dropped)
            return all(ok)

    # -- the rest of the PSClient surface ------------------------------------
    def invalidate(self) -> None:
        """Drop every shard connection's center cache (see
        ``PSClient.invalidate``); DOWN references are kept per-link."""
        for c in self.clients:
            c.invalidate()

    def stats(self) -> dict:
        """One merged stats document + the per-shard replies (balance
        inspection): counters/histograms sum across shards, ground-truth
        counters take the consistent view (min for per-worker commits,
        max for the in-flight update edge)."""
        replies = [c.stats() for c in self.clients]
        return {**merge_fleet_stats(replies),
                "server": "ShardedParameterServer",
                "num_workers": replies[0].get("num_workers"),
                "plan": self.plan.descriptor(),
                "shards": replies}

    def close(self) -> None:
        for c in self.clients:
            c.close()  # PSClient.close already tolerates dead sockets

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
