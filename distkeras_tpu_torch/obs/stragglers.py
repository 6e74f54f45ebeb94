"""Straggler detection over per-window worker heartbeats — the port's copy
of ``distkeras_tpu.obs.stragglers``.

The async trainers fail *statistically*: a slow worker never raises — it
just stretches the staleness/latency distributions (the exact failure
mode the paper's DynSGD rule exists to tolerate).  This module turns the
per-window heartbeat cadence the workers already emit into a live signal:

* ``StragglerDetector`` keeps a rolling EWMA of each worker's
  heartbeat gap (monotonic seconds between committed windows, shipped on
  the commit RPC as ``gap_s``) and flags any worker whose EWMA exceeds
  ``k×`` the fleet median.  Flagged count lands in a ``ps.stragglers``
  gauge (visible in the live ``stats`` RPC / ``obsview --ps``), per-worker
  EWMAs in ``ps.heartbeat_gap_ewma.worker<k>`` gauges, and the FIRST time
  a worker is flagged a single warn log names it — one line per incident,
  not one per window.

* ``LinkQuality`` is the **link half** of the same picture,
  living on the CLIENT next to the adaptive DOWN-codec policy: per-link
  pull/commit RTT EWMAs with a degradation edge against the best RTT the
  link has shown.  The adaptive policy consumes ``degraded()`` to
  downshift the codec (and tighten its reprobe schedule) BEFORE the
  worker's stretched window gap gets it flagged here, and the client
  ships its EWMA on every commit (``link_rtt_s``) so the server-side
  detector's snapshot renders gap and link side by side — a stretched
  gap whose link stretched equally is wire-degraded, not compute-stuck.

Thresholding is median-relative, not absolute: window wall time is
workload-dependent, but the *fleet* trains identical windows, so a worker
k× slower than the median is anomalous at any absolute scale.  The
``min_gap_s`` floor keeps sub-millisecond jitter on toy workloads from
flagging anything.
"""

from __future__ import annotations

import bisect
import math
import statistics
import threading
from typing import Dict, List, Optional, Sequence

from .logging import get_logger
from .registry import Registry


def _loo_median(vals_sorted: Sequence[float], i: int) -> float:
    """Median of ``vals_sorted`` with the element at index ``i`` removed
    (for equal values any occurrence's removal leaves the same multiset).
    Index math over the shared sort — the O(1) inner step that keeps the
    per-commit re-evaluation at one sort total."""
    m = len(vals_sorted) - 1

    def at(j: int) -> float:  # j-th element of the remainder
        return vals_sorted[j if j < i else j + 1]

    if m % 2:                        # odd remainder: single middle value
        return at(m // 2)
    return (at(m // 2 - 1) + at(m // 2)) / 2.0


class LinkQuality:
    """Per-link RTT EWMAs (pull + commit) with a degradation edge
   .  One instance per PS connection, on the CLIENT — the end
    that actually measures the link.

    The pull EWMA folds the VISIBLE pull wait (blocked-on-reply ->
    decoded): for a sequential pull that is the wire RTT; for a
    dispatch-ahead pull it is the drain left after compute — the pull's
    critical-path cost either way, and deliberately NOT the
    send-to-decode span, which under overlap would count the caller's
    whole device step as link time.  The commit EWMA is a full
    synchronous wire RTT.  Either direction's degradation trips the
    edge.

    ``degraded()`` is True while either direction's EWMA exceeds
    ``degrade_factor`` × the best EWMA that direction has shown (floored
    at ``min_rtt_s`` so toy-fast links never read as degraded).  After a
    consumer ACTS on the edge (the adaptive policy's codec downshift),
    :meth:`rebase` adopts the current EWMAs as the new baseline — the
    link's byte profile just changed, so the old best is no longer the
    comparison point (and the edge self-cools instead of re-firing every
    pull).  Thread-safe; hostile inputs (NaN, negative) are rejected
    before they can poison an EWMA."""

    def __init__(self, alpha: float = 0.25, degrade_factor: float = 2.5,
                 min_rtt_s: float = 1e-3, registry=None):
        if degrade_factor <= 1.0:
            raise ValueError(f"degrade_factor must exceed 1, "
                             f"got {degrade_factor}")
        self.alpha = float(alpha)
        self.degrade_factor = float(degrade_factor)
        self.min_rtt_s = float(min_rtt_s)
        self.registry = registry
        self._lock = threading.Lock()
        self._ewma: Dict[str, Optional[float]] = {"pull": None,
                                                  "commit": None}
        self._best: Dict[str, Optional[float]] = {"pull": None,
                                                  "commit": None}

    def _fold(self, kind: str, rtt_s) -> None:
        try:
            r = float(rtt_s)
        except (TypeError, ValueError):
            return
        if not math.isfinite(r) or r < 0:
            return
        with self._lock:
            prev = self._ewma[kind]
            cur = r if prev is None \
                else self.alpha * r + (1.0 - self.alpha) * prev
            self._ewma[kind] = cur
            best = self._best[kind]
            if best is None or cur < best:
                self._best[kind] = cur
        if self.registry is not None:
            self.registry.gauge(f"ps.link.{kind}_rtt_ewma").set(cur)

    def observe_pull(self, rtt_s) -> None:
        self._fold("pull", rtt_s)

    def observe_commit(self, rtt_s) -> None:
        self._fold("commit", rtt_s)

    @property
    def ewma(self) -> Optional[float]:
        """The link's representative RTT EWMA — the pull direction when
        it has samples (pulls carry the center, the dominant bytes),
        else the commit direction."""
        with self._lock:
            return self._ewma["pull"] if self._ewma["pull"] is not None \
                else self._ewma["commit"]

    def degraded(self) -> bool:
        with self._lock:
            return any(
                e is not None and b is not None
                and e > self.degrade_factor * max(b, self.min_rtt_s)
                for e, b in ((self._ewma[k], self._best[k])
                             for k in ("pull", "commit")))

    def rebase(self) -> None:
        """Adopt the current EWMAs as the new baseline (called after a
        consumer acted on the degradation edge)."""
        with self._lock:
            for k in ("pull", "commit"):
                self._best[k] = self._ewma[k]

    def snapshot(self) -> dict:
        with self._lock:
            return {"ewma_s": dict(self._ewma), "best_s": dict(self._best),
                    "degrade_factor": self.degrade_factor}


class StragglerDetector:
    """Rolling heartbeat-gap EWMA per worker, fleet-median flagging.

    ``record(worker_id, gap_s)`` is called once per committed window (the
    PS server feeds it from the commit RPC's ``gap_s`` field); it updates
    the worker's EWMA, re-evaluates the fleet, and maintains the
    ``ps.stragglers`` gauge.  Thread-safe — handler threads call it
    concurrently.
    """

    def __init__(self, k: float = 3.0, alpha: float = 0.25,
                 min_workers: int = 2, min_gap_s: float = 1e-3,
                 weight_floor: float = 0.1,
                 registry: Optional[Registry] = None):
        if k <= 1.0:
            raise ValueError(f"straggler threshold k must exceed 1, got {k}")
        self.k = float(k)
        self.alpha = float(alpha)
        #: a fleet of one has no peers to straggle behind
        self.min_workers = int(min_workers)
        #: median floor: below this the fleet is too fast for a multiple
        #: of the median to mean anything (toy tests, cache-warm windows)
        self.min_gap_s = float(min_gap_s)
        #: down-weighting floor: a flagged worker's commits are
        #: never scaled below this — evict-and-respawn, not starvation, is
        #: the remedy for a worker this far gone
        self.weight_floor = float(weight_floor)
        self.registry = registry
        self._lock = threading.Lock()
        self._ewma: Dict[int, float] = {}
        self._flagged: set = set()   # currently over threshold
        #: per-worker link RTT EWMAs + codec-downshift tallies shipped on
        #: the commit RPC — already EWMAs client-side, so the
        #: latest value wins; rendered next to the gap EWMAs so the
        #: numbers that justify (or excuse) a flag sit side by side
        self._link: Dict[int, float] = {}
        self._link_downshifts: Dict[int, int] = {}
        self._log = get_logger("obs.stragglers")

    def record(self, worker_id, gap_s) -> bool:
        """Fold one heartbeat gap in; returns True iff ``worker_id`` is
        currently flagged as a straggler."""
        try:
            w = int(worker_id)
            gap = float(gap_s)
        except (TypeError, ValueError):
            return False
        # gap_s arrives off the untrusted wire: one NaN would poison the
        # EWMA forever (alpha·gap + (1−alpha)·NaN stays NaN) and a NaN
        # member breaks every peer's median — reject non-finite outright
        if not math.isfinite(gap) or gap < 0:
            return False
        with self._lock:
            prev = self._ewma.get(w)
            cur = gap if prev is None \
                else self.alpha * gap + (1.0 - self.alpha) * prev
            self._ewma[w] = cur
            # rising-edge logging: one warn per INCIDENT — a worker that
            # recovers and later straggles again crosses the edge again
            prev_flagged = set(self._flagged)
            flagged = self._reeval(updated=w)
            newly = flagged - prev_flagged
            ewma = dict(self._ewma)
        for nw in sorted(newly):
            peers = [v for p, v in ewma.items() if p != nw]
            self._log.warning(
                "straggler: worker %d heartbeat-gap EWMA %.3fs exceeds "
                "%.1fx peer median %.3fs", nw, ewma[nw], self.k,
                statistics.median(peers) if peers else 0.0)
        return w in flagged

    def _reeval(self, updated=None) -> set:  # caller holds self._lock
        ewma = self._ewma
        if len(ewma) >= self.min_workers:
            # leave-one-out median: each worker is judged against its
            # PEERS.  A self-inclusive median breaks down on small fleets
            # — with 2 workers the straggler pulls the median halfway to
            # itself and k=3 becomes mathematically unreachable.  This
            # runs on the commit hot path under the detector lock, so the
            # per-worker medians come from ONE shared sort (index math
            # removes each worker's own value) — O(W log W) per commit,
            # not O(W² log W).
            vals = sorted(ewma.values())
            flagged = set()
            for w, e in ewma.items():
                median = _loo_median(vals, bisect.bisect_left(vals, e))
                if e > self.k * max(median, self.min_gap_s):
                    flagged.add(w)
            self._flagged = flagged
        else:
            self._flagged = set()
        if self.registry is not None:
            self.registry.gauge("ps.stragglers").set(len(self._flagged))
            # only the recorded worker's EWMA moved; peers' gauges were
            # set when THEY last recorded
            targets = ewma if updated is None or updated not in ewma \
                else {updated: ewma[updated]}
            for w, e in targets.items():
                # labeled series; flattens to the legacy
                # ps.heartbeat_gap_ewma.worker<k> name
                self.registry.gauge("ps.heartbeat_gap_ewma",
                                    labels={"worker": w}).set(e)
        return set(self._flagged)

    def record_link(self, worker_id, rtt_s, downshifts=None) -> None:
        """Fold one worker's reported link RTT EWMA (the commit RPC's
        ``link_rtt_s`` field) and, when present, its
        cumulative codec-downshift count.  Hostile values are rejected
        like ``record``'s ``gap_s``."""
        try:
            w = int(worker_id)
            r = float(rtt_s)
        except (TypeError, ValueError):
            return
        if not math.isfinite(r) or r < 0:
            return
        with self._lock:
            self._link[w] = r
            if downshifts is not None:
                try:
                    self._link_downshifts[w] = int(downshifts)
                except (TypeError, ValueError):
                    pass
        if self.registry is not None:
            self.registry.gauge("ps.link.rtt_ewma",
                                labels={"worker": w}).set(r)

    def commit_weight(self, worker_id) -> float:
        """DynSGD-style down-weighting multiplier for this worker's NEXT
        commit (the first rung of self-healing): an unflagged worker commits at full
        weight 1.0; a flagged straggler's commits are scaled by its peer
        median over its own EWMA — a worker whose cadence is 5× the
        fleet's contributes 1/5 of its delta, exactly the shape of
        DynSGD's 1/(staleness+1) rule but driven by the *liveness*
        signal instead of the update counter.  Floored at
        ``weight_floor``; restored to 1.0 the moment the flag clears."""
        try:
            w = int(worker_id)
        except (TypeError, ValueError):
            return 1.0
        with self._lock:
            if w not in self._flagged:
                return 1.0
            ewma = self._ewma.get(w)
            peers = [v for p, v in self._ewma.items() if p != w]
            if not peers or not ewma or ewma <= 0:
                return 1.0
            median = max(statistics.median(peers), self.min_gap_s)
            return max(self.weight_floor, min(1.0, median / ewma))

    @property
    def stragglers(self) -> List[int]:
        with self._lock:
            return sorted(self._flagged)

    def snapshot(self) -> dict:
        """Plain-data state for the ``stats`` RPC reply / post-mortems.
        ``peer_median_s`` is each worker's LEAVE-ONE-OUT peer median — the
        same quantity the flag threshold multiplies, so the rendered
        numbers always justify the flags shown next to them."""
        with self._lock:
            ewma = dict(self._ewma)
            flagged = sorted(self._flagged)
            link = dict(self._link)
            downshifts = dict(self._link_downshifts)
        return {"k": self.k, "alpha": self.alpha,
                "min_gap_s": self.min_gap_s,
                "link_rtt_s": {str(w): link[w] for w in sorted(link)},
                "link_downshifts": {str(w): downshifts[w]
                                    for w in sorted(downshifts)},
                "gap_ewma_s": {str(w): ewma[w] for w in sorted(ewma)},
                "peer_median_s": {
                    str(w): statistics.median(
                        [v for p, v in ewma.items() if p != w])
                    if len(ewma) > 1 else 0.0
                    for w in sorted(ewma)},
                "stragglers": flagged}


def detect_from_heartbeats(records, k: float = 3.0, alpha: float = 0.25,
                           min_workers: int = 2,
                           min_gap_s: float = 1e-3) -> dict:
    """Replay a recorded heartbeat stream through the detector — the
    offline half (``obsview`` run files).  ``records`` are JSONL dicts;
    only ``event == "heartbeat"`` entries carrying ``gap_s`` count (old
    streams without ``gap_s`` yield an empty fleet, never a crash)."""
    det = StragglerDetector(k=k, alpha=alpha, min_workers=min_workers,
                            min_gap_s=min_gap_s)
    for r in records:
        if r.get("event") != "heartbeat" or r.get("gap_s") is None:
            continue
        w = r.get("worker_id", r.get("worker"))
        if w is not None:
            det.record(w, r["gap_s"])
            if r.get("link_rtt_s") is not None:
                # the heartbeat-borne link half replays too
                det.record_link(w, r["link_rtt_s"],
                                r.get("link_downshifts"))
    return det.snapshot()
