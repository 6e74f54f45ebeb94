"""Fleet time-series aggregation: the port's copy of
``distkeras_tpu.obs.timeseries`` (same ingest rules, series and summary
documents), the push half of the telemetry plane.

* :class:`TimeSeriesStore` — the aggregator.  Sources (workers, engines,
  a router's health poller) feed it ``snapshot_delta`` increments
  (counters/histograms subtract, gauges keep the later level); it keeps
  a bounded ring of timestamped increments per flat metric name plus a
  cumulative per-source total, so consumers read ONE live fleet series
  — windowed deltas, merged totals — instead of running their own poll
  loops.
* :class:`TelemetryShipper` — the producer side: wraps a registry, and
  on each ``maybe_ship`` past ``period_s`` computes the delta since its
  previous snapshot and hands it to a ``send`` callable (a
  ``PSClient.ship_telemetry`` RPC, or a direct ``store.ingest_delta``).

Timestamps are stamped by the RECEIVER's monotonic clock at ingest —
shipped frames carry no trusted time, so cross-process clock skew can
never tear a window.  Hostile input (non-finite values, negative
counts, malformed entries) is rejected per entry and counted in
``obs.telemetry.rejected``.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, Optional

from .drift import snapshot_delta
from .logging import get_logger
from .registry import Registry

#: ring-buffer points kept per metric: at the default 1 s ship cadence
#: this retains minutes of history — enough for any burn-rate window
#: pair while bounding a long-lived aggregator's memory
DEFAULT_MAX_POINTS = 720

#: distinct metric series accepted before new names are dropped (and
#: counted) — a hostile source can't balloon the aggregator
DEFAULT_MAX_SERIES = 8192


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def _valid_entry(e) -> bool:
    """One shipped instrument entry, validated before folding."""
    if not isinstance(e, dict):
        return False
    t = e.get("type")
    if t in ("counter", "gauge"):
        return _finite(e.get("value"))
    if t == "histogram":
        bounds, counts = e.get("bounds"), e.get("counts")
        if not isinstance(bounds, (list, tuple)) or \
                not isinstance(counts, (list, tuple)) or \
                len(counts) != len(bounds) + 1:
            return False
        if list(bounds) != sorted(bounds) or \
                not all(_finite(b) for b in bounds):
            return False
        if not all(_finite(c) and c >= 0 for c in counts):
            return False
        return _finite(e.get("sum")) and _finite(e.get("count")) \
            and e["count"] >= 0
    return False


def _zero_delta(e: dict) -> bool:
    """True when an increment carries no information (skip the ring)."""
    if e["type"] == "counter":
        return e["value"] == 0
    if e["type"] == "histogram":
        return e["count"] == 0 and not any(e["counts"])
    return False  # a gauge level is always news


def _strip(e: dict) -> dict:
    """Drop label metadata (a labeled snapshot ships ``name``/``labels``
    keys) — the store series are keyed by flat name already."""
    return {k: v for k, v in e.items() if k not in ("name", "labels")}


class TimeSeriesStore:
    """Bounded per-metric ring buffers of shipped increments + merged
    cumulative totals per source.  Thread-safe; every method takes and
    returns plain data only, so replies ride the wire unchanged."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 max_points: int = DEFAULT_MAX_POINTS,
                 max_series: int = DEFAULT_MAX_SERIES,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        #: flat metric name -> deque[(ts, entry-delta dict)]
        self._rings: Dict[str, collections.deque] = {}
        #: source -> cumulative merged snapshot of everything it shipped
        self._totals: Dict[str, dict] = {}
        #: source -> last raw cumulative snapshot (ingest_total deltas)
        self._last_cum: Dict[str, dict] = {}
        self._last_seen: Dict[str, float] = {}
        reg = registry
        self._c_frames = reg.counter("obs.telemetry.frames") if reg else None
        self._c_rejected = reg.counter("obs.telemetry.rejected") \
            if reg else None
        self._g_series = reg.gauge("obs.telemetry.series") if reg else None
        self._g_sources = reg.gauge("obs.telemetry.sources") if reg else None

    # -- ingest -------------------------------------------------------------
    def ingest_delta(self, source: str, delta: dict,
                     ts: Optional[float] = None) -> int:
        """Fold one shipped increment frame; returns accepted entries.
        Invalid entries are rejected individually — the rest of the
        frame still lands."""
        now = self._clock() if ts is None else float(ts)
        if not isinstance(delta, dict):
            delta = {}
        accepted = rejected = 0
        with self._lock:
            src = str(source)
            self._last_seen[src] = now
            totals = self._totals.setdefault(src, {})
            for name, raw in sorted(delta.items()):
                if not isinstance(name, str) or not _valid_entry(raw):
                    rejected += 1
                    continue
                e = _strip(raw)
                self._fold_total(totals, name, e)
                if _zero_delta(e):
                    accepted += 1
                    continue
                ring = self._rings.get(name)
                if ring is None:
                    if len(self._rings) >= self.max_series:
                        rejected += 1
                        continue
                    ring = self._rings[name] = collections.deque(
                        maxlen=self.max_points)
                ring.append((now, e))
                accepted += 1
            n_series, n_sources = len(self._rings), len(self._last_seen)
        if self._c_frames is not None:
            self._c_frames.inc()
            if rejected:
                self._c_rejected.inc(rejected)
            self._g_series.set(n_series)
            self._g_sources.set(n_sources)
        return accepted

    def ingest_total(self, source: str, snap: dict,
                     ts: Optional[float] = None) -> int:
        """Fold one CUMULATIVE registry snapshot from a poll-fed source
        (the router's health poller, an in-process supervisor): the
        store derives the increment against the source's previous
        snapshot itself, with the ``snapshot_delta`` restart clamp."""
        if not isinstance(snap, dict):
            snap = {}
        with self._lock:
            prev = self._last_cum.get(str(source), {})
        delta = snapshot_delta(prev, snap)
        n = self.ingest_delta(source, delta, ts=ts)
        with self._lock:
            self._last_cum[str(source)] = snap
        return n

    @staticmethod
    def _fold_total(totals: dict, name: str, e: dict) -> None:
        cur = totals.get(name)
        if cur is None or cur["type"] != e["type"]:
            totals[name] = {**e, "counts": list(e["counts"])} \
                if e["type"] == "histogram" else dict(e)
            return
        if e["type"] == "counter":
            cur["value"] += e["value"]
        elif e["type"] == "gauge":
            cur["value"] = e["value"]
        elif list(cur["bounds"]) == list(e["bounds"]):
            cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                   e["counts"])]
            cur["sum"] += e["sum"]
            cur["count"] += e["count"]
        else:  # bucket schema changed mid-run: restart the series
            totals[name] = {**e, "counts": list(e["counts"])}

    # -- read ---------------------------------------------------------------
    def latest(self) -> dict:
        """One merged fleet cumulative snapshot across every source."""
        with self._lock:
            parts = [dict(t) for t in self._totals.values()]
        return Registry.merge_snapshots(*parts) if parts else {}

    def window_delta(self, name: str, window_s: float,
                     now: Optional[float] = None) -> Optional[dict]:
        """The merged increment for ``name`` over the trailing window:
        counters sum, histograms add elementwise, gauges keep the latest
        level.  ``None`` when the window holds no points."""
        now = self._clock() if now is None else float(now)
        cut = now - float(window_s)
        with self._lock:
            ring = self._rings.get(name)
            pts = [e for ts, e in ring if ts >= cut] if ring else []
        if not pts:
            return None
        acc: dict = {}
        for e in pts:
            self._fold_total(acc, name, e)
        return acc.get(name)

    def series(self, name: str, window_s: Optional[float] = None) -> list:
        """Raw ``(ts, scalar)`` points for rendering: counter increment,
        gauge level, or histogram count increment."""
        now = self._clock()
        cut = now - float(window_s) if window_s is not None \
            else -math.inf
        with self._lock:
            ring = self._rings.get(name)
            pts = [(ts, e) for ts, e in ring if ts >= cut] if ring else []
        return [(ts, e["count"] if e["type"] == "histogram"
                 else e["value"]) for ts, e in pts]

    def names(self) -> list:
        with self._lock:
            return sorted(self._rings)

    def sources(self) -> dict:
        """source -> seconds since it last shipped."""
        now = self._clock()
        with self._lock:
            return {s: now - ts for s, ts in sorted(self._last_seen.items())}

    def summary(self) -> dict:
        """Plain-data description for the ``alerts`` RPC / obsview."""
        with self._lock:
            n_series = len(self._rings)
            n_points = sum(len(r) for r in self._rings.values())
        return {"series": n_series, "points": n_points,
                "sources": self.sources()}


class TelemetryShipper:
    """Periodic ``snapshot_delta`` shipping from one registry to one
    ``send(payload)`` callable.  Send failures are swallowed and counted
    (``obs.telemetry.ship_errors``) — telemetry must never take down the
    training/serving loop it instruments; the increment that failed to
    ship is NOT lost, it rides the next frame (the delta base only
    advances on success)."""

    def __init__(self, registry: Registry, send: Callable[[dict], object],
                 *, source: str, period_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.send = send
        self.source = str(source)
        self.period_s = float(period_s)
        self._clock = clock
        self._last_snap: dict = {}
        self._last_ship: Optional[float] = None
        self._c_ships = registry.counter("obs.telemetry.ships")
        self._c_errors = registry.counter("obs.telemetry.ship_errors")

    def maybe_ship(self, now: Optional[float] = None) -> bool:
        """Ship if ``period_s`` has elapsed since the last attempt (the
        first call always ships); returns True when a frame went out."""
        now = self._clock() if now is None else float(now)
        if self._last_ship is not None and \
                now - self._last_ship < self.period_s:
            return False
        return self.ship(now)

    def ship(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else float(now)
        self._last_ship = now
        cur = self.registry.snapshot()
        delta = {k: v for k, v in snapshot_delta(self._last_snap,
                                                 cur).items()
                 if not _zero_delta(v)}
        if not delta:
            self._last_snap = cur
            return False
        try:
            self.send({"action": "telemetry", "source": self.source,
                       "delta": delta})
        except Exception as e:
            self._c_errors.inc()
            get_logger("obs.telemetry").warning(
                "telemetry ship from %s failed (increments ride the next "
                "frame): %s", self.source, e)
            return False
        self._last_snap = cur
        self._c_ships.inc()
        return True
