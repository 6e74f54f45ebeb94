"""Metric instruments + registry, the port's copy of
``distkeras_tpu.obs.registry``: the same instrument kinds, metric names,
flat-name label rule and plain-data snapshot format, so a snapshot from
either package reads the same (and travels over the PS wire as a
``stats`` reply unchanged).

* ``Counter``   — monotone accumulator (commits, bytes, batches).
* ``Gauge``     — last-write-wins level (queue depth, in-flight).
* ``Histogram`` — fixed-bucket (cumulative-``le`` boundaries), with an
  interpolated quantile read-out.

Labeled instruments live under their flat name (``flat_name``:
``("ps.staleness", {"worker": 3})`` is ``"ps.staleness.worker3"``).
``Registry.merge_snapshots`` folds plain-data snapshots together
(counters and histograms add, gauges take the later value): the serve
router's fleet view and the telemetry store's totals.  A ``Registry``
is a name → instrument map with get-or-create semantics; the
process-wide ``default_registry()`` serves call sites with no better
home (networking byte counts, the trainers' ``jit.*`` counters), while
servers own private registries so their snapshots describe exactly one
component.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Mapping, Optional, Sequence, Union

Number = Union[int, float]

#: label keys are identifier-shaped; values concatenate into the flat
#: name, so anything that would start a new ``.``-segment is rejected
_LABEL_KEY = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_VALUE = re.compile(r"^[A-Za-z0-9_:-]+$")


def flat_name(name: str, labels: Optional[Mapping[str, object]] = None
              ) -> str:
    """The back-compat flattening rule: a labeled instrument
    lives in the registry under ``name + ".<key><value>"`` per label in
    sorted key order — ``("ps.staleness", {"worker": 3})`` flattens to
    ``"ps.staleness.worker3"``, exactly the name the pre-label
    ``worker<k>`` families used, so OBS_BASELINE patterns, obsview
    renderers and the metric-contract gates keep matching
    unchanged."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        if not isinstance(k, str) or not _LABEL_KEY.match(k):
            raise ValueError(
                f"metric {name!r}: bad label key {k!r} (want "
                f"[a-z][a-z0-9_]*)")
        v = str(labels[k])
        if not _LABEL_VALUE.match(v):
            raise ValueError(
                f"metric {name!r}: bad label value {v!r} for key {k!r} "
                f"(no whitespace/dots — it embeds in the flat name)")
        parts.append(f".{k}{v}")
    return name + "".join(parts)


def flatten_snapshot(snap: dict) -> dict:
    """Strip label metadata from a (possibly labeled) snapshot, leaving
    the plain flat-name form every pre-label consumer reads.  Entries
    are already keyed by flat name, so flattening never merges or drops
    a series — it only removes the ``name``/``labels`` keys."""
    return {k: {kk: vv for kk, vv in e.items()
                if kk not in ("name", "labels")}
            for k, e in snap.items()}

#: latency buckets (seconds): 100 µs .. 10 s, roughly log-spaced — spans
#: the sub-ms localhost PS round-trip and the multi-second compile
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: small-integer buckets for staleness / queue depths
COUNT_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


class Counter:
    """Monotonically-increasing accumulator."""

    __slots__ = ("name", "base_name", "labels", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.base_name = name
        self.labels: Optional[dict] = None
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins level; ``inc``/``dec`` for up-down tracking."""

    __slots__ = ("name", "base_name", "labels", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.base_name = name
        self.labels: Optional[dict] = None
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: Number = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds
    (cumulative ``le`` semantics à la Prometheus; an implicit +Inf bucket
    catches the tail).  Mergeable: two histograms with identical bounds
    add elementwise (``merge``)."""

    __slots__ = ("name", "base_name", "labels", "bounds", "counts",
                 "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Sequence[Number] = TIME_BUCKETS):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be ascending")
        self.name = name
        self.base_name = name
        self.labels: Optional[dict] = None
        self.bounds = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation within the bucket
        holding the q-th observation (the standard fixed-bucket estimate;
        exact enough for run summaries)."""
        return _snapshot_quantile(self.snapshot(), q)

    def merge(self, other: Union["Histogram", dict]) -> None:
        """Add ``other`` (a Histogram or a histogram snapshot) into this
        one; bucket bounds must match."""
        snap = other.snapshot() if isinstance(other, Histogram) else other
        if tuple(snap["bounds"]) != self.bounds:
            raise ValueError(
                f"histogram {self.name}: cannot merge bounds "
                f"{tuple(snap['bounds'])} into {self.bounds}")
        with self._lock:
            for i, c in enumerate(snap["counts"]):
                self.counts[i] += c
            self._sum += snap["sum"]
            self._count += snap["count"]

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "bounds": list(self.bounds),
                    "counts": list(self.counts), "sum": self._sum,
                    "count": self._count}


def _snapshot_quantile(snap: dict, q: float) -> float:
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    total = snap["count"]
    if total == 0:
        return 0.0
    bounds, counts = list(snap["bounds"]), snap["counts"]
    target = q * total
    seen = 0.0
    lo = 0.0 if not bounds or bounds[0] >= 0 else bounds[0]
    for i, c in enumerate(counts):
        if seen + c >= target and c:
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (target - seen) / c
            return lo + (hi - lo) * frac
        seen += c
        if i < len(bounds):
            lo = bounds[i]
    return bounds[-1] if bounds else 0.0


class Registry:
    """Name → instrument map with get-or-create semantics.

    ``snapshot()`` reduces every instrument to plain data."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: type,
             labels: Optional[Mapping[str, object]] = None, **kw):
        flat = flat_name(name, labels)
        with self._lock:
            inst = self._instruments.get(flat)
            if inst is None:
                inst = self._instruments[flat] = kind(flat, **kw)
                if labels:
                    inst.base_name = name
                    inst.labels = {k: str(labels[k]) for k in sorted(labels)}
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"instrument {flat!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}")
            return inst

    def counter(self, name: str,
                labels: Optional[Mapping[str, object]] = None) -> Counter:
        return self._get(name, Counter, labels=labels)

    def gauge(self, name: str,
              labels: Optional[Mapping[str, object]] = None) -> Gauge:
        return self._get(name, Gauge, labels=labels)

    def histogram(self, name: str,
                  buckets: Sequence[Number] = TIME_BUCKETS, *,
                  labels: Optional[Mapping[str, object]] = None) -> Histogram:
        return self._get(name, Histogram, labels=labels, buckets=buckets)

    def get(self, name: str,
            labels: Optional[Mapping[str, object]] = None):
        return self._instruments.get(flat_name(name, labels))

    def snapshot(self, labeled: bool = False) -> dict:
        """{flat name: instrument snapshot} — plain data, wire/JSON-safe.

        ``labeled=True`` adds ``name``/``labels`` metadata keys to every
        entry whose instrument carries labels; keys stay the FLAT names
        either way (``flatten_snapshot`` strips the metadata)."""
        with self._lock:
            insts = dict(self._instruments)
        out = {}
        for name, inst in sorted(insts.items()):
            e = inst.snapshot()
            if labeled and inst.labels:
                e["name"] = inst.base_name
                e["labels"] = dict(inst.labels)
            out[name] = e
        return out

    @staticmethod
    def merge_snapshots(*snaps: dict) -> dict:
        """Fold plain-data snapshots: counters and histograms add, gauges
        keep the last value seen (there is no meaningful sum of levels)."""
        out: dict = {}
        for snap in snaps:
            for name, s in snap.items():
                cur = out.get(name)
                if cur is None:
                    out[name] = {**s, "counts": list(s["counts"])} \
                        if s["type"] == "histogram" else dict(s)
                    continue
                if cur["type"] != s["type"]:
                    raise TypeError(f"instrument {name!r}: cannot merge "
                                    f"{s['type']} into {cur['type']}")
                if s["type"] == "counter":
                    cur["value"] += s["value"]
                elif s["type"] == "gauge":
                    cur["value"] = s["value"]
                else:
                    if list(cur["bounds"]) != list(s["bounds"]):
                        raise ValueError(
                            f"histogram {name!r}: bucket bounds differ")
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], s["counts"])]
                    cur["sum"] += s["sum"]
                    cur["count"] += s["count"]
        return out


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry — call sites with no component-scoped
    registry (networking byte counts, streaming prefetch) land here."""
    return _DEFAULT


def snapshot_quantile(snap: dict, q: float) -> float:
    """Quantile estimate straight from a histogram snapshot (obsview and
    other consumers that never held the live instrument)."""
    return _snapshot_quantile(snap, q)
