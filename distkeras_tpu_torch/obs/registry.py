"""Metric instruments + registry, copied from ``distkeras_tpu.obs.registry``
and cut to what the port records through.

Same instrument kinds, metric names and plain-data snapshot format as the
JAX package, so a snapshot from either reads the same:

* ``Counter``   — monotone accumulator.
* ``Gauge``     — last-write-wins level.
* ``Histogram`` — fixed-bucket (cumulative-``le`` boundaries), with an
  interpolated quantile read-out.

Labeled instruments (``flat_name``) are not ported yet: no port module
records a labeled metric.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Sequence, Union

Number = Union[int, float]

#: latency buckets (seconds): 100 µs .. 10 s, roughly log-spaced
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonically-increasing accumulator."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
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
    """Last-write-wins level."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds
    (cumulative ``le`` semantics; an implicit +Inf bucket catches the
    tail)."""

    __slots__ = ("name", "bounds", "counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Sequence[Number] = TIME_BUCKETS):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be ascending")
        self.name = name
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

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation within the bucket
        holding the q-th observation."""
        return snapshot_quantile(self.snapshot(), q)

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "histogram", "bounds": list(self.bounds),
                    "counts": list(self.counts), "sum": self._sum,
                    "count": self._count}


def snapshot_quantile(snap: dict, q: float) -> float:
    """Quantile estimate straight from a histogram snapshot."""
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
    """Name → instrument map with get-or-create semantics; ``snapshot()``
    reduces every instrument to plain data."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: type, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = kind(name, **kw)
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"instrument {name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[Number] = TIME_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def get(self, name: str):
        return self._instruments.get(name)

    def snapshot(self) -> dict:
        """{name: instrument snapshot} — plain data, JSON-safe."""
        with self._lock:
            insts = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(insts.items())}


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry: where a component with no registry of
    its own records (the trainers' ``jit.*`` counters and ``mem.*``
    gauges)."""
    return _DEFAULT

