"""Prometheus text exposition for registry snapshots — the port's copy of
``distkeras_tpu.obs.exposition``.

``to_prometheus_text(registry_or_snapshot)`` renders the standard text
format (``# TYPE`` lines, ``_total`` counters, cumulative
``_bucket{le=...}`` histogram series) so a poller that speaks Prometheus
can scrape a ``stats`` reply — or a snapshot file — without any adapter.
Instrument names are dotted (``ps.commits``); exposition maps them to the
legal Prometheus charset (``ps_commits``).  Same text as the JAX
package's for the same snapshot.
"""

from __future__ import annotations

import re

from .registry import Registry

_ILLEGAL = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _ILLEGAL.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus_text(source) -> str:
    """Registry (or plain snapshot dict) -> Prometheus text format."""
    snap = source.snapshot() if isinstance(source, Registry) else source
    lines = []
    for name in sorted(snap):
        s = snap[name]
        pname = _prom_name(name)
        kind = s["type"]
        if kind == "counter":
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_fmt(s['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(s['value'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound, c in zip(list(s["bounds"]) + [float("inf")],
                                s["counts"]):
                cum += c
                lines.append(
                    f'{pname}_bucket{{le="{_fmt(bound)}"}} {cum}')
            lines.append(f"{pname}_sum {_fmt(s['sum'])}")
            lines.append(f"{pname}_count {s['count']}")
        else:  # pragma: no cover - snapshots only carry the three kinds
            raise TypeError(f"unknown instrument type {kind!r} for {name!r}")
    return "\n".join(lines) + ("\n" if lines else "")
