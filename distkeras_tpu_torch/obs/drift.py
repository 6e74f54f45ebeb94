"""Interval deltas of live registries: the port's copy of
``distkeras_tpu.obs.drift.snapshot_delta`` and its per-instrument helper,
with the same semantics, so the telemetry store folds a snapshot from
either package alike.  The drift gate and the windowed classifier of
that module are not ported."""

from __future__ import annotations


def _instrument_delta(base: dict, cand: dict) -> dict:
    """One instrument's interval delta (see :func:`snapshot_delta`)."""
    if base.get("type") != cand.get("type"):
        return dict(cand)  # instrument re-registered as a new kind
    if cand["type"] == "counter":
        d = float(cand["value"]) - float(base["value"])
        # a negative delta means the process restarted mid-window; the
        # cand value IS that fresh process's interval
        return {"type": "counter", "value": d if d >= 0 else cand["value"]}
    if cand["type"] == "gauge":
        return dict(cand)  # levels have no meaningful subtraction
    if list(base["bounds"]) != list(cand["bounds"]):
        return dict(cand)  # schema change: start the series over
    counts = [c - b for b, c in zip(base["counts"], cand["counts"])]
    if any(c < 0 for c in counts):
        return dict(cand)  # restart mid-window
    return {"type": "histogram", "bounds": list(cand["bounds"]),
            "counts": counts, "sum": cand["sum"] - base["sum"],
            "count": cand["count"] - base["count"]}


def snapshot_delta(base: dict, cand: dict) -> dict:
    """Interval delta between two cumulative ``Registry.snapshot()``s of
    the SAME live registry taken at t0 < t1: counters and histograms
    subtract (the delta describes what happened *during* [t0, t1]),
    gauges keep the later level.  Metrics born mid-interval enter at
    their cand value; metrics that vanished are dropped."""
    out = {}
    for name, c in cand.items():
        b = base.get(name)
        out[name] = _instrument_delta(b, c) if b is not None else dict(c)
    return out
