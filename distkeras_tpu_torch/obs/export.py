"""Chrome Trace Event Format export of the telemetry JSONL — the port's
copy of ``distkeras_tpu.obs.export``: the same document for the same
records, so ``scripts/obsview.py --export-trace`` and this module agree.

The record stream (spans, heartbeats, epoch records) becomes one linked
timeline at ``ui.perfetto.dev``:

* one **process row per trace id** — each async worker is a pid named
  ``worker <k>``, the trainer's lazily-minted trace is ``process
  <trace_id>``;
* two **thread rows per worker process** — the worker's own spans on
  tid 0, the SERVER spans that adopted its trace over the wire
  (``ps.apply`` / ``ps.serve_pull``) on tid 1;
* **flow arrows** (``ph: s``/``f``) for every cross-thread parent link;
* heartbeats as instant events, per-epoch records as duration events on
  a ``run`` process, and ``live_bytes`` memory samples as counter tracks.

Everything is a pure function over plain record dicts.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional, Tuple

#: span names emitted by the SERVER side of the PS wire while adopting a
#: remote trace — rendered as a separate thread row inside the adopting
#: worker's process so parent/child shows as nesting, not interleaving
SERVER_SPAN_NAMES = ("ps.apply", "ps.serve_pull")

#: MetricsLogger's json_safe writes non-finite floats as these strings
_NONFINITE = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}

_WORKER_TRACE = re.compile(r"^w(\d+)$")


def _num(v, default: float = math.nan) -> float:
    if isinstance(v, str):
        v = _NONFINITE.get(v, v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _finite(v) -> Optional[float]:
    f = _num(v)
    return f if math.isfinite(f) else None


def _trace_sort_key(trace_id: str) -> Tuple:
    """Workers first, numerically (``w10`` after ``w2``), then everything
    else lexicographically — stable pids across exports of the same run."""
    m = _WORKER_TRACE.match(trace_id)
    if m:
        return (0, int(m.group(1)), trace_id)
    return (1, 0, trace_id)


def _process_name(trace_id: str) -> str:
    m = _WORKER_TRACE.match(trace_id)
    if m:
        return f"worker {m.group(1)}"
    return f"process {trace_id}"


def records_to_chrome_trace(records: List[dict]) -> dict:
    """Telemetry records -> a Chrome Trace Event Format document
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``).

    Timestamps: span records are stamped at CLOSE (``ts`` is the emit
    wall clock, ``seconds`` the duration), so each event starts at
    ``ts - seconds``; the whole trace is rebased to the earliest start so
    Perfetto opens at t=0 regardless of wall-clock epoch."""
    spans, heartbeats, epochs = [], [], []
    for r in records:
        ev = r.get("event")
        if ev == "span" and _finite(r.get("ts")) is not None \
                and _finite(r.get("seconds")) is not None:
            spans.append(r)
        elif ev == "heartbeat" and _finite(r.get("ts")) is not None:
            heartbeats.append(r)
        elif ev == "epoch" and _finite(r.get("ts")) is not None:
            epochs.append(r)

    #: the run pid hosts trace-less records (per-epoch rows)
    RUN_PID = 0
    trace_ids = sorted({str(s.get("trace_id", "?")) for s in spans}
                      | {f"w{h['worker_id']}" for h in heartbeats
                         if h.get("worker_id") is not None},
                      key=_trace_sort_key)
    pid_of = {t: i + 1 for i, t in enumerate(trace_ids)}

    def span_tid(s: dict) -> int:
        return 1 if s.get("name") in SERVER_SPAN_NAMES else 0

    # rebase: earliest event start anywhere in the stream
    starts = [_num(s["ts"]) - _num(s["seconds"]) for s in spans]
    starts += [_num(h["ts"]) for h in heartbeats]
    starts += [_num(e["ts"]) - _num(e.get("epoch_seconds"), 0.0)
               for e in epochs]
    t0 = min((t for t in starts if math.isfinite(t)), default=0.0)

    def us(wall: float) -> float:
        return max(0.0, (wall - t0) * 1e6)

    events: List[dict] = []
    if epochs or not trace_ids:
        events.append({"ph": "M", "name": "process_name", "pid": RUN_PID,
                       "args": {"name": "run"}})
        events.append({"ph": "M", "name": "process_sort_index",
                       "pid": RUN_PID, "args": {"sort_index": -1}})
    for t, pid in pid_of.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": _process_name(t)}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "args": {"sort_index": pid}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": 0, "args": {"name": "worker"
                                          if _WORKER_TRACE.match(t)
                                          else "main"}})
        if any(str(s.get("trace_id")) == t and span_tid(s) == 1
               for s in spans):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 1, "args": {"name": "ps server"}})

    # where each span landed, for flow-arrow endpoints
    placed: Dict[str, Tuple[int, int, float]] = {}
    for s in spans:
        pid = pid_of.get(str(s.get("trace_id", "?")), RUN_PID)
        tid = span_tid(s)
        dur_s = _num(s["seconds"])
        start = us(_num(s["ts"]) - dur_s)
        args = {"span_id": s.get("span_id"), "trace_id": s.get("trace_id"),
                "path": s.get("path"), "depth": s.get("depth")}
        if s.get("parent_span") is not None:
            args["parent_span"] = s["parent_span"]
        if s.get("worker") is not None:
            args["worker"] = s["worker"]
        if s.get("error"):
            args["error"] = True
        events.append({"name": s.get("name", "?"), "cat": "span",
                       "ph": "X", "pid": pid, "tid": tid, "ts": start,
                       "dur": max(0.0, dur_s * 1e6), "args": args})
        if s.get("span_id") is not None:
            placed[str(s["span_id"])] = (pid, tid, start)

    # flow arrows for parent links that CROSS a thread/process row —
    # same-thread nesting already reads as containment
    flow_id = 0
    for s in spans:
        parent = s.get("parent_span")
        if parent is None or str(parent) not in placed:
            continue
        child_pid = pid_of.get(str(s.get("trace_id", "?")), RUN_PID)
        child_tid = span_tid(s)
        p_pid, p_tid, p_start = placed[str(parent)]
        if (p_pid, p_tid) == (child_pid, child_tid):
            continue
        flow_id += 1
        child_start = us(_num(s["ts"]) - _num(s["seconds"]))
        events.append({"name": "trace", "cat": "flow", "ph": "s",
                       "id": flow_id, "pid": p_pid, "tid": p_tid,
                       "ts": p_start,
                       "args": {"span_id": str(parent)}})
        events.append({"name": "trace", "cat": "flow", "ph": "f",
                       "bp": "e", "id": flow_id, "pid": child_pid,
                       "tid": child_tid, "ts": child_start,
                       "args": {"span_id": s.get("span_id")}})

    for h in heartbeats:
        w = h.get("worker_id", h.get("worker"))
        pid = pid_of.get(f"w{w}", RUN_PID)
        args = {k: h[k] for k in ("window", "epoch", "gap_s", "mean_loss")
                if h.get(k) is not None}
        events.append({"name": "heartbeat", "cat": "heartbeat", "ph": "i",
                       "s": "t", "pid": pid, "tid": 0,
                       "ts": us(_num(h["ts"])), "args": args})
        live = _finite(h.get("live_bytes"))
        if live is not None:
            events.append({"name": "live_bytes", "cat": "memory",
                           "ph": "C", "pid": pid, "tid": 0,
                           "ts": us(_num(h["ts"])),
                           "args": {"bytes": live}})

    for e in epochs:
        dur_s = max(0.0, _num(e.get("epoch_seconds"), 0.0))
        events.append({"name": f"epoch {e.get('epoch', '?')}",
                       "cat": "epoch", "ph": "X", "pid": RUN_PID, "tid": 0,
                       "ts": us(_num(e["ts"]) - dur_s),
                       "dur": dur_s * 1e6,
                       "args": {k: e[k] for k in
                                ("trainer", "epoch", "mean_loss",
                                 "samples_per_sec") if e.get(k) is not None}})
        live = _finite(e.get("live_bytes"))
        if live is not None:
            events.append({"name": "live_bytes", "cat": "memory", "ph": "C",
                           "pid": RUN_PID, "tid": 0,
                           "ts": us(_num(e["ts"])),
                           "args": {"bytes": live}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"format": "distkeras_tpu obs export",
                          "traces": {t: pid_of[t] for t in trace_ids}}}


def write_chrome_trace(records: List[dict], path: str) -> dict:
    """Export ``records`` to ``path`` as Chrome trace JSON; returns the
    document (callers report event counts without re-reading)."""
    doc = records_to_chrome_trace(records)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
