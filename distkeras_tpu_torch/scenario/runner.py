"""Open-loop scenario runner — the port's copy of
``distkeras_tpu.scenario.runner``: fire a :class:`ScenarioSpec` at the
serve fleet AT ITS TRACE TIMESTAMPS, regardless of completion.

A dispatcher thread walks the arrival schedule on the wall clock and
hands each request to a worker pool the moment its timestamp comes due.
If every worker is busy the request *waits dispatched*, and the wait is
recorded as ``scenario.dispatch_skew_seconds`` (start-minus-scheduled),
so generator lag can never masquerade as server latency.

Accounting is exact by construction: every dispatched request ends in
exactly one of three ways —

* **completed** — the server replied ``ok`` (SLO verdict + goodput
  tokens recorded from the server-measured ttft/e2e in the reply),
* **rejected** — the admission controller load-shed it (or the request
  errored server-side),
* **timeouts** — the client-side deadline fired, or the connection died
  — either way the CLIENT gave up.

and ``scenario.dispatched == completed + rejected + timeouts`` is
asserted at drain (:meth:`ScenarioRunner.run` raises on mismatch).
Phase attribution is by ARRIVAL time, while the interval registry
snapshots cut at the phase-boundary wall times attribute server-side
histograms by COMPLETION time — both views ride the returned row.

Chaos hook: :meth:`mark_eviction` stamps "an engine just died"; the
next completed request closes the window into
``scenario.recovery_seconds``.  The wire is the JAX package's, so the
runner drives either package's router or server.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import TIME_BUCKETS, Registry, default_registry
from ..obs.logging import get_logger
from ..utils.metrics import MetricsLogger
from .slo import PhaseAccountant, SLOTarget
from .traces import ScenarioSpec

_LOG = "scenario.runner"

#: every instrument the runner touches, pre-created before traffic so a
#: scenario that never sheds/times out/recovers shows 0 —
#: present-not-missing — in drift diffs
SCENARIO_COUNTERS = (
    "scenario.dispatched", "scenario.completed", "scenario.rejected",
    "scenario.timeouts", "scenario.slo_met", "scenario.slo_missed",
    "scenario.goodput_tokens", "scenario.scale_up", "scenario.scale_down",
)
SCENARIO_HISTOGRAMS = (
    "scenario.dispatch_skew_seconds", "scenario.recovery_seconds",
)


def precreate_metrics(registry: Optional[Registry] = None) -> Registry:
    """Materialize every ``scenario.*`` counter/histogram at 0."""
    reg = registry if registry is not None else default_registry()
    for name in SCENARIO_COUNTERS:
        reg.counter(name)
    for name in SCENARIO_HISTOGRAMS:
        reg.histogram(name, TIME_BUCKETS)
    return reg


def _blank_tally() -> Dict[str, int]:
    return {"offered": 0, "completed": 0, "rejected": 0, "timeouts": 0,
            "slo_met": 0, "goodput_tokens": 0}


def build_prompt(arrival, idx: int, vocab: int,
                 prefix_len: int = 8) -> np.ndarray:
    """Deterministic prompt tokens for one arrival: requests of the
    same ``group`` share their first ``prefix_len`` tokens (the shared
    system prompt the affinity router and KV cache key on), the rest is
    unique per request index.  Pure function of (arrival, idx, vocab,
    prefix_len) — replaying a trace replays the exact token streams."""
    n = int(arrival.prompt_len)
    if arrival.group >= 0 and n > 1:
        p = min(int(prefix_len), n - 1)
        head = np.random.default_rng(1_000_003 + arrival.group) \
            .integers(0, vocab, size=p)
        tail = np.random.default_rng(7_000_003 + idx) \
            .integers(0, vocab, size=n - p)
        toks = np.concatenate([head, tail])
    else:
        toks = np.random.default_rng(7_000_003 + idx) \
            .integers(0, vocab, size=n)
    return toks.astype(np.int32)


class ScenarioRunner:
    """Drive one :class:`ScenarioSpec` through a pool of workers, each
    owning its own client to the fleet front door.

    ``make_client`` returns a fresh connected client (``ServeClient``
    to the router) — called once per worker plus once per poisoned
    connection.  ``snap`` returns the CUMULATIVE fleet snapshot the
    phase accountant diffs (``client.stats()["stats"]`` against the
    router merges every live engine); when ``None`` the per-phase
    server-side view is skipped and only client-side tallies report.
    """

    def __init__(self, spec: ScenarioSpec, make_client: Callable[[], object],
                 *, snap: Optional[Callable[[], dict]] = None,
                 registry: Optional[Registry] = None,
                 target: Optional[SLOTarget] = None,
                 workers: int = 8, deadline_s: Optional[float] = None,
                 vocab: int = 64, prefix_len: int = 8,
                 events: Optional[MetricsLogger] = None):
        self.spec = spec
        self.make_client = make_client
        self.snap = snap
        self.registry = precreate_metrics(registry)
        self.target = target if target is not None else SLOTarget()
        self.workers = max(1, int(workers))
        self.deadline_s = deadline_s
        self.vocab = int(vocab)
        self.prefix_len = int(prefix_len)
        self.events = events
        self.log = get_logger(_LOG)

        r = self.registry
        self._c_dispatched = r.counter("scenario.dispatched")
        self._c_completed = r.counter("scenario.completed")
        self._c_rejected = r.counter("scenario.rejected")
        self._c_timeouts = r.counter("scenario.timeouts")
        self._c_slo_met = r.counter("scenario.slo_met")
        self._c_slo_missed = r.counter("scenario.slo_missed")
        self._c_goodput = r.counter("scenario.goodput_tokens")
        self._h_skew = r.histogram("scenario.dispatch_skew_seconds",
                                   TIME_BUCKETS)
        self._h_recovery = r.histogram("scenario.recovery_seconds",
                                       TIME_BUCKETS)

        self._q: "queue.Queue" = queue.Queue()
        self._tallies: List[Dict[str, Dict[str, int]]] = [
            {} for _ in range(self.workers)]
        self._evict_lock = threading.Lock()
        self._evict_t: Optional[float] = None
        self._recoveries = 0

    # -- chaos hook ---------------------------------------------------------
    def mark_eviction(self, t: Optional[float] = None) -> None:
        """Stamp "an engine just died" — the next completion (served by
        a survivor, by definition) closes the recovery window into
        ``scenario.recovery_seconds``.  Re-marking before recovery
        keeps the EARLIER stamp: recovery is measured from the first
        casualty of the incident."""
        with self._evict_lock:
            if self._evict_t is None:
                self._evict_t = time.perf_counter() if t is None else t

    def _note_completion(self) -> None:
        with self._evict_lock:
            if self._evict_t is not None:
                dt = time.perf_counter() - self._evict_t
                self._evict_t = None
                self._recoveries += 1
            else:
                return
        self._h_recovery.observe(max(dt, 0.0))
        self.log.info("recovered %.3fs after eviction", dt)
        if self.events is not None:
            self.events.log("recovery", seconds=round(dt, 6))

    # -- worker side --------------------------------------------------------
    def _fresh_client(self):
        try:
            return self.make_client()
        except (ConnectionError, OSError) as e:
            self.log.warning("client (re)dial failed: %s", e)
            return None

    def _worker(self, wid: int) -> None:
        client = self._fresh_client()
        tallies = self._tallies[wid]
        while True:
            item = self._q.get()
            if item is None:
                break
            arrival, sched, idx = item
            start = time.perf_counter()
            self._h_skew.observe(max(0.0, start - sched))
            tally = tallies.setdefault(arrival.phase, _blank_tally())
            tally["offered"] += 1
            self._c_dispatched.inc()
            if client is None:
                client = self._fresh_client()
            if client is None:
                # front door unreachable — the CLIENT gives up, which is
                # the timeout outcome (keeps the 3-way invariant exact)
                self._c_timeouts.inc()
                tally["timeouts"] += 1
                continue
            prompt = build_prompt(arrival, idx, self.vocab,
                                  self.prefix_len)
            try:
                if self.deadline_s is not None:
                    client.sock.settimeout(self.deadline_s)
                reply = client.generate(
                    prompt, max_new_tokens=arrival.new_tokens)
                if self.deadline_s is not None:
                    client.sock.settimeout(
                        getattr(client, "connect_timeout", 30.0))
            except socket.timeout:
                # deadline fired mid-reply: the connection is poisoned
                # (a late reply would desynchronize the framing) —
                # replace it
                self._c_timeouts.inc()
                tally["timeouts"] += 1
                try:
                    client.sock.close()
                except OSError:
                    pass
                client = self._fresh_client()
                continue
            except (ConnectionError, OSError):
                self._c_timeouts.inc()
                tally["timeouts"] += 1
                try:
                    client.sock.close()
                except OSError:
                    pass
                client = self._fresh_client()
                continue
            if reply.get("ok"):
                self._c_completed.inc()
                tally["completed"] += 1
                ttft = float(reply.get("ttft_s") or 0.0)
                e2e = float(reply.get("e2e_s") or 0.0)
                ntok = int(np.size(reply.get("tokens", ())))
                if self.target.met(ttft, e2e):
                    self._c_slo_met.inc()
                    self._c_goodput.inc(ntok)
                    tally["slo_met"] += 1
                    tally["goodput_tokens"] += ntok
                else:
                    self._c_slo_missed.inc()
                self._note_completion()
            else:
                # load-shed ("rejected") and malformed-request errors
                # both mean the SERVER refused it — the shed bucket
                self._c_rejected.inc()
                tally["rejected"] += 1
        if client is not None:
            try:
                client.close()
            except (ConnectionError, OSError):
                pass

    # -- dispatcher ---------------------------------------------------------
    def run(self) -> dict:
        """Fire the whole trace, drain, account.  Returns the scenario
        row: per-phase reports, totals, the exact-accounting proof, and
        recovery stats.  Raises ``RuntimeError`` if the open-loop
        invariant breaks."""
        spec = self.spec
        acct = PhaseAccountant(self.target)
        threads = [threading.Thread(target=self._worker, args=(w,),
                                    name=f"scn-worker-{w}", daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        cuts: List[tuple] = []          # (phase, snapshot, wall_s)
        t0 = time.perf_counter()
        if self.snap is not None:
            acct.open(self.snap())
        self.log.info("scenario %s: %d arrivals, %d workers, phases %s",
                      spec.name, len(spec.arrivals), self.workers,
                      "/".join(spec.phases))
        if self.events is not None:
            self.events.log("scenario_start", name=spec.name,
                            seed=spec.seed, arrivals=len(spec.arrivals),
                            workers=self.workers)
        # phase boundaries AFTER the first (which opens at 0)
        bounds = [(p, s) for p, s in spec.phase_bounds]
        bi = 1
        prev_cut_t = 0.0

        def _cut_through(now_rel: float):
            # close every phase whose window ended at or before now_rel
            nonlocal bi, prev_cut_t
            while bi < len(bounds) and bounds[bi][1] <= now_rel:
                phase, start = bounds[bi - 1][0], bounds[bi][1]
                _sleep_until(t0 + start)
                snap = self.snap() if self.snap is not None else None
                cuts.append((phase, snap, start - prev_cut_t))
                prev_cut_t = start
                bi += 1

        for idx, a in enumerate(spec.arrivals):
            _cut_through(a.t)
            _sleep_until(t0 + a.t)
            self._q.put((a, t0 + a.t, idx))
        # phases with no arrivals left on the clock still get their cuts
        _cut_through(spec.duration_s + 1e-9)
        # drain: all arrivals are in flight or queued — sentinels stop
        # the workers once the queue empties
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        final_snap = self.snap() if self.snap is not None else None
        cuts.append((bounds[-1][0], final_snap, wall - prev_cut_t))

        tallies = self._merge_tallies()
        reports = []
        for phase, snap, wall_s in cuts:
            if self.snap is not None:
                rep = acct.cut(phase, snap, wall_s,
                               tallies.get(phase, _blank_tally()))
            else:
                rep = acct_offline(acct, phase, wall_s,
                                   tallies.get(phase, _blank_tally()))
            reports.append(rep)
            if self.events is not None:
                self.events.log("phase_report", **rep.to_row())

        counts = {k: int(self.registry.counter(f"scenario.{k}").value)
                  for k in ("dispatched", "completed", "rejected",
                            "timeouts", "slo_met", "goodput_tokens")}
        settled = (counts["completed"] + counts["rejected"]
                   + counts["timeouts"])
        if counts["dispatched"] != settled:
            raise RuntimeError(
                f"open-loop accounting broken: dispatched="
                f"{counts['dispatched']} != completed+rejected+timeouts="
                f"{settled}")
        if counts["dispatched"] != len(spec.arrivals):
            raise RuntimeError(
                f"dispatch loss: {counts['dispatched']} dispatched of "
                f"{len(spec.arrivals)} scheduled")
        row = {
            "scenario": spec.name, "seed": spec.seed,
            "arrivals": len(spec.arrivals), "wall_s": round(wall, 3),
            "phases": [r.to_row() for r in reports],
            "slo": {"ttft_s": self.target.ttft_s,
                    "e2e_s": self.target.e2e_s,
                    "attainment": self.target.attainment},
            "slo_misses": acct.misses(),
            "counts": counts,
            "accounting_exact": True,
            "recoveries": self._recoveries,
        }
        if self.events is not None:
            self.events.log("scenario_done", name=spec.name,
                            wall_s=round(wall, 3), **counts)
        self.log.info(
            "scenario %s done: %d/%d completed, %d shed, %d timeouts, "
            "misses=%s", spec.name, counts["completed"],
            counts["dispatched"], counts["rejected"], counts["timeouts"],
            row["slo_misses"] or "none")
        return row

    def _merge_tallies(self) -> Dict[str, Dict[str, int]]:
        merged: Dict[str, Dict[str, int]] = {}
        for per_worker in self._tallies:
            for phase, t in per_worker.items():
                m = merged.setdefault(phase, _blank_tally())
                for k, v in t.items():
                    m[k] += v
        return merged


def acct_offline(acct: PhaseAccountant, phase: str, wall_s: float,
                 tallies: Dict[str, int]):
    """Client-tallies-only phase report for runs without a ``snap``
    source (no server-side histograms ⇒ no attainment/percentiles)."""
    from .slo import PhaseReport
    offered = int(tallies.get("offered", 0))
    rejected = int(tallies.get("rejected", 0))
    wall = max(float(wall_s), 1e-9)
    rep = PhaseReport(
        phase=phase, offered=offered,
        completed=int(tallies.get("completed", 0)),
        rejected=rejected, timeouts=int(tallies.get("timeouts", 0)),
        slo_met=int(tallies.get("slo_met", 0)), attainment=None,
        shed_rate=(rejected / offered) if offered else 0.0,
        goodput_tps=float(tallies.get("goodput_tokens", 0)) / wall,
        ttft_p50=None, ttft_p99=None, e2e_p50=None, e2e_p99=None,
        wall_s=float(wall_s))
    acct._reports.append(rep)
    return rep


def _sleep_until(deadline: float) -> None:
    while True:
        dt = deadline - time.perf_counter()
        if dt <= 0:
            return
        time.sleep(min(dt, 0.05))
