"""Live alert evaluation over the fleet time series — the port's copy of
``distkeras_tpu.obs.alerts``: the same rule schema, hysteresis, counters
and state documents, over the port's ``TimeSeriesStore``.

The drift gate (``obs.drift``) judges a run AFTER it ends; this module
judges it WHILE it runs.  :class:`AlertEngine` evaluates two rule kinds:

* **threshold** — a metric's merged cumulative value must stay at/below
  ``max_value`` (``jit.retraces`` at 0, leak counters at 0), or its
  counter RATE over ``window_s`` must stay at/below ``max_rate``.
* **burn_rate** — the SLO-debt rule: over a SHORT and a LONG trailing
  window, attainment = fraction of a latency histogram's observations
  ≤ ``bound_s`` (the scenario ``hist_fraction_le`` math, replicated here
  so obs never imports the scenario layer); burn = (1 − attainment) /
  (1 − target attainment).  The rule breaches only when BOTH windows
  exceed ``max_burn`` (the multiwindow guard).

Hysteresis: a breach must PERSIST ``for_s`` seconds before the rule
fires, and a firing rule must stay clean ``clear_s`` seconds before it
resolves.  Every transition is an ``obs.alerts.{fired,resolved}``
counter (labeled by rule) plus an optional JSONL ``alert`` record; rapid
transitions also count ``obs.alerts.flaps``.  Rules whose series carry
no (or not enough) data hold their current state.

Rules load from the committed baseline contract: the ``"alerts"`` list
of ``OBS_BASELINE.json``, each entry a plain dict (see
:func:`parse_rules`), read as JSON.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional

from .logging import get_logger
from .registry import Registry, flat_name
from .timeseries import TimeSeriesStore

_LOG = "obs.alerts"

#: label keys the telemetry plane blesses — an alert rule using a key
#: outside this vocabulary is refused (a typo'd key silently forks a
#: new series)
KNOWN_LABEL_KEYS = ("engine", "phase", "rule", "shard", "source",
                    "tenant", "version", "worker")

#: transitions within this window before a rule counts as flapping
FLAP_WINDOW_S = 60.0
FLAP_TRANSITIONS = 4


def hist_fraction_le(snap: Optional[dict], bound: float) -> Optional[float]:
    """Fraction of a histogram snapshot's observations ≤ ``bound`` —
    exact on bucket boundaries, conservative (next-lower bound)
    otherwise; ``None`` with nothing to read.  Mirrors
    ``scenario.slo.hist_fraction_le`` (obs does not import scenario)."""
    if not snap or snap.get("type") != "histogram" or not snap.get("count"):
        return None
    k = bisect.bisect_right(list(snap["bounds"]), bound)
    return sum(snap["counts"][:k]) / snap["count"]


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One rule, parsed and validated.  ``kind`` selects which fields
    matter: threshold rules use ``max_value``/``max_rate`` +
    ``window_s``; burn-rate rules use ``bound_s``/``attainment``/
    ``short_s``/``long_s``/``max_burn``/``min_samples``.  ``for_s`` /
    ``clear_s`` are the hysteresis pair on both kinds."""

    name: str
    kind: str                       # "threshold" | "burn_rate"
    metric: str                     # flat metric name
    labels: Optional[dict] = None   # informational label filter
    # threshold
    max_value: Optional[float] = None
    max_rate: Optional[float] = None
    window_s: float = 30.0
    # burn rate
    bound_s: Optional[float] = None
    attainment: float = 0.95
    short_s: float = 5.0
    long_s: float = 30.0
    max_burn: float = 2.0
    min_samples: int = 8
    # hysteresis
    for_s: float = 0.0
    clear_s: float = 1.0

    def flat_metric(self) -> str:
        return flat_name(self.metric, self.labels)


_RULE_KEYS = {f.name for f in dataclasses.fields(AlertRule)} | {"_comment"}


def parse_rules(doc) -> List[AlertRule]:
    """Rules from a baseline document (or a bare list of rule dicts).
    Malformed rules raise — a typo'd alert contract must fail loudly at
    load, not silently gate nothing."""
    raw = doc.get("alerts", []) if isinstance(doc, dict) else doc
    rules: List[AlertRule] = []
    seen = set()
    for i, r in enumerate(raw or []):
        if not isinstance(r, dict):
            raise ValueError(f"alert rule #{i}: not a mapping: {r!r}")
        unknown = set(r) - _RULE_KEYS
        if unknown:
            raise ValueError(f"alert rule #{i}: unknown keys "
                             f"{sorted(unknown)}")
        kw = {k: v for k, v in r.items() if k != "_comment"}
        try:
            rule = AlertRule(**kw)
        except TypeError as e:
            raise ValueError(f"alert rule #{i}: {e}") from None
        if not rule.name or rule.name in seen:
            raise ValueError(f"alert rule #{i}: missing or duplicate "
                             f"name {rule.name!r}")
        seen.add(rule.name)
        if rule.kind == "threshold":
            if rule.max_value is None and rule.max_rate is None:
                raise ValueError(f"alert rule {rule.name!r}: threshold "
                                 f"needs max_value or max_rate")
        elif rule.kind == "burn_rate":
            if rule.bound_s is None:
                raise ValueError(f"alert rule {rule.name!r}: burn_rate "
                                 f"needs bound_s")
            if not 0.0 < rule.attainment < 1.0:
                raise ValueError(f"alert rule {rule.name!r}: attainment "
                                 f"must be in (0, 1)")
            if rule.short_s > rule.long_s:
                raise ValueError(f"alert rule {rule.name!r}: short_s "
                                 f"must not exceed long_s")
        else:
            raise ValueError(f"alert rule {rule.name!r}: unknown kind "
                             f"{rule.kind!r}")
        if rule.labels:
            for k in rule.labels:
                if k not in KNOWN_LABEL_KEYS:
                    raise ValueError(
                        f"alert rule {rule.name!r}: unknown label key "
                        f"{k!r} (known: {', '.join(KNOWN_LABEL_KEYS)})")
        rules.append(rule)
    return rules


class _RuleState:
    __slots__ = ("firing", "breach_since", "clean_since", "fired",
                 "resolved", "transitions", "measure", "evidence")

    def __init__(self):
        self.firing = False
        self.breach_since: Optional[float] = None
        self.clean_since: Optional[float] = None
        self.fired = 0
        self.resolved = 0
        #: transition timestamps for flap detection
        self.transitions: collections.deque = collections.deque(maxlen=16)
        #: last measurement doc (value / burn_short / burn_long / ...)
        self.measure: dict = {}
        #: whether the LATEST evaluation had evidence (``measure`` may be
        #: older: it holds the last evaluation that had)
        self.evidence = False


class AlertEngine:
    """Evaluate rules over a store; keep hysteresis state per rule.

    Evaluation is PULL-driven and rate-limited (``eval_interval_s``):
    callers invoke :meth:`evaluate` from whatever cadence they already
    own — a telemetry ingest, an autoscaler tick, an ``alerts`` RPC —
    and redundant calls inside the interval are free.  No thread of its
    own, so attaching an engine to a server adds no lock-order or
    shutdown sequencing surface.

    ``source_registry`` makes a standalone server alertable with zero
    extra plumbing: each evaluation first self-ingests that registry's
    cumulative snapshot into the store under source ``_local``.
    """

    def __init__(self, store: TimeSeriesStore, rules: List[AlertRule], *,
                 registry: Optional[Registry] = None,
                 events=None,
                 source_registry: Optional[Registry] = None,
                 eval_interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.rules = list(rules)
        self.registry = registry
        self.events = events
        self.source_registry = source_registry
        self.eval_interval_s = float(eval_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_eval: Optional[float] = None
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self.log = get_logger(_LOG)
        if registry is not None:
            # pre-created so a clean run reports 0 instead of omitting
            # the counters (the drift gate's present-0 contract)
            self._c_fired = registry.counter("obs.alerts.fired")
            self._c_resolved = registry.counter("obs.alerts.resolved")
            self._c_flaps = registry.counter("obs.alerts.flaps")
            self._g_firing = registry.gauge("obs.alerts.firing")
        else:
            self._c_fired = self._c_resolved = self._c_flaps = None
            self._g_firing = None

    # -- measurement --------------------------------------------------------
    def _measure(self, rule: AlertRule, now: float) -> Optional[bool]:
        """One rule's verdict: True breach, False clean, None no data
        (hold state)."""
        metric = rule.flat_metric()
        if rule.kind == "threshold":
            if rule.max_value is not None:
                e = self.store.latest().get(metric)
                v = e.get("value") if isinstance(e, dict) else None
                if v is None or not math.isfinite(float(v)):
                    return None
                st = self._state[rule.name]
                st.measure = {"value": float(v), "max_value": rule.max_value}
                return float(v) > float(rule.max_value)
            d = self.store.window_delta(metric, rule.window_s, now)
            if d is None or d.get("type") != "counter":
                return None
            rate = float(d["value"]) / max(rule.window_s, 1e-9)
            st = self._state[rule.name]
            st.measure = {"rate": rate, "max_rate": rule.max_rate}
            return rate > float(rule.max_rate)
        # burn_rate
        burns, fracs = {}, {}
        for tag, w in (("short", rule.short_s), ("long", rule.long_s)):
            d = self.store.window_delta(metric, w, now)
            if d is None or d.get("count", 0) < rule.min_samples:
                return None
            frac = hist_fraction_le(d, float(rule.bound_s))
            if frac is None or not math.isfinite(frac):
                return None
            fracs[tag] = frac
            burns[tag] = (1.0 - frac) / max(1.0 - rule.attainment, 1e-9)
        st = self._state[rule.name]
        st.measure = {"burn_short": burns["short"],
                      "burn_long": burns["long"],
                      "attainment_short": fracs["short"],
                      "attainment_long": fracs["long"],
                      "max_burn": rule.max_burn}
        return burns["short"] > rule.max_burn and \
            burns["long"] > rule.max_burn

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> List[dict]:
        """One evaluation pass; returns the transition events it caused
        (also logged/counted).  Rate-limited unless ``force``."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if not force and self._last_eval is not None and \
                    now - self._last_eval < self.eval_interval_s:
                return []
            self._last_eval = now
        if self.source_registry is not None:
            self.store.ingest_total("_local",
                                    self.source_registry.snapshot(), now)
        events: List[dict] = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                breach = self._measure(rule, now)
                st.evidence = breach is not None
                if breach is None:
                    continue  # hold state on missing evidence
                if breach:
                    st.clean_since = None
                    if st.breach_since is None:
                        st.breach_since = now
                    if not st.firing and \
                            now - st.breach_since >= rule.for_s:
                        events.append(self._transition(rule, st, now,
                                                       firing=True))
                else:
                    st.breach_since = None
                    if st.clean_since is None:
                        st.clean_since = now
                    if st.firing and \
                            now - st.clean_since >= rule.clear_s:
                        events.append(self._transition(rule, st, now,
                                                       firing=False))
            n_firing = sum(s.firing for s in self._state.values())
        if self._g_firing is not None:
            self._g_firing.set(n_firing)
        for ev in events:
            self._emit(ev)
        return events

    def _transition(self, rule: AlertRule, st: _RuleState, now: float,
                    *, firing: bool) -> dict:  # caller holds _lock
        st.firing = firing
        st.transitions.append(now)
        if firing:
            st.fired += 1
        else:
            st.resolved += 1
        recent = [t for t in st.transitions if now - t <= FLAP_WINDOW_S]
        flapping = len(recent) >= FLAP_TRANSITIONS
        return {"rule": rule.name, "state": "firing" if firing
                else "resolved", "kind": rule.kind,
                "metric": rule.flat_metric(), "flapping": flapping,
                **self._state[rule.name].measure}

    def _emit(self, ev: dict) -> None:
        if self.registry is not None:
            what = "fired" if ev["state"] == "firing" else "resolved"
            (self._c_fired if what == "fired" else self._c_resolved).inc()
            # labeled per-rule tally; flattens to obs.alerts.<what>.rule<name>
            self.registry.counter(f"obs.alerts.{what}",
                                  labels={"rule": ev["rule"]}).inc()
            if ev.get("flapping"):
                self._c_flaps.inc()
        (self.log.warning if ev["state"] == "firing"
         else self.log.info)("alert %s: %s (%s)", ev["state"], ev["rule"],
                             ev.get("metric"))
        if self.events is not None:
            self.events.log("alert", **ev)

    # -- read ---------------------------------------------------------------
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._state.items() if s.firing)

    def counts(self) -> dict:
        with self._lock:
            return {"fired": sum(s.fired for s in self._state.values()),
                    "resolved": sum(s.resolved
                                    for s in self._state.values()),
                    "firing": sum(s.firing for s in self._state.values())}

    def attainment_signal(self) -> Optional[float]:
        """The min short-window attainment across burn-rate rules with
        evidence — the alert-plane replacement for the autoscaler's own
        interval-delta poll math.  ``None`` with no evidence.  A rule
        keeps its last measured attainment after its windows empty, as
        the JAX package's does: an idle fleet reads the attainment of its
        last busy seconds."""
        with self._lock:
            vals = [s.measure["attainment_short"]
                    for r in self.rules
                    for s in (self._state[r.name],)
                    if r.kind == "burn_rate"
                    and "attainment_short" in s.measure]
        return min(vals) if vals else None

    def state_doc(self) -> dict:
        """Plain-data engine state — the ``alerts`` RPC reply body and
        the obsview --alerts panel source."""
        now = self._clock()
        with self._lock:
            rules = []
            for r in self.rules:
                s = self._state[r.name]
                recent = [t for t in s.transitions
                          if now - t <= FLAP_WINDOW_S]
                rules.append({
                    "name": r.name, "kind": r.kind,
                    "metric": r.flat_metric(), "firing": s.firing,
                    "fired": s.fired, "resolved": s.resolved,
                    "flapping": len(recent) >= FLAP_TRANSITIONS,
                    "measure": dict(s.measure)})
        doc = {"rules": rules, "counts": self.counts(),
               "store": self.store.summary()}
        return doc
