"""Obs-driven autoscaler — the port's copy of
``distkeras_tpu.scenario.autoscale``: grow/shrink the engine fleet
behind ONE ``ServeRouter`` from the signals the obs layer already
publishes.

The scale primitive is the router's evict/rejoin machinery: scale-DOWN
is the planned single-engine drain (migrate hot KV to survivors → drain
→ evict; ``router.scale_down``), scale-UP un-drains a parked engine and
re-adopts it through the same stats-probe path a rejoining engine takes
(``router.scale_up``).  A parked engine keeps its warm model, so
scale-up costs a round-trip and ``jit.retraces`` stays 0 across the
whole scaling history.

The policy is thresholds with hysteresis:

* **pressure** (scale up): fleet queue depth per live engine at or
  above ``queue_high``, OR interval SLO attainment below
  ``attainment_low``;
* **slack** (scale down): queue per engine at or below ``queue_low``
  AND attainment at or above ``attainment_high`` (or no traffic).

A decision fires only after the signal holds for ``up_after`` /
``down_after`` consecutive ticks AND the post-action ``cooldown_s`` has
elapsed.  Both streaks reset after any action.  Every decision is a
``scenario.scale_{up,down}`` counter increment plus a JSONL
``scale_event`` record.

:meth:`AutoScaler.decide` is a pure function of (signals, now, its own
streak/cooldown state), so the same ``Signals`` stream gives the JAX
package's decisions; the thread loop feeds it real signals from the
router's merged stats.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from ..obs import Registry, default_registry, snapshot_delta
from ..obs.logging import get_logger
from ..utils.metrics import MetricsLogger
from .slo import E2E_HIST, TTFT_HIST, SLOTarget, hist_fraction_le

_LOG = "scenario.autoscale"


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Scaling knobs.  ``queue_*`` are per-LIVE-engine queue depths
    (fleet total / engines alive), ``attainment_*`` the interval SLO
    attainment bounds, ``*_after`` consecutive-tick streak lengths, and
    ``cooldown_s`` the refractory period after any action."""

    min_engines: int = 1
    max_engines: int = 4
    interval_s: float = 0.25
    queue_high: float = 4.0
    queue_low: float = 0.5
    attainment_low: float = 0.90
    attainment_high: float = 0.98
    up_after: int = 2
    down_after: int = 6
    cooldown_s: float = 1.0
    #: completions needed in an interval before its attainment counts —
    #: two requests can't outvote the queue signal
    min_samples: int = 8


@dataclasses.dataclass(frozen=True)
class Signals:
    """One tick's inputs: live engines, fleet queue depth, and interval
    attainment (``None`` = not enough samples — no opinion)."""

    alive: int
    queue_depth: float
    attainment: Optional[float]


class AutoScaler:
    """Poll → decide → act loop over a ``ServeRouter``.

    ``router`` needs ``scale_up(addr)`` / ``scale_down(addr)`` and the
    ``backends`` list (addr/alive/idx) — i.e. a ``ServeRouter``.  Call
    :meth:`start` / :meth:`stop` around the traffic window, or drive
    :meth:`tick` manually from a test."""

    def __init__(self, router, policy: Optional[AutoscalePolicy] = None,
                 *, target: Optional[SLOTarget] = None,
                 registry: Optional[Registry] = None,
                 events: Optional[MetricsLogger] = None,
                 alerts=None):
        self.router = router
        #: optional :class:`~distkeras_tpu_torch.obs.alerts.AlertEngine`:
        #: when set, each tick evaluates it and prefers its
        #: burn-rate attainment (computed over the router's PUSH-fed
        #: aggregator windows) to this scaler's own two-poll delta math —
        #: one SLO computation shared by alerts and scaling decisions
        self.alerts = alerts
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.target = target if target is not None else SLOTarget()
        self.registry = registry if registry is not None \
            else default_registry()
        self.events = events
        self.log = get_logger(_LOG)
        self._c_up = self.registry.counter("scenario.scale_up")
        self._c_down = self.registry.counter("scenario.scale_down")
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        self._last_stats: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: decision history [(t_rel, action, alive_after, reason)] —
        #: the scale-event trail the scenario row persists
        self.history: List[dict] = []
        self._t0 = time.perf_counter()

    # -- decision (pure w.r.t. the fleet: unit-testable) --------------------
    def decide(self, signals: Signals, now: float) -> Optional[str]:
        """Fold one tick of signals through the hysteresis state;
        returns ``"up"`` / ``"down"`` / ``None``.  Mutates only streaks
        and cooldown — never the fleet (that's :meth:`tick`)."""
        p = self.policy
        per_engine = signals.queue_depth / max(signals.alive, 1)
        att = signals.attainment
        pressure = (per_engine >= p.queue_high
                    or (att is not None and att < p.attainment_low))
        slack = (per_engine <= p.queue_low
                 and (att is None or att >= p.attainment_high))
        self._up_streak = self._up_streak + 1 if pressure else 0
        self._down_streak = self._down_streak + 1 if slack else 0
        if now < self._cooldown_until:
            return None
        if (self._up_streak >= p.up_after
                and signals.alive < p.max_engines):
            self._arm(now)
            return "up"
        if (self._down_streak >= p.down_after
                and signals.alive > p.min_engines):
            self._arm(now)
            return "down"
        return None

    def _arm(self, now: float) -> None:
        self._up_streak = self._down_streak = 0
        self._cooldown_until = now + self.policy.cooldown_s

    # -- signal gathering ---------------------------------------------------
    def read_signals(self) -> Signals:
        """One merged-stats poll → a :class:`Signals`.  Attainment is
        the min of the interval ttft/e2e fractions between THIS poll
        and the previous one (the same read the phase accountant does,
        at tick granularity)."""
        reply = self.router._handle_stats()
        stats = reply.get("stats", {}) or {}
        att = None
        if self.alerts is not None:
            self.alerts.evaluate()
            att = self.alerts.attainment_signal()
        if att is None and self._last_stats is not None:
            delta = snapshot_delta(self._last_stats, stats)
            e2e = delta.get(E2E_HIST)
            if e2e and e2e.get("count", 0) >= self.policy.min_samples:
                fr_e2e = hist_fraction_le(e2e, self.target.e2e_s)
                fr_ttft = hist_fraction_le(delta.get(TTFT_HIST),
                                           self.target.ttft_s)
                cands = [f for f in (fr_e2e, fr_ttft) if f is not None]
                att = min(cands) if cands else None
        self._last_stats = stats
        return Signals(alive=int(reply.get("engines_alive", 0)),
                       queue_depth=float(reply.get("queue_depth", 0) or 0),
                       attainment=att)

    # -- action -------------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One poll-decide-act cycle; returns the action taken."""
        signals = self.read_signals()
        now = time.perf_counter()
        action = self.decide(signals, now)
        if action is None:
            return None
        if action == "up":
            be = next((b for b in self.router.backends if not b.alive),
                      None)
            if be is None:
                return None
            result = self.router.scale_up(be.addr)
        else:
            parked = [b for b in self.router.backends if b.alive]
            if len(parked) <= self.policy.min_engines:
                return None
            be = parked[-1]
            result = self.router.scale_down(be.addr)
        ok = bool(result.get("ok"))
        if ok:
            (self._c_up if action == "up" else self._c_down).inc()
        alive = sum(b.alive for b in self.router.backends)
        reason = (f"queue/engine={signals.queue_depth / max(signals.alive, 1):.1f}"
                  f" attainment="
                  f"{'n/a' if signals.attainment is None else f'{signals.attainment:.3f}'}")
        event = {"t": round(now - self._t0, 3), "action": action,
                 "engine": be.addr, "ok": ok, "alive": alive,
                 "reason": reason}
        self.history.append(event)
        self.log.info("scale_%s %s (alive=%d, %s)%s", action, be.addr,
                      alive, reason, "" if ok else " FAILED")
        if self.events is not None:
            self.events.log("scale_event", **event)
        return action if ok else None

    # -- thread loop --------------------------------------------------------
    def start(self) -> "AutoScaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._t0 = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception as e:           # noqa: BLE001 — keep polling
                self.log.warning("autoscaler tick failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def summary(self) -> Dict[str, object]:
        return {"scale_up": int(self._c_up.value),
                "scale_down": int(self._c_down.value),
                "events": list(self.history)}
