"""Drift-gated deploy decisions — the port's copy of
``distkeras_tpu.continual.gate``.

``DeployGate`` owns the rolling window of per-interval registry deltas
and the decision rule on top of ``obs.drift.classify_window``: a
checkpoint may deploy only when (a) at least ``min_history`` intervals
have accumulated and (b) the windowed diff classifies the retained
history as **stable** — neither an abrupt step change between
consecutive intervals nor a gradual first→last trend.

Every decision is a recorded obs metric: ``continual.verdicts_{stable,
step,trend}`` count classifications, ``continual.deploys`` counts
promotions that actually happened, ``continual.deploys_rejected`` (split
``continual.rejected_dirty`` / ``continual.rejected_warmup``) counts
blocked ones.  A bounded plain-data decision log (``history_log``) feeds
the bench row.  The gate reads only the metrics it watches, so equal
deltas give the JAX package's decisions.
"""

from __future__ import annotations

import collections
import fnmatch
from typing import Optional, Sequence

from ..obs import Registry, drift
from .config import DEFAULT_WATCH


class DeployGate:
    """Rolling interval window + the drift-clean deploy rule.

    ``observe(interval_delta)`` appends one per-interval snapshot (an
    ``obs.drift.snapshot_delta`` output, pre-filtered to ``watch``) and
    classifies the window; ``decide(verdict, interval)`` turns the
    verdict into a recorded accept/reject; ``record_deployed(entry)`` is
    called by the trainer AFTER the promotion actually succeeded, so
    ``continual.deploys`` counts deploys that happened, not intents.
    """

    #: decision-log bound — a train-forever daemon must not grow a list
    log_keep = 256

    def __init__(self, history: int = 4, min_history: int = 3,
                 baseline: Optional[dict] = None,
                 registry: Optional[Registry] = None,
                 watch: Sequence[str] = DEFAULT_WATCH):
        if int(history) < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        if not 1 <= int(min_history) <= int(history):
            raise ValueError(f"min_history must lie in [1, {history}], "
                             f"got {min_history}")
        self.registry = registry if registry is not None else Registry()
        #: drift-threshold config (an ``OBS_BASELINE.json`` document) the
        #: windowed diff resolves thresholds from; None = built-ins
        self.baseline = baseline
        self.watch = tuple(watch)
        self.min_history = int(min_history)
        self._window: collections.deque = collections.deque(
            maxlen=int(history))
        self._log: collections.deque = collections.deque(
            maxlen=self.log_keep)
        reg = self.registry
        self._c_verdicts = {k: reg.counter(f"continual.verdicts_{k}")
                            for k in drift.WINDOW_KINDS}
        self._c_deploys = reg.counter("continual.deploys")
        self._c_rejected = reg.counter("continual.deploys_rejected")
        self._c_rej_dirty = reg.counter("continual.rejected_dirty")
        self._c_rej_warmup = reg.counter("continual.rejected_warmup")
        #: 1.0 while the CURRENT window classifies dirty (deploys
        #: blocked) — the live DRIFT-DIRTY alarm bit a stats poll reads
        #: without access to the in-process decision log
        self._g_dirty = reg.gauge("continual.window_dirty")

    # -- window -------------------------------------------------------------
    def _filtered(self, snapshot: dict) -> dict:
        """The gate watches model-health metrics only: bookkeeping
        counters (deploy/verdict counts, cold ``jit.compiles``, wire
        bytes) would self-trigger or alarm on host noise."""
        return {name: s for name, s in snapshot.items()
                if any(fnmatch.fnmatch(name, pat) for pat in self.watch)}

    def __len__(self) -> int:
        return len(self._window)

    def observe(self, interval_delta: dict) -> drift.WindowVerdict:
        """Append one per-interval registry delta and classify the
        retained window (step / trend / stable)."""
        self._window.append(self._filtered(interval_delta))
        verdict = drift.classify_window(list(self._window),
                                        baseline=self.baseline)
        self._c_verdicts[verdict.kind].inc()
        self._g_dirty.set(0.0 if verdict.clean else 1.0)
        return verdict

    # -- decisions ----------------------------------------------------------
    def decide(self, verdict: drift.WindowVerdict,
               interval: Optional[int] = None) -> dict:
        """Verdict -> recorded deploy decision.  Returns the (mutable)
        log entry; ``entry["deploy"]`` says whether the trainer should
        promote, ``entry["deployed"]`` flips once it actually did."""
        entry = {"interval": interval, "kind": verdict.kind,
                 "metrics": verdict.dirty_metrics,
                 "details": list(verdict.get("details", [])),
                 "window": len(self._window),
                 "deploy": False, "deployed": False, "reason": ""}
        if len(self._window) < self.min_history:
            entry["reason"] = (f"warmup ({len(self._window)}/"
                               f"{self.min_history} intervals)")
            self._c_rejected.inc()
            self._c_rej_warmup.inc()
        elif not verdict.clean:
            entry["reason"] = (f"drift-dirty ({verdict.kind}: "
                               + ", ".join(verdict.dirty_metrics) + ")")
            self._c_rejected.inc()
            self._c_rej_dirty.inc()
        else:
            entry["deploy"] = True
            entry["reason"] = "clean window"
        self._log.append(entry)
        return entry

    def record_deployed(self, entry: dict) -> None:
        """Mark a decided-deployable entry as actually promoted."""
        entry["deployed"] = True
        self._c_deploys.inc()

    def history_log(self) -> list:
        """Bounded plain-data decision history, oldest first — the
        ``verdicts`` list the bench persists and obsview renders."""
        return [dict(e) for e in self._log]
