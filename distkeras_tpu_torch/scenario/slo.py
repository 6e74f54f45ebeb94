"""SLO-attainment accounting over the obs layer — the port's copy of
``distkeras_tpu.scenario.slo``.

The serve fleet already measures everything the SLO verdict needs —
``serve.ttft_seconds`` / ``serve.e2e_seconds`` histograms, completion
and rejection counters — this module reads them *per phase*.  The runner
cuts a cumulative registry snapshot at each phase boundary; a
:class:`PhaseAccountant` turns consecutive snapshots into interval
deltas (:func:`obs.snapshot_delta`, the same primitive the drift gate
uses) and computes per phase:

* **attainment** — fraction of completed requests whose ttft AND e2e
  land within :class:`SLOTarget` (read exactly from histogram buckets
  when the targets sit on ``TIME_BUCKETS`` bounds),
* **shed rate** — rejected / offered,
* **goodput** — tokens/sec counting only SLO-met requests,
* p50/p99 ttft and e2e for the phase window.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

from ..obs import snapshot_delta, snapshot_quantile

#: histogram names the accountant reads from each interval
TTFT_HIST = "serve.ttft_seconds"
E2E_HIST = "serve.e2e_seconds"


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """A serving SLO: per-request latency bounds + the fleet-level
    attainment floor.  Defaults (250 ms ttft, 1 s e2e, 95 %) sit exactly
    on ``TIME_BUCKETS`` bounds — keep custom targets on bucket bounds
    too, or attainment silently becomes a lower bound (the fraction
    ≤ the next-lower bound) instead of exact."""

    ttft_s: float = 0.25
    e2e_s: float = 1.0
    attainment: float = 0.95

    def met(self, ttft_s: float, e2e_s: float) -> bool:
        """Per-request verdict (the runner's goodput classifier)."""
        return ttft_s <= self.ttft_s and e2e_s <= self.e2e_s


def hist_fraction_le(snap: Optional[dict], bound: float) -> Optional[float]:
    """Fraction of a histogram snapshot's observations ≤ ``bound``.
    Exact when ``bound`` is one of the histogram's bucket bounds
    (buckets hold per-bucket counts with le semantics: bucket i counts
    v in (bounds[i-1], bounds[i]]); otherwise the fraction up to the
    next-LOWER bound — a conservative lower bound on attainment, never
    an optimistic one.  ``None`` when there is nothing to read."""
    if not snap or snap.get("type") != "histogram" or not snap.get("count"):
        return None
    bounds = list(snap["bounds"])
    counts = list(snap["counts"])
    # bucket index i covers (bounds[i-1], bounds[i]]; everything in
    # buckets 0..k is <= bounds[k], so include bucket k iff
    # bounds[k] <= bound
    k = bisect.bisect_right(bounds, bound)
    return sum(counts[:k]) / snap["count"]


@dataclasses.dataclass(frozen=True)
class PhaseReport:
    """One phase's SLO verdict — plain data, rides the obs document
    (``row["phases"]``) and the obsview table."""

    phase: str
    offered: int           # dispatched into this phase window
    completed: int
    rejected: int          # load-shed (server said no)
    timeouts: int          # client deadline fired
    slo_met: int
    attainment: Optional[float]   # from the serve.* interval histograms
    shed_rate: float
    goodput_tps: float     # SLO-met tokens / phase wall seconds
    ttft_p50: Optional[float]
    ttft_p99: Optional[float]
    e2e_p50: Optional[float]
    e2e_p99: Optional[float]
    wall_s: float

    def to_row(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 6)
        return d

    def meets(self, target: SLOTarget) -> bool:
        """Phase-level verdict: attainment at or above the target floor.
        A phase with no completions fails — "nothing finished" is the
        worst attainment there is, not a free pass."""
        if self.attainment is None:
            return self.offered == 0
        return self.attainment >= target.attainment


class PhaseAccountant:
    """Turns the runner's phase-boundary registry snapshots + per-phase
    tallies into :class:`PhaseReport`s.

    Usage: ``cut(phase, snapshot, wall_s)`` once per boundary in phase
    order (the snapshot CLOSES the named phase; cumulative, as returned
    by ``Registry.snapshot()`` or the router's merged stats), after an
    initial ``open(snapshot)`` establishing the pre-traffic base."""

    def __init__(self, target: SLOTarget):
        self.target = target
        self._base: Optional[dict] = None
        self._reports: List[PhaseReport] = []

    def open(self, snapshot: dict) -> None:
        self._base = dict(snapshot)

    def cut(self, phase: str, snapshot: dict, wall_s: float,
            tallies: Dict[str, int]) -> PhaseReport:
        """Close ``phase`` with the cumulative ``snapshot`` taken at its
        end.  ``tallies`` carries the runner's client-side per-phase
        counts: offered / completed / rejected / timeouts / slo_met /
        goodput_tokens."""
        if self._base is None:
            raise RuntimeError("PhaseAccountant.cut before open")
        delta = snapshot_delta(self._base, snapshot)
        self._base = dict(snapshot)
        ttft = delta.get(TTFT_HIST)
        e2e = delta.get(E2E_HIST)
        frac_ttft = hist_fraction_le(ttft, self.target.ttft_s)
        frac_e2e = hist_fraction_le(e2e, self.target.e2e_s)
        # both bounds must hold; the fractions come from independent
        # histograms so the joint attainment is at best min(, ) — report
        # that (exact when misses are nested, conservative otherwise)
        attainment = None
        if frac_ttft is not None and frac_e2e is not None:
            attainment = min(frac_ttft, frac_e2e)
        elif frac_e2e is not None:
            attainment = frac_e2e
        elif frac_ttft is not None:
            attainment = frac_ttft
        offered = int(tallies.get("offered", 0))
        rejected = int(tallies.get("rejected", 0))
        timeouts = int(tallies.get("timeouts", 0))
        wall = max(float(wall_s), 1e-9)
        rep = PhaseReport(
            phase=phase, offered=offered,
            completed=int(tallies.get("completed", 0)),
            rejected=rejected, timeouts=timeouts,
            slo_met=int(tallies.get("slo_met", 0)),
            attainment=attainment,
            shed_rate=(rejected / offered) if offered else 0.0,
            goodput_tps=float(tallies.get("goodput_tokens", 0)) / wall,
            ttft_p50=_q(ttft, 0.5), ttft_p99=_q(ttft, 0.99),
            e2e_p50=_q(e2e, 0.5), e2e_p99=_q(e2e, 0.99),
            wall_s=float(wall_s))
        self._reports.append(rep)
        return rep

    @property
    def reports(self) -> Sequence[PhaseReport]:
        return tuple(self._reports)

    def misses(self) -> List[str]:
        """Phases trailing the attainment floor (obsview's SLO-MISS
        alarm reads this off the persisted rows)."""
        return [r.phase for r in self._reports if not r.meets(self.target)]


def _q(snap: Optional[dict], q: float) -> Optional[float]:
    if not snap or not snap.get("count"):
        return None
    return snapshot_quantile(snap, q)
