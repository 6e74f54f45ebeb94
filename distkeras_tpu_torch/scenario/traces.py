"""Open-loop arrival traces — the port's copy of
``distkeras_tpu.scenario.traces``: seeded, deterministic workload
generators at production shape, equal arrival for arrival to the JAX
package's for the same seed.

A closed loop (each client waits for its reply before sending the next
request) lets the offered load *adapt to* the service under test, so a
slowdown quietly sheds its own traffic.  Production traffic does not
wait: requests arrive when users send them.  This module emits that
shape as plain data — a :class:`ScenarioSpec` holding a fully
materialized arrival schedule — which the runner then fires **at the
trace timestamps regardless of completion** (the open loop).

Generators (all driven by one ``np.random.default_rng(seed)``, so the
same seed always yields the identical schedule, byte for byte):

* :func:`poisson_trace` — steady-state Poisson arrivals.
* :func:`diurnal_trace` — a non-homogeneous Poisson ramp over one
  sinusoidal "day" (night → ramp-up → peak → ramp-down → evening),
  generated by Lewis–Shedler thinning against the peak rate.
* :func:`spike_trace` — flash crowd: base-rate traffic with a
  rectangular rate spike (pre → spike → post phases).

Request *sizes* ride a :class:`LengthModel` — fixed lengths or
heavy-tail lognormal prompt/output lengths — and a :class:`PrefixMix`
assigns a share of requests to shared-prefix groups with a power-law
popularity skew (the system-prompt workload the fleet's affinity routing
and prefix cache exist for).

Recorded traces replay: :func:`save_trace` writes a spec as JSONL (one
header line + one line per arrival), :func:`replay_trace` loads it back
— a file either package wrote replays in either.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs.logging import get_logger

_LOG = "scenario.traces"

#: replay-file header schema tag (bump on incompatible change)
TRACE_SCHEMA = "dktpu-trace/v1"


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at ``t`` seconds after scenario
    start, with a ``prompt_len``-token prompt (the first tokens shared
    with every other arrival of the same ``group`` when ``group >= 0``;
    a unique prompt when ``group`` is -1) and ``new_tokens`` of decode.
    ``phase`` names the accounting window the request belongs to."""

    t: float
    phase: str
    prompt_len: int
    new_tokens: int
    group: int = -1

    def to_row(self) -> dict:
        return {"t": float(self.t), "phase": self.phase,
                "prompt_len": int(self.prompt_len),
                "new_tokens": int(self.new_tokens),
                "group": int(self.group)}

    @classmethod
    def from_row(cls, row: dict) -> "Arrival":
        return cls(t=float(row["t"]), phase=str(row["phase"]),
                   prompt_len=int(row["prompt_len"]),
                   new_tokens=int(row["new_tokens"]),
                   group=int(row.get("group", -1)))


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A fully materialized open-loop workload: plain data, no live
    state — two specs with the same fields ARE the same workload.

    ``phase_bounds`` maps the timeline into contiguous accounting
    windows: ``[(name, start_s), ...]`` ascending by start, first entry
    at 0.0.  Every arrival's ``phase`` is consistent with these bounds
    by construction; the runner cuts its interval snapshots at the
    bound times."""

    name: str
    seed: int
    duration_s: float
    phase_bounds: Tuple[Tuple[str, float], ...]
    arrivals: Tuple[Arrival, ...]

    @property
    def phases(self) -> List[str]:
        return [p for p, _ in self.phase_bounds]

    def phase_at(self, t: float) -> str:
        name = self.phase_bounds[0][0]
        for p, start in self.phase_bounds:
            if t >= start:
                name = p
            else:
                break
        return name

    def counts_by_phase(self) -> dict:
        out = {p: 0 for p in self.phases}
        for a in self.arrivals:
            out[a.phase] = out.get(a.phase, 0) + 1
        return out


@dataclasses.dataclass(frozen=True)
class LengthModel:
    """Prompt/output length distribution.  ``sigma`` 0 is the fixed
    model (every request exactly ``prompt_median`` / ``new_median``);
    positive sigmas draw lognormal lengths — the heavy-tail shape —
    clamped to ``[min, max]`` so a tail draw can never exceed the
    engine's sequence budget."""

    prompt_median: int = 12
    new_median: int = 8
    prompt_sigma: float = 0.0
    new_sigma: float = 0.0
    prompt_min: int = 2
    prompt_max: int = 48
    new_min: int = 1
    new_max: int = 32

    def sample(self, rng: np.random.Generator,
               n: int) -> Tuple[np.ndarray, np.ndarray]:
        def draw(median, sigma, lo, hi):
            if sigma <= 0:
                return np.full(n, int(median), dtype=np.int64)
            v = rng.lognormal(mean=np.log(float(median)), sigma=sigma,
                              size=n)
            return np.clip(np.round(v).astype(np.int64), lo, hi)

        return (draw(self.prompt_median, self.prompt_sigma,
                     self.prompt_min, self.prompt_max),
                draw(self.new_median, self.new_sigma,
                     self.new_min, self.new_max))


@dataclasses.dataclass(frozen=True)
class PrefixMix:
    """Shared-prefix assignment: with probability ``share`` a request
    joins one of ``groups`` prefix groups (popularity ∝ 1/(rank+1), the
    power-law skew of real system prompts); otherwise its prompt is
    unique (group -1)."""

    groups: int = 8
    share: float = 0.7

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.groups < 1 or self.share <= 0:
            return np.full(n, -1, dtype=np.int64)
        w = 1.0 / (np.arange(self.groups) + 1.0)
        w /= w.sum()
        g = rng.choice(self.groups, size=n, p=w)
        keep = rng.random(n) < float(self.share)
        return np.where(keep, g, -1)


def _assemble(name: str, seed: int, duration_s: float, times: np.ndarray,
              phase_bounds: Sequence[Tuple[str, float]],
              lengths: LengthModel, mix: PrefixMix,
              rng: np.random.Generator) -> ScenarioSpec:
    """Times + phase map + per-request draws -> a frozen spec.  Length
    and group draws happen AFTER the arrival process consumed the rng,
    in one vectorized pass each — the draw order is part of the
    determinism contract (same seed ⇒ identical schedule)."""
    n = len(times)
    prompt_lens, new_tokens = lengths.sample(rng, n)
    groups = mix.sample(rng, n)
    bounds = tuple((str(p), float(t)) for p, t in phase_bounds)
    spec = ScenarioSpec(
        name=name, seed=int(seed), duration_s=float(duration_s),
        phase_bounds=bounds, arrivals=tuple(
            Arrival(t=float(t),
                    phase=_phase_at(bounds, float(t)),
                    prompt_len=int(prompt_lens[i]),
                    new_tokens=int(new_tokens[i]),
                    group=int(groups[i]))
            for i, t in enumerate(times)))
    get_logger(_LOG).info(
        "trace %s: %d arrivals over %.1fs (%s)", name, n, duration_s,
        ", ".join(f"{p}={c}" for p, c in spec.counts_by_phase().items()))
    return spec


def _phase_at(bounds, t: float) -> str:
    name = bounds[0][0]
    for p, start in bounds:
        if t >= start:
            name = p
        else:
            break
    return name


def poisson_trace(rate: float, duration_s: float, *, seed: int = 0,
                  lengths: Optional[LengthModel] = None,
                  mix: Optional[PrefixMix] = None,
                  phase: str = "steady",
                  name: str = "poisson") -> ScenarioSpec:
    """Homogeneous Poisson arrivals at ``rate`` req/s for
    ``duration_s`` (exponential inter-arrival gaps)."""
    if rate <= 0 or duration_s <= 0:
        raise ValueError("poisson_trace needs rate > 0 and duration > 0")
    rng = np.random.default_rng(seed)
    # draw in one vectorized block sized generously, trim to duration —
    # per-arrival python-loop draws would dominate generation time at
    # production arrival counts
    n_max = max(16, int(rate * duration_s * 2 + 10 * np.sqrt(
        rate * duration_s + 1)))
    gaps = rng.exponential(1.0 / rate, size=n_max)
    times = np.cumsum(gaps)
    times = times[times < duration_s]
    return _assemble(name, seed, duration_s, times, ((phase, 0.0),),
                     lengths or LengthModel(), mix or PrefixMix(), rng)


#: diurnal phase map as fractions of the period — contiguous windows
#: over one sinusoidal day (rate λ(t) = base + Δ·sin²(πt/P): trough at
#: the edges, peak in the middle)
DIURNAL_PHASES = (("night", 0.0), ("ramp_up", 0.25), ("peak", 0.40),
                  ("ramp_down", 0.60), ("evening", 0.75))


def diurnal_trace(base_rate: float, peak_rate: float, period_s: float, *,
                  seed: int = 0, lengths: Optional[LengthModel] = None,
                  mix: Optional[PrefixMix] = None,
                  name: str = "diurnal") -> ScenarioSpec:
    """One sinusoidal "day": a non-homogeneous Poisson process with
    λ(t) = base + (peak-base)·sin²(πt/period), generated by thinning
    against the peak rate (Lewis–Shedler), phased night → ramp_up →
    peak → ramp_down → evening."""
    if not (0 < base_rate <= peak_rate) or period_s <= 0:
        raise ValueError("diurnal_trace needs 0 < base_rate <= peak_rate "
                         "and period_s > 0")
    rng = np.random.default_rng(seed)
    n_max = max(16, int(peak_rate * period_s * 2 + 10 * np.sqrt(
        peak_rate * period_s + 1)))
    gaps = rng.exponential(1.0 / peak_rate, size=n_max)
    cand = np.cumsum(gaps)
    cand = cand[cand < period_s]
    lam = base_rate + (peak_rate - base_rate) * np.sin(
        np.pi * cand / period_s) ** 2
    keep = rng.random(len(cand)) < lam / peak_rate
    times = cand[keep]
    bounds = [(p, frac * period_s) for p, frac in DIURNAL_PHASES]
    return _assemble(name, seed, period_s, times, bounds,
                     lengths or LengthModel(), mix or PrefixMix(), rng)


def spike_trace(base_rate: float, spike_rate: float, duration_s: float, *,
                spike_start: float, spike_duration: float, seed: int = 0,
                lengths: Optional[LengthModel] = None,
                mix: Optional[PrefixMix] = None,
                name: str = "spike") -> ScenarioSpec:
    """Flash crowd: ``base_rate`` traffic with a rectangular jump to
    ``spike_rate`` during [spike_start, spike_start+spike_duration)
    — phases pre → spike → post."""
    if base_rate <= 0 or spike_rate < base_rate or duration_s <= 0:
        raise ValueError("spike_trace needs 0 < base_rate <= spike_rate")
    end = spike_start + spike_duration
    if not (0 < spike_start < end < duration_s):
        raise ValueError("spike window must sit strictly inside the trace")
    rng = np.random.default_rng(seed)
    n_max = max(16, int(spike_rate * duration_s * 2 + 10 * np.sqrt(
        spike_rate * duration_s + 1)))
    gaps = rng.exponential(1.0 / spike_rate, size=n_max)
    cand = np.cumsum(gaps)
    cand = cand[cand < duration_s]
    lam = np.where((cand >= spike_start) & (cand < end),
                   spike_rate, base_rate)
    keep = rng.random(len(cand)) < lam / spike_rate
    times = cand[keep]
    bounds = [("pre", 0.0), ("spike", float(spike_start)),
              ("post", float(end))]
    return _assemble(name, seed, duration_s, times, bounds,
                     lengths or LengthModel(), mix or PrefixMix(), rng)


# ---------------------------------------------------------------------------
# recorded-trace replay
# ---------------------------------------------------------------------------

def save_trace(spec: ScenarioSpec, path: str) -> None:
    """Write a spec as JSONL: one header line (schema + scenario
    metadata), then one line per arrival in schedule order."""
    with open(path, "w") as f:
        f.write(json.dumps({
            "schema": TRACE_SCHEMA, "name": spec.name, "seed": spec.seed,
            "duration_s": spec.duration_s,
            "phase_bounds": [[p, t] for p, t in spec.phase_bounds],
        }) + "\n")
        for a in spec.arrivals:
            f.write(json.dumps(a.to_row()) + "\n")


def replay_trace(path: str) -> ScenarioSpec:
    """Load a recorded arrival trace (the :func:`save_trace` format)
    back into a spec — the replay seam for captured production arrival
    logs.  Arrivals are re-sorted by timestamp so a log assembled from
    several capture shards replays in schedule order."""
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"{path}: not a {TRACE_SCHEMA} trace "
                f"(schema={header.get('schema')!r})")
        rows = [Arrival.from_row(json.loads(line))
                for line in f if line.strip()]
    rows.sort(key=lambda a: a.t)
    return ScenarioSpec(
        name=str(header.get("name", "replay")),
        seed=int(header.get("seed", -1)),
        duration_s=float(header["duration_s"]),
        phase_bounds=tuple((str(p), float(t))
                           for p, t in header["phase_bounds"]),
        arrivals=tuple(rows))
