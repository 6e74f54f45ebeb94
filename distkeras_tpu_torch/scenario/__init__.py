"""Scenario harness on the port (the port of ``distkeras_tpu.scenario``):
trace-driven open-loop load, SLO attainment accounting, and the
obs-driven autoscaler.

``traces`` generates seeded deterministic arrival schedules at
production shape (Poisson / diurnal / flash-crowd, heavy-tail lengths,
shared-prefix mix) or replays recorded JSONL traces; ``runner`` fires
them open-loop at the serve fleet with exact three-way accounting;
``slo`` turns the fleet's own ``serve.*`` histograms into per-phase
attainment/shed/goodput verdicts; ``autoscale`` grows and shrinks
engines behind the router from those same signals.  One entry point:
``python -m distkeras_tpu_torch.bench --scenario NAME``.
"""

from .autoscale import AutoscalePolicy, AutoScaler, Signals
from .runner import (SCENARIO_COUNTERS, SCENARIO_HISTOGRAMS,
                     ScenarioRunner, build_prompt, precreate_metrics)
from .slo import (PhaseAccountant, PhaseReport, SLOTarget,
                  hist_fraction_le)
from .traces import (Arrival, LengthModel, PrefixMix, ScenarioSpec,
                     diurnal_trace, poisson_trace, replay_trace,
                     save_trace, spike_trace)

__all__ = [
    "Arrival", "AutoScaler", "AutoscalePolicy", "LengthModel",
    "PhaseAccountant", "PhaseReport", "PrefixMix", "SCENARIO_COUNTERS",
    "SCENARIO_HISTOGRAMS", "SLOTarget", "ScenarioRunner", "ScenarioSpec",
    "Signals", "build_prompt", "diurnal_trace", "hist_fraction_le",
    "poisson_trace", "precreate_metrics", "replay_trace", "save_trace",
    "spike_trace",
]
