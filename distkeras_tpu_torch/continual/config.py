"""Continual-learning knobs — the port's copy of
``distkeras_tpu.continual.config``, the bundle ``ContinualTrainer`` and
``DeployGate`` share, with the same fields, defaults and validation
messages.

The load-bearing choices are the three cadences:

* ``window_steps`` — batches per window-loop call (static shape, so the
  window program keeps one argument signature for the whole run:
  ``jit.retraces == 0`` in steady state, as in the epoch trainers).
* ``snapshot_every`` — windows per **obs interval**: at each interval
  edge the trainer snapshots its registry, differences it against the
  previous edge (``obs.drift.snapshot_delta``) and feeds the per-interval
  delta to the deploy gate.  Loss observations per interval =
  ``window_steps * snapshot_every`` — size it against the drift
  thresholds' ``min_count`` or the gate compares nothing.
* ``history`` / ``min_history`` — the rolling window of interval deltas
  the windowed diff classifies (step vs trend vs stable), and how many
  intervals must accumulate before ANY deploy: a half-empty window that
  trivially classifies "stable" is warm-up, not evidence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

#: loss-valued histogram buckets — log-spaced over the span a training
#: loss actually crosses (cross-entropy from ln(vocab) cold to ~1e-3
#: converged); the drift gate's PSI reads bucket mass, so the buckets
#: must resolve both ends
LOSS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 10.0)

#: gate default: model-health metrics only.  Wall-clock-shaped series
#: (window seconds, stream lag) stay OUT of the deploy decision — a
#: loaded host must not block deploys — but are still recorded and
#: persisted for the bench/obsview views.
DEFAULT_WATCH = ("continual.loss", "jit.retraces")


@dataclasses.dataclass
class ContinualConfig:
    """Knobs for the train-forever loop.

    * ``batch_size`` / ``window_steps`` — feed batch shape and batches
      per window-loop call.
    * ``snapshot_every`` — windows per obs interval (snapshot + gate +
      checkpoint + deploy decision cadence).
    * ``history`` — rolling window N of interval deltas the windowed
      diff classifies; ``min_history`` intervals must accumulate before
      deploys may start.
    * ``prefetch`` — feed prefetch depth (``data.streaming`` producer
      thread; 0 consumes the feed synchronously).
    * ``checkpoint_keep`` — rolling-keep depth for the per-interval
      checkpoints (``utils.checkpoint.CheckpointManager``).
    * ``max_intervals`` — bounded run (bench/tests); ``None`` trains
      until ``stop()``.
    * ``watch`` — fnmatch patterns selecting which metrics the deploy
      gate watches; ``loss_buckets`` — the ``continual.loss`` histogram
      bounds.
    """

    batch_size: int = 16
    window_steps: int = 4
    snapshot_every: int = 4
    history: int = 4
    min_history: int = 3
    prefetch: int = 4
    checkpoint_keep: int = 3
    max_intervals: Optional[int] = None
    watch: Sequence[str] = DEFAULT_WATCH
    loss_buckets: Tuple[float, ...] = LOSS_BUCKETS

    def __post_init__(self):
        for field in ("batch_size", "window_steps", "snapshot_every",
                      "history", "min_history", "checkpoint_keep"):
            if int(getattr(self, field)) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)}")
        if int(self.prefetch) < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if int(self.min_history) > int(self.history):
            raise ValueError(
                f"min_history {self.min_history} cannot exceed the "
                f"rolling window history {self.history} — the gate could "
                f"never fill far enough to deploy")
        if self.max_intervals is not None and int(self.max_intervals) < 1:
            raise ValueError(f"max_intervals must be >= 1 or None, got "
                             f"{self.max_intervals}")

    def config_row(self) -> dict:
        """Plain-data config for obs snapshots / the bench row — the
        fields that make two runs comparable (drift gate ``config``)."""
        return {
            "batch_size": int(self.batch_size),
            "window_steps": int(self.window_steps),
            "snapshot_every": int(self.snapshot_every),
            "history": int(self.history),
            "min_history": int(self.min_history),
            "watch": list(self.watch),
        }
