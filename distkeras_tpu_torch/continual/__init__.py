"""Continual learning on the port: train forever on an unbounded stream,
deploy drift-gated checkpoints into the live decode service (the port of
``distkeras_tpu.continual``).

* ``config``  — ``ContinualConfig``: the window / snapshot / history
  cadences and the gate's watch list.
* ``trainer`` — ``ContinualTrainer``: the train-forever daemon over a
  prefetched unbounded feed (``synthetic_lm_feed`` simulates one),
  snapshotting its obs registry at interval edges, checkpointing with
  rolling-keep, and promoting drift-clean checkpoints into a running
  ``serve.DecodeEngine`` (in-process ``promote()``) or a service over the
  ``promote`` RPC (``serve.ServeClient.promote``).
* ``gate``    — ``DeployGate``: the rolling window of per-interval
  registry deltas classified by ``obs.drift.classify_window``; only
  stable windows deploy, every verdict and rejection a recorded metric.
"""

from .config import DEFAULT_WATCH, LOSS_BUCKETS, ContinualConfig  # noqa: F401
from .gate import DeployGate  # noqa: F401
from .trainer import ContinualTrainer, synthetic_lm_feed  # noqa: F401
