"""Telemetry for the port: instruments and registry, logging, and the
retrace sentinel — the parts of ``distkeras_tpu.obs`` the serving slice
records through, with the same metric names and snapshot format."""

from .registry import (  # noqa: F401
    TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    snapshot_quantile,
)
from .logging import get_logger  # noqa: F401
from .profile import RetraceSentinel, tree_signature  # noqa: F401
