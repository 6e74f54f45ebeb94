"""Telemetry for the port: instruments and registry, logging, spans, the
retrace sentinel and the trainers' profile knobs — the parts of
``distkeras_tpu.obs`` the serving and training slices record through,
with the same metric names and record formats."""

from .registry import (  # noqa: F401
    TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    snapshot_quantile,
)
from .logging import get_logger  # noqa: F401
from .profile import (  # noqa: F401
    ProfileConfig,
    RetraceSentinel,
    observe_memory,
    tree_signature,
)
from .spans import SpanTracer, span  # noqa: F401
