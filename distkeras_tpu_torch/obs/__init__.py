"""Telemetry for the port: instruments and registry (labeled, mergeable),
logging, spans, the retrace sentinel, the trainers' profile knobs and the
straggler and link-quality detectors, and the telemetry store the serve
router's health poll feeds — the parts of ``distkeras_tpu.obs`` the
serving, training and parameter-server slices record through, with the
same metric names and record formats."""

from .registry import (  # noqa: F401
    COUNT_BUCKETS,
    TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    flat_name,
    flatten_snapshot,
    snapshot_quantile,
)
from .logging import emit, get_logger  # noqa: F401
from .profile import (  # noqa: F401
    ProfileConfig,
    RetraceSentinel,
    observe_memory,
    tree_signature,
)
from .spans import SpanTracer, span  # noqa: F401
from .stragglers import (  # noqa: F401
    LinkQuality,
    StragglerDetector,
)
from .drift import snapshot_delta  # noqa: F401
from .timeseries import TelemetryShipper, TimeSeriesStore  # noqa: F401
