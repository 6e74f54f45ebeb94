"""Telemetry for the port — the counterpart of ``distkeras_tpu.obs``,
exporting the same names with the same metric names and record formats.

* ``registry`` — counters, gauges and histograms (labeled, mergeable,
  plain-data snapshots); ``exposition`` renders them as Prometheus text.
* ``spans`` / ``logging`` — timed scopes on the JSONL metrics stream and
  the library's logging and console seam.
* ``stragglers`` — heartbeat-gap and link-quality detectors.
* ``profile`` — the retrace sentinel, memory watermarks, the host/device
  step split and the ``torch.profiler`` capture seam; ``export`` renders
  the span/heartbeat JSONL as a Chrome trace.
* ``drift`` — cross-run snapshot diffs and the windowed step/trend
  classifier the continual deploy gate reads.
* ``timeseries`` / ``alerts`` — the live fleet series the serve router's
  health poll feeds, and threshold and SLO burn-rate rules over it.
"""

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
from .spans import SpanTracer, default_tracer, set_default_sink, span  # noqa: F401
from .exposition import to_prometheus_text  # noqa: F401
from .logging import emit, enable_stderr_logging, get_logger  # noqa: F401
from .stragglers import (  # noqa: F401
    LinkQuality,
    StragglerDetector,
    detect_from_heartbeats,
)
from .profile import (  # noqa: F401
    ProfileConfig,
    RetraceSentinel,
    device_trace,
    memory_snapshot,
    observe_memory,
    step_split,
    tree_signature,
)
from .export import records_to_chrome_trace, write_chrome_trace  # noqa: F401
from .drift import (  # noqa: F401
    BASELINE_SCHEMA,
    DEFAULT_THRESHOLDS,
    WINDOW_KINDS,
    DriftReport,
    WindowVerdict,
    classify_window,
    diff_docs,
    diff_files,
    find_baseline,
    load_baseline,
    snapshot_delta,
)
from .timeseries import TelemetryShipper, TimeSeriesStore  # noqa: F401
from .alerts import (  # noqa: F401
    KNOWN_LABEL_KEYS,
    AlertEngine,
    AlertRule,
    parse_rules,
)
