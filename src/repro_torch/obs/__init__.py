"""Query-lifecycle observability.

  * :mod:`.trace`   — context-var span tracer (no-op when disabled).
  * :mod:`.metrics` — counters / gauges / fixed-bucket histograms + registry.
"""
from . import metrics, trace  # noqa: F401
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .trace import Tracer, annotate, current, enabled, recording, span  # noqa: F401
