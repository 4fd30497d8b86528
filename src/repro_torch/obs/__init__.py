"""Observability of the port. So far the span tracer the planner records
into and the metrics registry the planner service keeps
(``repro.obs.spans`` and ``repro.obs.metrics``'s counterparts); the rest of
``repro.obs`` is a later slice."""
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, Metric, MetricsRegistry,
    escape_label_value, parse_prometheus_text)
from repro_torch.obs.spans import (
    Span, Tracer, export_tracer_metrics, get_tracer, set_tracer, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
    "escape_label_value", "parse_prometheus_text",
    "Span", "Tracer", "export_tracer_metrics", "get_tracer", "set_tracer",
    "span",
]
