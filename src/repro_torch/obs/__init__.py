"""Observability of the port, ``repro.obs``'s counterpart:

  * ``trace``          — Chrome/Perfetto trace export of predicted schedule
                         ``Timeline``s and executed event streams, and the
                         predicted-vs-executed ``diff_report``;
  * ``spans``          — the thread-safe span API the planner records into;
  * ``metrics``        — counters, gauges and histograms with Prometheus-text
                         and JSON dumps;
  * ``torch_profiler`` — ``torch.profiler`` around one step, its Chrome trace
                         parsed into ``StepRecord.collectives`` (the
                         counterpart of ``repro.obs.xla_profiler``);
  * ``collector``      — the cross-process span/event spool (fcntl-locked
                         JSONL shards with wall<->monotonic anchors) and its
                         incremental merge into one Chrome trace;
  * ``server``         — the stdlib HTTP daemon serving /metrics, /healthz,
                         /traces/<run_id>, /plans, /runs,
                         /runs/<run_id>/health and /alerts;
  * ``health``         — ``RunHealthAnalyzer``: executed-vs-predicted
                         residual attribution, straggler ranking, replan
                         priority;
  * ``alerts``         — step-time SLO tracking with multi-window burn-rate
                         ``AlertRule`` evaluation.
"""
from repro_torch.obs.alerts import (
    AlertEvaluator, AlertRule, AlertState, SLOTracker, default_rules,
    load_rules, parse_rules)
from repro_torch.obs.collector import SpoolWriter, TraceCollector, shard_path
from repro_torch.obs.health import RunHealthAnalyzer
from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, Metric, MetricsRegistry,
    escape_label_value, parse_prometheus_text)
from repro_torch.obs.server import PROM_CONTENT_TYPE, ObsServer
from repro_torch.obs.spans import (
    Span, Tracer, export_tracer_metrics, get_tracer, set_tracer, span)
from repro_torch.obs.torch_profiler import (
    attach_collectives, classify_op, find_trace_files,
    parse_trace_collectives, profile_step, profiler_available)
from repro_torch.obs.trace import (
    aggregate_events, chrome_trace, diff_report, event_name,
    executed_events_of, executed_trace_events, format_diff,
    timeline_trace_events, validate_chrome_trace, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
    "escape_label_value", "parse_prometheus_text",
    "Span", "Tracer", "export_tracer_metrics", "get_tracer",
    "set_tracer", "span",
    "SpoolWriter", "TraceCollector", "shard_path",
    "ObsServer", "PROM_CONTENT_TYPE",
    "AlertEvaluator", "AlertRule", "AlertState", "SLOTracker",
    "default_rules", "load_rules", "parse_rules",
    "RunHealthAnalyzer",
    "aggregate_events", "chrome_trace", "diff_report", "event_name",
    "executed_events_of", "executed_trace_events", "format_diff",
    "timeline_trace_events", "validate_chrome_trace",
    "write_chrome_trace",
    "attach_collectives", "classify_op", "find_trace_files",
    "parse_trace_collectives", "profile_step", "profiler_available",
]
