"""Metrics registry: counters / gauges / histograms with Prometheus-text
and JSON dumps.

The planner service is the primary producer (hit/warm/cold rates,
plan-latency histograms, playouts-to-best, store size, drift-detector
state); the calibration layer adds per-device-type and per-op-type
utilization gauges. Everything is in-process and thread-safe — a metric
is a named family, each (sorted) label set a separate series:

    reg = MetricsRegistry()
    reg.counter("planner_requests_total", "requests").inc(source="hit")
    reg.histogram("planner_plan_latency_seconds", "latency").observe(0.2)
    print(reg.to_prometheus())        # text exposition format
    reg.to_dict()                     # JSON-able dump

No server is bundled: ``python -m repro_torch.service.cli metrics`` prints either format, and a
future planner front end can mount ``to_prometheus()`` on a /metrics
route unchanged.
"""
from __future__ import annotations

import re
import threading

# default histogram buckets: exponential, centered on plan/step latencies
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def escape_label_value(v: str) -> str:
    """Prometheus text-exposition escaping for label values: backslash,
    double-quote, and newline must be escaped inside the quotes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Metric:
    """Base: a named family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict = {}

    def _get(self, labels: dict, default):
        key = _labelkey(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = default()
            return key, self._series[key]

    def series(self) -> dict:
        with self._lock:
            return dict(self._series)

    def remove(self, **labels) -> int:
        """Drop every series whose label set contains all the given
        pairs; returns how many were removed. Long-lived registries
        (the served plane) use this to retire series for runs the
        health analyzer has evicted, so label cardinality tracks live
        runs instead of growing forever."""
        want = {(str(k), str(v)) for k, v in labels.items()}
        with self._lock:
            doomed = [k for k in self._series if want <= set(k)]
            for k in doomed:
                del self._series[k]
        return len(doomed)


class Counter(Metric):
    """Monotonically increasing counter (per label set)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labelkey(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_labelkey(labels), 0.0)

    def to_dict(self) -> dict:
        return {_labelstr(k) or "": v for k, v in self.series().items()}

    def to_prometheus(self) -> list:
        return [f"{self.name}{_labelstr(k)} {v:.10g}"
                for k, v in sorted(self.series().items())]


class Gauge(Metric):
    """Set-to-current-value gauge (per label set)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        key = _labelkey(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _labelkey(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_labelkey(labels), 0.0)

    to_dict = Counter.to_dict
    to_prometheus = Counter.to_prometheus


class _HistSeries:
    __slots__ = ("counts", "total", "count", "vmin", "vmax")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)       # +inf bucket last
        self.total = 0.0
        self.count = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float, **labels):
        value = float(value)
        key, s = self._get(labels, lambda: _HistSeries(len(self.buckets)))
        with self._lock:
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            s.counts[i] += 1
            s.total += value
            s.count += 1
            s.vmin = min(s.vmin, value)
            s.vmax = max(s.vmax, value)

    def snapshot(self, **labels) -> dict:
        """count/sum/mean/min/max + per-bucket cumulative counts."""
        with self._lock:
            s = self._series.get(_labelkey(labels))
            if s is None or s.count == 0:
                return {"count": 0, "sum": 0.0}
            cum, cumcounts = 0, []
            for c in s.counts:
                cum += c
                cumcounts.append(cum)
            return {"count": s.count, "sum": s.total,
                    "mean": s.total / s.count, "min": s.vmin,
                    "max": s.vmax,
                    "buckets": {("+Inf" if i >= len(self.buckets)
                                 else repr(self.buckets[i])): c
                                for i, c in enumerate(cumcounts)}}

    def to_dict(self) -> dict:
        return {_labelstr(_labelkey(dict(k))) or "":
                self.snapshot(**dict(k)) for k in self.series()}

    def to_prometheus(self) -> list:
        lines = []
        for key in sorted(self.series()):
            snap = self.snapshot(**dict(key))
            base = dict(key)
            for le, c in snap.get("buckets", {}).items():
                lab = _labelstr(_labelkey(dict(base, le=le)))
                lines.append(f"{self.name}_bucket{lab} {c}")
            lab = _labelstr(key)
            lines.append(f"{self.name}_sum{lab} {snap['sum']:.10g}")
            lines.append(f"{self.name}_count{lab} {snap['count']}")
        return lines


class MetricsRegistry:
    """Get-or-create metric families; re-registering a name with a
    different kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def to_dict(self) -> dict:
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m.to_dict()} for m in self.metrics()}

    def to_prometheus(self) -> str:
        lines = []
        for m in self.metrics():
            if m.help:
                esc = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {m.name} {esc}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.to_prometheus())
        return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------
# text exposition parser — the validating half of the format contract.
# The CI smoke step and `python -m repro_torch.service.cli metrics --url` run every scrape through
# this, so a registry that emits malformed HELP/TYPE lines, label escaping,
# or histogram series fails loudly instead of at Prometheus ingest time.

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_labels(s: str, lineno: int) -> dict:
    """Parse ``{k="v",...}`` with escape handling; raises ValueError."""
    labels: dict = {}
    i = 1                                  # past '{'
    while True:
        if i >= len(s):
            raise ValueError(f"line {lineno}: unterminated label set")
        if s[i] == "}":
            return labels
        j = s.find("=", i)
        if j < 0:
            raise ValueError(f"line {lineno}: label without '='")
        name = s[i:j].strip()
        if not _LABEL_NAME.match(name):
            raise ValueError(f"line {lineno}: bad label name {name!r}")
        i = j + 1
        if i >= len(s) or s[i] != '"':
            raise ValueError(f"line {lineno}: label value not quoted")
        i += 1
        out = []
        while i < len(s) and s[i] != '"':
            c = s[i]
            if c == "\\":
                if i + 1 >= len(s):
                    raise ValueError(f"line {lineno}: dangling escape")
                nxt = s[i + 1]
                if nxt == "n":
                    out.append("\n")
                elif nxt in ('"', "\\"):
                    out.append(nxt)
                else:
                    raise ValueError(
                        f"line {lineno}: bad escape \\{nxt!r}")
                i += 2
            elif c == "\n":
                raise ValueError(f"line {lineno}: raw newline in value")
            else:
                out.append(c)
                i += 1
        if i >= len(s):
            raise ValueError(f"line {lineno}: unterminated label value")
        labels[name] = "".join(out)
        i += 1                             # past closing '"'
        if i < len(s) and s[i] == ",":
            i += 1


def parse_prometheus_text(text: str) -> dict:
    """Strict parser for the Prometheus text exposition format.

    Returns ``{family: {"kind", "help", "samples": [(name, labels,
    value), ...]}}`` — histogram ``_bucket``/``_sum``/``_count`` series
    fold into their declared base family. Raises ``ValueError`` on any
    format violation: bad metric/label names, broken quoting/escaping,
    unparseable values, duplicate or unknown TYPE declarations, or a
    histogram family missing its ``le``-labelled buckets.
    """
    families: dict = {}

    def fam(name: str) -> dict:
        return families.setdefault(
            name, {"kind": None, "help": None, "samples": []})

    def base_family(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
                if families.get(base, {}).get("kind") in ("histogram",
                                                          "summary"):
                    return base
        return name

    for lineno, raw in enumerate(text.split("\n"), 1):
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name = parts[0]
            if not _METRIC_NAME.match(name):
                raise ValueError(f"line {lineno}: bad HELP name {name!r}")
            fam(name)["help"] = (parts[1] if len(parts) > 1 else "")
        elif line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            name, kind = parts
            if not _METRIC_NAME.match(name):
                raise ValueError(f"line {lineno}: bad TYPE name {name!r}")
            if kind not in _TYPES:
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            f = fam(name)
            if f["kind"] is not None:
                raise ValueError(f"line {lineno}: duplicate TYPE {name}")
            f["kind"] = kind
        elif line.startswith("#"):
            continue                       # free-form comment
        else:
            brace = line.find("{")
            if brace >= 0:
                name = line[:brace]
                close = line.rfind("}")
                if close < brace:
                    raise ValueError(f"line {lineno}: unbalanced braces")
                labels = _parse_labels(line[brace:close + 1], lineno)
                rest = line[close + 1:].strip()
            else:
                name, _, rest = line.partition(" ")
                labels, rest = {}, rest.strip()
            if not _METRIC_NAME.match(name):
                raise ValueError(f"line {lineno}: bad metric name {name!r}")
            fields = rest.split()
            if not fields:
                raise ValueError(f"line {lineno}: sample missing value")
            tok = fields[0]
            try:
                value = float("inf" if tok == "+Inf" else
                              "-inf" if tok == "-Inf" else tok)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: bad sample value {tok!r}") from None
            fam(base_family(name))["samples"].append((name, labels, value))

    for name, f in families.items():
        if f["kind"] is None:
            f["kind"] = "untyped"
        if f["kind"] == "histogram" and f["samples"]:
            series = {s for s, _, _ in f["samples"]}
            if f"{name}_bucket" not in series:
                raise ValueError(f"histogram {name} has no _bucket series")
            if f"{name}_count" not in series or f"{name}_sum" not in series:
                raise ValueError(f"histogram {name} missing _sum/_count")
            if not all(lbl.get("le") for s, lbl, _ in f["samples"]
                       if s == f"{name}_bucket"):
                raise ValueError(f"histogram {name} bucket missing 'le'")
    return families
