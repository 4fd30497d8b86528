"""Served observability plane: /metrics, /healthz, /traces, /plans,
/runs, /alerts.

A stdlib ``http.server`` daemon that turns the in-process observability
surfaces into live endpoints — no third-party dependency, safe to embed
in the planner service or run standalone via ``python -m
repro_torch.service.cli serve-metrics``:

  * ``GET /metrics``        — Prometheus text exposition from the live
                              ``MetricsRegistry`` (planner counters,
                              calibration gauges, tracer drop counter,
                              collector spool gauges, run-health
                              series);
  * ``GET /healthz``        — liveness JSON (uptime, scrape count,
                              collector/recalibration state);
  * ``GET /traces``         — JSON list of spooled run ids;
  * ``GET /traces/<run_id>``— the merged, clock-aligned Chrome trace
                              for one run (all runs via ``/traces/all``;
                              runs past ``trace_stream_events`` stream
                              chunked with bounded memory);
  * ``GET /plans``          — plan-store stats + per-plan entries with
                              their cached verify diagnostics;
  * ``GET /plans/<fp>/verify`` — full TAGxxx diagnostics for plans
                              matching a fingerprint prefix;
  * ``GET /runs``           — run-health index (one row per run);
  * ``GET /runs/<run_id>/health`` — the full health snapshot: residual
                              ratios, stragglers, attribution, SLO;
  * ``GET /alerts``         — all runs' burn-rate alert states.

The server binds before ``start()`` returns (port 0 picks a free port,
so tests never race on a fixed one), handles requests on daemon threads,
and refreshes per-scrape state inside the request: each ``/metrics``
scrape re-exports tracer drop counts, drains this process's tracer into
the spool (when one is attached), polls the collector and the health
analyzer, and re-reads the plan-store size — a scrape always reflects
*now*, not server start.
"""
from __future__ import annotations

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import json
import threading
import time
from urllib.parse import urlparse

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import export_tracer_metrics, get_tracer

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """HTTP front end over a registry + optional service/collector/loop.

    Every collaborator is optional and duck-typed: ``service`` needs
    ``.metrics``/``.store``/``.stats()`` (a ``PlannerService``),
    ``collector`` is a ``TraceCollector``, ``spool`` a ``SpoolWriter``
    this process drains its own tracer into, ``recalib`` a
    ``RecalibrationLoop`` whose lifecycle the server adopts on
    ``start()``/``stop()``.
    """

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 service=None, collector=None, spool=None, recalib=None,
                 health=None, host: str = "127.0.0.1", port: int = 0,
                 spool_max_age_s: float | None = None,
                 spool_max_bytes: int | None = None,
                 trace_stream_events: int = 10_000):
        if registry is None:
            registry = service.metrics if service is not None \
                else MetricsRegistry()
        self.registry = registry
        self.service = service
        self.collector = collector
        self.spool = spool
        self.recalib = recalib
        # run-health analyzer (repro_torch.obs.health.RunHealthAnalyzer):
        # polled + exported on every /metrics scrape, served on /runs,
        # /runs/<run_id>/health and /alerts
        self.health = health
        # traces with more merged spans than this stream chunked instead
        # of buffering the whole serialized JSON document
        self.trace_stream_events = int(trace_stream_events)
        # shard retention budgets: each /metrics scrape GCs drained
        # spool shards past these (None = keep forever)
        self.spool_max_age_s = spool_max_age_s
        self.spool_max_bytes = spool_max_bytes
        self._t0 = time.time()
        self._scrapes = registry.counter(
            "obs_http_requests_total", "requests served by the obs plane")
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- lifecycle
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-server", daemon=True)
        self._thread.start()
        if self.recalib is not None:
            self.recalib.start()
        return self

    def stop(self):
        if self.recalib is not None:
            self.recalib.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- routes
    def render_metrics(self) -> str:
        """The /metrics body; refreshes live state before rendering."""
        export_tracer_metrics(self.registry)
        if self.spool is not None:
            try:
                self.spool.emit_tracer(get_tracer())
            except OSError:
                pass
        if self.service is not None:
            self.registry.gauge(
                "planner_store_size",
                "plans resident in the store").set(len(self.service.store))
        if self.collector is not None:
            self.collector.poll()
            if self.spool_max_age_s is not None \
                    or self.spool_max_bytes is not None:
                res = self.collector.gc(max_age_s=self.spool_max_age_s,
                                        max_bytes=self.spool_max_bytes)
                if res["deleted"]:
                    self.registry.counter(
                        "collector_spool_gc_deleted_total",
                        "drained spool shard files removed by retention "
                        "GC").inc(res["deleted"])
                    self.registry.counter(
                        "collector_spool_gc_bytes_total",
                        "spool bytes reclaimed by retention GC").inc(
                        res["bytes_freed"])
            c = self.collector.counts()
            g = self.registry.gauge
            g("collector_spool_shards",
              "spool shard files seen by the collector").set(c["shards"])
            g("collector_spool_spans",
              "span records merged from the spool").set(c["spans"])
            g("collector_spool_bad_lines",
              "malformed spool lines skipped").set(c["bad_lines"])
            g("collector_spool_runs",
              "distinct run ids in the spool").set(c["runs"])
        if self.health is not None:
            self.health.poll()
            self.health.export_metrics(self.registry)
        return self.registry.to_prometheus()

    def _healthz(self) -> dict:
        body = {"status": "ok", "uptime_s": time.time() - self._t0,
                "requests": self._scrapes.value(path="/metrics")}
        if self.collector is not None:
            body["collector"] = self.collector.counts()
        if self.recalib is not None:
            body["recalibration"] = self.recalib.stats()
        if self.service is not None:
            body["store_size"] = len(self.service.store)
        if self.health is not None:
            body["run_health"] = self.health.stats()
        return body

    def _plan_listing(self) -> dict:
        """The /plans body: service stats + per-plan entries carrying
        the cached verify verdict AND the full TAGxxx diagnostics."""
        body = self.service.stats()
        body["plans"] = self.service.plan_entries()
        return body

    def _plan_verify_detail(self, fp: str):
        """Plans matching a fingerprint prefix, with full diagnostics.

        ``fp`` matches a record when it prefixes the graph fingerprint,
        the topology fingerprint, or the ``<graph24>-<topo24>`` combined
        form the store names its files with.
        """
        matches = []
        for entry in self.service.plan_entries():
            combined = f"{entry['graph_fp'][:24]}-{entry['topo_fp'][:24]}"
            if (entry["graph_fp"].startswith(fp)
                    or entry["topo_fp"].startswith(fp)
                    or combined.startswith(fp)):
                matches.append(entry)
        return matches

    def _route(self, path: str):
        """Returns (status, content_type, body) — ``body`` is a str, or
        an iterator of str fragments for chunked streaming responses."""
        def as_json(obj, status=200):
            return status, "application/json", json.dumps(
                obj, indent=2, sort_keys=True, default=str) + "\n"

        if path in ("/metrics", "/metrics/"):
            self._scrapes.inc(path="/metrics")
            return 200, PROM_CONTENT_TYPE, self.render_metrics()
        if path in ("/healthz", "/healthz/", "/health"):
            self._scrapes.inc(path="/healthz")
            return as_json(self._healthz())
        if path in ("/plans", "/plans/"):
            self._scrapes.inc(path="/plans")
            if self.service is None:
                return as_json({"error": "no planner service attached"},
                               404)
            return as_json(self._plan_listing())
        if path.startswith("/plans/") and path.rstrip("/").endswith(
                "/verify"):
            self._scrapes.inc(path="/plans/<fp>/verify")
            if self.service is None:
                return as_json({"error": "no planner service attached"},
                               404)
            fp = path[len("/plans/"):].rstrip("/")
            fp = fp[:-len("/verify")].strip("/")
            matches = self._plan_verify_detail(fp)
            if not matches:
                return as_json(
                    {"error": f"no plan matching fingerprint {fp!r}",
                     "plans": [e["graph_fp"][:24] for e in
                               self.service.plan_entries()]}, 404)
            return as_json({"fingerprint": fp, "matches": matches})
        if path in ("/runs", "/runs/"):
            self._scrapes.inc(path="/runs")
            if self.health is None:
                return as_json({"error": "no health analyzer attached"},
                               404)
            self.health.poll()
            return as_json({"runs": self.health.run_summaries()})
        if path.startswith("/runs/") and path.rstrip("/").endswith(
                "/health"):
            self._scrapes.inc(path="/runs/<run_id>/health")
            if self.health is None:
                return as_json({"error": "no health analyzer attached"},
                               404)
            run_id = path[len("/runs/"):].rstrip("/")
            run_id = run_id[:-len("/health")].strip("/")
            self.health.poll()
            try:
                return as_json(self.health.health(run_id))
            except KeyError:
                return as_json({"error": f"unknown run {run_id!r}",
                                "runs": self.health.run_ids()}, 404)
        if path in ("/alerts", "/alerts/"):
            self._scrapes.inc(path="/alerts")
            if self.health is None:
                return as_json({"error": "no health analyzer attached"},
                               404)
            self.health.poll()
            return as_json({"alerts": self.health.alerts()})
        if path in ("/traces", "/traces/"):
            self._scrapes.inc(path="/traces")
            if self.collector is None:
                return as_json({"error": "no trace collector attached"},
                               404)
            self.collector.poll()
            return as_json({"runs": self.collector.run_ids()})
        if path.startswith("/traces/"):
            self._scrapes.inc(path="/traces/<run_id>")
            if self.collector is None:
                return as_json({"error": "no trace collector attached"},
                               404)
            run_id = path[len("/traces/"):].strip("/")
            rid = None if run_id in ("all", "*") else run_id
            self.collector.poll()
            try:
                if self.collector.span_count(rid) \
                        > self.trace_stream_events:
                    # large run: stream the serialized document chunked
                    # instead of buffering it whole
                    return (200, "application/json",
                            self.collector.chrome_stream(rid))
                doc = self.collector.chrome(rid)
            except KeyError as e:
                return as_json({"error": str(e),
                                "runs": self.collector.run_ids()}, 404)
            return as_json(doc)
        if path in ("", "/"):
            return as_json({"endpoints": [
                "/metrics", "/healthz", "/plans",
                "/plans/<fingerprint>/verify", "/runs",
                "/runs/<run_id>/health", "/alerts", "/traces",
                "/traces/<run_id>"]})
        return as_json({"error": f"no route {path!r}"}, 404)

    # ------------------------------------------------------------ handler
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):      # keep stdout clean
                pass

            def do_GET(self):
                try:
                    status, ctype, body = server._route(
                        urlparse(self.path).path)
                except Exception as e:         # a broken route must not
                    status, ctype = 500, "text/plain; charset=utf-8"
                    body = f"internal error: {e}\n"   # kill the daemon
                if isinstance(body, str):
                    data = body.encode("utf-8")
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                # iterator body: HTTP/1.1 chunked transfer — memory per
                # in-flight response is one fragment, not the document
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for part in body:
                        if not part:
                            continue
                        data = part.encode("utf-8")
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data
                            + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass                      # client went away mid-body

        return Handler
