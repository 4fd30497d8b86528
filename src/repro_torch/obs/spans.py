"""Structured spans: a low-overhead, thread-safe tracing API.

A ``Span`` is one timed region of the planning path (``PlannerService
.plan`` -> store lookup -> policy resolve -> MCTS playouts with
expand / featurize / gnn_forward / simulate sub-spans). Spans nest per
thread (each thread keeps its own open-span stack) and finished spans
are appended under a lock, so concurrent planners share one tracer.

The global tracer is DISABLED by default and ``span()`` on a disabled
tracer returns a shared no-op context manager — no allocation, no
clock read — so instrumented hot paths (one span per MCTS playout)
stay effectively free until someone opts in:

    from repro_torch.obs import get_tracer
    tr = get_tracer()
    tr.enable()
    with tr.span("plan", cat="planner", model="bert_small"):
        ...
    events = tr.to_chrome()           # chrome://tracing JSON events

``to_chrome`` renders spans in the same Chrome trace-event format as
``obs.trace`` renders schedule timelines, so planner spans and pipeline
timelines open in one viewer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import threading
import time


@dataclass
class Span:
    """One finished timed region. Times are seconds relative to the
    tracer epoch; ``tid`` is a dense per-thread track id."""
    name: str
    cat: str
    start: float
    end: float
    tid: int
    depth: int
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.end - self.start


class _NullSpan:
    """Reusable, re-entrant no-op context manager (disabled tracer)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = self.tracer._push()
        return self

    def __exit__(self, *exc):
        self.tracer._pop(self.name, self.cat, self._t0, self.args)
        return False


class _ThreadState(threading.local):
    def __init__(self):
        self.depth = 0
        self.tid = None


class Tracer:
    """Thread-safe span recorder. Disabled tracers cost one attribute
    read per ``span()`` call."""

    def __init__(self, *, enabled: bool = False, max_spans: int = 200_000):
        self.enabled = enabled
        self.max_spans = max_spans
        self._epoch = time.perf_counter()
        self._spans: list = []
        self._lock = threading.Lock()
        self._local = _ThreadState()
        self._tids: dict = {}              # thread ident -> dense tid
        self.dropped = 0

    @property
    def epoch(self) -> float:
        """``time.perf_counter()`` reading that span-relative times are
        measured from (lets exporters recover monotonic timestamps)."""
        return self._epoch

    # ------------------------------------------------------------- control
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def clear(self):
        with self._lock:
            self._spans = []
            self.dropped = 0
            self._epoch = time.perf_counter()

    # --------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "planner", **args):
        """Context manager timing one region. No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, cat, args)

    def _tid(self) -> int:
        st = self._local
        if st.tid is None:
            ident = threading.get_ident()
            with self._lock:
                st.tid = self._tids.setdefault(ident, len(self._tids))
        return st.tid

    def _push(self) -> float:
        self._local.depth += 1
        return time.perf_counter()

    def _pop(self, name, cat, t0, args):
        t1 = time.perf_counter()
        st = self._local
        depth = st.depth - 1
        st.depth = depth
        sp = Span(name=name, cat=cat, start=t0 - self._epoch,
                  end=t1 - self._epoch, tid=self._tid(), depth=depth,
                  args=args)
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(sp)
            else:
                self.dropped += 1

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def __len__(self):
        with self._lock:
            return len(self._spans)

    # ------------------------------------------------------------- summary
    def summary(self) -> dict:
        """Per-(cat, name) totals: count and summed seconds."""
        out: dict = {}
        for sp in self.spans():
            key = f"{sp.cat}/{sp.name}"
            agg = out.setdefault(key, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += sp.dur
        return out

    def to_chrome(self, *, pid: int = 0, process_name: str = "planner",
                  time_scale: float = 1e6) -> list:
        """Chrome trace-event JSON events (``ph: "X"`` complete events,
        microsecond timestamps) for all finished spans."""
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        tids = sorted({sp.tid for sp in self.spans()})
        for t in tids:
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": t,
                "args": {"name": f"thread {t}"}})
        for sp in self.spans():
            events.append({
                "name": sp.name, "cat": sp.cat, "ph": "X",
                "ts": sp.start * time_scale,
                "dur": max(sp.dur, 0.0) * time_scale,
                "pid": pid, "tid": sp.tid,
                "args": dict(sp.args, depth=sp.depth),
            })
        return events


_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until ``.enable()``)."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests); returns the old one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, tracer
    return old


def span(name: str, cat: str = "planner", **args):
    """``get_tracer().span(...)`` shorthand for instrumented call sites."""
    return _GLOBAL.span(name, cat, **args)


def export_tracer_metrics(registry, tracer: Tracer | None = None):
    """Mirror a tracer's drop/buffer state into a metrics registry.

    ``tracer_dropped_spans_total`` counts spans silently discarded at
    the ``max_spans`` cap — the one failure mode of the span layer that
    is otherwise invisible. The counter is advanced by the delta since
    the last export (a swapped/cleared tracer resets its ``dropped``;
    the registry counter stays monotonic, as counters must). Also sets
    ``tracer_buffered_spans`` and ``tracer_enabled`` gauges. Returns the
    counter.
    """
    tr = tracer if tracer is not None else _GLOBAL
    c = registry.counter(
        "tracer_dropped_spans_total",
        "spans dropped at the tracer max_spans cap")
    delta = tr.dropped - c.value()
    if delta > 0:
        c.inc(delta)
    registry.gauge(
        "tracer_buffered_spans",
        "finished spans buffered in the tracer").set(float(len(tr)))
    registry.gauge(
        "tracer_enabled",
        "1 when the span tracer records").set(1.0 if tr.enabled else 0.0)
    return c
