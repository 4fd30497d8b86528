"""Cross-process span/event spool + trace collector.

The spans, metrics and traces of ``obs`` live inside one Python process; this module
is the boundary-crossing half. Every producer — the planner's span
tracer, the pipeline engine's per-event stream, ``launch.train``, the
replay executor — appends records to its own JSONL **shard** in a shared
spool directory (``fcntl``-locked appends, the ``MeasurementStore``
pattern), and a ``TraceCollector`` incrementally merges the shards into
one Chrome trace.

Clock alignment: processes disagree on ``time.perf_counter()`` epochs
(monotonic clocks start at boot/process-dependent zeros), so each shard
opens with an **anchor** record pairing one wall-clock reading with one
monotonic reading from the same instant. Every span record carries
monotonic timestamps; the collector maps them onto the shared wall
clock via ``wall = anchor.wall + (t - anchor.mono)`` and renders all
shards relative to the earliest aligned event — one coherent timeline
regardless of which host/process produced which events.

    w = SpoolWriter(spool_dir, run_id="run7", name="train")
    w.emit_span("F0.0", t0, t1, tid=0, cat="pipeline")

    c = TraceCollector(spool_dir)
    c.poll()                        # incremental: only new bytes parsed
    doc = c.chrome("run7")          # validated Chrome trace document

Record schema (one JSON object per line):

  * ``{"type": "anchor", "run_id", "process", "pid", "wall", "mono"}``
    — first line of every shard;
  * ``{"type": "span", "name", "cat", "tid", "t0", "t1", "args"}``
    — one timed region, ``t0``/``t1`` on the producer's monotonic clock;
  * ``{"type": "track", "tid", "name"}`` — names a tid's trace track.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

from repro_torch.obs.trace import chrome_trace, validate_chrome_trace

try:
    import fcntl
except ImportError:                       # non-posix: locking degrades
    fcntl = None

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _safe(s: str) -> str:
    return _SAFE.sub("_", str(s)) or "x"


def shard_path(spool_dir: str, run_id: str, name: str, pid: int) -> str:
    return os.path.join(spool_dir,
                        f"{_safe(run_id)}--{_safe(name)}-{int(pid)}.jsonl")


class SpoolWriter:
    """Appends span/event records to this producer's spool shard.

    One writer owns one shard file ``<run_id>--<name>-<pid>.jsonl``; the
    first line written is the wall<->monotonic anchor. Appends take an
    ``fcntl`` exclusive lock so a shard shared across threads (or an
    accidentally reused (run_id, name, pid) triple) stays line-atomic.

    ``anchor=(wall, mono)`` overrides the clock pair — used by tests to
    inject deterministic cross-process clock skew, and by replay-style
    producers whose "timestamps" are simulated seconds.
    """

    def __init__(self, spool_dir: str, *, run_id: str = "run",
                 name: str = "proc", pid: int | None = None,
                 anchor: tuple | None = None, meta: dict | None = None):
        os.makedirs(spool_dir, exist_ok=True)
        self.run_id = str(run_id)
        self.name = str(name)
        self.pid = int(pid if pid is not None else os.getpid())
        self.path = shard_path(spool_dir, self.run_id, self.name, self.pid)
        if anchor is not None:
            wall, mono = float(anchor[0]), float(anchor[1])
        else:
            wall, mono = time.time(), time.perf_counter()
        self.anchor = (wall, mono)
        self._lock = threading.Lock()
        self._tracer_pos: dict = {}       # id(tracer) -> spans emitted
        self._write_lines([json.dumps({
            "type": "anchor", "run_id": self.run_id,
            "process": self.name, "pid": self.pid,
            "wall": wall, "mono": mono, "meta": dict(meta or {}),
        }, sort_keys=True)], anchor_guard=True)

    # ------------------------------------------------------------ appends
    def _write_lines(self, lines: list, *, anchor_guard: bool = False):
        if not lines:
            return
        payload = "".join(line + "\n" for line in lines)
        with self._lock, open(self.path, "a") as f:
            if fcntl is not None:
                fcntl.flock(f, fcntl.LOCK_EX)
            try:
                if anchor_guard and f.tell() > 0:
                    return                # shard already anchored
                f.write(payload)
                f.flush()
            finally:
                if fcntl is not None:
                    fcntl.flock(f, fcntl.LOCK_UN)

    def emit(self, record: dict):
        """Append one raw record (already schema-shaped)."""
        self.emit_many([record])

    def emit_many(self, records: list):
        """Append a batch of records under ONE lock/write — the cheap
        path for per-step event streams."""
        self._write_lines([json.dumps(r, sort_keys=True) for r in records])

    def emit_span(self, name: str, t0: float, t1: float, *, tid: int = 0,
                  cat: str = "span", args: dict | None = None):
        """One timed region; ``t0``/``t1`` are producer-monotonic
        (``time.perf_counter()``) seconds."""
        self.emit({"type": "span", "name": str(name), "cat": str(cat),
                   "tid": int(tid), "t0": float(t0), "t1": float(t1),
                   "args": dict(args or {})})

    def emit_track(self, tid: int, name: str):
        """Name ``tid``'s track in the merged trace."""
        self.emit({"type": "track", "tid": int(tid), "name": str(name)})

    def emit_tracer(self, tracer, *, cat: str | None = None) -> int:
        """Spool a ``repro_torch.obs.spans.Tracer``'s finished spans.

        Incremental per tracer: repeated calls only append spans recorded
        since the previous call, so a serve loop can drain the planner's
        tracer on every scrape. Returns the number of spans spooled.
        """
        spans = tracer.spans()
        pos = self._tracer_pos.get(id(tracer), 0)
        if pos > len(spans):              # tracer.clear() underneath us
            pos = 0
        new = spans[pos:]
        if not new:
            return 0
        epoch = tracer.epoch
        self.emit_many([{
            "type": "span", "name": sp.name,
            "cat": cat if cat is not None else sp.cat, "tid": sp.tid,
            "t0": epoch + sp.start, "t1": epoch + sp.end,
            "args": dict(sp.args, depth=sp.depth),
        } for sp in new])
        self._tracer_pos[id(tracer)] = len(spans)
        return len(new)


class _Shard:
    __slots__ = ("path", "offset", "anchor", "run_id", "process", "pid",
                 "tracks", "spans", "bad")

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.anchor = None                # (wall, mono)
        self.run_id = ""
        self.process = os.path.basename(path)
        self.pid = 0
        self.tracks: dict = {}            # tid -> name
        self.spans: list = []             # raw span records
        self.bad = 0

    def wall(self, t_mono: float) -> float:
        """Producer-monotonic seconds -> shared wall-clock seconds via
        the shard's anchor (identity for an unanchored shard)."""
        if self.anchor is None:
            return t_mono
        w, m = self.anchor
        return w + (t_mono - m)


class TraceCollector:
    """Incrementally merge spool shards into one Chrome trace.

    ``poll()`` reads only bytes appended since the previous poll (torn
    in-flight lines stay buffered via the complete-lines-only cut, the
    ``MeasurementStore.read_new`` discipline; a truncated shard resets
    and replays). ``chrome(run_id)`` renders the merged, clock-aligned,
    schema-validated trace document with per-process ``pid`` metadata.
    """

    def __init__(self, spool_dir: str):
        self.spool_dir = spool_dir
        self._shards: dict = {}           # path -> _Shard
        self._lock = threading.Lock()

    # ------------------------------------------------------------ ingest
    def poll(self) -> int:
        """Consume newly appended spool records; returns how many."""
        with self._lock:
            n = 0
            if not os.path.isdir(self.spool_dir):
                return 0
            for fn in sorted(os.listdir(self.spool_dir)):
                if not fn.endswith(".jsonl"):
                    continue
                n += self._poll_shard(os.path.join(self.spool_dir, fn))
            return n

    def _poll_shard(self, path: str) -> int:
        sh = self._shards.get(path)
        if sh is None:
            sh = self._shards[path] = _Shard(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size < sh.offset:              # truncated/rewritten: replay
            self._shards[path] = sh = _Shard(path)
        if size == sh.offset:
            return 0
        with open(path, "rb") as f:
            f.seek(sh.offset)
            data = f.read()
        end = data.rfind(b"\n")
        if end < 0:
            return 0                      # only a torn line so far
        n = 0
        for line in data[:end].split(b"\n"):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                kind = rec["type"]
            except (ValueError, KeyError, TypeError):
                sh.bad += 1
                continue
            if kind == "anchor":
                sh.anchor = (float(rec["wall"]), float(rec["mono"]))
                sh.run_id = str(rec.get("run_id", ""))
                sh.process = str(rec.get("process", sh.process))
                sh.pid = int(rec.get("pid", 0))
            elif kind == "track":
                sh.tracks[int(rec["tid"])] = str(rec["name"])
            elif kind == "span":
                sh.spans.append(rec)
            else:
                sh.bad += 1
                continue
            n += 1
        sh.offset += end + 1
        return n

    # --------------------------------------------------------- retention
    def gc(self, max_age_s: float | None = None,
           max_bytes: int | None = None) -> dict:
        """Delete fully-drained spool shard files past a retention
        budget; the long-lived-spool half of plan-store eviction.

        A shard file is deletable only when the collector has consumed
        every byte of it (``offset == size`` — a torn trailing line
        means undrained, the file survives). ``max_age_s`` drops drained
        shards whose file mtime is older; ``max_bytes`` then drops
        oldest-mtime-first until the spool directory's total drained
        footprint fits. In-memory spans are kept, so already-collected
        traces keep rendering after their shard files are gone.

        Returns ``{"deleted", "kept", "bytes_freed"}``.
        """
        self.poll()       # drain appends first so fresh bytes never die
        deleted, freed = 0, 0
        with self._lock:
            stats: list[tuple[float, int, str]] = []   # (mtime, size, p)
            kept = 0
            for path, sh in self._shards.items():
                try:
                    st = os.stat(path)
                except OSError:
                    continue              # already gone underneath us
                if sh.offset < st.st_size:
                    kept += 1             # undrained: never delete
                    continue
                stats.append((st.st_mtime, st.st_size, path))
            doomed: set = set()
            if max_age_s is not None:
                cutoff = time.time() - float(max_age_s)
                doomed |= {p for mt, _, p in stats if mt < cutoff}
            if max_bytes is not None:
                total = sum(sz for _, sz, p in stats if p not in doomed)
                for _mt, sz, p in sorted(stats):
                    if total <= int(max_bytes):
                        break
                    if p in doomed:
                        continue
                    doomed.add(p)
                    total -= sz
            for _mt, sz, p in stats:
                if p not in doomed:
                    kept += 1
                    continue
                try:
                    os.remove(p)
                except OSError:
                    kept += 1
                    continue
                deleted += 1
                freed += sz
                # the _Shard entry (and its spans) stays: collected
                # traces keep rendering, and a recreated file replays
                # through the size < offset truncation path
        return {"deleted": deleted, "kept": kept, "bytes_freed": freed}

    # ----------------------------------------------------------- queries
    def shards(self, run_id: str | None = None) -> list:
        with self._lock:
            return [sh for sh in self._shards.values()
                    if run_id is None or sh.run_id == run_id]

    def run_ids(self) -> list:
        with self._lock:
            return sorted({sh.run_id for sh in self._shards.values()
                           if sh.spans or sh.anchor is not None})

    def span_count(self, run_id: str | None = None) -> int:
        """Merged span records for one run (all when None) — the cheap
        size probe the server uses to pick buffered vs streamed trace
        responses."""
        with self._lock:
            return sum(len(sh.spans) for sh in self._shards.values()
                       if run_id is None or sh.run_id == run_id)

    def counts(self) -> dict:
        with self._lock:
            shards = list(self._shards.values())
        return {"shards": len(shards),
                "spans": sum(len(sh.spans) for sh in shards),
                "bad_lines": sum(sh.bad for sh in shards),
                "runs": len({sh.run_id for sh in shards})}

    # ------------------------------------------------------------ render
    def trace_events(self, run_id: str | None = None) -> list:
        """Merged Chrome trace events for one run (or all shards).

        Every shard becomes one trace ``pid`` (dense, deterministic
        order) with ``process_name``/``thread_name`` metadata; span
        timestamps are aligned through each shard's wall<->monotonic
        anchor and rendered relative to the earliest event across the
        selection, so cross-process ordering is real wall-clock order.
        """
        shards = [sh for sh in self.shards(run_id) if sh.spans]
        shards.sort(key=lambda sh: (sh.run_id, sh.process, sh.pid))
        if not shards:
            return []
        base = min(sh.wall(float(sp["t0"]))
                   for sh in shards for sp in sh.spans)
        events, spans = [], []
        for pid, sh in enumerate(shards):
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"{sh.process} (pid {sh.pid})"}})
            tids = sorted({int(sp.get("tid", 0)) for sp in sh.spans}
                          | set(sh.tracks))
            for tid in tids:
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": sh.tracks.get(tid, f"track {tid}")}})
            for sp in sh.spans:
                t0 = sh.wall(float(sp["t0"]))
                t1 = sh.wall(float(sp["t1"]))
                spans.append({
                    "name": str(sp.get("name", "?")),
                    "cat": str(sp.get("cat", "span")), "ph": "X",
                    "ts": (t0 - base) * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                    "pid": pid, "tid": int(sp.get("tid", 0)),
                    "args": dict(sp.get("args") or {},
                                 process=sh.process, run_id=sh.run_id),
                })
        spans.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))
        return events + spans

    def chrome(self, run_id: str | None = None, **metadata) -> dict:
        """Validated Chrome trace document for ``run_id`` (all runs when
        None); raises ``KeyError`` for a run with no spooled events."""
        events = self.trace_events(run_id)
        if not events:
            raise KeyError(f"no spooled events for run {run_id!r} in "
                           f"{self.spool_dir}")
        doc = chrome_trace(events, spool_dir=self.spool_dir,
                           run_id=run_id, **metadata)
        return validate_chrome_trace(doc)

    def chrome_stream(self, run_id: str | None = None, *,
                      chunk_events: int = 512, **metadata):
        """Incrementally-serialized Chrome trace: a generator of JSON
        text fragments that concatenate to the same document ``chrome``
        returns. ``json.dumps`` of a whole merged trace costs several
        times the span list's own footprint in one allocation; this
        serializes ``chunk_events`` events at a time so the server's
        extra memory per in-flight response is bounded by the chunk,
        not the run. Raises ``KeyError`` (before yielding anything) for
        a run with no spooled events."""
        events = self.trace_events(run_id)
        if not events:
            raise KeyError(f"no spooled events for run {run_id!r} in "
                           f"{self.spool_dir}")

        def gen():
            head = {"spool_dir": self.spool_dir, "run_id": run_id,
                    **metadata}
            yield ('{"displayTimeUnit": "ms", "otherData": '
                   + json.dumps(head, default=str)
                   + ', "traceEvents": [')
            for i in range(0, len(events), max(chunk_events, 1)):
                block = events[i:i + max(chunk_events, 1)]
                prefix = "" if i == 0 else ","
                yield prefix + ",".join(
                    json.dumps(e, default=str) for e in block)
            yield "]}"
        return gen()
