"""Step telemetry: instrumented timers + an append-only measurement log.

A ``StepRecord`` is one observed training/serving step: wall time plus —
when the executor can attribute them — per-device busy seconds, per-link
busy seconds, per-op compute samples, and per-collective transfer
samples. Records are keyed by the service layer's graph/topology
fingerprints so the feedback loop can join observations back to cached
plans.

``MeasurementStore`` persists records as append-only JSONL (one line per
step, ``fcntl``-locked appends so concurrent launchers can share a log);
``StepTimer`` wraps a step callable (``launch.steps`` /
``launch.train`` / ``launch.serve``) and records each invocation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import json
import os
import time

import numpy as np
import torch

try:
    import fcntl
except ImportError:                       # non-posix: locking degrades
    fcntl = None

TELEMETRY_FILE = "measurements.jsonl"


@dataclass
class StepRecord:
    """One observed execution step."""
    graph_fp: str = ""
    topo_fp: str = ""
    step: int = 0
    wall_time: float = 0.0                # end-to-end step seconds
    device_busy: dict = field(default_factory=dict)   # str(dev) -> busy s
    link_busy: dict = field(default_factory=dict)     # "gi-gj" -> busy s
    compute: list = field(default_factory=list)
    # compute sample: {"gpu_type", "flops", "time"}
    collectives: list = field(default_factory=list)
    # collective sample: {"kind": allreduce|ps|xfer, "nbytes", "n_dev",
    #                     "nominal_bw" (spec-sheet B/s), "link":
    #                     intra|cross|p2p, "time"}
    meta: dict = field(default_factory=dict)
    ts: float = 0.0                        # record timestamp (epoch s)

    def to_dict(self) -> dict:
        return {
            "graph_fp": self.graph_fp, "topo_fp": self.topo_fp,
            "step": self.step, "wall_time": self.wall_time,
            "device_busy": self.device_busy, "link_busy": self.link_busy,
            "compute": self.compute, "collectives": self.collectives,
            "meta": self.meta, "ts": self.ts,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StepRecord":
        return cls(
            graph_fp=d.get("graph_fp", ""), topo_fp=d.get("topo_fp", ""),
            step=int(d.get("step", 0)),
            wall_time=float(d.get("wall_time", 0.0)),
            device_busy=d.get("device_busy", {}),
            link_busy=d.get("link_busy", {}),
            compute=d.get("compute", []),
            collectives=d.get("collectives", []),
            meta=d.get("meta", {}), ts=float(d.get("ts", 0.0)))


class MeasurementStore:
    """Append-only JSONL measurement log.

    ``path=None`` keeps records in memory only (tests, single-process
    benchmarks). With a path — a directory (a ``measurements.jsonl`` is
    created inside) or a ``.jsonl`` file — appends are atomic
    single-line writes under an ``fcntl`` exclusive lock, so multiple
    launcher processes can share one log.
    """

    def __init__(self, path: str | None = None):
        if path and not path.endswith(".jsonl"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, TELEMETRY_FILE)
        elif path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._mem: list = []
        # incremental-reader cursor (``read_new``): byte offset of the
        # first unconsumed line (memory mode: index into ``_mem``)
        self._offset = 0

    def append(self, rec: StepRecord) -> StepRecord:
        if not rec.ts:
            rec.ts = time.time()
        if self.path is None:
            self._mem.append(rec)
            return rec
        line = json.dumps(rec.to_dict(), sort_keys=True)
        with open(self.path, "a") as f:
            if fcntl is not None:
                fcntl.flock(f, fcntl.LOCK_EX)
            try:
                f.write(line + "\n")
                f.flush()
            finally:
                if fcntl is not None:
                    fcntl.flock(f, fcntl.LOCK_UN)
        return rec

    @staticmethod
    def _parse(line, graph_fp, topo_fp):
        """StepRecord of a JSONL line passing the substring pre-filter and
        the exact fingerprint match, else None."""
        if isinstance(line, bytes):
            try:
                line = line.decode()
            except UnicodeDecodeError:
                return None
        line = line.strip()
        if not line:
            return None
        if graph_fp is not None and graph_fp not in line:
            return None
        if topo_fp is not None and topo_fp not in line:
            return None
        try:
            rec = StepRecord.from_dict(json.loads(line))
        except (ValueError, KeyError):
            return None                   # torn/garbled line: skip
        if graph_fp is not None and rec.graph_fp != graph_fp:
            return None
        if topo_fp is not None and rec.topo_fp != topo_fp:
            return None
        return rec

    def records(self, *, graph_fp: str | None = None,
                topo_fp: str | None = None,
                limit: int | None = None) -> list:
        """Matching records, oldest first; ``limit`` keeps the newest N.

        Lines are pre-filtered by raw substring before JSON parsing, so
        fingerprint-keyed queries over a large log only pay full parse
        cost for matching steps. With ``limit`` the log is read BACKWARDS
        in blocks (``tail``) — a long-running observe loop polling the
        newest N records stays O(tail), not O(log).
        """
        if self.path is not None and limit is not None:
            return self.tail(limit, graph_fp=graph_fp, topo_fp=topo_fp)
        if self.path is None:
            out = [r for r in self._mem
                   if (graph_fp is None or r.graph_fp == graph_fp)
                   and (topo_fp is None or r.topo_fp == topo_fp)]
        else:
            out = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    for line in f:
                        rec = self._parse(line, graph_fp, topo_fp)
                        if rec is not None:
                            out.append(rec)
        if limit is not None:
            out = out[-limit:]
        return out

    def tail(self, limit: int, *, graph_fp: str | None = None,
             topo_fp: str | None = None,
             block_size: int = 1 << 16) -> list:
        """Newest ``limit`` matching records, oldest first, reading the
        log backwards in ``block_size`` chunks — cost is proportional to
        the tail, not the full log."""
        if limit <= 0:
            return []
        if self.path is None:
            out = [r for r in self._mem
                   if (graph_fp is None or r.graph_fp == graph_fp)
                   and (topo_fp is None or r.topo_fp == topo_fp)]
            return out[-limit:]
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            pos = f.tell()
            buf = b""
            while pos > 0 and len(out) < limit:
                size = min(block_size, pos)
                pos -= size
                f.seek(pos)
                buf = f.read(size) + buf
                lines = buf.split(b"\n")
                # lines[0] may be a partial line continuing into the
                # previous (unread) block — keep it buffered
                buf = lines[0] if pos > 0 else b""
                start = 1 if pos > 0 else 0
                for line in reversed(lines[start:]):
                    rec = self._parse(line, graph_fp, topo_fp)
                    if rec is not None:
                        out.append(rec)
                        if len(out) >= limit:
                            break
        out.reverse()
        return out

    def read_new(self, *, graph_fp: str | None = None,
                 topo_fp: str | None = None) -> list:
        """Records appended since the previous ``read_new`` call (oldest
        first) — the O(new records) incremental reader for long-running
        observe/feedback polls. Only COMPLETE lines are consumed: a
        torn in-flight append stays buffered for the next poll. A
        truncated/rotated log resets the cursor and replays from the
        start."""
        if self.path is None:
            out = [r for r in self._mem[self._offset:]
                   if (graph_fp is None or r.graph_fp == graph_fp)
                   and (topo_fp is None or r.topo_fp == topo_fp)]
            self._offset = len(self._mem)
            return out
        if not os.path.exists(self.path):
            self._offset = 0
            return []
        size = os.path.getsize(self.path)
        if size < self._offset:          # rotated/truncated underneath us
            self._offset = 0
        out = []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        end = data.rfind(b"\n")
        if end < 0:
            return []
        for line in data[:end].split(b"\n"):
            rec = self._parse(line, graph_fp, topo_fp)
            if rec is not None:
                out.append(rec)
        self._offset += end + 1
        return out

    def __len__(self):
        """Total record count — a line count, no JSON parse."""
        if self.path is None:
            return len(self._mem)
        if not os.path.exists(self.path):
            return 0
        with open(self.path) as f:
            return sum(1 for line in f if line.strip())


def _cuda_devices(obj, out: set) -> set:
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Wrap a step callable so that every call is timed end to end and
    appended to a MeasurementStore.

        timer = StepTimer(store, meta={...})
        step_fn = timer.wrap(step_fn)      # drop-in replacement

    CUDA runs asynchronously: the wrapper synchronizes every CUDA device that
    holds one of the step's arguments (the parameters' device) before it
    reads the clock, so the time covers the device's work, not the enqueue.
    """

    def __init__(self, store: MeasurementStore | None = None,
                 graph_fp: str = "", topo_fp: str = "", meta: dict | None = None):
        self.store = store if store is not None else MeasurementStore()
        self.graph_fp = graph_fp
        self.topo_fp = topo_fp
        self.meta = dict(meta or {})
        self.wall_times: list = []

    def record(self, wall_time: float, **kw) -> StepRecord:
        self.wall_times.append(wall_time)
        rec = StepRecord(graph_fp=self.graph_fp, topo_fp=self.topo_fp,
                         step=len(self.wall_times) - 1,
                         wall_time=wall_time, meta=dict(self.meta), **kw)
        return self.store.append(rec)

    def wrap(self, fn):
        def timed(*args, **kwargs):
            devices = _cuda_devices((args, kwargs), set())
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            for dev in devices:
                torch.cuda.synchronize(dev)
            self.record(time.perf_counter() - t0)
            return out
        return timed

    def summary(self) -> dict:
        w = np.asarray(self.wall_times, float)
        if w.size == 0:
            return {"steps": 0}
        return {"steps": int(w.size), "mean_s": float(w.mean()),
                "median_s": float(np.median(w)), "p90_s":
                float(np.percentile(w, 90)), "total_s": float(w.sum())}


def observed_sim_result(records: list, topo):
    """Aggregate observed StepRecords into a ``SimResult``-shaped object.

    The GNN's runtime-feedback features (makespan, per-device idle %,
    per-link idle %) are normally read off the simulator; this builds the
    same container from MEASURED telemetry so ``core.features.featurize
    (..., observed=...)`` feeds real signals to trained policies.
    Group-level features (per-group makespan, idle-before-transfer) stay
    empty unless a record carries them — real executions observe devices
    and links, not op groups.
    """
    from repro_torch.core.simulator import SimResult
    if not records:
        raise ValueError("observed_sim_result needs at least one record")
    makespan = float(np.median([r.wall_time for r in records]))
    dev_busy: dict = {}
    link_busy: dict = {}
    n = len(records)
    for r in records:
        for d, b in r.device_busy.items():
            dev_busy[int(d)] = dev_busy.get(int(d), 0.0) + float(b) / n
        for k, b in r.link_busy.items():
            gi, gj = (int(x) for x in str(k).split("-"))
            link_busy[(gi, gj)] = link_busy.get((gi, gj), 0.0) \
                + float(b) / n
    return SimResult(
        makespan=makespan, feasible=True, task_start=[], task_finish=[],
        device_busy=dev_busy, peak_mem={}, link_busy=link_busy)
