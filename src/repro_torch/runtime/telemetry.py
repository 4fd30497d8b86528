"""Step telemetry, the part of ``repro.runtime.telemetry`` that the train
launcher uses: ``StepRecord``, an append-only ``MeasurementStore`` in the same
JSONL format (``repro``'s store reads the port's logs), and ``StepTimer``.

The rest of the runtime-feedback subsystem (reading, calibration, drift)
is a later slice (ROADMAP, queue 1, item 7).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

try:
    import fcntl
except ImportError:                       # non-posix: appends are not locked
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
    collectives: list = field(default_factory=list)
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


class MeasurementStore:
    """Append-only JSONL measurement log. ``path=None`` keeps records in
    memory; a directory gets a ``measurements.jsonl`` inside; a ``.jsonl``
    path is the log itself. Each append is one line written under an
    ``fcntl`` exclusive lock, so several processes can share a log."""

    def __init__(self, path: str | None = None):
        if path and not path.endswith(".jsonl"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, TELEMETRY_FILE)
        elif path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._mem: list = []

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
