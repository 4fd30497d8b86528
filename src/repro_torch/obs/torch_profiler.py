"""torch.profiler hook: per-collective attribution for instrumented steps,
the port's counterpart of ``repro.obs.xla_profiler``.

``profile_step`` runs a step callable under ``torch.profiler.profile`` with
the CPU and (where a card is present) CUDA activities, synchronizes the
card, exports the Chrome trace with ``export_chrome_trace`` into ``log_dir``
and parses it into the per-collective sample shape
``runtime.telemetry.StepRecord.collectives`` carries ({kind, nbytes, n_dev,
nominal_bw, link, time, pair?}), the input of
``runtime.calibration.fit_profile``'s per-link-pair tier.

Collectives are recognised by name (``classify_op``, the reference's
patterns): NCCL kernels such as ``ncclDevKernel_AllReduce_Sum_f32_RING_LL``
match them. Under one controller on one card the stage syncs are sums over
shards on that card and no NCCL kernel runs, so a trace with no collective
in it is a valid outcome (``n_collectives == 0``), as is ``"no_trace"``.

Unlike the reference, a profiler that fails raises: the step is never run
a second time unprofiled, since for a train step that would be a second
optimizer update.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time

import torch

# op-name fragments -> StepRecord collective kinds
_COLLECTIVE_PATTERNS = (
    (re.compile(r"all[-_]?reduce", re.I), "allreduce"),
    (re.compile(r"reduce[-_]?scatter", re.I), "allreduce"),
    (re.compile(r"all[-_]?gather", re.I), "allreduce"),
    (re.compile(r"all[-_]?to[-_]?all", re.I), "xfer"),
    (re.compile(r"collective[-_]?permute", re.I), "xfer"),
    (re.compile(r"\b(send|recv)\b|copy[-_]?start|copy[-_]?done", re.I),
     "xfer"),
)
# arg keys the profiler may use for moved bytes, in preference order
_BYTES_KEYS = ("nbytes", "bytes", "bytes_accessed", "bytes accessed",
               "size", "shape_size")


def profiler_available() -> bool:
    try:
        import torch.profiler  # noqa: F401
        return True
    except ImportError:
        return False


def classify_op(name: str) -> str | None:
    """Collective kind of an op or kernel name, or None for non-collectives."""
    for pat, kind in _COLLECTIVE_PATTERNS:
        if pat.search(name):
            return kind
    return None


def _event_bytes(args: dict) -> float:
    for k in _BYTES_KEYS:
        v = args.get(k)
        if v is None:
            continue
        try:
            return float(v)
        except (TypeError, ValueError):
            continue
    return 0.0


def find_trace_files(log_dir: str) -> list:
    """Chrome trace JSONs under a profiler log dir (newest first): what
    ``export_chrome_trace`` writes (``*.trace.json``, gzipped or not)."""
    pats = ("**/*.trace.json.gz", "**/*.trace.json",
            "**/perfetto_trace.json.gz", "**/perfetto_trace.json")
    out: list = []
    for pat in pats:
        out.extend(glob.glob(os.path.join(log_dir, pat), recursive=True))
    return sorted(set(out), key=lambda p: os.path.getmtime(p),
                  reverse=True)


def parse_trace_collectives(path: str, *, nominal_bw: float = 0.0,
                            n_dev: int = 2, link: str = "intra",
                            pair: str | None = None) -> list:
    """Collective samples from one trace-event JSON(.gz) file.

    Complete (``ph == "X"``) events whose name matches a collective
    pattern become samples; ``dur`` is microseconds per the trace-event
    contract. ``nominal_bw``/``n_dev``/``link``/``pair`` supply the
    cluster-side context the device trace cannot know.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    samples = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        kind = classify_op(name)
        if kind is None:
            continue
        dur_us = float(e.get("dur", 0.0))
        if dur_us <= 0:
            continue
        sample = {"kind": kind, "nbytes": _event_bytes(e.get("args", {})),
                  "n_dev": n_dev, "nominal_bw": nominal_bw, "link": link,
                  "time": dur_us / 1e6, "op": name}
        if pair:
            sample["pair"] = pair
        samples.append(sample)
    return samples


def profile_step(fn, *args, log_dir: str, nominal_bw: float = 0.0,
                 n_dev: int = 2, link: str = "intra",
                 pair: str | None = None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` and parse
    per-collective samples out of its trace.

    Returns ``(out, samples, meta)``; ``meta["profiler"]`` is ``"ok"``
    (with ``trace_file`` and ``n_collectives``), ``"no_trace"`` when no
    trace file parses, or ``"unavailable"``. The card(s) holding the
    arguments or the output are synchronized before the profile closes, so
    the trace holds the step's kernels. A failing profiler raises.
    """
    if not profiler_available():
        return fn(*args, **kwargs), [], {"profiler": "unavailable"}
    from torch.profiler import ProfilerActivity, profile

    # lazily: runtime imports the planner, whose MCTS imports obs
    from repro_torch.runtime.telemetry import _cuda_devices
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        for dev in _cuda_devices((args, kwargs, out), set()):
            torch.cuda.synchronize(dev)
    path = os.path.join(log_dir, f"step_{os.getpid()}_{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    samples: list = []
    parsed_from = None
    for path in find_trace_files(log_dir):
        try:
            samples = parse_trace_collectives(
                path, nominal_bw=nominal_bw, n_dev=n_dev, link=link,
                pair=pair)
            parsed_from = path
            break
        except (OSError, ValueError, KeyError):
            continue
    if parsed_from is None:
        return out, [], {"profiler": "no_trace", "log_dir": log_dir}
    return out, samples, {"profiler": "ok", "trace_file": parsed_from,
                          "n_collectives": len(samples)}


def attach_collectives(record, samples: list, meta: dict | None = None):
    """Merge profiler-derived samples into a ``StepRecord`` in place (and
    stamp how they were obtained); returns the record. The key stays the
    reference's ``xla_profiler`` so that both packages' records read alike."""
    record.collectives = list(record.collectives) + list(samples)
    record.meta = dict(record.meta, xla_profiler=(meta or {}))
    return record
