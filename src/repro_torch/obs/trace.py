"""Chrome/Perfetto trace export for pipeline timelines + the
predicted-vs-executed diff report.

Renders both sides of the §4.3 feedback loop into the Chrome trace-event
format (``chrome://tracing`` / https://ui.perfetto.dev):

  * the schedule simulator's *predicted* ``Timeline`` (``exec.schedule
    .simulate_schedule``) — one track per stage plus a transfer track,
    events named ``F0.1`` / ``B2c1.0`` / ``X0->1.3``, colored by kind;
  * the *executed* event stream — a replay ``StepRecord`` (``exec
    .replay.execute_pipeline`` puts per-event start/finish in
    ``meta["events"]``) or the real engine's ``StepStats`` events.

``diff_report`` joins the two streams per ``(stage, mb, kind, chunk)``
and attributes the step-time error to compute (F/B/W) vs transfer (X)
vs sync/other — the "where did my predicted step go" view the feedback
loop calibrates from.

All timestamps are emitted in microseconds (the trace-event contract);
``validate_chrome_trace`` is the schema check the tests and the
``python -m repro_torch.service.cli trace`` CLI both run on every exported document.
"""
from __future__ import annotations

import gzip
import json
import os

# chrome://tracing reserved color names per event kind
KIND_CNAME = {"F": "good", "B": "bad", "W": "yellow", "X": "grey"}
KIND_LABEL = {"F": "forward", "B": "backward", "W": "weight-grad",
              "X": "transfer"}
US = 1e6                      # seconds -> trace-event microseconds


def _meta_event(name: str, pid: int, tid: int, value: str) -> dict:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": value}}


def event_name(kind: str, stage: int, mb: int, chunk: int,
               src: int = -1) -> str:
    """Canonical event label: ``F0.1`` / ``B2c1.0`` / ``X0->1.3`` —
    shared by timeline export, executed traces, and spool producers."""
    c = f"c{chunk}" if chunk else ""
    if kind == "X":
        return f"X{src}->{stage}.{mb}"
    return f"{kind}{stage}{c}.{mb}"


_event_name = event_name


def timeline_trace_events(tl, *, pid: int = 0,
                          process_name: str = "predicted") -> list:
    """Trace events for a simulated ``Timeline``: tid ``s`` is stage
    ``s``'s compute track, tid ``n_stages + s`` its incoming-transfer
    track."""
    S = tl.n_stages
    events = [_meta_event("process_name", pid, 0, process_name)]
    for s in range(S):
        events.append(_meta_event("thread_name", pid, s, f"stage {s}"))
    xfer_tids = sorted({e.stage for e in tl.events if e.kind == "X"})
    for s in xfer_tids:
        events.append(_meta_event("thread_name", pid, S + s,
                                  f"stage {s} transfers in"))
    for e in tl.events:
        tid = e.stage if e.kind != "X" else S + e.stage
        args = {"kind": KIND_LABEL.get(e.kind, e.kind), "stage": e.stage,
                "mb": e.mb, "chunk": e.chunk}
        if e.kind == "X":
            args["src_stage"] = e.src
            args["nbytes"] = e.nbytes
        events.append({
            "name": _event_name(e.kind, e.stage, e.mb, e.chunk, e.src),
            "cat": f"pipeline,{KIND_LABEL.get(e.kind, e.kind)}",
            "ph": "X", "ts": e.start * US,
            "dur": max(e.dur, 0.0) * US,
            "pid": pid, "tid": tid,
            "cname": KIND_CNAME.get(e.kind, "generic_work"),
            "args": args,
        })
    return events


def executed_events_of(source) -> list:
    """Normalize an executed event stream to
    ``[{kind, stage, mb, chunk, start, finish}, ...]``.

    Accepts a replay/engine ``StepRecord`` (events under
    ``meta["events"]``), an ``exec.engine.StepStats``, or an already
    normalized list of event dicts.
    """
    meta = getattr(source, "meta", None)
    if isinstance(meta, dict) and "events" in meta:
        source = meta["events"]
    evs = getattr(source, "events", source)
    out = []
    for e in evs:
        if isinstance(e, dict):
            out.append({"kind": e["kind"], "stage": int(e["stage"]),
                        "mb": int(e["mb"]),
                        "chunk": int(e.get("chunk", 0)),
                        "src": int(e.get("src", -1)),
                        "start": float(e["start"]),
                        "finish": float(e["finish"])})
        else:
            # engine StepStats tuple: (kind, stage, mb, dur, chunk, start)
            kind, s, m, dur, chunk = e[:5]
            start = float(e[5]) if len(e) > 5 else 0.0
            out.append({"kind": kind, "stage": int(s), "mb": int(m),
                        "chunk": int(chunk), "src": -1, "start": start,
                        "finish": start + float(dur)})
    return out


def executed_trace_events(source, *, pid: int = 1,
                          process_name: str = "executed",
                          n_stages: int | None = None) -> list:
    """Trace events for an executed step (see ``executed_events_of``)."""
    evs = executed_events_of(source)
    S = n_stages if n_stages is not None \
        else max((e["stage"] for e in evs), default=-1) + 1
    events = [_meta_event("process_name", pid, 0, process_name)]
    tids = sorted({e["stage"] for e in evs})
    for s in tids:
        events.append(_meta_event("thread_name", pid, s, f"stage {s}"))
    xfer_tids = sorted({e["stage"] for e in evs if e["kind"] == "X"})
    for s in xfer_tids:
        events.append(_meta_event("thread_name", pid, S + s,
                                  f"stage {s} transfers in"))
    for e in evs:
        tid = e["stage"] if e["kind"] != "X" else S + e["stage"]
        args = {"kind": KIND_LABEL.get(e["kind"], e["kind"]),
                "stage": e["stage"], "mb": e["mb"], "chunk": e["chunk"]}
        if e["kind"] == "X" and e["src"] >= 0:
            args["src_stage"] = e["src"]
        events.append({
            "name": _event_name(e["kind"], e["stage"], e["mb"], e["chunk"],
                                e["src"]),
            "cat": f"pipeline,{KIND_LABEL.get(e['kind'], e['kind'])}",
            "ph": "X", "ts": e["start"] * US,
            "dur": max(e["finish"] - e["start"], 0.0) * US,
            "pid": pid, "tid": tid,
            "cname": KIND_CNAME.get(e["kind"], "generic_work"),
            "args": args,
        })
    return events


def chrome_trace(events: list, **metadata) -> dict:
    """Wrap trace events as a Chrome trace-event JSON document."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms",
            "otherData": dict(metadata)}


def write_chrome_trace(path: str, events_or_doc, **metadata) -> str:
    """Write (and validate) a trace document; ``.gz`` paths compress."""
    doc = events_or_doc if isinstance(events_or_doc, dict) \
        else chrome_trace(events_or_doc, **metadata)
    validate_chrome_trace(doc)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(doc, f)
    else:
        with open(path, "w") as f:
            json.dump(doc, f)
    return path


def validate_chrome_trace(doc) -> dict:
    """Schema check for the trace-event JSON object format; raises
    ``ValueError`` on violation, returns the (JSON-round-trippable)
    document otherwise."""
    doc = json.loads(json.dumps(doc))      # proves serializability
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must carry 'traceEvents'")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in e:
                raise ValueError(f"event {i} missing required key {k!r}")
        ph = e["ph"]
        if ph == "M":
            continue
        if "ts" not in e:
            raise ValueError(f"event {i} ({e['name']}): missing 'ts'")
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            raise ValueError(f"event {i} ({e['name']}): bad ts {e['ts']}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event {i} ({e['name']}): complete event needs "
                    f"dur >= 0, got {dur!r}")
    return doc


def aggregate_events(events: list) -> dict:
    """Reduce a normalized executed-event list (``executed_events_of``)
    to the per-key busy sums the run-health analyzer rolls over:

      * ``stage``: compute seconds (F/B/W) by stage id;
      * ``link``:  transfer seconds (X) by directed ``"src->dst"`` stage
        edge (``"?->dst"`` when the producer did not record a src);
      * ``span``:  (earliest start, latest finish) across all events.
    """
    stage: dict = {}
    link: dict = {}
    t0, t1 = float("inf"), float("-inf")
    for e in events:
        dur = e["finish"] - e["start"]
        t0 = min(t0, e["start"])
        t1 = max(t1, e["finish"])
        if e["kind"] == "X":
            src = e.get("src", -1)
            key = f"{src if src >= 0 else '?'}->{e['stage']}"
            link[key] = link.get(key, 0.0) + dur
        else:
            s = int(e["stage"])
            stage[s] = stage.get(s, 0.0) + dur
    if not events:
        t0 = t1 = 0.0
    return {"stage": stage, "link": link, "span": (t0, t1)}


# ------------------------------------------------------------ diff report

def _key(e) -> tuple:
    # src disambiguates the two transfers into one stage (forward
    # activation from s-1 vs backward grad from s+1, same mb/chunk)
    return (e["stage"], e["mb"], e["kind"], e["chunk"], e["src"])


def diff_report(predicted_tl, executed, *, sync_time: float = 0.0,
                executed_wall: float | None = None, top_k: int = 8) -> dict:
    """Join predicted vs executed per (stage, mb, kind, chunk) and
    attribute the step-time gap.

    ``predicted_tl`` is a simulated ``Timeline``; ``executed`` anything
    ``executed_events_of`` accepts. ``executed_wall`` (default: the
    latest executed finish) is the measured step seconds; ``sync_time``
    is the predicted post-flush gradient-sync that the timeline itself
    does not contain.

    The report's ``attribution`` splits the summed per-event error into
    ``compute_s`` (F/B/W), ``transfer_s`` (X) and ``sync_other_s`` (the
    wall-clock gap unexplained by per-event deltas — gradient sync,
    dispatch overhead, host time).
    """
    pred = {}
    for e in predicted_tl.events:
        pred[(e.stage, e.mb, e.kind, e.chunk, e.src)] = {
            "start": e.start, "finish": e.finish, "dur": e.dur}
    exe = {_key(e): {"start": e["start"], "finish": e["finish"],
                     "dur": e["finish"] - e["start"]}
           for e in executed_events_of(executed)}

    rows = []
    compute_d = transfer_d = 0.0
    matched = 0
    for key in sorted(set(pred) | set(exe)):
        stage, mb, kind, chunk, src = key
        p, x = pred.get(key), exe.get(key)
        row = {"stage": stage, "mb": mb, "kind": kind, "chunk": chunk,
               "src": src,
               "predicted_s": p["dur"] if p else None,
               "executed_s": x["dur"] if x else None,
               "delta_s": (x["dur"] - p["dur"]) if p and x else None}
        rows.append(row)
        if p and x:
            matched += 1
            if kind == "X":
                transfer_d += x["dur"] - p["dur"]
            else:
                compute_d += x["dur"] - p["dur"]

    by_kind = {}
    for row in rows:
        agg = by_kind.setdefault(row["kind"], {
            "predicted_s": 0.0, "executed_s": 0.0, "events": 0})
        agg["events"] += 1
        agg["predicted_s"] += row["predicted_s"] or 0.0
        agg["executed_s"] += row["executed_s"] or 0.0
    for agg in by_kind.values():
        agg["delta_s"] = agg["executed_s"] - agg["predicted_s"]

    predicted_step = predicted_tl.makespan + sync_time
    if executed_wall is None:
        executed_wall = max((e["finish"] for e in
                             executed_events_of(executed)), default=0.0)
    step_err = executed_wall - predicted_step
    worst = sorted((r for r in rows if r["delta_s"] is not None),
                   key=lambda r: -abs(r["delta_s"]))[:top_k]
    return {
        "predicted_step_s": predicted_step,
        "predicted_makespan_s": predicted_tl.makespan,
        "predicted_sync_s": sync_time,
        "executed_step_s": executed_wall,
        "step_error_s": step_err,
        "step_error_frac": step_err / predicted_step
        if predicted_step > 0 else 0.0,
        "events_predicted": len(pred), "events_executed": len(exe),
        "events_matched": matched,
        "unmatched": [r for r in rows if r["delta_s"] is None],
        "attribution": {
            "compute_s": compute_d,
            "transfer_s": transfer_d,
            "sync_other_s": step_err - compute_d - transfer_d,
        },
        "by_kind": by_kind,
        "worst_events": worst,
        "rows": rows,
    }


def format_diff(report: dict) -> str:
    """Human-oriented rendering of a ``diff_report``."""
    a = report["attribution"]
    lines = [
        f"predicted step {report['predicted_step_s']:.6f}s "
        f"(makespan {report['predicted_makespan_s']:.6f}s"
        f" + sync {report['predicted_sync_s']:.6f}s), "
        f"executed {report['executed_step_s']:.6f}s "
        f"-> error {report['step_error_frac']:+.2%}",
        f"attribution: compute {a['compute_s']:+.6f}s, "
        f"transfer {a['transfer_s']:+.6f}s, "
        f"sync/other {a['sync_other_s']:+.6f}s",
        f"events: {report['events_matched']} matched / "
        f"{report['events_predicted']} predicted / "
        f"{report['events_executed']} executed",
    ]
    for kind, agg in sorted(report["by_kind"].items()):
        lines.append(
            f"  {KIND_LABEL.get(kind, kind):>11}: "
            f"predicted {agg['predicted_s']:.6f}s, "
            f"executed {agg['executed_s']:.6f}s "
            f"({agg['delta_s']:+.6f}s over {agg['events']} events)")
    for r in report["worst_events"]:
        lines.append(
            f"  worst: "
            f"{_event_name(r['kind'], r['stage'], r['mb'], r['chunk'], r.get('src', -1))}"
            f" predicted {r['predicted_s']:.6f}s executed "
            f"{r['executed_s']:.6f}s ({r['delta_s']:+.6f}s)")
    return "\n".join(lines)
