"""Replay executor for pipelines: run a (StagePlan, schedule) pair on a
cluster ``Topology`` and emit step telemetry.

The real engine (``exec.engine``) plays this role on actual hardware;
here the "cluster" is a ``Topology`` whose true parameters may differ
from the nominal ones the plan was searched under (the perturbed-cluster
scenario of the runtime-feedback benchmarks). One execution walks the
schedule timeline on the TRUE topology and records:

  * per-event compute samples (stage gpu_type, flops, time),
  * per-boundary transfer samples carrying the ``pair`` key
    (``"gi-gj"``) — the per-link-pair calibration tier's input
    (``runtime.calibration.fit_profile(min_pair_samples=...)``),

all normalized against the NOMINAL topology's spec-sheet numbers, exactly
what a live profiler would log. The predicted timeline and the executed
one come from the same schedule semantics, so
``simulate_schedule(plan, topo, order)`` at noise 0 must agree
event-for-event with the replay — the plan->execution cross-check the
tests assert.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.device import Topology
from repro_torch.exec.schedule import (
    DEFAULT_CHUNKS, FWD_FRAC, ZB_DGRAD_FRAC, Timeline, make_schedule,
    simulate_schedule)
from repro_torch.exec.stages import StagePlan
from repro_torch.runtime.telemetry import MeasurementStore, StepRecord


def execute_pipeline(plan: StagePlan, true_topo: Topology, *,
                     schedule: str = "1f1b",
                     n_chunks: int = DEFAULT_CHUNKS,
                     nominal_topo: Topology | None = None,
                     graph_fp: str = "", topo_fp: str = "",
                     step: int = 0, noise: float = 0.0, seed: int = 0,
                     store: MeasurementStore | None = None,
                     meta: dict | None = None, spool=None,
                     overlap: str = "link") -> tuple:
    """Execute one pipelined step on ``true_topo``; returns
    ``(StepRecord, Timeline)``. ``noise`` adds multiplicative jitter
    (relative std-dev) per recorded sample. ``n_chunks`` only applies to
    the interleaved schedule (virtual chunks per stage). ``overlap`` is
    the transfer/compute overlap model the replayed timeline runs under
    (default: the legacy link-serialization model, so predicted and
    replayed timelines agree event-for-event).

    ``spool`` (an ``obs.collector.SpoolWriter``) streams the executed
    events into the cross-process trace spool: simulated seconds are
    re-based onto this process's monotonic clock at emission time, so
    the merged trace shows the replay where it actually ran."""
    nominal = nominal_topo or true_topo
    rng = np.random.default_rng(seed)

    def jitter():
        return 1.0 + noise * float(rng.standard_normal()) if noise else 1.0

    order = make_schedule(schedule, plan.n_stages, plan.n_micro,
                          n_chunks=n_chunks)
    tl: Timeline = simulate_schedule(plan, true_topo, order,
                                     overlap=overlap)
    M = max(plan.n_micro, 1)
    has_w = any(e.kind == "W" for e in tl.events)
    bwd_frac = 1.0 - FWD_FRAC

    compute, collectives = [], []
    stage_events = []
    for e in tl.events:
        dur = e.dur * jitter()
        spec = plan.stages[e.stage]
        if e.kind != "X":
            if e.kind == "F":
                frac = FWD_FRAC
            elif e.kind == "W":
                frac = bwd_frac * (1.0 - ZB_DGRAD_FRAC)
            else:
                frac = bwd_frac * (ZB_DGRAD_FRAC if has_w else 1.0)
            compute.append({
                "gpu_type": spec.gpu_type,
                "flops": spec.flops / M / tl.n_chunks * frac,
                "time": dur, "stage": e.stage, "mb": e.mb,
                "kind": e.kind, "chunk": e.chunk})
        else:                              # "X": boundary transfer
            src = plan.stages[e.src]
            gi, gj = src.device_group, spec.device_group
            collectives.append({
                "kind": "xfer", "nbytes": e.nbytes, "n_dev": 2,
                "nominal_bw": nominal.nominal_bw(gi, gj),
                "link": "p2p", "pair": f"{gi}-{gj}", "time": dur})
        stage_events.append({"kind": e.kind, "stage": e.stage,
                             "mb": e.mb, "chunk": e.chunk, "src": e.src,
                             "start": e.start, "finish": e.start + dur})

    busy = {str(s.device_group): tl.stage_busy[i]
            for i, s in enumerate(plan.stages)}
    rec = StepRecord(
        graph_fp=graph_fp, topo_fp=topo_fp, step=step,
        wall_time=tl.makespan * jitter(),
        device_busy=busy, compute=compute, collectives=collectives,
        meta=dict(meta or {}, executor="pipeline-replay",
                  schedule=schedule, n_stages=plan.n_stages,
                  n_chunks=tl.n_chunks, n_micro=plan.n_micro,
                  bubble_frac=tl.bubble_fraction(),
                  true_topo=true_topo.name, events=stage_events))
    if store is not None:
        store.append(rec)
    if spool is not None:
        _spool_replay(spool, stage_events, plan.n_stages, schedule, step)
    return rec, tl


def _spool_replay(spool, stage_events: list, n_stages: int,
                  schedule: str, step: int):
    import time

    from repro_torch.obs.trace import KIND_LABEL, event_name

    t0 = time.perf_counter()
    recs = [{"type": "track", "tid": s, "name": f"stage {s}"}
            for s in range(n_stages)]
    recs += [{"type": "track", "tid": n_stages + s,
              "name": f"stage {s} transfers in"}
             for s in sorted({e["stage"] for e in stage_events
                              if e["kind"] == "X"})]
    for e in stage_events:
        tid = e["stage"] if e["kind"] != "X" else n_stages + e["stage"]
        recs.append({
            "type": "span",
            "name": event_name(e["kind"], e["stage"], e["mb"], e["chunk"],
                               e["src"]),
            "cat": "pipeline", "tid": tid,
            "t0": t0 + e["start"], "t1": t0 + e["finish"],
            "args": {"kind": KIND_LABEL.get(e["kind"], e["kind"]),
                     "stage": e["stage"], "mb": e["mb"],
                     "chunk": e["chunk"], "schedule": schedule,
                     "step": step}})
    spool.emit_many(recs)
