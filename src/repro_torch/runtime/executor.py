"""Replay executor: run a compiled TaskGraph on the *actual* cluster and
emit telemetry.

On real hardware this role is played by the instrumented launchers
(``launch.train --telemetry-dir``, ``launch.serve --observe``); here the
"actual cluster" is a ``Topology`` whose true parameters (utilization,
link efficiency, latency) may differ from the nominal one the plan was
searched under — the perturbed-cluster scenario of the feedback
benchmark. Each execution walks the simulated schedule on the TRUE
topology and records per-op compute samples and per-collective transfer
samples against the NOMINAL topology's spec-sheet numbers, exactly what a
profiler on a live cluster would log (observed time vs nominal
bandwidth). Calibration then fits the gap.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.device import Topology
from repro_torch.core.simulator import simulate
from repro_torch.core.strategy import device_group_of
from repro_torch.runtime.telemetry import MeasurementStore, StepRecord


def dominant_op(gg, group_id: int) -> str | None:
    """Flops-dominant primitive name of an op group — the ``"op"`` tag
    compute samples carry so calibration can bucket utilization per op
    type, not just per device type."""
    if gg is None or group_id is None or group_id >= len(gg.groups):
        return None
    by_op: dict = {}
    for oid in gg.groups[group_id].op_ids:
        node = gg.base.nodes.get(oid)
        if node is not None:
            by_op[node.op_type] = by_op.get(node.op_type, 0.0) + node.flops
    if not by_op:
        return None
    return max(by_op.items(), key=lambda kv: kv[1])[0]


def execute_plan(tg, true_topo: Topology, *,
                 nominal_topo: Topology | None = None,
                 graph_fp: str = "", topo_fp: str = "",
                 step: int = 0, noise: float = 0.0, seed: int = 0,
                 store: MeasurementStore | None = None,
                 gg=None, meta: dict | None = None) -> StepRecord:
    """Execute one step of ``tg`` on ``true_topo`` and record telemetry.

    ``nominal_topo`` (default: ``true_topo``) supplies the spec-sheet
    bandwidths the samples are normalized against — on a live cluster the
    profiler knows the nominal link speed, not the achieved one.
    ``noise`` adds multiplicative jitter (relative std-dev) per sample.
    ``gg`` (the GroupedGraph ``tg`` was compiled from, optional) lets
    compute samples carry their group's dominant primitive as ``"op"``
    for the per-op-type calibration tier.
    """
    nominal = nominal_topo or true_topo
    rng = np.random.default_rng(seed)
    op_of = {g: dominant_op(gg, g)
             for g in range(len(gg.groups))} if gg is not None else {}

    def jitter():
        return 1.0 + noise * float(rng.standard_normal()) if noise else 1.0

    res = simulate(tg, true_topo)
    g_of = {d: device_group_of(true_topo, d)
            for d in range(true_topo.total_devices)}

    compute, collectives = [], []
    for t in tg.tasks:
        dur = (res.task_finish[t.tid] - res.task_start[t.tid]) * jitter()
        if t.kind == "compute":
            sample = {
                "gpu_type": true_topo.groups[g_of[t.device]].gpu_type,
                "flops": t.flops, "time": dur}
            op = op_of.get(t.group)
            if op:
                sample["op"] = op
            compute.append(sample)
        elif t.kind == "xfer":
            gi, gj = g_of[t.src], g_of[t.dst]
            collectives.append({
                "kind": "xfer", "nbytes": t.nbytes, "n_dev": 2,
                "nominal_bw": nominal.nominal_bw(gi, gj),
                "link": "p2p", "pair": f"{gi}-{gj}", "time": dur})
        elif t.kind in ("allreduce", "ps"):
            gids = sorted({g_of[d] for d in t.devices})
            b_nom, cls = nominal.nominal_bottleneck(gids)
            collectives.append({
                "kind": t.kind, "nbytes": t.nbytes,
                "n_dev": len(t.devices), "nominal_bw": b_nom,
                "link": cls, "time": dur})

    rec = StepRecord(
        graph_fp=graph_fp, topo_fp=topo_fp, step=step,
        wall_time=res.makespan * jitter(),
        device_busy={str(d): b for d, b in res.device_busy.items()},
        link_busy={f"{gi}-{gj}": b
                   for (gi, gj), b in res.link_busy.items()},
        compute=compute, collectives=collectives,
        meta=dict(meta or {}, executor="replay",
                  true_topo=true_topo.name))
    if store is not None:
        store.append(rec)
    return rec
