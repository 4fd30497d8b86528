"""Discrete-event simulator (paper §4.3.2).

FIFO queue per device (TF-default-scheduler-like): a task enters its
device queue when all inputs are ready; devices execute their queues
independently. Transfers serialize per directed link; collectives occupy
all participating devices. Reference-counted tensor lifetimes give peak
memory per device; the result carries the runtime-feedback features the
GNN consumes (makespan, idle-before-transfer, per-device idle %, per-link
idle %, peak memory) and an OOM flag.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import heapq

from repro_torch.core.compiler import TaskGraph
from repro_torch.core.device import Topology
from repro_torch.core.profiler import (
    allreduce_time, compute_time, ps_round_time, transfer_time)
from repro_torch.core.strategy import device_group_of


@dataclass
class SimResult:
    makespan: float
    feasible: bool
    task_start: list
    task_finish: list
    device_busy: dict                 # device -> busy seconds
    peak_mem: dict                    # device -> bytes
    link_busy: dict                   # (gi, gj) -> busy seconds
    group_start: dict = field(default_factory=dict)
    group_finish: dict = field(default_factory=dict)
    group_idle_before_xfer: dict = field(default_factory=dict)

    def device_idle_frac(self, dev: int) -> float:
        if self.makespan <= 0:
            return 0.0
        return 1.0 - self.device_busy.get(dev, 0.0) / self.makespan

    def link_idle_frac(self, gi: int, gj: int) -> float:
        if self.makespan <= 0:
            return 0.0
        return 1.0 - self.link_busy.get((gi, gj), 0.0) / self.makespan


def _dev_speed(topo: Topology, dev: int) -> float:
    return topo.groups[device_group_of(topo, dev)].flops


def simulate(tg: TaskGraph, topo: Topology, profile=None) -> SimResult:
    """Simulate a TaskGraph on a topology.

    ``profile`` is an optional ``repro.runtime.calibration
    .CalibrationProfile``: when given, the hard-coded device utilization
    and link-efficiency constants baked into ``topo`` are replaced by the
    measurement-fitted values before timing anything (paper §4.3 runtime
    feedback refining the simulator).
    """
    if profile is not None:
        topo = profile.apply(topo)
    n = len(tg.tasks)
    indeg = [0] * n
    succs: list = [[] for _ in range(n)]
    for t in tg.tasks:
        for d in t.deps:
            succs[d].append(t.tid)
            indeg[t.tid] += 1

    dev_free: dict = {}
    link_free: dict = {}
    dev_busy: dict = {}
    link_busy: dict = {}
    start = [0.0] * n
    finish = [0.0] * n
    ready_time = [0.0] * n

    # min-heap of (ready_time, tid) — FIFO per device approximated by
    # global readiness order, matching the paper's queue-insertion rule.
    heap = [(0.0, t.tid) for t in tg.tasks if indeg[t.tid] == 0]
    heapq.heapify(heap)
    done = 0
    g_of = {d: device_group_of(topo, d)
            for d in range(topo.total_devices)}

    while heap:
        rt, tid = heapq.heappop(heap)
        t = tg.tasks[tid]
        if t.kind == "compute":
            s = max(rt, dev_free.get(t.device, 0.0))
            dur = compute_time(t.flops, _dev_speed(topo, t.device))
            dev_free[t.device] = s + dur
            dev_busy[t.device] = dev_busy.get(t.device, 0.0) + dur
        elif t.kind == "xfer":
            gi, gj = g_of[t.src], g_of[t.dst]
            key = (t.src, t.dst)
            s = max(rt, link_free.get(key, 0.0))
            dur = transfer_time(t.nbytes, topo.bw(gi, gj), topo.latency)
            link_free[key] = s + dur
            link_busy[(gi, gj)] = link_busy.get((gi, gj), 0.0) + dur
        elif t.kind == "allreduce":
            s = max([rt, *(dev_free.get(d, 0.0) for d in t.devices)])
            gids = [g_of[d] for d in t.devices]
            tau = topo.bottleneck_bw(gids)
            dur = allreduce_time(t.nbytes, len(t.devices), tau, topo.latency)
            for d in t.devices:
                dev_free[d] = s + dur
                dev_busy[d] = dev_busy.get(d, 0.0) + dur
        elif t.kind == "ps":
            # sharded PS: each worker pushes/pulls its share; the slowest
            # link bounds it, but workers are NOT barriered together.
            gids = [g_of[d] for d in t.devices]
            tau = topo.bottleneck_bw(gids)
            dur = ps_round_time(t.nbytes, len(t.devices), tau, topo.latency)
            s = rt  # overlaps with device compute of others
        else:
            s, dur = rt, 0.0
        start[tid], finish[tid] = s, s + dur
        done += 1
        for nx in succs[tid]:
            indeg[nx] -= 1
            ready_time[nx] = max(ready_time[nx], finish[tid])
            if indeg[nx] == 0:
                heapq.heappush(heap, (ready_time[nx], nx))

    makespan = max(finish) if finish else 0.0

    # reference-counted tensor lifetimes (paper §4.3.2): a replica's output
    # is allocated when its compute task finishes and freed when its last
    # consumer (compute on the same device, or outgoing transfer) finishes.
    events: dict = {d: [] for d in range(topo.total_devices)}
    last_use = [finish[t.tid] for t in tg.tasks]
    for t in tg.tasks:
        for d in t.deps:
            last_use[d] = max(last_use[d], finish[t.tid])
    for t in tg.tasks:
        if t.kind != "compute":
            continue
        gid = t.group
        grp_bytes = 0.0
        reps = tg.replicas.get(gid, [])
        rep = next((r for r in reps if r.task == t.tid), None)
        if rep is not None:
            total = tg.group_out_bytes.get(gid, 0.0)
            if tg.group_is_mp.get(gid):
                grp_bytes = total / max(len(reps), 1)   # stage slice
            else:
                grp_bytes = total * rep.frac
        if grp_bytes <= 0:
            continue
        events[t.device].append((finish[t.tid], grp_bytes))
        events[t.device].append((last_use[t.tid], -grp_bytes))

    peak_mem = {}
    feasible = done == n
    for d in range(topo.total_devices):
        resident = tg.params_on.get(d, 0.0) * 4.0  # param+grad+adam moments
        cur, peak = resident, resident
        for _, delta in sorted(events[d]):
            cur += delta
            peak = max(peak, cur)
        peak_mem[d] = peak
        if peak > topo.groups[g_of[d]].mem_bytes:
            feasible = False

    res = SimResult(
        makespan=makespan, feasible=feasible and done == n,
        task_start=start, task_finish=finish, device_busy=dev_busy,
        peak_mem=peak_mem, link_busy=link_busy)

    # per-group runtime feedback
    for gid, reps in tg.replicas.items():
        ts = [r.task for r in reps]
        res.group_start[gid] = min(start[t] for t in ts)
        res.group_finish[gid] = max(finish[t] for t in ts)
    for t in tg.tasks:
        if t.kind == "xfer" and t.group >= 0 and t.deps:
            lag = start[t.tid] - max(finish[d] for d in t.deps)
            cur = res.group_idle_before_xfer.get(t.group, 0.0)
            res.group_idle_before_xfer[t.group] = max(cur, lag)
    return res


def device_group_stats(res: SimResult, topo: Topology):
    """Aggregate per-device-group feedback (GNN features part 3)."""
    stats = []
    base = 0
    for dg in topo.groups:
        devs = range(base, base + dg.num_gpus)
        base += dg.num_gpus
        peak = max((res.peak_mem.get(d, 0.0) for d in devs), default=0.0)
        idle = sum(res.device_idle_frac(d) for d in devs) / max(dg.num_gpus, 1)
        stats.append({"peak_mem": peak, "idle_frac": idle,
                      "mem_frac": peak / dg.mem_bytes})
    return stats
