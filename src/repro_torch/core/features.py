"""GNN input featurization (paper §4.2.1, Table 1).

The unified heterogeneous graph has op-group nodes and device-group nodes;
three link types (op-op tensors, dev-dev links, op-dev placements). The
four feature parts: raw graph/device features, the strategy encoding,
runtime feedback from the simulator, and search progress. Features are
log-scaled where sizes/times appear so unseen model scales stay in range.
"""
from __future__ import annotations

from dataclasses import dataclass
import math

import numpy as np

from repro_torch.core.device import Topology
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.simulator import SimResult, device_group_stats
from repro_torch.core.strategy import Strategy

OP_F = 13      # per-op-node features (5-wide option one-hot)
DEV_F = 8      # per-device-node features
EDGE_F = 2     # per-edge features (both etypes)

_AVG_FLOPS = 5e12  # normalizing device speed


def _log1p(x, scale=1.0):
    return math.log1p(max(x, 0.0) / scale)


@dataclass
class HetGraph:
    op_x: np.ndarray       # (N, OP_F)
    dev_x: np.ndarray      # (M, DEV_F)
    oo_mask: np.ndarray    # (N, N) bool
    oo_e: np.ndarray       # (N, N, EDGE_F)
    dd_mask: np.ndarray    # (M, M)
    dd_e: np.ndarray       # (M, M, EDGE_F)
    od_e: np.ndarray       # (N, M, EDGE_F) — full bipartite, placement bit


def featurize(gg: GroupedGraph, topo: Topology, strat: Strategy,
              res: SimResult | None, next_gid: int | None,
              observed: SimResult | None = None) -> HetGraph:
    """Build the heterogeneous GNN input.

    ``res`` carries the runtime-feedback feature part (Table 1 part 3).
    When ``observed`` is given — a SimResult-shaped aggregate of REAL step
    telemetry (``repro.runtime.telemetry.observed_sim_result``) — its
    measured device/link idle signals overlay the simulator's estimates
    (paper §4.3). Features real telemetry cannot attribute stay
    per-candidate from ``res``: group makespan / idle-before-transfer
    (real executions observe devices, not op groups, unless a record
    carries group data) and peak-memory fractions (reference-counted in
    the simulator only) — a wholesale replacement would make every MCTS
    candidate look identical on exactly the signals that rank them.
    """
    # overlay only what the observation actually ATTRIBUTES: a wall-time-
    # only record (empty busy maps) would otherwise read as "everything
    # 100% idle" — a fabricated constant wiping the per-candidate signals
    grp_src = observed if observed is not None and observed.group_finish \
        else res
    N, M = gg.n, topo.m
    op_x = np.zeros((N, OP_F), np.float32)
    stats = device_group_stats(res, topo) if res is not None else None
    obs_stats = device_group_stats(observed, topo) \
        if observed is not None and observed.device_busy else None
    link_src = observed if observed is not None and observed.link_busy \
        else res
    for i, grp in enumerate(gg.groups):
        a = strat.actions[i]
        t_avg = grp.flops / _AVG_FLOPS
        op_x[i, 0] = _log1p(t_avg, 1e-3)                   # computation time
        op_x[i, 1] = _log1p(grp.param_bytes, 1e6)          # parameter size
        if a is not None:
            op_x[i, 2 + int(a.option)] = 1.0               # replication plan
        if grp_src is not None:
            op_x[i, 7] = _log1p(
                grp_src.group_finish.get(i, 0.0)
                - grp_src.group_start.get(i, 0.0), 1e-3)    # makespan
            op_x[i, 8] = _log1p(
                grp_src.group_idle_before_xfer.get(i, 0.0), 1e-3)
        op_x[i, 9] = 1.0 if a is not None else 0.0          # decided
        op_x[i, 10] = 1.0 if i == next_gid else 0.0         # produced next
        op_x[i, 11] = 1.0 if grp.has_grad else 0.0
        op_x[i, 12] = _log1p(grp.bytes_out, 1e6)

    dev_x = np.zeros((M, DEV_F), np.float32)
    for j, dg in enumerate(topo.groups):
        dev_x[j, 0] = dg.num_gpus / 8.0
        dev_x[j, 1] = _log1p(dg.mem_bytes, 1e9)
        dev_x[j, 2] = _log1p(dg.intra_bw, 1e9)
        dev_x[j, 3] = dg.flops / _AVG_FLOPS
        if stats is not None:
            dev_x[j, 4] = stats[j]["mem_frac"]              # peak memory
            dev_x[j, 5] = stats[j]["idle_frac"]             # idling %
        if obs_stats is not None:
            dev_x[j, 5] = obs_stats[j]["idle_frac"]         # measured
    oo_mask = np.zeros((N, N), bool)
    oo_e = np.zeros((N, N, EDGE_F), np.float32)
    for (gi, gj), b in gg.edges.items():
        oo_mask[gi, gj] = oo_mask[gj, gi] = True
        oo_e[gi, gj, 0] = oo_e[gj, gi, 0] = _log1p(b, 1e6)  # tensor size

    dd_mask = np.ones((M, M), bool)
    dd_e = np.zeros((M, M, EDGE_F), np.float32)
    for i in range(M):
        for j in range(M):
            dd_e[i, j, 0] = _log1p(topo.bw(i, j), 1e9)      # inter-group bw
            if link_src is not None:
                dd_e[i, j, 1] = link_src.link_idle_frac(i, j)  # idling %

    od_e = np.zeros((N, M, EDGE_F), np.float32)
    for i, a in enumerate(strat.actions):
        if a is None:
            continue
        for j in a.placement:
            od_e[i, j, 0] = 1.0                             # placement bit
    return HetGraph(op_x, dev_x, oo_mask, oo_e, dd_mask, dd_e, od_e)
