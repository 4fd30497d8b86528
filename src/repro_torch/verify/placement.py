"""Placement feasibility checks for a ``StagePlan`` on a ``Topology``.

Proves the structural preconditions the partitioner (and the
optimal-contiguous-split literature it follows) guarantees by
construction, so a hand-edited, deserialized or bit-rotted plan cannot
reach the engine:

  * every stage references a real device group (TAG402) and its recorded
    device count matches that group (TAG403);
  * stage spans are non-empty (TAG405), each op group belongs to exactly
    one stage (TAG406), and spans are contiguous in topological order
    with stages appearing in pipeline order (TAG401) — the invariant the
    rematerializing engine and the boundary-bytes accounting both rely
    on;
  * every scheduled boundary transfer (consecutive stages, plus the
    chunk-wrap link interleaved schedules add from the last stage back
    to the first) rides a link with positive effective bandwidth
    (TAG404): ``pair_eff`` of 0 means calibration proved the pair
    unreachable.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Mapping

from repro_torch.verify.diagnostics import Report

if TYPE_CHECKING:
    from repro_torch.core.device import Topology
    from repro_torch.core.graph import GroupedGraph
    from repro_torch.exec.stages import StagePlan


def group_positions(gg: "GroupedGraph") -> dict[int, float]:
    """Mean topological position per op group.

    This is the order ``build_stage_plan`` cut along.
    """
    order = {op: i for i, op in enumerate(gg.base.topo_order())}
    pos: dict[int, float] = {}
    for g in gg.groups:
        ps = [order[o] for o in g.op_ids if o in order]
        pos[g.group_id] = (sum(ps) / len(ps)) if ps else 0.0
    return pos


def analyze_placement(plan: "StagePlan", topo: "Topology | None" = None,
                      *, positions: Mapping[int, float] | None = None,
                      n_chunks: int = 1) -> Report:
    """Check stage spans and device references (TAG401-TAG406)."""
    rep = Report()
    m = topo.m if topo is not None else None

    # --- device-group references + capacity --------------------------
    for s, st in enumerate(plan.stages):
        if m is not None and not (0 <= st.device_group < m):
            rep.add("TAG402",
                    f"stage {s} references device group "
                    f"{st.device_group}; topology "
                    f"{topo.name or '?'} has groups 0..{m - 1}",
                    stage=s)
            continue
        if s < len(plan.placement) \
                and plan.placement[s] != st.device_group:
            rep.add("TAG402",
                    f"stage {s} sits on device group {st.device_group} "
                    f"but the plan's pipeline spine names group "
                    f"{plan.placement[s]} at that position", stage=s)
        if m is not None:
            have = int(topo.groups[st.device_group].num_gpus)
            if int(st.n_devices) != have:
                rep.add("TAG403",
                        f"stage {s} records {st.n_devices} devices but "
                        f"device group {st.device_group} has {have}",
                        stage=s)

    # --- span structure ----------------------------------------------
    owner: dict[int, int] = {}
    for s, st in enumerate(plan.stages):
        if not st.op_group_ids:
            rep.add("TAG405", f"stage {s} owns no op groups", stage=s)
        for gid in st.op_group_ids:
            if gid in owner:
                rep.add("TAG406",
                        f"op group {gid} assigned to stage {owner[gid]} "
                        f"and stage {s}", stage=s)
            else:
                owner[int(gid)] = s

    if positions is not None and owner:
        ranked = sorted(owner, key=lambda g: (positions.get(g, 0.0), g))
        labels = [owner[g] for g in ranked]
        prev = labels[0] if labels else 0
        for i in range(1, len(labels)):
            if labels[i] < prev:
                rep.add("TAG401",
                        f"op group {ranked[i]} (topological position "
                        f"{i}) belongs to stage {labels[i]} after "
                        f"stage {prev} already closed: stage spans are "
                        f"not contiguous in topological order",
                        stage=labels[i])
                break
            prev = labels[i]

    # --- boundary links ----------------------------------------------
    if topo is not None:
        pairs: list[tuple[int, int, float]] = []
        for s in range(plan.n_stages - 1):
            pairs.append((s, s + 1, plan.stages[s].out_bytes))
        if n_chunks > 1 and plan.n_stages >= 2:
            # interleaved chunk boundaries wrap last stage -> first
            pairs.append((plan.n_stages - 1, 0,
                          plan.stages[plan.n_stages - 1].out_bytes
                          or plan.stages[0].out_bytes))
        for src, dst, nbytes in pairs:
            gi = plan.stages[src].device_group
            gj = plan.stages[dst].device_group
            if not (0 <= gi < topo.m and 0 <= gj < topo.m):
                continue                 # TAG402 already covers it
            if gi == gj or nbytes <= 0:
                continue
            for a, b in ((gi, gj), (gj, gi)):   # F and grad directions
                if topo.bw(a, b) <= 0:
                    rep.add("TAG404",
                            f"stage {src} -> stage {dst} transfers "
                            f"{nbytes:.0f}B over device groups "
                            f"{a} -> {b}, whose effective bandwidth "
                            f"is 0 (pair_eff marks the link "
                            f"unreachable)", stage=src)
    return rep
