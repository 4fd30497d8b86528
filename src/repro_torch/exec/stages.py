"""Stage partitioner: cut a searched Strategy into executable pipeline
stages (paper Fig. 5/6 regime — pipelined stages spanning heterogeneous
device groups).

A ``Strategy`` marks op groups with ``Option.PIPE`` over a placement (a
tuple of device groups). This module turns that into a ``StagePlan``:

  * the **pipeline spine** is the PIPE placement carrying the most
    compute (flops-weighted vote across PIPE actions) — partial
    placements are respected, device groups outside the spine host no
    stage;
  * every op group is assigned to exactly one stage; groups are laid out
    in topological order and cut into contiguous spans whose flops are
    proportional to each stage's device-group compute capacity
    (heterogeneity-aware balance, paper §4.2);
  * each stage carries the gradient-sync mode its member groups voted
    for (AR -> "allreduce", PS -> "ps", DUP -> "sfb", by grad bytes) —
    the §4.2.3 ILP's decisions routed to the real engine;
  * stage boundaries carry the inter-group tensor bytes that cross them,
    so the schedule simulator charges the same activation traffic the
    executed pipeline moves.

``StagePlan.assign_local_devices`` maps the plan onto whatever torch
devices the host actually has (per-stage submeshes, proportional to the
topology's group sizes), raising ``PipelineInfeasible`` when there are
fewer devices than stages — the launcher catches that and falls back to
single-mesh axis rules with a clear warning.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.device import Topology
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.strategy import Option, Strategy

# Option -> runtime gradient-sync mode (parallel/sfb_dense.SYNC_MODES)
OPTION_SYNC = {Option.AR: "allreduce", Option.PS: "ps", Option.DUP: "sfb"}


class PipelineInfeasible(RuntimeError):
    """The host cannot execute this stage map (too few devices)."""


@dataclass
class StageSpec:
    """One pipeline stage: a contiguous span of op groups mapped to one
    topology device group."""
    stage_id: int
    device_group: int            # topology device-group id hosting it
    op_group_ids: list           # op groups assigned (topological order)
    flops: float                 # summed group flops (fwd+bwd trace)
    param_bytes: float
    grad_bytes: float
    out_bytes: float             # activation bytes crossing to stage+1
    sync: str = "allreduce"      # gradient-sync mode within the stage
    n_devices: int = 1           # devices in the topology group
    gpu_type: str = ""           # device type (telemetry attribution)

    def to_dict(self) -> dict:
        return {"stage_id": self.stage_id,
                "device_group": self.device_group,
                "op_group_ids": [int(g) for g in self.op_group_ids],
                "flops": self.flops, "param_bytes": self.param_bytes,
                "grad_bytes": self.grad_bytes, "out_bytes": self.out_bytes,
                "sync": self.sync, "n_devices": self.n_devices,
                "gpu_type": self.gpu_type}

    @classmethod
    def from_dict(cls, d: dict) -> "StageSpec":
        return cls(stage_id=int(d["stage_id"]),
                   device_group=int(d["device_group"]),
                   op_group_ids=list(d["op_group_ids"]),
                   flops=float(d["flops"]),
                   param_bytes=float(d["param_bytes"]),
                   grad_bytes=float(d["grad_bytes"]),
                   out_bytes=float(d["out_bytes"]),
                   sync=d.get("sync", "allreduce"),
                   n_devices=int(d.get("n_devices", 1)),
                   gpu_type=d.get("gpu_type", ""))


@dataclass
class StagePlan:
    """Executable pipeline layout for one strategy on one topology."""
    stages: list                        # list[StageSpec]
    placement: tuple                    # device-group ids (pipeline spine)
    n_micro: int = 4
    topo_name: str = ""
    schedule: str = "1f1b"              # microbatch schedule the PIPE
    #                                     actions voted for (flops-weighted)
    meta: dict = field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def flops_fracs(self) -> list:
        tot = sum(s.flops for s in self.stages) or 1.0
        return [s.flops / tot for s in self.stages]

    def layer_splits(self, n_layers: int, n_chunks: int = 1) -> list:
        """Contiguous [lo, hi) layer spans per virtual stage, proportional
        to the stages' flops share (model adapter: map transformer periods
        onto stages). With ``n_chunks > 1`` (interleaved schedules) each
        physical stage hosts ``n_chunks`` model chunks; virtual stage
        ``u = chunk * S + s`` executes the u-th span at 1/n_chunks of the
        stage's flops share. Every span gets >= 0 layers; all layers are
        covered."""
        fracs = self.flops_fracs()
        if n_chunks > 1:
            fracs = [fracs[u % len(fracs)] / n_chunks
                     for u in range(len(fracs) * n_chunks)]
        splits, lo = [], 0
        acc = 0.0
        for s, f in enumerate(fracs):
            acc += f
            hi = n_layers if s == len(fracs) - 1 \
                else min(n_layers, round(acc * n_layers))
            hi = max(hi, lo)
            splits.append((lo, hi))
            lo = hi
        return splits

    def with_carry_bytes(self, nbytes: float) -> "StagePlan":
        """Copy with every interior boundary's bytes replaced by the
        EXECUTED inter-stage carry. The traced graph's cut-crossing bytes
        include tensors the engine never ships (it rematerializes the
        stage forward during backward and only moves the hidden-state
        carry — see the boundary accounting note in ``build_stage_plan``);
        callers that know the model's carry size (batch x seq x d_model x
        dtype) use this to cost schedules against real traffic."""
        import copy
        plan = copy.deepcopy(self)
        for s in plan.stages[:-1]:
            s.out_bytes = float(nbytes)
        return plan

    def assign_local_devices(self, devices) -> list:
        """Map stages onto the host's ``torch.device``s: one contiguous slice
        per stage, sized proportionally to the topology group's device
        count (>= 1 each). Raises ``PipelineInfeasible`` when the host
        has fewer devices than stages."""
        devices = list(devices)
        S = self.n_stages
        if len(devices) < S:
            raise PipelineInfeasible(
                f"stage map needs {S} stages but the host has "
                f"{len(devices)} device(s)")
        want = [max(1, s.n_devices) for s in self.stages]
        tot = sum(want)
        # proportional shares, then hand out leftovers largest-first
        share = [max(1, int(len(devices) * w / tot)) for w in want]
        while sum(share) > len(devices):
            share[share.index(max(share))] -= 1
        leftovers = len(devices) - sum(share)
        order = sorted(range(S), key=lambda i: -want[i])
        for i in range(leftovers):
            share[order[i % S]] += 1
        out, base = [], 0
        for k in share:
            out.append(devices[base:base + k])
            base += k
        return out

    def to_dict(self) -> dict:
        return {"stages": [s.to_dict() for s in self.stages],
                "placement": [int(g) for g in self.placement],
                "n_micro": self.n_micro, "topo_name": self.topo_name,
                "schedule": self.schedule, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "StagePlan":
        return cls(stages=[StageSpec.from_dict(s) for s in d["stages"]],
                   placement=tuple(d["placement"]),
                   n_micro=int(d.get("n_micro", 4)),
                   topo_name=d.get("topo_name", ""),
                   schedule=d.get("schedule", "1f1b"),
                   meta=d.get("meta", {}))


def _group_topo_positions(gg: GroupedGraph) -> dict:
    """Mean topological position of each op group's member ops."""
    order = {op: i for i, op in enumerate(gg.base.topo_order())}
    pos = {}
    for g in gg.groups:
        ps = [order[o] for o in g.op_ids if o in order]
        pos[g.group_id] = (sum(ps) / len(ps)) if ps else 0.0
    return pos


def pipeline_spine(strat: Strategy, gg: GroupedGraph,
                   topo: Topology) -> tuple | None:
    """The flops-weighted majority PIPE placement, or None when the
    strategy pipelines nothing (or only within a single device group)."""
    votes: dict = {}
    for gid, a in enumerate(strat.actions):
        if a is None or a.option != Option.PIPE:
            continue
        if len(a.placement) < 2:
            continue                    # single-group PIPE: no real stages
        w = gg.groups[gid].flops if gid < len(gg.groups) else 1.0
        votes[a.placement] = votes.get(a.placement, 0.0) + max(w, 1.0)
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: kv[1])[0]


def vote_schedule(strat: Strategy, gg: GroupedGraph,
                  spine: tuple) -> str:
    """Flops-weighted majority microbatch schedule among the PIPE
    actions on the chosen spine; "1f1b" when none names one (legacy
    strategies searched before the schedule field existed)."""
    votes: dict = {}
    fallback: dict = {}
    for gid, a in enumerate(strat.actions):
        if a is None or a.option != Option.PIPE or not a.schedule:
            continue
        w = gg.groups[gid].flops if gid < len(gg.groups) else 1.0
        fallback[a.schedule] = fallback.get(a.schedule, 0.0) + max(w, 1.0)
        if a.placement == spine:
            votes[a.schedule] = votes.get(a.schedule, 0.0) + max(w, 1.0)
    votes = votes or fallback       # truncated spine: no exact match
    if not votes:
        return "1f1b"
    return max(votes.items(), key=lambda kv: kv[1])[0]


def _refine_cuts(spans: list, order: list, gg: GroupedGraph, caps: list,
                 cap_tot: float, total_flops: float, *,
                 window: int = 4, min_share: float = 0.25,
                 passes: int = 3) -> list:
    """Shift stage boundaries toward cheap cuts (the paper's partition
    objective: minimize crossing tensor bytes under compute balance).

    The capacity-proportional fill above balances flops but is blind to
    activation sizes, so a boundary can land on a huge tensor (e.g. the
    early-conv activations of a VGG) when a few positions over the
    crossing bytes collapse. Each pass slides every cut within a window,
    keeping every stage at >= ``min_share`` of its capacity-proportional
    flops target, and keeps the move only when it lowers total crossing
    bytes.
    """
    S = len(spans)
    if S < 2:
        return spans
    flops = [max(gg.groups[g].flops, 1.0) for g in order]
    pos_of = {g: i for i, g in enumerate(order)}
    cuts = []
    acc = 0
    for span in spans[:-1]:
        acc += len(span)
        cuts.append(acc)                # stage k = order[cuts[k-1]:cuts[k]]

    def stage_of(idx: int, cuts_) -> int:
        for k, c in enumerate(cuts_):
            if idx < c:
                return k
        return S - 1

    def cut_bytes(cuts_) -> float:
        # consecutive-stage crossings only — matching what the executed
        # pipeline moves (see the boundary accounting note below)
        return sum(b for (gi, gj), b in gg.edges.items()
                   if stage_of(pos_of[gj], cuts_)
                   == stage_of(pos_of[gi], cuts_) + 1)

    def feasible(cuts_) -> bool:
        bounds = [0, *cuts_, len(order)]
        for k in range(S):
            lo, hi = bounds[k], bounds[k + 1]
            if hi <= lo:
                return False
            target = caps[k] / cap_tot * total_flops
            if sum(flops[lo:hi]) < min_share * target:
                return False
        return True

    best = cut_bytes(cuts)
    for _ in range(passes):
        improved = False
        for k in range(S - 1):
            for delta in range(-window, window + 1):
                if delta == 0:
                    continue
                cand = list(cuts)
                cand[k] += delta
                if not (0 < cand[k] <= len(order) - 1):
                    continue
                if k > 0 and cand[k] <= cand[k - 1]:
                    continue
                if k < S - 2 and cand[k] >= cand[k + 1]:
                    continue
                if not feasible(cand):
                    continue
                b = cut_bytes(cand)
                if b < best:
                    best, cuts, improved = b, cand, True
        if not improved:
            break
    bounds = [0, *cuts, len(order)]
    return [order[bounds[k]:bounds[k + 1]] for k in range(S)]


def build_stage_plan(gg: GroupedGraph, strat: Strategy, topo: Topology,
                     *, n_micro: int = 4) -> StagePlan | None:
    """Cut ``gg`` at the strategy's PIPE boundaries into a StagePlan.

    Returns ``None`` when the strategy contains no multi-group PIPE
    action — the single-mesh lowering in ``core.plan`` stays in charge.
    """
    spine = pipeline_spine(strat, gg, topo)
    if spine is None:
        return None
    if gg.n < len(spine):               # degenerate: fewer op groups than
        spine = spine[:max(gg.n, 2)]    # stages — truncate the spine
        if len(spine) < 2:
            return None
    S = len(spine)
    # capacity-proportional flops targets per stage
    caps = [topo.groups[g].flops * topo.groups[g].num_gpus for g in spine]
    cap_tot = sum(caps) or 1.0

    pos = _group_topo_positions(gg)
    order = sorted(range(gg.n), key=lambda g: (pos[g], g))
    total_flops = sum(max(gg.groups[g].flops, 1.0) for g in order)

    # contiguous spans: stage s closes once its cumulative capacity share
    # is filled (or when the remaining stages need every remaining group)
    spans: list = [[] for _ in range(S)]
    acc, s = 0.0, 0
    for idx, g in enumerate(order):
        target = sum(caps[:s + 1]) / cap_tot * total_flops
        left = len(order) - idx
        if spans[s] and s < S - 1 and (acc >= target
                                       or left <= S - s - 1):
            s += 1
        spans[s].append(g)
        acc += max(gg.groups[g].flops, 1.0)
    if any(not span for span in spans):
        # capacity targets left a stage empty (tiny graphs): fall back to
        # contiguous near-equal-count chunks, preserving topo order
        spans = [[] for _ in range(S)]
        for i, g in enumerate(order):
            spans[min(i * S // len(order), S - 1)].append(g)
    spans = _refine_cuts(spans, order, gg, caps, cap_tot, total_flops)

    gid_stage = {g: si for si, span in enumerate(spans) for g in span}
    stages = []
    for si, span in enumerate(spans):
        # Boundary bytes = edges into the NEXT stage only. The flat
        # fwd+bwd trace contains long-range activation->backward edges
        # (a forward op early in topo order feeding a grad op late in
        # it); the execution engine rematerializes the stage forward
        # on-stage during backward, so those tensors never cross a
        # boundary at runtime — only the consecutive carry does.
        out_bytes = sum(
            b for (gi, gj), b in gg.edges.items()
            if gid_stage.get(gi) == si and gid_stage.get(gj, si) == si + 1)
        sync_votes: dict = {}
        for g in span:
            a = strat.actions[g]
            if a is None:
                continue
            mode = OPTION_SYNC.get(a.option)
            if mode is not None and gg.groups[g].has_grad:
                w = max(gg.groups[g].grad_bytes, 1.0)
                sync_votes[mode] = sync_votes.get(mode, 0.0) + w
        sync = max(sync_votes.items(), key=lambda kv: kv[1])[0] \
            if sync_votes else "allreduce"
        dg = topo.groups[spine[si]]
        stages.append(StageSpec(
            stage_id=si, device_group=spine[si], op_group_ids=span,
            flops=sum(gg.groups[g].flops for g in span),
            param_bytes=sum(gg.groups[g].param_bytes for g in span),
            grad_bytes=sum(gg.groups[g].grad_bytes for g in span),
            out_bytes=out_bytes, sync=sync, n_devices=dg.num_gpus,
            gpu_type=dg.gpu_type))
    return StagePlan(stages=stages, placement=spine, n_micro=n_micro,
                     topo_name=topo.name,
                     schedule=vote_schedule(strat, gg, spine),
                     meta={"n_groups": gg.n,
                           "pipe_groups": sum(
                               1 for a in strat.actions
                               if a is not None
                               and a.option == Option.PIPE)})
