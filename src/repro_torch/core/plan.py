"""Strategy -> execution plan (the hardware adaptation layer).

TAG strategies speak op-group placement on heterogeneous device groups.
This module lowers a searched Strategy into what a launcher consumes:

  * a logical-axis -> mesh-axis ``rules`` dict over the mesh's axis names
    (``repro.core.plan`` wraps the same dict in a jax ``AxisRules``),
  * per-group gradient-sync modes ("allreduce" | "ps" | "sfb") and the
    optimizer-state sharding choice (PS => ZeRO-style sharded moments),
  * the pipeline ``StagePlan`` when the strategy carries PIPE actions.

Mapping rules, as in ``repro``:
  * dominant option MP            -> tensor parallelism over "model"
  * AR / PS replication           -> data parallelism over "pod"+"data";
                                     PS additionally shards optimizer
                                     moments over "data" (ZeRO-1)
  * DUP (SFB)                     -> grad_sync "sfb" for the groups whose
                                     gradients the ILP duplicated
  * partial placement (subset of
    device groups)                -> smaller data-parallel degree: batch
                                     maps to "data" only (not "pod")

A rule naming an axis the mesh lacks shards nothing, so on one device
(axis names ``("data",)`` of size 1) the rules shard nothing.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from repro_torch.core.strategy import Option, Strategy


@dataclass
class ExecutionPlan:
    rules: dict                  # logical axis -> mesh axis (or tuple, or None)
    grad_sync: dict              # group prefix -> sync mode
    zero1: bool                  # shard optimizer moments over data axis
    summary: dict
    # Pipeline stage map when the strategy carries PIPE actions spanning
    # >= 2 device groups (repro_torch.exec.stages.StagePlan). None for pure
    # single-mesh plans.
    stage_plan: object | None = None

    @property
    def is_pipelined(self) -> bool:
        return self.stage_plan is not None


def lower_strategy(strat: Strategy, gg, topo, *, axis_names=("data",),
                   n_micro: int = 4) -> ExecutionPlan:
    opts = Counter(a.option for a in strat.actions if a is not None)
    n = max(sum(opts.values()), 1)
    placements = [a.placement for a in strat.actions if a is not None]
    full_m = topo.m
    partial = sum(1 for p in placements if len(p) < full_m) / max(
        len(placements), 1)

    multi = "pod" in axis_names
    batch_axes = ("pod", "data") if multi else ("data",)
    if partial > 0.5 and multi:
        batch_axes = ("data",)      # partial replication: keep DP inside pod

    rules = {
        "batch": batch_axes,
        "cache_seq": ("data",),
        "embed": None, "expert_embed": None, "layers": None, "seq": None,
        "q_heads": None, "kv_heads": None, "mlp": None, "experts": None,
        "vocab": None, "ssm_heads": None, "ssm_inner": None,
    }
    mp_frac = (opts.get(Option.MP, 0) + opts.get(Option.PIPE, 0)) / n
    if mp_frac > 0.1 or full_m == 1:
        for k in ("q_heads", "kv_heads", "mlp", "experts", "vocab",
                  "ssm_heads", "ssm_inner"):
            rules[k] = "model"

    grad_sync = {}
    zero1 = False
    for gid, a in enumerate(strat.actions):
        if a is None:
            continue
        if a.option == Option.PS:
            grad_sync[f"group{gid}"] = "ps"
            zero1 = True
        elif a.option == Option.DUP:
            grad_sync[f"group{gid}"] = "sfb"
        else:
            grad_sync[f"group{gid}"] = "allreduce"

    stage_plan = None
    if gg is not None and strat.has_pipeline():
        # lazy import: exec sits above core in the layering
        from repro_torch.exec.stages import build_stage_plan
        stage_plan = build_stage_plan(gg, strat, topo, n_micro=n_micro)

    return ExecutionPlan(
        rules=rules, grad_sync=grad_sync, zero1=zero1, stage_plan=stage_plan,
        summary={
            "options": {o.name: c for o, c in opts.items()},
            "partial_placement_frac": partial,
            "mp_frac": mp_frac,
            "pipe_frac": opts.get(Option.PIPE, 0) / n,
            "batch_axes": batch_axes,
            "n_stages": stage_plan.n_stages if stage_plan else 0,
        })
