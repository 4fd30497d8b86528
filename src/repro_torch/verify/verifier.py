"""Static plan verifier: orchestration over the four analyses.

Entry points, from narrowest to widest:

  * ``verify_schedule(order, n_stages, n_micro)`` — happens-before
    analysis of explicit event lists (deadlock, coverage, boundary
    matching, transfer races);
  * ``verify_stage_plan(plan, topo, ...)`` — a ``StagePlan`` about to
    execute: generates (or takes) its event lists and runs the
    happens-before, memory, collective and placement analyses.
    ``topo=None`` (preflight on a host that only has the plan) skips the
    topology-dependent halves;
  * ``verify_deployment(gg, strat, topo)`` — a searched ``Strategy`` as
    the planner service ships it: strategy-level structure checks, then
    the full stage-plan verification when the strategy pipelines.

Everything here is pure static analysis — no device, no jax, no
network; safe to run inside the planner's serving path and in CI.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.core.strategy import Option, Strategy
from repro_torch.exec.schedule import DEFAULT_CHUNKS, Event, make_schedule
from repro_torch.verify import collectives as collectives_mod
from repro_torch.verify import hb as hb_mod
from repro_torch.verify import memory as memory_mod
from repro_torch.verify import placement as placement_mod
from repro_torch.verify.diagnostics import Report

if TYPE_CHECKING:
    from repro_torch.core.device import Topology
    from repro_torch.core.graph import GroupedGraph
    from repro_torch.exec.stages import StagePlan


def verify_schedule(order: list[list[Event]], n_stages: int,
                    n_micro: int,
                    n_chunks: int | None = None) -> Report:
    """Happens-before verification of explicit schedule event lists."""
    return hb_mod.analyze_schedule(order, n_stages, n_micro,
                                   n_chunks=n_chunks)


def resolve_schedule_params(plan: "StagePlan",
                            schedule: str | None = None,
                            n_micro: int | None = None,
                            n_chunks: int | None = None
                            ) -> tuple[str, int, int, Report]:
    """Resolve the (schedule, n_micro, n_chunks) triple that would run.

    Normalized the same way the launcher normalizes it (interleaved
    needs ``n_micro % n_stages == 0``), with an info diagnostic when
    normalization changed the request.
    """
    rep = Report()
    sched = schedule or plan.schedule or "1f1b"
    m = int(n_micro if n_micro is not None else plan.n_micro)
    S = plan.n_stages
    if m < 1:
        rep.add("TAG002", f"n_micro {m} raised to 1 for verification")
        m = 1
    V = int(n_chunks) if n_chunks is not None \
        else (DEFAULT_CHUNKS if sched == "interleaved" else 1)
    if sched == "interleaved" and S >= 2 and m % S:
        fixed = max(S, (m // S) * S)
        rep.add("TAG002",
                f"interleaved needs n_micro % n_stages == 0: verifying "
                f"at n_micro={fixed} instead of {m} (the launcher "
                f"applies the same rounding)")
        m = fixed
    return sched, m, V, rep


def verify_stage_plan(plan: "StagePlan",
                      topo: "Topology | None" = None, *,
                      gg: "GroupedGraph | None" = None,
                      strat: Strategy | None = None,
                      schedule: str | None = None,
                      n_micro: int | None = None,
                      n_chunks: int | None = None,
                      order: list[list[Event]] | None = None,
                      engine: str = "eager") -> Report:
    """Full static verification of one executable stage plan.

    ``engine`` selects the memory-proof accounting: ``"eager"`` follows
    the schedule's peak stash, ``"scan"`` proves the compiled engine's
    all-microbatch stash plus double-buffered boundary stacks
    (``memory.engine_peak_stash``).
    """
    sched, m, V, rep = resolve_schedule_params(
        plan, schedule=schedule, n_micro=n_micro, n_chunks=n_chunks)
    if plan.n_stages < 1:
        rep.add("TAG001", "stage plan has no stages")
        return rep
    if order is None:
        try:
            order = make_schedule(sched, plan.n_stages, m, n_chunks=V)
        except ValueError as e:
            rep.add("TAG001",
                    f"cannot generate schedule {sched!r} for "
                    f"{plan.n_stages} stages x {m} microbatches: {e}")
            return rep
    rep.extend(hb_mod.analyze_schedule(order, plan.n_stages, m,
                                       n_chunks=V))
    positions = placement_mod.group_positions(gg) if gg is not None \
        else None
    rep.extend(placement_mod.analyze_placement(plan, topo,
                                               positions=positions,
                                               n_chunks=V))
    rep.extend(collectives_mod.analyze_collectives(plan, topo, gg=gg,
                                                   strat=strat))
    if topo is not None:
        rep.extend(memory_mod.analyze_memory(plan, topo, order, m,
                                             engine=engine))
    return rep


def _verify_strategy_structure(strat: Strategy,
                               topo: "Topology") -> Report:
    """Structure checks that apply with or without a pipeline.

    Placements must reference real device groups, and SFB (DUP) needs
    >= 2 devices to broadcast factors between.
    """
    rep = Report()
    for gid, a in enumerate(strat.actions):
        if a is None:
            continue
        bad = [g for g in a.placement if not (0 <= g < topo.m)]
        if bad:
            rep.add("TAG402",
                    f"op group {gid} placement {tuple(a.placement)} "
                    f"references device group(s) {bad} outside "
                    f"topology {topo.name or '?'} (0..{topo.m - 1})")
            continue
        if a.option is Option.DUP:
            ndev = sum(topo.groups[g].num_gpus for g in a.placement)
            if ndev <= 1:
                rep.add("TAG302",
                        f"op group {gid} chose SFB (DUP) on placement "
                        f"{tuple(a.placement)} with {ndev} total "
                        f"device(s): sufficient-factor broadcast needs "
                        f">= 2 participants")
    return rep


def verify_deployment(gg: "GroupedGraph", strat: Strategy,
                      topo: "Topology", *,
                      n_micro: int | None = None) -> Report:
    """Verify a searched strategy end to end.

    Strategy structure, and — when it pipelines — the lowered stage
    plan under its voted schedule. This is the check ``PlannerService``
    runs before caching and the ``repro-plan verify`` CLI renders.
    """
    rep = _verify_strategy_structure(strat, topo)
    if rep.errors():
        return rep          # a broken placement cannot be lowered
    if strat.has_pipeline():
        from repro_torch.exec.stages import build_stage_plan
        plan = build_stage_plan(gg, strat, topo,
                                n_micro=int(n_micro or 4))
        if plan is not None:
            rep.extend(verify_stage_plan(plan, topo, gg=gg, strat=strat))
    return rep


def verify_preflight(plan: "StagePlan",
                     order: list[list[Event]], n_micro: int, *,
                     n_chunks: int = 1,
                     device_counts: list[int] | None = None) -> Report:
    """Device-free preflight for the engine/launcher.

    Happens-before over the exact event lists about to execute, plus
    collective and structural checks from the plan alone (no topology
    on the host). ``device_counts`` are the per-stage device-set sizes
    the run will actually use (they override the plan's recorded
    topology counts).
    """
    rep = hb_mod.analyze_schedule(order, plan.n_stages, n_micro,
                                  n_chunks=n_chunks)
    rep.extend(placement_mod.analyze_placement(plan, None,
                                               n_chunks=n_chunks))
    rep.extend(collectives_mod.analyze_collectives(
        plan, None, device_counts=device_counts))
    return rep
