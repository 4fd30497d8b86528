"""Mutation-based self-test of the static plan verifier.

Soundness gate: inject one known violation at a time into an otherwise
clean deployment — dropped/duplicated events, swapped dependencies that
deadlock, consumer-side reorders that race, shrunk device memory,
mismatched or degenerate collectives, broken placements — and require
the verifier to flag every injected class with its designated
``TAGxxx`` code, across all four schedule families. ``run_selftest``
is wired into CI (``repro-plan verify --selftest``) so the analyses
cannot silently rot as schedules evolve.

Every mutation is a pure function on a deep-copied ``MutationContext``,
so the harness is deterministic and order-independent.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.device import DeviceGroup, Topology, _full_inter
from repro_torch.exec.schedule import SCHEDULES, Event, make_schedule
from repro_torch.exec.stages import StagePlan, StageSpec
from repro_torch.verify import collectives as collectives_mod
from repro_torch.verify import hb as hb_mod
from repro_torch.verify import memory as memory_mod
from repro_torch.verify import placement as placement_mod
from repro_torch.verify.diagnostics import Report


@dataclass
class MutationContext:
    """Everything one verification pass consumes, mutable in place."""

    plan: StagePlan
    topo: Topology
    order: list[list[Event]]
    schedule: str
    n_micro: int
    n_chunks: int
    # synthetic topological positions (stand-in for a traced graph's
    # ``group_positions``) so the contiguity analysis runs without jax
    positions: dict[int, float] = field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        """Stage count of the context's plan."""
        return self.plan.n_stages


@dataclass(frozen=True)
class Mutation:
    """One seeded violation: a mutator plus the codes it must trigger."""

    name: str
    klass: str                 # violation class (acceptance taxonomy)
    expect: tuple[str, ...]    # every listed code must be reported
    apply: Callable[[MutationContext], bool]   # False: not applicable


def make_context(schedule: str, *, n_stages: int = 4, n_micro: int = 8,
                 n_chunks: int = 2) -> MutationContext:
    """Build a small, clean, fully synthetic deployment.

    ``n_stages`` stages over a homogeneous V100 topology, modest
    tensors, well inside every budget — the verifier must report zero
    errors on it.
    """
    gbps = 1e9 / 8
    groups = [DeviceGroup(g, "V100", 2, intra_bw=300 * gbps)
              for g in range(n_stages)]
    topo = Topology(groups, _full_inter(n_stages, 100 * gbps),
                    name="selftest")
    stages = []
    for s in range(n_stages):
        stages.append(StageSpec(
            stage_id=s, device_group=s, op_group_ids=[2 * s, 2 * s + 1],
            flops=1e12, param_bytes=64e6, grad_bytes=64e6,
            out_bytes=8e6 if s < n_stages - 1 else 0.0,
            sync="allreduce", n_devices=2, gpu_type="V100"))
    plan = StagePlan(stages=stages, placement=tuple(range(n_stages)),
                     n_micro=n_micro, topo_name="selftest",
                     schedule=schedule)
    V = n_chunks if schedule == "interleaved" else 1
    order = make_schedule(schedule, n_stages, n_micro, n_chunks=V)
    positions = {gid: float(gid) for st in stages
                 for gid in st.op_group_ids}
    return MutationContext(plan=plan, topo=topo, order=order,
                           schedule=schedule, n_micro=n_micro,
                           n_chunks=V, positions=positions)


def verify_context(ctx: MutationContext) -> Report:
    """The full four-analysis pass over a (possibly mutated) context."""
    rep = hb_mod.analyze_schedule(ctx.order, ctx.n_stages, ctx.n_micro,
                                  n_chunks=ctx.n_chunks)
    rep.extend(placement_mod.analyze_placement(
        ctx.plan, ctx.topo, positions=ctx.positions or None,
        n_chunks=ctx.n_chunks))
    rep.extend(collectives_mod.analyze_collectives(ctx.plan, ctx.topo))
    rep.extend(memory_mod.analyze_memory(ctx.plan, ctx.topo, ctx.order,
                                         ctx.n_micro))
    return rep


# ------------------------------------------------------------ mutators

def _mid_stage(ctx: MutationContext) -> int:
    return ctx.n_stages // 2


def _drop_event(ctx: MutationContext) -> bool:
    """Remove one backward from a middle stage.

    Creates a coverage hole and an unmatched boundary recv downstream.
    """
    s = _mid_stage(ctx)
    evs = ctx.order[s]
    idx = next((i for i, e in enumerate(evs) if e.kind == "B"), None)
    if idx is None:
        return False
    del evs[idx]
    return True


def _duplicate_event(ctx: MutationContext) -> bool:
    """Issue one forward twice on the same stage."""
    s = _mid_stage(ctx)
    evs = ctx.order[s]
    idx = next((i for i, e in enumerate(evs) if e.kind == "F"), None)
    if idx is None:
        return False
    evs.insert(idx + 1, evs[idx])
    return True


def _swap_dependency_deadlock(ctx: MutationContext) -> bool:
    """Move stage 0's last forward behind its own backward chain.

    The downstream stages' forwards now wait on an event that waits
    (through the backward chain) on them — a pure happens-before cycle.
    """
    if ctx.n_stages < 2:
        return False
    evs = ctx.order[0]
    idx = max(i for i, e in enumerate(evs) if e.kind == "F")
    evs.append(evs.pop(idx))
    return True


def _reorder_transfer_race(ctx: MutationContext) -> bool:
    """Swap the last stage's first two forward arrivals (chunk 0).

    The producer still emits mb 0 then 1, the consumer now awaits 1
    then 0 — reordered traffic on a FIFO boundary link.
    """
    if ctx.n_stages < 2:
        return False
    evs = ctx.order[ctx.n_stages - 1]
    f_idx = [i for i, e in enumerate(evs)
             if e.kind == "F" and e.chunk == 0]
    if len(f_idx) < 2:
        return False
    i, j = f_idx[0], f_idx[1]
    evs[i], evs[j] = evs[j], evs[i]
    return True


def _w_before_b(ctx: MutationContext) -> bool:
    """Hoist a weight-grad above the backward it consumes (zb only)."""
    for evs in ctx.order:
        wi = next((i for i, e in enumerate(evs) if e.kind == "W"), None)
        if wi is None:
            continue
        w = evs.pop(wi)
        bi = next(i for i, e in enumerate(evs)
                  if e.kind == "B" and e.mb == w.mb
                  and e.chunk == w.chunk)
        evs.insert(bi, w)
        return True
    return False


def _shrink_memory(ctx: MutationContext) -> bool:
    """Shrink a stage's device memory below its parameter residents."""
    g = ctx.plan.stages[0].device_group
    ctx.topo.groups[g].mem_bytes = 2.0 * ctx.plan.stages[0].param_bytes
    return True


def _sfb_on_singleton(ctx: MutationContext) -> bool:
    """Demand SFB sync on a group shrunk to one device."""
    st = ctx.plan.stages[0]
    ctx.topo.groups[st.device_group].num_gpus = 1
    st.n_devices = 1
    st.sync = "sfb"
    return True


def _unknown_sync(ctx: MutationContext) -> bool:
    ctx.plan.stages[_mid_stage(ctx)].sync = "ring-exchange"
    return True


def _invalid_device_group(ctx: MutationContext) -> bool:
    ctx.plan.stages[_mid_stage(ctx)].device_group = ctx.topo.m + 7
    return True


def _capacity_mismatch(ctx: MutationContext) -> bool:
    ctx.plan.stages[_mid_stage(ctx)].n_devices += 5
    return True


def _non_contiguous_span(ctx: MutationContext) -> bool:
    """Swap an op group between the first and last stages.

    Both spans now straddle each other in topological order.
    """
    if ctx.n_stages < 2:
        return False
    a, b = ctx.plan.stages[0], ctx.plan.stages[-1]
    if not a.op_group_ids or not b.op_group_ids:
        return False
    a.op_group_ids[0], b.op_group_ids[-1] = (b.op_group_ids[-1],
                                             a.op_group_ids[0])
    return True


def _unreachable_link(ctx: MutationContext) -> bool:
    """Calibrate the first boundary's link down to zero bandwidth."""
    if ctx.n_stages < 2 or ctx.plan.stages[0].out_bytes <= 0:
        return False
    gi = ctx.plan.stages[0].device_group
    gj = ctx.plan.stages[1].device_group
    ctx.topo.pair_eff[(gi, gj)] = 0.0
    ctx.topo.pair_eff[(gj, gi)] = 0.0
    return True


MUTATIONS: tuple[Mutation, ...] = (
    Mutation("drop_event", "dropped", ("TAG104", "TAG106"), _drop_event),
    Mutation("duplicate_event", "dropped", ("TAG105",),
             _duplicate_event),
    Mutation("swap_dependency_deadlock", "deadlock", ("TAG101",),
             _swap_dependency_deadlock),
    Mutation("reorder_transfer_race", "race", ("TAG107",),
             _reorder_transfer_race),
    Mutation("w_before_b", "deadlock", ("TAG103",), _w_before_b),
    Mutation("shrink_memory", "oom", ("TAG201",), _shrink_memory),
    Mutation("sfb_on_singleton", "collective", ("TAG302",),
             _sfb_on_singleton),
    Mutation("unknown_sync", "collective", ("TAG301",), _unknown_sync),
    Mutation("invalid_device_group", "placement", ("TAG402",),
             _invalid_device_group),
    Mutation("capacity_mismatch", "placement", ("TAG403",),
             _capacity_mismatch),
    Mutation("non_contiguous_span", "placement", ("TAG401",),
             _non_contiguous_span),
    Mutation("unreachable_link", "placement", ("TAG404",),
             _unreachable_link),
)


def run_selftest(*, schedules: tuple[str, ...] = SCHEDULES,
                 n_stages: int = 4, n_micro: int = 8
                 ) -> dict[str, object]:
    """Run every mutation against every schedule family.

    Returns a summary dict; ``ok`` is True iff every clean baseline
    verified with zero errors AND every applicable mutation was caught
    with every expected code. ``missed`` lists failures as
    ``{schedule, mutation, expected, got}``.
    """
    missed: list[dict[str, object]] = []
    ran = caught = 0
    clean_ok = True
    for sched in schedules:
        base = make_context(sched, n_stages=n_stages, n_micro=n_micro)
        base_rep = verify_context(base)
        if not base_rep.ok:
            clean_ok = False
            missed.append({"schedule": sched, "mutation": "<clean>",
                           "expected": [],
                           "got": sorted(base_rep.codes())})
        for mut in MUTATIONS:
            ctx = copy.deepcopy(base)
            if not mut.apply(ctx):
                continue                  # not applicable to this family
            ran += 1
            rep = verify_context(ctx)
            if rep.has(*mut.expect):
                caught += 1
            else:
                missed.append({"schedule": sched, "mutation": mut.name,
                               "expected": list(mut.expect),
                               "got": sorted(rep.codes())})
    return {"schedules": list(schedules), "mutations_run": ran,
            "caught": caught, "missed": missed,
            "clean_baselines_ok": clean_ok,
            "ok": clean_ok and not missed}
