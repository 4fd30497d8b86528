"""Microbatch pipeline schedules as explicit event lists.

A schedule is, per physical stage, an ordered list of ``Event``s —
``F(s, m)`` (forward of microbatch ``m`` on stage ``s``), ``B(s, m)``
(backward), plus two extensions:

  * a ``chunk`` id for **interleaved (virtual-stage)** schedules: stage
    ``s`` hosts ``V`` model chunks, chunk ``v`` of stage ``s`` being
    virtual pipeline stage ``u = v * S + s`` (the Megatron-LM mapping).
    For ``V == 1`` everything degenerates to the plain schedules.
  * a ``W`` kind for **zero-bubble** schedules: the backward is split
    into the activation-gradient half ``B`` (on the cross-stage critical
    path) and the weight-gradient half ``W`` (local to the stage, free to
    slide into bubbles).

Four schedules are provided:

  * **GPipe**: all forwards, then all backwards. Stash peaks at
    ``n_micro`` per stage.
  * **1F1B** (PipeDream-flush): warm-up of ``min(S - s, M)`` forwards,
    then one-forward/one-backward, then drain. Stash peaks at
    ``min(S - s, M)``.
  * **Interleaved 1F1B** (Megatron virtual stages): each stage runs
    ``V`` chunks; warm-up ``min(2(S - s - 1) + (V - 1) S, M V)``
    virtual forwards with microbatch groups of size ``S`` (requires
    ``M % S == 0``). Warm-up/drain bubbles shrink by ``V`` at the cost
    of ``V``x the boundary transfers.
  * **Zero-bubble** (ZB-H1-style): 1F1B skeleton with the backward
    split; each drain gap is filled by a pending ``W``, and the
    cross-stage ``B`` chain is half as deep as a full backward — same
    activation stash as 1F1B (``W`` promptly releases the stash).

``simulate_schedule`` lowers a (StagePlan, schedule) pair onto a
``Topology`` as a dependency-driven timeline: per-stage serial execution
in schedule order, cross-(virtual-)stage activation / activation-grad
transfers serialized per directed link. The same timeline code is the
*predicted* side of the replay executor's cross-check (``exec.replay``),
the bubble-fraction source for the pipeline benchmark, and — via
``schedule_step_cost`` — the cost model MCTS uses to rank PIPE actions.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.device import Topology
from repro_torch.core.profiler import (
    allreduce_time, compute_time, ps_round_time, transfer_time)

if TYPE_CHECKING:
    from repro_torch.core.graph import GroupedGraph
    from repro_torch.core.simulator import SimResult
    from repro_torch.exec.stages import StagePlan

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb")

# fraction of a group's traced flops attributed to the forward pass (the
# training trace contains fwd+bwd; backward is ~2x forward for dense nets)
FWD_FRAC = 1.0 / 3.0

# zero-bubble split of the backward: activation-grad (B) vs weight-grad
# (W). For dense nets dgrad ~= wgrad ~= one forward each, so the split is
# even — F, B and W all cost ~1/3 of the traced fwd+bwd flops.
ZB_DGRAD_FRAC = 0.5

# default virtual-chunk count for interleaved schedules
DEFAULT_CHUNKS = 2

# a stage boundary's crossing bytes come from the fwd+bwd trace, so they
# cover BOTH directions: the F-edge carries the activation half, the
# B-edge the activation-grad half
BOUNDARY_DIR_FRAC = 0.5

# transfer/compute overlap models for the timeline simulator:
#   "link" — transfers serialize only per directed device-group link
#            (the legacy model; both stage rows keep computing)
#   "none" — the transfer ALSO occupies the destination stage row, the
#            way the eager engine's synchronous per-event ``device_put``
#            dispatch does
#   "full" — double-buffered boundaries: back-to-back transfers on the
#            same link form a stream, and only the first pays the wire
#            latency (the scan engine's bulk stacked transfer)
OVERLAP_MODES = ("link", "none", "full")


@dataclass(frozen=True)
class Event:
    """One schedule slot: kind F/B/W on (stage, microbatch, chunk)."""

    kind: str                 # "F" | "B" | "W"
    stage: int                # physical stage
    mb: int
    chunk: int = 0            # virtual chunk (interleaved); 0 otherwise

    def __repr__(self) -> str:
        c = f"c{self.chunk}" if self.chunk else ""
        return f"{self.kind}{self.stage}{c}.{self.mb}"


def gpipe_schedule(n_stages: int, n_micro: int) -> list[list[Event]]:
    """Per-stage issue order: F(0..M-1) then B(M-1..0)."""
    out: list[list[Event]] = []
    for s in range(n_stages):
        evs = [Event("F", s, m) for m in range(n_micro)]
        evs += [Event("B", s, m) for m in reversed(range(n_micro))]
        out.append(evs)
    return out


def one_f_one_b_schedule(n_stages: int,
                         n_micro: int) -> list[list[Event]]:
    """Per-stage issue order with warm-up ``min(S - s, M)`` forwards."""
    out: list[list[Event]] = []
    for s in range(n_stages):
        warm = min(n_stages - s, n_micro)
        evs = [Event("F", s, m) for m in range(warm)]
        nf, nb = warm, 0
        while nb < n_micro:
            evs.append(Event("B", s, nb))
            nb += 1
            if nf < n_micro:
                evs.append(Event("F", s, nf))
                nf += 1
        out.append(evs)
    return out


def interleaved_1f1b_schedule(
        n_stages: int, n_micro: int,
        n_chunks: int = DEFAULT_CHUNKS) -> list[list[Event]]:
    """Megatron-style interleaved 1F1B over virtual stages.

    Runs ``n_chunks`` virtual stages per physical stage.

    Virtual microbatches are issued in groups of ``S`` per chunk
    (forwards walk chunks 0..V-1, backwards V-1..0), which requires
    ``n_micro % n_stages == 0``. Warm-up is
    ``min(2 (S - s - 1) + (V - 1) S, M V)`` virtual forwards, then
    one-forward/one-backward, then drain.
    """
    S, M, V = n_stages, n_micro, n_chunks
    if V < 2:
        raise ValueError(f"interleaved needs n_chunks >= 2, got {V}")
    if S < 2:
        raise ValueError("interleaved needs n_stages >= 2")
    if M % S:
        raise ValueError(
            f"interleaved needs n_micro % n_stages == 0 "
            f"(got M={M}, S={S})")
    total = M * V

    def chunk_mb(k: int, forward: bool) -> tuple[int, int]:
        """Map virtual-microbatch index ``k`` to its (chunk, mb)."""
        c = (k % (S * V)) // S
        if not forward:
            c = V - 1 - c
        return c, (k // (S * V)) * S + k % S

    out: list[list[Event]] = []
    for s in range(S):
        warm = min(2 * (S - s - 1) + (V - 1) * S, total)
        evs: list[Event] = []
        for k in range(warm):
            c, mb = chunk_mb(k, True)
            evs.append(Event("F", s, mb, c))
        nf, nb = warm, 0
        while nf < total:
            c, mb = chunk_mb(nf, True)
            evs.append(Event("F", s, mb, c))
            nf += 1
            c, mb = chunk_mb(nb, False)
            evs.append(Event("B", s, mb, c))
            nb += 1
        while nb < total:
            c, mb = chunk_mb(nb, False)
            evs.append(Event("B", s, mb, c))
            nb += 1
        out.append(evs)
    return out


def zero_bubble_schedule(n_stages: int,
                         n_micro: int) -> list[list[Event]]:
    """ZB-H1-style split-backward schedule.

    The 1F1B skeleton with each backward split into ``B`` (activation
    grad, cross-stage dependency) and ``W`` (weight grad, stage-local).
    ``W(m)`` is issued promptly
    after ``B(m)`` — releasing the activation stash BEFORE the next
    forward acquires one, so peak stash stays exactly at 1F1B's
    ``min(S - s, M)`` bound — and in the drain phase it fills the gap
    while the stage waits for the next downstream ``B``.
    """
    S, M = n_stages, n_micro
    out: list[list[Event]] = []
    for s in range(S):
        warm = min(S - s, M)
        evs = [Event("F", s, m) for m in range(warm)]
        nf, nb, nw = warm, 0, 0
        while nb < M:
            evs.append(Event("B", s, nb))
            nb += 1
            evs.append(Event("W", s, nw))
            nw += 1
            if nf < M:
                evs.append(Event("F", s, nf))
                nf += 1
        out.append(evs)
    return out


def make_schedule(name: str, n_stages: int, n_micro: int, *,
                  n_chunks: int = DEFAULT_CHUNKS) -> list[list[Event]]:
    """Build the named schedule's per-stage event lists."""
    if name == "gpipe":
        return gpipe_schedule(n_stages, n_micro)
    if name == "1f1b":
        return one_f_one_b_schedule(n_stages, n_micro)
    if name == "interleaved":
        return interleaved_1f1b_schedule(n_stages, n_micro, n_chunks)
    if name == "zb":
        return zero_bubble_schedule(n_stages, n_micro)
    raise ValueError(f"unknown schedule {name!r} (use one of {SCHEDULES})")


def n_chunks_of(order: Sequence[Sequence[Event]]) -> int:
    """Virtual-chunk count of a schedule (1 for plain schedules)."""
    return max((e.chunk for evs in order for e in evs), default=0) + 1


def _dep_of(e: Event, n_stages: int, n_chunks: int) -> Event | None:
    """Cross-event dependency of ``e`` (None when only its own F).

    Virtual stage ``u = chunk * S + stage``: forwards chain up the
    virtual pipeline, backwards chain down it, ``W`` waits on its own
    ``B``.
    """
    S, U = n_stages, n_stages * n_chunks
    u = e.chunk * S + e.stage
    if e.kind == "F":
        if u == 0:
            return None
        p = u - 1
        return Event("F", p % S, e.mb, p // S)
    if e.kind == "B":
        if u == U - 1:
            return None                 # only its own F (checked separately)
        p = u + 1
        return Event("B", p % S, e.mb, p // S)
    return Event("B", e.stage, e.mb, e.chunk)       # "W"


def validate_schedule(order: list[list[Event]], n_stages: int,
                      n_micro: int) -> None:
    """Check schedule invariants; raises ``ValueError`` on violation.

      * every stage issues F and B of every (chunk, microbatch) exactly
        once (chunk count inferred from the events);
      * per stage, B(s, m, c) comes after F(s, m, c);
      * when a stage issues W events (zero-bubble), they cover the same
        (chunk, mb) set and W(s, m, c) comes after B(s, m, c);
      * a consistent global order exists: following per-stage order plus
        the cross-virtual-stage deps never deadlocks (no stage executes
        a microbatch before its predecessor produced it).
    """
    if len(order) != n_stages:
        raise ValueError(f"{len(order)} stage lists != {n_stages} stages")
    V = n_chunks_of(order)
    want = sorted((c, m) for c in range(V) for m in range(n_micro))
    for s, evs in enumerate(order):
        kinds = {e.kind for e in evs}
        for kind in ("F", "B") + (("W",) if "W" in kinds else ()):
            cms = sorted((e.chunk, e.mb) for e in evs if e.kind == kind)
            if cms != want:
                raise ValueError(f"stage {s}: {kind} covers {cms}")
        seen: dict[str, set[tuple[int, int]]] = {"F": set(),
                                                 "B": set()}
        for e in evs:
            if e.kind == "F":
                seen["F"].add((e.chunk, e.mb))
            elif e.kind == "B":
                if (e.chunk, e.mb) not in seen["F"]:
                    raise ValueError(
                        f"stage {s}: B before F for {(e.chunk, e.mb)}")
                seen["B"].add((e.chunk, e.mb))
            else:
                if (e.chunk, e.mb) not in seen["B"]:
                    raise ValueError(
                        f"stage {s}: W before B for {(e.chunk, e.mb)}")
    flatten_schedule(order, n_stages, n_micro)   # raises on deadlock


def flatten_schedule(order: list[list[Event]], n_stages: int,
                     n_micro: int) -> list[Event]:
    """Build a single dependency-consistent global issue order.

    The eager engine executes events in this order. Raises on deadlock.
    """
    del n_micro
    V = n_chunks_of(order)
    ptr = [0] * n_stages
    done: set[Event] = set()
    out: list[Event] = []
    total = sum(len(evs) for evs in order)
    while len(out) < total:
        progressed = False
        for s in range(n_stages):
            if ptr[s] >= len(order[s]):
                continue
            e = order[s][ptr[s]]
            dep = _dep_of(e, n_stages, V)
            need_f = Event("F", s, e.mb, e.chunk) if e.kind == "B" else None
            if (dep is None or dep in done) and \
                    (need_f is None or need_f in done):
                out.append(e)
                done.add(e)
                ptr[s] += 1
                progressed = True
        if not progressed:
            raise ValueError("schedule deadlocks: unsatisfiable order")
    return out


def peak_stash(order: "Sequence[Sequence[Event | TimedEvent]]"
               ) -> list[int]:
    """Per-stage peak number of in-flight forward activations (stash).

    The pipeline's activation-memory driver: GPipe peaks at n_micro,
    1F1B at min(S - s, M). A stash is released by the event that last
    consumes the stage input: ``W`` when the stage splits its backward
    (zero-bubble), else ``B``.
    """
    peaks: list[int] = []
    for evs in order:
        release = "W" if any(e.kind == "W" for e in evs) else "B"
        cur = peak = 0
        for e in evs:
            if e.kind == "F":
                cur += 1
            elif e.kind == release:
                cur -= 1
            peak = max(peak, cur)
        peaks.append(peak)
    return peaks


def max_feasible_micro(plan: "StagePlan", schedule: str, *,
                       mb_act_bytes: float | Sequence[float],
                       mem_budget: float | Sequence[float],
                       cap: int = 64,
                       n_chunks: int = DEFAULT_CHUNKS) -> int:
    """Largest microbatch count whose peak stash fits the memory budget.

    Evaluated per stage at a FIXED microbatch size. ``mb_act_bytes``
    and ``mem_budget`` are scalars (uniform across stages) or per-stage
    sequences. GPipe stashes all M microbatches, so its feasible M is
    memory-capped; 1F1B/zero-bubble stash is bounded by the stage depth
    regardless of M; interleaved stashes more warm-up activations (its
    M must also be a multiple of the stage count — other M are skipped
    as infeasible).
    """
    S = plan.n_stages
    acts = list(mb_act_bytes) if isinstance(mb_act_bytes, Sequence) \
        else [float(mb_act_bytes)] * S
    buds = list(mem_budget) if isinstance(mem_budget, Sequence) \
        else [float(mem_budget)] * S
    best = 0
    for m in range(1, cap + 1):
        try:
            order = make_schedule(schedule, S, m, n_chunks=n_chunks)
        except ValueError:
            continue
        peaks = peak_stash(order)
        if all(p * a <= b for p, a, b in zip(peaks, acts, buds)):
            best = m
    return best


# ----------------------------------------------------------- timeline

@dataclass
class TimedEvent:
    """A schedule event placed on the simulated clock."""

    kind: str                 # "F" | "B" | "W" | "X" (boundary transfer)
    stage: int                # executing stage (transfers: dst stage)
    mb: int
    start: float
    finish: float
    src: int = -1             # transfers: producing stage (F: stage-1,
    #                           B: stage+1); -1 for compute events
    chunk: int = 0
    nbytes: float = 0.0       # transfers: bytes on the wire

    @property
    def dur(self) -> float:
        """Event duration in simulated seconds."""
        return self.finish - self.start


@dataclass
class Timeline:
    """Simulated execution of one schedule: events plus summary stats."""

    events: list[TimedEvent]
    makespan: float
    stage_busy: list[float]              # compute seconds per stage
    n_stages: int
    n_micro: int
    n_chunks: int = 1
    meta: dict[str, object] = field(default_factory=dict)

    def bubble_fraction(self) -> float:
        """1 - busy/(S * makespan): the idle share of stage-seconds."""
        if self.makespan <= 0:
            return 0.0
        return 1.0 - sum(self.stage_busy) / (self.n_stages * self.makespan)

    def finish_of(self, kind: str, stage: int, mb: int,
                  chunk: int = 0) -> float:
        """Finish time of the matching event; raises ``KeyError``."""
        for e in self.events:
            if e.kind == kind and e.stage == stage and e.mb == mb \
                    and e.chunk == chunk:
                return e.finish
        raise KeyError((kind, stage, mb, chunk))


def _stage_speed(plan: "StagePlan", topo: Topology, s: int) -> float:
    dg = topo.groups[plan.stages[s].device_group]
    return dg.flops * max(dg.num_gpus, 1)


def boundary_bytes(plan: "StagePlan", u_lo: int,
                   n_micro: int) -> float:
    """Per-direction, per-microbatch bytes over boundary (u_lo, u_lo+1).

    Interior boundaries carry the traced stage-crossing activation;
    chunk-wrap boundaries (last physical stage back to the first,
    between chunks) are estimated as the mean interior crossing — the
    wrapped tensor is the same hidden-state carry, just not present in
    the unchunked trace.
    """
    S = plan.n_stages
    s = u_lo % S
    if s < S - 1:
        nb = plan.stages[s].out_bytes
    else:
        interior = [st.out_bytes for st in plan.stages[:-1]
                    if st.out_bytes > 0]
        nb = sum(interior) / len(interior) if interior else 0.0
    return nb * BOUNDARY_DIR_FRAC / max(n_micro, 1)


def simulate_schedule(plan: "StagePlan", topo: Topology,
                      order: list[list[Event]], *,
                      fwd_frac: float = FWD_FRAC,
                      overlap: str = "link") -> Timeline:
    """Dependency-driven timeline of a schedule on a topology.

    Per-stage compute is serial in the stage's issue order; forward of
    virtual stage u waits for virtual stage u-1's forward plus the
    boundary activation transfer; backward waits symmetrically on u+1
    plus the activation-grad transfer; W (zero-bubble weight grad) waits
    only on the stage's own B. Transfers serialize per directed
    (src, dst) device-group link, so a congested boundary link shows up
    as pipeline bubble exactly like on a real cluster. Interleaved
    chunks split each stage's compute by the chunk count and pay the
    extra chunk-boundary transfers.

    ``overlap`` picks the transfer/compute overlap model
    (``OVERLAP_MODES``): ``"link"`` (legacy) lets transfers overlap all
    compute and serialize only per directed link; ``"none"`` charges
    each transfer to the destination stage row as well, matching the
    eager engine's synchronous per-event ``device_put``; ``"full"``
    models double-buffered boundaries — a transfer departing while (or
    exactly when) its link is still streaming the previous one joins
    the stream and pays only the bandwidth term, not the wire latency.
    """
    if overlap not in OVERLAP_MODES:
        raise ValueError(
            f"unknown overlap mode {overlap!r} (use one of "
            f"{OVERLAP_MODES})")
    S = len(order)
    V = n_chunks_of(order)
    U = S * V
    M = max((e.mb for evs in order for e in evs), default=-1) + 1
    has_w = any(e.kind == "W" for evs in order for e in evs)
    fwd_t: list[float] = []
    bwd_t: list[float] = []
    for s in range(S):
        flops_m = plan.stages[s].flops / max(M, 1)
        speed = _stage_speed(plan, topo, s)
        fwd_t.append(compute_time(flops_m * fwd_frac, speed))
        bwd_t.append(compute_time(flops_m * (1.0 - fwd_frac), speed))

    def dur_of(e: Event) -> float:
        """Compute duration of one event on its stage."""
        if e.kind == "F":
            return fwd_t[e.stage] / V
        if e.kind == "W":
            return bwd_t[e.stage] / V * (1.0 - ZB_DGRAD_FRAC)
        return bwd_t[e.stage] / V * (ZB_DGRAD_FRAC if has_w else 1.0)

    def xfer_t(u_lo: int, src_stage: int, dst_stage: int,
               streamed: bool = False) -> tuple[float, float]:
        """(transfer seconds, bytes) across one virtual boundary."""
        gi = plan.stages[src_stage].device_group
        gj = plan.stages[dst_stage].device_group
        nb = boundary_bytes(plan, u_lo, M)
        if nb <= 0 or gi == gj:
            return 0.0, 0.0
        lat = 0.0 if streamed else topo.latency
        return transfer_time(nb, topo.bw(gi, gj), lat), nb

    # (kind, stage, mb, chunk) -> finish time
    finish: dict[tuple[str, int, int, int], float] = {}
    stage_free = [0.0] * S
    link_free: dict[tuple[int, int], float] = {}   # (src_g, dst_g) -> t
    busy = [0.0] * S
    events: list[TimedEvent] = []
    ptr = [0] * S

    def ready(e: Event) -> tuple[float | None, TimedEvent | None]:
        """(ready time, transfer TimedEvent|None) for event e."""
        u = e.chunk * S + e.stage
        if e.kind == "F":
            if u == 0:
                return 0.0, None
            p = u - 1
            key = ("F", p % S, e.mb, p // S)
        elif e.kind == "B":
            if u == U - 1:
                return finish.get(("F", e.stage, e.mb, e.chunk), 0.0), None
            p = u + 1
            key = ("B", p % S, e.mb, p // S)
        else:                                       # "W": own B, no transfer
            key = ("B", e.stage, e.mb, e.chunk)
            if key not in finish:
                return None, None
            return finish[key], None
        if key not in finish:
            return None, None
        t0 = finish[key]
        src = key[1]
        u_lo = min(u, p)
        gi = plan.stages[src].device_group
        gj = plan.stages[e.stage].device_group
        free = link_free.get((gi, gj), 0.0)
        # "full": joining a still-busy (or just-freed) link streams
        # behind the previous transfer — latency already paid once
        streamed = overlap == "full" and free > 0.0 and t0 <= free
        dur, nb = xfer_t(u_lo, src, e.stage, streamed=streamed)
        if dur <= 0:
            return t0, None
        s0 = max(t0, free)
        if overlap == "none":
            # eager engine: the synchronous device_put blocks the
            # destination stage's dispatch thread
            s0 = max(s0, stage_free[e.stage])
            stage_free[e.stage] = s0 + dur
        link_free[(gi, gj)] = s0 + dur
        return s0 + dur, TimedEvent("X", e.stage, e.mb, s0, s0 + dur,
                                    src=src, chunk=e.chunk, nbytes=nb)

    total = sum(len(evs) for evs in order)
    while len(finish) < total:
        progressed = False
        for s in range(S):
            if ptr[s] >= len(order[s]):
                continue
            e = order[s][ptr[s]]
            if e.kind == "B" and ("F", s, e.mb, e.chunk) not in finish:
                continue
            rt, xev = ready(e)
            if rt is None:
                continue
            if xev is not None:
                events.append(xev)
            t = dur_of(e)
            start = max(rt, stage_free[s])
            stage_free[s] = start + t
            busy[s] += t
            finish[(e.kind, s, e.mb, e.chunk)] = start + t
            events.append(TimedEvent(e.kind, s, e.mb, start, start + t,
                                     chunk=e.chunk))
            ptr[s] += 1
            progressed = True
        if not progressed:
            raise ValueError("schedule deadlocks on the timeline")
    makespan = max((e.finish for e in events), default=0.0)
    return Timeline(events=events, makespan=makespan, stage_busy=busy,
                    n_stages=S, n_micro=M, n_chunks=V,
                    meta={"fwd_t": fwd_t, "bwd_t": bwd_t,
                          "overlap": overlap})


# ------------------------------------------------ search-facing costing

def stage_sync_time(plan: "StagePlan", topo: Topology) -> float:
    """Worst per-stage gradient-sync time (collective after the flush).

    Stages sync on disjoint device groups, so they overlap — the
    slowest one bounds the step. SFB stages broadcast sufficient
    factors with the activations and recompute locally, so they add no
    post-flush sync.
    """
    worst = 0.0
    for st in plan.stages:
        if st.grad_bytes <= 0 or st.n_devices <= 1 or st.sync == "sfb":
            continue
        tau = topo.bottleneck_bw([st.device_group])
        if st.sync == "ps":
            t = ps_round_time(st.grad_bytes, st.n_devices, tau, topo.latency)
        else:
            t = allreduce_time(st.grad_bytes, st.n_devices, tau,
                               topo.latency)
        worst = max(worst, t)
    return worst


def schedule_step_cost(plan: "StagePlan", topo: Topology,
                       schedule: str, *, global_micro: int = 16,
                       n_chunks: int = DEFAULT_CHUNKS,
                       mb_act_bytes: Sequence[float] | None = None,
                       mem_budget: Sequence[float] | None = None,
                       include_sync: bool = True,
                       overlap: str = "full"
                       ) -> dict[str, object] | None:
    """Memory-capped effective per-global-batch cost of one schedule.

    The schedule runs at its largest feasible microbatch depth under the
    per-stage activation budget; shallower depths pay multiple pipeline
    flushes (``ceil(global_micro / m)``). Default budgets derive from
    the topology: per stage, group memory minus 4x resident parameters
    (param + grad + Adam moments); a stage whose parameters alone
    overflow is infeasible. Returns ``None`` when no microbatch depth
    fits, else a dict with ``n_micro/flushes/flush_time_s/step_time_s/
    bubble_frac/sync_time_s/timeline``.

    ``overlap`` is the transfer/compute overlap model the timeline runs
    under (``OVERLAP_MODES``). The default is ``"full"`` — the
    double-buffered streaming model of the compiled scan engine — so
    MCTS and the feedback loop rank strategies under the costing of the
    engine that actually executes them; pass ``"link"`` for the legacy
    per-link-serialization model.
    """
    S = plan.n_stages
    if mb_act_bytes is None:
        mb_act_bytes = [
            (plan.stages[s - 1].out_bytes if s else plan.stages[0].out_bytes)
            / max(global_micro, 1) for s in range(S)]
    if mem_budget is None:
        mem_budget = []
        for st in plan.stages:
            dg = topo.groups[st.device_group]
            free = (dg.mem_bytes - 4.0 * st.param_bytes) * max(dg.num_gpus, 1)
            mem_budget.append(free)
    if any(b <= 0 for b in mem_budget):
        return None
    m = max_feasible_micro(plan, schedule, mb_act_bytes=mb_act_bytes,
                           mem_budget=mem_budget, cap=global_micro,
                           n_chunks=n_chunks)
    if m <= 0:
        return None
    m = min(m, global_micro)
    flushes = -(-global_micro // m)
    order = make_schedule(schedule, S, m, n_chunks=n_chunks)
    tl = simulate_schedule(plan, topo, order, overlap=overlap)
    sync = stage_sync_time(plan, topo) if include_sync else 0.0
    return {"schedule": schedule, "n_micro": m, "flushes": flushes,
            "flush_time_s": tl.makespan,
            "step_time_s": flushes * tl.makespan + sync,
            "bubble_frac": tl.bubble_fraction(),
            "sync_time_s": sync, "timeline": tl}


def timeline_to_simresult(plan: "StagePlan", tl: Timeline,
                          topo: Topology,
                          gg: "GroupedGraph | None" = None, *,
                          flushes: int = 1,
                          sync_time: float = 0.0) -> "SimResult":
    """Project a schedule ``Timeline`` into the ``SimResult`` shape.

    The GNN featurization consumes it (runtime-feedback features part
    3), so schedule-aware MCTS evaluations feed the policy the same way
    FIFO evaluations do: per-device busy/idle, per-link busy, peak
    memory, and per-op-group start/finish mapped through the stage that
    hosts the group.
    """
    from repro_torch.core.simulator import SimResult

    step = flushes * tl.makespan + sync_time
    dev_busy: dict[int, float] = {}
    peak_mem: dict[int, float] = {}
    link_busy: dict[tuple[int, int], float] = {}
    order: list[list[TimedEvent]] = [[] for _ in range(tl.n_stages)]
    for e in tl.events:
        if e.kind == "X":
            gi = plan.stages[e.src].device_group
            gj = plan.stages[e.stage].device_group
            link_busy[(gi, gj)] = link_busy.get((gi, gj), 0.0) \
                + e.dur * flushes
        else:
            order[e.stage].append(e)
    base = [sum(topo.groups[k].num_gpus for k in range(g))
            for g in range(topo.m)]
    stash = peak_stash(order) if any(order) else [0] * tl.n_stages
    for si, st in enumerate(plan.stages):
        g = st.device_group
        dg = topo.groups[g]
        act = boundary_bytes(plan, si - 1 if si else si, tl.n_micro) \
            * 2.0 * stash[si]
        per_dev = 4.0 * st.param_bytes + act / max(dg.num_gpus, 1)
        for d in range(base[g], base[g] + dg.num_gpus):
            dev_busy[d] = tl.stage_busy[si] * flushes + sync_time
            peak_mem[d] = per_dev
    res = SimResult(makespan=step, feasible=True, task_start=[],
                    task_finish=[], device_busy=dev_busy,
                    peak_mem=peak_mem, link_busy=link_busy)
    if gg is not None:
        span: dict[int, tuple[float, float]] = {}
        for e in tl.events:
            if e.kind == "X":
                continue
            lo, hi = span.get(e.stage, (e.start, e.finish))
            span[e.stage] = (min(lo, e.start), max(hi, e.finish))
        for si, st in enumerate(plan.stages):
            lo, hi = span.get(si, (0.0, 0.0))
            for gid in st.op_group_ids:
                res.group_start[gid] = lo
                res.group_finish[gid] = hi
    return res
