"""Per-device memory-budget prover for pipelined deployments.

Mirrors the accounting the search itself uses (``schedule_step_cost`` /
``max_feasible_micro`` in ``exec.schedule``) so every plan the search
accepts proves clean, then turns the same inequality into a hard error
with the exact overshoot when it fails:

  resident per stage  =  4 x param_bytes x num_gpus
                         (param + grad + two Adam moments)
  stash per stage     =  peak_stash(order) x boundary activation bytes
                         per microbatch (the stage input the backward
                         rematerializes from, i.e. the boundary buffer)
  required            =  resident + stash  <=  mem_bytes x num_gpus

``peak_stash`` is the schedule-specific in-flight activation count
(GPipe: n_micro; 1F1B/zero-bubble: min(S - s, M); interleaved: the
deeper virtual warm-up), so the proof is per (plan, topology, schedule,
n_micro) — exactly the deployment that would run.

The proof is ALSO engine-specific (``engine=``): the eager engine
follows the schedule's ``peak_stash`` exactly, but the scan-rolled
engine (``exec.engine.CompiledPipelineRunner``) executes in dataflow
order and stashes ALL ``n_micro`` inputs per hosted virtual stage —
GPipe-like memory whatever the schedule family — plus one extra
``n_micro``-deep stacked boundary buffer per stage (the double-buffered
transfer: producer output and consumer copy coexist while the bulk
``device_put`` streams).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.exec.schedule import Event, n_chunks_of, peak_stash
from repro_torch.verify.diagnostics import Report

if TYPE_CHECKING:
    from repro_torch.core.device import Topology
    from repro_torch.exec.stages import StagePlan

# memory-pressure warn threshold: required / capacity above this emits
# TAG202 even though the budget technically holds
PRESSURE_WARN = 0.90


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TiB"


def stage_act_bytes(plan: "StagePlan", n_micro: int) -> list[float]:
    """Per-stage, per-microbatch boundary activation bytes.

    Each stage stashes its input — the previous stage's crossing bytes;
    stage 0 stashes its own microbatch input, approximated by its out
    edge as in ``schedule_step_cost``.
    """
    S = plan.n_stages
    return [
        (plan.stages[s - 1].out_bytes if s else plan.stages[0].out_bytes)
        / max(n_micro, 1) for s in range(S)]


def engine_peak_stash(order: list[list[Event]], n_micro: int,
                      engine: str = "eager") -> list[int]:
    """Per-stage peak stash count under the executing engine.

    ``"eager"`` follows the schedule (``peak_stash``). ``"scan"`` is the
    compiled engine's dataflow execution: every hosted virtual chunk
    stashes all ``n_micro`` inputs, plus one ``n_micro``-deep stacked
    boundary double-buffer per stage.
    """
    if engine == "eager":
        return peak_stash(order)
    if engine == "scan":
        V = n_chunks_of(order)
        return [n_micro * V + n_micro for _ in order]
    raise ValueError(f"unknown engine {engine!r} (use 'eager' or 'scan')")


def analyze_memory(plan: "StagePlan", topo: "Topology",
                   order: list[list[Event]], n_micro: int, *,
                   engine: str = "eager") -> Report:
    """Prove every stage's device group fits its peak working set.

    Residents (params, grads, optimizer state) plus the engine's peak
    activation stash under this schedule (TAG201/TAG202).
    """
    rep = Report()
    peaks = engine_peak_stash(order, n_micro, engine)
    acts = stage_act_bytes(plan, n_micro)
    for s, st in enumerate(plan.stages):
        if not (0 <= st.device_group < topo.m):
            continue                     # placement analysis owns this
        dg = topo.groups[st.device_group]
        ngpu = max(dg.num_gpus, 1)
        capacity = dg.mem_bytes * ngpu
        resident = 4.0 * st.param_bytes * ngpu
        stash = float(peaks[s]) * acts[s] if s < len(peaks) else 0.0
        required = resident + stash
        if capacity <= 0:
            rep.add("TAG201",
                    f"stage {s} on device group {st.device_group} "
                    f"({dg.gpu_type or 'unknown'} x{ngpu}) has no "
                    f"memory capacity recorded", stage=s)
            continue
        if required > capacity:
            over = required - capacity
            rep.add("TAG201",
                    f"stage {s} on device group {st.device_group} "
                    f"({dg.gpu_type or 'unknown'} x{ngpu}) needs "
                    f"{_fmt_bytes(required)} "
                    f"({_fmt_bytes(resident)} params+opt, "
                    f"{peaks[s]} stashed activations x "
                    f"{_fmt_bytes(acts[s])}) but has "
                    f"{_fmt_bytes(capacity)}: OOM by "
                    f"{_fmt_bytes(over)}", stage=s)
        elif required > PRESSURE_WARN * capacity:
            rep.add("TAG202",
                    f"stage {s} on device group {st.device_group} uses "
                    f"{100.0 * required / capacity:.1f}% of "
                    f"{_fmt_bytes(capacity)} "
                    f"(>{PRESSURE_WARN:.0%} threshold)", stage=s)
    return rep
