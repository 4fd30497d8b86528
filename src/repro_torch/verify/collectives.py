"""Collective-matching checks for gradient synchronization.

Every stage of a ``StagePlan`` carries one gradient-sync mode
(``allreduce`` | ``ps`` | ``sfb``, the §4.2.3 ILP decisions routed to
the engine). These checks prove the collectives are well-formed before
anything runs:

  * the mode is one the runtime implements (TAG301);
  * SFB (sufficient-factor broadcast) requires >= 2 participants — on a
    single device there is nobody to broadcast factors to, and the
    engine's gather-recompute would silently degenerate (TAG302);
  * the op groups folded into a stage voted for the mode coherently
    (TAG303 when votes were mixed) and actually placed themselves on
    the device group that will run the collective (TAG305 when the
    searched placement drifted — legal, ``build_stage_plan`` routes
    spillover groups onto spine stages, but worth surfacing);
  * degenerate lints: a sync over one device is a no-op (TAG304), and a
    parameter-server round whose per-device shard is tiny spends its
    time on latency, not bandwidth (TAG306).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

from repro_torch.core.strategy import Option, Strategy
from repro_torch.exec.stages import OPTION_SYNC
from repro_torch.parallel.sfb_dense import SYNC_MODES
from repro_torch.verify.diagnostics import Report

if TYPE_CHECKING:
    from repro_torch.core.device import Topology
    from repro_torch.core.graph import GroupedGraph
    from repro_torch.exec.stages import StagePlan

# PS shards whose per-device slice is below this are pure latency
TINY_SHARD_BYTES = 4096.0


def _stage_ndev(plan: "StagePlan", s: int, topo: "Topology | None",
                device_counts: Sequence[int] | None) -> int:
    if device_counts is not None and s < len(device_counts):
        return max(int(device_counts[s]), 1)
    st = plan.stages[s]
    if topo is not None and 0 <= st.device_group < topo.m:
        return max(int(topo.groups[st.device_group].num_gpus), 1)
    return max(int(st.n_devices), 1)


def analyze_collectives(plan: "StagePlan", topo: "Topology | None" = None,
                        gg: "GroupedGraph | None" = None,
                        strat: Strategy | None = None,
                        device_counts: Sequence[int] | None = None
                        ) -> Report:
    """Lint every stage's gradient-sync collective (TAG301-TAG306)."""
    rep = Report()
    for s, st in enumerate(plan.stages):
        ndev = _stage_ndev(plan, s, topo, device_counts)
        if st.sync not in SYNC_MODES:
            rep.add("TAG301",
                    f"stage {s} requests sync mode {st.sync!r}; the "
                    f"runtime implements {SYNC_MODES}", stage=s)
            continue
        if st.sync == "sfb" and ndev <= 1:
            rep.add("TAG302",
                    f"stage {s} requests SFB gradient sync on device "
                    f"group {st.device_group} with {ndev} device: "
                    f"sufficient-factor broadcast needs >= 2 "
                    f"participants", stage=s)
        elif ndev <= 1 and st.grad_bytes > 0:
            rep.add("TAG304",
                    f"stage {s} {st.sync} sync over a single device is "
                    f"a no-op collective", stage=s)
        if st.sync == "ps" and ndev > 1 and st.grad_bytes > 0:
            shard = st.grad_bytes / ndev
            if shard < TINY_SHARD_BYTES:
                rep.add("TAG306",
                        f"stage {s} PS round moves only {shard:.0f}B "
                        f"per device shard ({st.grad_bytes:.0f}B over "
                        f"{ndev} devices): latency-bound degenerate "
                        f"split", stage=s)
    if gg is not None and strat is not None:
        _check_votes(plan, gg, strat, rep)
    return rep


def _check_votes(plan: "StagePlan", gg: "GroupedGraph",
                 strat: Strategy, rep: Report) -> None:
    """Cross-check each stage's mode against its members' searched actions.

    Flags mixed sync votes (TAG303) and placement drift (TAG305).
    """
    for s, st in enumerate(plan.stages):
        modes: set[str] = set()
        drifted: list[int] = []
        for gid in st.op_group_ids:
            if not (0 <= gid < len(strat.actions)):
                continue
            a = strat.actions[gid]
            if a is None:
                continue
            mode = OPTION_SYNC.get(a.option)
            if mode is not None and gid < len(gg.groups) \
                    and gg.groups[gid].has_grad:
                modes.add(mode)
            if a.option is not Option.PIPE and a.placement \
                    and st.device_group not in a.placement:
                drifted.append(gid)
        if len(modes) > 1:
            rep.add("TAG303",
                    f"stage {s} resolves sync {st.sync!r} from mixed "
                    f"member votes {sorted(modes)}: the losing groups' "
                    f"gradients sync under a mode they did not choose",
                    stage=s)
        if drifted:
            rep.add("TAG305",
                    f"stage {s} (device group {st.device_group}) hosts "
                    f"{len(drifted)} op group(s) (e.g. {drifted[:3]}) "
                    f"whose searched placement does not include that "
                    f"group: sync participants drift from the searched "
                    f"deployment", stage=s)
