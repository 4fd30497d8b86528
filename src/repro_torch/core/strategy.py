"""Deployment strategies (paper §4.2).

A strategy assigns every op group a placement row P_i over device groups
and one of the four replication options O_i:
  AR  — replicate with AllReduce gradient sync
  PS  — replicate with parameter-server sync (round-robin shard owners)
  DUP — duplicate: inputs broadcast, identical compute on every device
        (this is how SFB manifests: broadcast sufficient factors,
        recompute gradients locally — no sync op)
  MP  — model parallelism: ops split across the devices of the group
"""
from __future__ import annotations

from dataclasses import dataclass
import enum
import json

from repro_torch.core.device import Topology


class Option(enum.IntEnum):
    AR = 0
    PS = 1
    DUP = 2
    MP = 3
    PIPE = 4   # beyond-paper: the paper's stated future work (§6) —
               # pipeline the group's stages across devices w/ microbatches


# microbatch schedules the search may attach to a PIPE action (GPipe is
# excluded: it is dominated by 1F1B on both bubble and stash, so offering
# it only widens the branching factor; it stays reachable via --pipeline)
PIPE_SEARCH_SCHEDULES = ("1f1b", "interleaved", "zb")


@dataclass(frozen=True)
class Action:
    """Deployment of one op group: device groups + replication option.

    PIPE actions additionally carry the microbatch ``schedule`` the
    pipeline should run ("gpipe" | "1f1b" | "interleaved" | "zb") — the
    schedule-aware search costs each choice with the schedule timeline
    simulator. Empty string = not applicable / legacy default (1F1B).
    """
    placement: tuple          # sorted tuple of device-group ids
    option: Option
    schedule: str = ""        # PIPE only; "" elsewhere

    def __repr__(self):
        tail = f":{self.schedule}" if self.schedule else ""
        return (f"<{self.option.name}{tail}"
                f"@{','.join(map(str, self.placement))}>")

    def to_dict(self) -> dict:
        d = {"placement": [int(g) for g in self.placement],
             "option": self.option.name}
        if self.schedule:
            d["schedule"] = self.schedule   # omitted when unset, so plans
            #                                 stored before the field keep
            #                                 a byte-identical canonical form
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Action":
        return cls(placement=tuple(int(g) for g in d["placement"]),
                   option=Option[d["option"]],
                   schedule=d.get("schedule", ""))


@dataclass
class Strategy:
    actions: list             # index = group id; None = undecided

    @classmethod
    def empty(cls, n_groups: int) -> "Strategy":
        return cls(actions=[None] * n_groups)

    def with_action(self, gid: int, action: Action) -> "Strategy":
        acts = list(self.actions)
        acts[gid] = action
        return Strategy(acts)

    @property
    def n_decided(self):
        return sum(a is not None for a in self.actions)

    def complete(self):
        return all(a is not None for a in self.actions)

    def fill_undecided(self, default: Action) -> "Strategy":
        """Paper footnote 2: undecided groups take the strategy of the most
        expensive decided group (the default here)."""
        return Strategy([a if a is not None else default
                         for a in self.actions])

    # -- serialization (plan store schema) --------------------------------
    def to_dict(self) -> dict:
        return {"actions": [a.to_dict() if a is not None else None
                            for a in self.actions]}

    @classmethod
    def from_dict(cls, d: dict) -> "Strategy":
        return cls([Action.from_dict(a) if a is not None else None
                    for a in d["actions"]])

    def canonical_json(self) -> str:
        """Deterministic byte representation (cache identity checks)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def pipe_actions(self) -> list:
        """[(gid, action)] for groups the strategy pipelines across >= 2
        device groups — the ones ``repro.exec.stages`` cuts stages at."""
        return [(gid, a) for gid, a in enumerate(self.actions)
                if a is not None and a.option == Option.PIPE
                and len(a.placement) >= 2]

    def has_pipeline(self) -> bool:
        """True when a real multi-stage execution path exists (any PIPE
        action spanning more than one device group)."""
        return bool(self.pipe_actions())


def data_parallel_all(topo: Topology, option: Option = Option.AR) -> Action:
    """The DP baseline action: replicate on every device group."""
    return Action(tuple(range(topo.m)), option)


def candidate_actions(topo: Topology, *, has_grad: bool,
                      max_actions: int = 128) -> list:
    """Enumerate the candidate deployments for one op group.

    The raw space (2^M - 1 placements x 4 options) is intractable for MCTS
    branching; following the paper's device-group abstraction we enumerate:
    each single device group, each same-GPU-type set, the fastest-k
    prefixes, and all groups.
    """
    m = topo.m
    placements: list = []
    if m > 1:
        placements.append(tuple(range(m)))   # DP-all first (never truncated)
    for g in range(m):
        placements.append((g,))
    by_type: dict = {}
    for g, dg in enumerate(topo.groups):
        by_type.setdefault(dg.gpu_type, []).append(g)
    for gs in by_type.values():
        if len(gs) > 1:
            placements.append(tuple(sorted(gs)))
    order = sorted(range(m), key=lambda g: -(topo.groups[g].flops
                                             * topo.groups[g].num_gpus))
    for k in range(2, m):
        placements.append(tuple(sorted(order[:k])))
    if m > 1:
        placements.append(tuple(range(m)))
    # dedupe, preserve order
    seen, uniq = set(), []
    for p in placements:
        if p not in seen:
            seen.add(p)
            uniq.append(p)

    actions = []
    for p in uniq:
        n_dev = sum(topo.groups[g].num_gpus for g in p)
        opts = [Option.AR, Option.PS] if (has_grad and n_dev > 1) \
            else [Option.AR]
        if has_grad and n_dev > 1:
            opts.append(Option.DUP)
        if n_dev > 1:
            opts.append(Option.MP)
        for o in opts:
            actions.append(Action(p, o))
        if n_dev > 1 and len(p) > 1:
            # one PIPE variant per searchable schedule: the schedule-aware
            # evaluator ranks them by bubble fraction + boundary transfers
            for sched in PIPE_SEARCH_SCHEDULES:
                actions.append(Action(p, Option.PIPE, schedule=sched))
    return actions[:max_actions]


def canonical_strategies(n_groups: int, topo: Topology) -> list:
    """Well-known strategy families inside TAG's space: DP-AR/PS over all
    devices, each GPU type alone (AR/PS), and the fastest-half prefix.
    Used as warm-start candidates (benchmarks) and as re-search seeds when
    the runtime feedback loop recalibrates the cost model — a drifted
    cluster can move the optimum far from the cached plan."""
    out = [Strategy([data_parallel_all(topo, o)] * n_groups)
           for o in (Option.AR, Option.PS)]
    by_type: dict = {}
    for g, dg in enumerate(topo.groups):
        by_type.setdefault(dg.gpu_type, []).append(g)
    order = sorted(range(topo.m),
                   key=lambda g: -(topo.groups[g].flops
                                   * topo.groups[g].num_gpus))
    subsets = [tuple(sorted(v)) for v in by_type.values()]
    subsets.append(tuple(sorted(order[:max(1, topo.m // 2)])))
    for p in subsets:
        for o in (Option.AR, Option.PS):
            out.append(Strategy([Action(p, o)] * n_groups))
    return out


def devices_of(topo: Topology, placement) -> list:
    """Flat device ids for a placement (group-major)."""
    out = []
    for g in placement:
        base = sum(topo.groups[k].num_gpus for k in range(g))
        out.extend(range(base, base + topo.groups[g].num_gpus))
    return out


def device_group_of(topo: Topology, dev: int) -> int:
    acc = 0
    for g, dg in enumerate(topo.groups):
        acc += dg.num_gpus
        if dev < acc:
            return g
    raise ValueError(dev)
