"""Compiler (paper §4.3.1): apply a deployment strategy to the grouped
computation graph, inserting the auxiliary ops that keep the deployed
graph mathematically equivalent to the original:

  * producer replicated, consumer not   -> Concat (CONCAT splittables) or
                                           AddN (SUM splittables) gathers
  * consumer replicated, producer not   -> Split (batch-dim scatter)
  * replica counts differ               -> Concat + Split (re-shard)
  * replicated parameter, option AR/PS  -> AllReduce / sharded-PS sync task
  * option DUP                          -> inputs broadcast to every copy,
                                           no sync (SFB semantics)

Output is a TaskGraph for the discrete-event simulator. Transfers carry
the exact byte fractions implied by the split/concat insertions, so the
simulator charges the same traffic the rewritten graph would move.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.device import Topology
from repro_torch.core.graph import GroupedGraph, Split
from repro_torch.core.strategy import Action, Option, Strategy, devices_of


@dataclass
class Task:
    tid: int
    kind: str                 # compute | xfer | allreduce | ps
    group: int                # op-group id (-1 for sync/aux)
    device: int = -1          # compute: flat device id
    flops: float = 0.0
    src: int = -1             # xfer: source device
    dst: int = -1
    nbytes: float = 0.0
    devices: tuple = ()       # collectives: participating devices
    deps: list = field(default_factory=list)
    label: str = ""


@dataclass
class Replica:
    device: int
    frac: float               # batch fraction processed by this replica
    task: int                 # compute task id


@dataclass
class TaskGraph:
    tasks: list = field(default_factory=list)
    replicas: dict = field(default_factory=dict)   # gid -> list[Replica]
    params_on: dict = field(default_factory=dict)  # device -> param bytes
    act_bytes: dict = field(default_factory=dict)  # device -> activ. bytes
    group_out_bytes: dict = field(default_factory=dict)  # gid -> bytes_out
    group_is_mp: dict = field(default_factory=dict)      # gid -> bool

    def add(self, **kw) -> Task:
        t = Task(tid=len(self.tasks), **kw)
        self.tasks.append(t)
        return t


N_MICRO = 4   # micro-batches for the PIPE option


def _replica_plan(topo: Topology, action: Action, proportional: bool):
    """[(device, frac)] for one op group under an action."""
    devs = devices_of(topo, action.placement)
    if action.option == Option.DUP:
        return [(d, 1.0) for d in devs]
    if action.option in (Option.MP, Option.PIPE):
        # stages, each handling the full batch for a slice of the ops
        return [(d, 1.0) for d in devs]
    if proportional:
        from repro_torch.core.strategy import device_group_of
        speeds = [topo.groups[device_group_of(topo, d)].flops for d in devs]
        tot = sum(speeds)
        return [(d, s / tot) for d, s in zip(devs, speeds, strict=True)]
    return [(d, 1.0 / len(devs)) for d in devs]


def compile_strategy(gg: GroupedGraph, strat: Strategy, topo: Topology,
                     *, proportional: bool = False,
                     sfb_plans: dict | None = None) -> TaskGraph:
    assert strat.complete(), "strategy must cover every op group"
    tg = TaskGraph()
    tg.params_on = {}
    tg.act_bytes = {}

    # 1. compute tasks per replica
    for gid, grp in enumerate(gg.groups):
        action = strat.actions[gid]
        plan = _replica_plan(topo, action, proportional)
        n = len(plan)
        reps = []
        tg.group_out_bytes[gid] = grp.bytes_out
        tg.group_is_mp[gid] = action.option in (Option.MP, Option.PIPE)
        sfb = (sfb_plans or {}).get(gid)
        if action.option == Option.PIPE and n > 1:
            # paper §6 future work: pipeline the stages over micro-batches.
            # m independent micro-chains; device FIFO queues overlap them.
            reps = []
            stage_bytes = grp.bytes_out / max(n, 1) / N_MICRO
            first_tasks = []
            for m in range(N_MICRO):
                prev = None
                for si, (d, _) in enumerate(plan):
                    deps = [prev.tid] if prev is not None else []
                    t = tg.add(kind="compute", group=gid, device=d,
                               flops=grp.flops / n / N_MICRO, deps=deps,
                               label=f"g{gid}s{si}m{m}")
                    if prev is not None and prev.device != d:
                        x = tg.add(kind="xfer", group=gid, src=prev.device,
                                   dst=d, nbytes=stage_bytes,
                                   deps=[prev.tid], label=f"pipe{gid}")
                        t.deps.append(x.tid)
                    if si == 0:
                        first_tasks.append(t)
                    prev = t
                reps.append(Replica(plan[-1][0], 1.0 / N_MICRO, prev.tid))
            for d, _ in plan:
                tg.params_on[d] = tg.params_on.get(d, 0.0) \
                    + grp.param_bytes / n
                tg.act_bytes[d] = tg.act_bytes.get(d, 0.0) \
                    + grp.bytes_out / n
            tg.replicas[gid] = reps
            continue
        for d, frac in plan:
            if action.option == Option.MP:
                flops = grp.flops / n          # stage slice, full batch
            elif action.option == Option.DUP:
                flops = grp.flops              # full batch everywhere
            else:
                flops = grp.flops * frac
                if sfb is not None and n > 1:
                    # SFB-duplicated ops recompute the full batch locally
                    flops += sfb.extra_flops * (n - 1) / n
            t = tg.add(kind="compute", group=gid, device=d, flops=flops,
                       label=f"g{gid}@d{d}")
            reps.append(Replica(d, frac, t.tid))
            tg.params_on[d] = tg.params_on.get(d, 0.0) + grp.param_bytes \
                * (1.0 if action.option in (Option.DUP, Option.AR, Option.PS)
                   else 1.0 / n)
            tg.act_bytes[d] = tg.act_bytes.get(d, 0.0) + grp.bytes_out * (
                1.0 if action.option == Option.DUP else frac if
                action.option != Option.MP else 1.0 / n)
        if action.option == Option.MP and n > 1:
            # sequential stages with boundary transfers
            stage_bytes = grp.bytes_out / max(n, 1)
            for a, b in zip(reps[:-1], reps[1:], strict=True):
                if a.device == b.device:
                    tg.tasks[b.task].deps.append(a.task)
                    continue
                x = tg.add(kind="xfer", group=gid, src=a.device,
                           dst=b.device, nbytes=stage_bytes,
                           deps=[a.task], label=f"mp{gid}")
                tg.tasks[b.task].deps.append(x.tid)
        tg.replicas[gid] = reps

    # 2. inter-group tensors with split/concat-implied traffic
    for (gi, gj), nbytes in gg.edges.items():
        src_reps = tg.replicas[gi]
        dst_reps = tg.replicas[gj]
        src_dup = strat.actions[gi].option == Option.DUP
        consumer_split = gg.groups[gj].split != Split.OTHER \
            and strat.actions[gj].option not in (Option.DUP,)
        for rc in dst_reps:
            need = nbytes * (rc.frac if consumer_split else 1.0)
            if src_dup:
                # every producer replica holds the full tensor: read the
                # local copy when possible, else the first producer
                local = next((rp for rp in src_reps
                              if rp.device == rc.device), None)
                rp = local or src_reps[0]
                if rp.device == rc.device:
                    tg.tasks[rc.task].deps.append(rp.task)
                else:
                    x = tg.add(kind="xfer", group=gi, src=rp.device,
                               dst=rc.device, nbytes=need, deps=[rp.task])
                    tg.tasks[rc.task].deps.append(x.tid)
                continue
            for rp in src_reps:
                part = need * rp.frac
                if part <= 0:
                    continue
                if rp.device == rc.device:
                    tg.tasks[rc.task].deps.append(rp.task)
                    continue
                x = tg.add(kind="xfer", group=gi, src=rp.device,
                           dst=rc.device, nbytes=part, deps=[rp.task],
                           label=f"t{gi}->{gj}")
                tg.tasks[rc.task].deps.append(x.tid)

    # 3. DUP option: broadcast the *inputs* (sufficient factors) of the
    # duplicated group to every copy — already handled above because each
    # DUP replica pulls the full input tensor (consumer_split == False).

    # 4. gradient synchronization
    for gid, grp in enumerate(gg.groups):
        action = strat.actions[gid]
        reps = tg.replicas[gid]
        if not grp.has_grad or grp.grad_bytes <= 0 or len(reps) <= 1:
            continue
        sync_bytes = grp.grad_bytes
        sfb = (sfb_plans or {}).get(gid)
        if sfb is not None:
            sync_bytes = max(0.0, sync_bytes - sfb.saved_sync_bytes)
            per_pair = sfb.bcast_bytes / max(len(reps), 1)
            for rp in reps:
                for rc in reps:
                    if rp.device == rc.device or per_pair <= 0:
                        continue
                    tg.add(kind="xfer", group=gid, src=rp.device,
                           dst=rc.device, nbytes=per_pair,
                           deps=[rp.task], label=f"sfb{gid}")
            if sync_bytes <= 0:
                continue
        if action.option == Option.AR:
            tg.add(kind="allreduce", group=gid, nbytes=sync_bytes,
                   devices=tuple(r.device for r in reps),
                   deps=[r.task for r in reps], label=f"ar{gid}")
        elif action.option == Option.PS:
            tg.add(kind="ps", group=gid, nbytes=sync_bytes,
                   devices=tuple(r.device for r in reps),
                   deps=[r.task for r in reps], label=f"ps{gid}")
        # DUP: gradients identical on every copy — no sync (SFB), MP: no
        # replication of parameters.
    return tg
