"""Eager pipeline execution engine: run a ``StagePlan`` as a real multi-stage
train step, the port of ``repro.exec.engine.PipelineRunner``.

One controller, as in ``repro``: a single process dispatches every event of
the microbatch schedule (``exec.schedule``) and places tensors on each
stage's ``torch.device`` list. A stage with ``n`` devices holds its
batch-sharded values as ``n`` shards, shard ``i`` on device ``i``; a leaf is
split on dim 0 only where ``n`` divides it, and replicated otherwise
(``_batch_split``, ``repro``'s ``_batch_spec``). Parameters live on the
stage's first device and are handed to the other shards at each step; the
explicit AR / PS / SFB parameter-gradient syncs are functions over the shards
(``parallel.sfb_dense``). The same code runs on a CPU device list in the
tests, on ``[cuda:0] * k`` on one card, where every shard shares the card
(that checks the schedule and the gradients, not overlap), and with a
stage's shards on distinct cards.

Two schedule extensions execute for real:

  * **interleaved** (virtual stages): ``n_chunks`` model chunks per physical
    stage; virtual stage ``u = chunk * S + s`` runs on physical stage ``s``.
  * **zb** (zero-bubble): the backward splits into an activation-grad half
    (``B`` events) and a weight-grad half (``W`` events). Each half re-runs
    the stage forward, so the split costs one extra recomputation.

Backward recomputes the stage forward from the stashed input
(``torch.enable_grad`` on detached leaves, then ``torch.autograd.grad``
asking only for the gradients the event needs), so only boundary
activations are stashed and the stash count follows the schedule's
``peak_stash`` (``W`` releases the stash under zb).

Gradient semantics, as ``repro``'s: the step loss is the mean over
microbatches of the mean over stage-DP shards of the local loss. The engine
seeds the last stage's backward with ``1/ndev_last``, syncs parameter
gradients with a plain sum (AR: the sum on every shard; PS: reduce-scatter
and all-gather; SFB: gather the inputs and output gradients, recompute),
accumulates over microbatches and divides by ``n_micro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import time

import torch

from repro_torch.exec.schedule import flatten_schedule, make_schedule
from repro_torch.parallel.sfb_dense import tree_grad_sync
from repro_torch.verify.diagnostics import PlanVerificationError


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _flat(tree) -> list:
    """Leaves of a tree of dicts, tuples and tensors (None: no leaves), dict
    keys sorted as ``optim.adam.leaves`` sorts them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _unflat(like, flat: list):
    """``like``'s structure over the leaves ``flat``, in ``_flat``'s order."""
    return None if like is None else _rebuild(like, iter(flat))


def _rebuild(node, it):
    # a module-level function: a recursive closure would hold the leaves in
    # a reference cycle, freed only when the garbage collector runs
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (tuple, list)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)


def _batch_split(x, ndev: int, dim: int = 0) -> bool:
    """``repro``'s ``_batch_spec``: shard the rows (dim 0, or dim 1 of a
    stacked ``[n_micro, rows, ...]`` value) where ``ndev`` divides them."""
    return x.dim() > dim and x.shape[dim] > 0 and x.shape[dim] % ndev == 0


def _stack(trees: list):
    """Trees of one structure as one tree, each leaf stacked on a new dim 0."""
    return _unflat(trees[0], [torch.stack(parts) for parts in zip(*map(_flat, trees))])


def _at(tree, j: int):
    """Row ``j`` of every leaf of a stacked tree (views)."""
    return _map(lambda t: t[j], tree)


def stack_microbatches(batch: dict, n_micro: int) -> dict:
    """Reshape every batch leaf to ``[n_micro, per_mb, ...]``; row ``m`` is
    exactly ``split_microbatches(batch, n_micro)[m]``."""
    for k, v in batch.items():
        if v.shape[0] % n_micro:
            raise ValueError(f"batch dim {v.shape[0]} of {k!r} not divisible by "
                             f"n_micro={n_micro}")
    return {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
            for k, v in batch.items()}


def split_microbatches(batch: dict, n_micro: int) -> list:
    """Split every batch leaf into ``n_micro`` equal chunks on dim 0."""
    for k, v in batch.items():
        if v.shape[0] % n_micro:
            raise ValueError(f"batch dim {v.shape[0]} of {k!r} not divisible by "
                             f"n_micro={n_micro}")
    out = []
    for m in range(n_micro):
        out.append({k: v[m * (v.shape[0] // n_micro):(m + 1) * (v.shape[0] // n_micro)]
                    for k, v in batch.items()})
    return out


@dataclass
class StepStats:
    loss: float
    metrics: dict
    wall_time: float
    events: list = field(default_factory=list)  # (kind, stage, mb, dur, chunk,
    #                                              start); start is seconds
    #                                              from step begin
    peak_stash: int = 0


class PipelineRunner:
    """Execute stage functions under a microbatch schedule.

    ``stage_fns[u]`` has signature ``fn(params_u, carry, mb) -> carry``
    (``(loss, metrics)`` for the last virtual stage); with ``n_chunks > 1``
    there are ``S * n_chunks`` virtual stages, virtual stage ``u`` running on
    physical stage ``u % S``. ``device_sets[s]`` lists the ``torch.device``s
    of physical stage ``s`` (more than one: per-stage data parallelism, with
    the gradient sync of ``plan.stages[s].sync``). ``mb_keys[u]`` names the
    microbatch entries virtual stage ``u`` consumes (default: all).
    ``spool`` (an ``obs.collector.SpoolWriter``) streams every step's events
    into the live-observability spool, and so turns event recording on.
    """

    def __init__(self, stage_fns, plan, device_sets, *, schedule: str = "1f1b",
                 n_micro: int | None = None, n_chunks: int = 1, mb_keys=None,
                 tied_ref=None, store=None, graph_fp: str = "", topo_fp: str = "",
                 meta: dict | None = None, spool=None):
        self.fns = list(stage_fns)
        self.plan = plan
        self.S = len(device_sets)
        self.V = max(1, int(n_chunks))
        if self.V > 1 and schedule != "interleaved":
            # only the interleaved generator emits chunked events; any other
            # schedule would leave virtual stages S..U-1 unscheduled
            raise ValueError(f"n_chunks={self.V} requires schedule='interleaved' "
                             f"(got {schedule!r})")
        self.U = self.S * self.V
        assert len(self.fns) == self.U, (len(self.fns), self.S, self.V)
        self.device_sets = [[torch.device(d) for d in devs] for devs in device_sets]
        self.schedule = schedule
        self.n_micro = int(n_micro or plan.n_micro)
        self.mb_keys = mb_keys
        self.tied_ref = tied_ref
        self.store = store
        self.graph_fp, self.topo_fp = graph_fp, topo_fp
        self.meta = dict(meta or {})
        # live-observability spool (obs.collector.SpoolWriter): recorded
        # events go to it once a step, after the step's own timing
        self.spool = spool
        self._spool_tracks_done = False
        self.syncs = [plan.stages[s].sync if s < len(plan.stages) else "allreduce"
                      for s in range(self.S)]
        order = make_schedule(schedule, self.S, self.n_micro, n_chunks=self.V)
        # static preflight: the event lists deadlock- and race-free and the
        # plan's collectives well-formed for the device sets we were handed,
        # before any tensor moves (lazy import: verify imports exec.schedule)
        from repro_torch.verify.verifier import verify_preflight, verify_schedule
        if getattr(plan, "n_stages", None) == self.S:
            pre = verify_preflight(plan, order, self.n_micro, n_chunks=self.V,
                                   device_counts=[len(d) for d in self.device_sets])
        else:
            pre = verify_schedule(order, self.S, self.n_micro, n_chunks=self.V)
        if pre.errors():
            raise PlanVerificationError(
                pre, context=f"pipeline preflight ({schedule}, S={self.S}, "
                             f"n_micro={self.n_micro})")
        self.flat = flatten_schedule(order, self.S, self.n_micro)
        self.has_w = any(e.kind == "W" for e in self.flat)
        self.last_stats = None               # StepStats of the last step

    # ------------------------------------------------------- placement
    def phys(self, u: int) -> int:
        """Physical stage hosting virtual stage ``u``."""
        return u % self.S

    def _ndev(self, s: int) -> int:
        return len(self.device_sets[s])

    def place(self, s: int, tree):
        """A tree of tensors on physical stage ``s``'s first device, where
        the stage keeps its parameters and optimizer state."""
        dev = self.device_sets[s][0]
        return _map(lambda t: t.to(dev), tree)

    def place_params(self, params_list) -> list:
        return [self.place(self.phys(u), p) for u, p in enumerate(params_list)]

    def _scatter(self, s: int, tree, dim: int = 0) -> list:
        """A batch-leading tree as stage ``s``'s shards: one tree a device,
        the rows (dim ``dim``) split where the device count divides them,
        else replicated."""
        devs = self.device_sets[s]
        n = len(devs)

        def shard(t, i):
            if n > 1 and _batch_split(t, n, dim):
                w = t.shape[dim] // n
                t = t.narrow(dim, i * w, w)
            return t.to(devs[i])
        return [_map(lambda t, i=i: shard(t, i), tree) for i in range(n)]

    def _gather(self, s: int, shards: list, full_rows: int, dim: int = 0):
        """Stage ``s``'s shards as one tree on its first device: split
        leaves concatenated on ``dim`` in shard order, replicated ones from
        shard 0. ``full_rows`` is the microbatch's row count, which decided
        the split."""
        n = len(shards)
        if n == 1:
            return shards[0]
        dev = self.device_sets[s][0]
        split = full_rows > 0 and full_rows % n == 0
        flat = [_flat(t) for t in shards]
        out = []
        for parts in zip(*flat):
            if split and parts[0].dim() > dim:
                out.append(torch.cat([p.to(dev) for p in parts], dim=dim))
            else:
                out.append(parts[0].to(dev))
        return _unflat(shards[0], out)

    def _move(self, s_from: int, s_to: int, shards: list, rows: int, dim: int = 0) -> list:
        """Reshard a batch-leading value from one physical stage to another."""
        if self.device_sets[s_from] == self.device_sets[s_to]:
            return shards
        return self._scatter(s_to, self._gather(s_from, shards, rows, dim), dim)

    def _mb_for(self, u: int, mb: dict) -> dict:
        if self.mb_keys is None:
            return mb
        return {k: mb[k] for k in self.mb_keys[u] if k in mb}

    def _sync_devices(self, s: int):
        for d in set(self.device_sets[s]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------- stage math
    def _vjp(self, u: int, p, carry, mb, dout, want_p: bool, want_c: bool):
        """Re-run virtual stage ``u`` on one shard and pull ``dout`` back.
        Returns (d params or None, d carry or None)."""
        fn, is_last = self.fns[u], u == self.U - 1
        want_c = want_c and carry is not None
        with torch.enable_grad():
            pl = [t.detach().requires_grad_(want_p) for t in _flat(p)]
            cl = [t.detach().requires_grad_(want_c) for t in _flat(carry)]
            out = fn(_unflat(p, pl), _unflat(carry, cl), mb)
            outs = [out[0]] if is_last else _flat(out)
            douts = [dout] if is_last else _flat(dout)
            ins = (pl if want_p else []) + (cl if want_c else [])
            pairs = [(o, d) for o, d in zip(outs, douts, strict=True) if o.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], ins, [d for _, d in pairs],
                                      allow_unused=True) if ins and pairs else [None] * len(ins)
        got = [torch.zeros_like(x) if g is None else g for x, g in zip(ins, got)]
        dp = _unflat(p, got[:len(pl)]) if want_p else None
        dc = _unflat(carry, got[len(pl) if want_p else 0:]) if want_c else None
        return dp, dc

    def _sfb(self, s: int) -> bool:
        """Whether physical stage ``s`` syncs by SFB: gathers the sufficient
        factors and recomputes the parameter gradient on shard 0."""
        return self._ndev(s) > 1 and self.syncs[s] == "sfb"

    def _workers(self, s: int, want_p: bool, want_c: bool) -> list:
        """The shards of stage ``s`` with work in a backward event: all of
        them where carry gradients or unsynced parameter gradients are asked
        for, else shard 0 alone where SFB recomputes the parameter gradient,
        else none."""
        if want_c or (want_p and not self._sfb(s)):
            return list(range(self._ndev(s)))
        return [0] if want_p else []

    def _sync(self, s: int, dps: list):
        """Stage ``s``'s AR or PS sync of its shards' parameter gradients:
        the synced tree on the stage's first device."""
        return tree_grad_sync(dps, self.syncs[s], self._ndev(s), out=0)

    def _sfb_factors(self, u: int, carry, mb, dout, rows: int, dim: int = 0) -> dict:
        """SFB's sufficient factors of virtual stage ``u`` on its first
        device: the shards' carry, microbatch and output gradient gathered
        (rows on ``dim``: 1 for a stacked run of microbatches). The last
        stage's seed is shard 0's ``1/ndev`` times ``ndev``: the gathered
        loss is the global mean."""
        s = self.phys(u)
        return {"c": None if carry is None else self._gather(s, carry, rows, dim),
                "mb": self._gather(s, mb, rows, dim),
                "dout": (dout[0] * self._ndev(s) if u == self.U - 1
                         else self._gather(s, dout, rows, dim))}

    def _shard_vjp(self, u: int, i: int, p, carry, mb, dout, factors, want_p: bool,
                   want_c: bool):
        """Shard ``i``'s part of one backward event of virtual stage ``u``:
        (its parameter gradient, unsynced, or on shard 0 under SFB the one
        recomputed on ``factors``; its carry gradient), each None where not
        asked for."""
        sfb = self._sfb(self.phys(u))
        dp = dc = None
        if want_c or (want_p and not sfb):
            dp, dc = self._vjp(u, p, carry, mb, dout, want_p and not sfb, want_c)
        if want_p and sfb and i == 0:
            dp, _ = self._vjp(u, p, factors["c"], factors["mb"], factors["dout"], True, False)
        return dp, dc

    def _grads(self, u: int, reps, carry, mb, dout, rows: int, want_p: bool,
               want_c: bool):
        """One backward event of virtual stage ``u`` over its shards:
        (synced parameter gradient on the stage's first device or None,
        per-shard carry gradients or None)."""
        s = self.phys(u)
        want_c = want_c and carry is not None
        factors = (self._sfb_factors(u, carry, mb, dout, rows)
                   if want_p and self._sfb(s) else None)
        got = [self._shard_vjp(u, i, reps[i], None if carry is None else carry[i], mb[i],
                               dout[i], factors, want_p, want_c)
               for i in self._workers(s, want_p, want_c)]
        dp = None
        if want_p:
            dp = got[0][0] if factors is not None else self._sync(s, [g[0] for g in got])
        return dp, ([g[1] for g in got] if want_c else None)

    # ------------------------------------------------------------- step
    def step(self, params_list, batch, *, record: bool = False) -> tuple:
        """One pipelined train step.

        Returns ``(grads_list, StepStats)``; grads match the structure of
        ``params_list`` (one entry per virtual stage, on the stage's first
        device; the tied-head gradient already folded back into the stage-0
        embedding).
        """
        t_start = time.perf_counter()
        record = record or self.spool is not None   # spooling needs events
        mbs = split_microbatches(batch, self.n_micro)
        S, U, M = self.S, self.U, self.n_micro
        rows = next(iter(mbs[0].values())).shape[0]

        params_eff = list(params_list)
        if self.tied_ref is not None:
            src_key, dst_key = self.tied_ref
            head = self.place(self.phys(U - 1), params_list[0][src_key])
            params_eff[U - 1] = dict(params_list[U - 1], **{dst_key: head})
        # each shard's view of its stage's parameters (no copy on a device
        # the stage's first device already is)
        reps = [[_map(lambda t, d=d: t.to(d), params_eff[u])
                 for d in self.device_sets[self.phys(u)]] for u in range(U)]

        mb_cache: dict = {}             # (u, m) -> the microbatch's shards

        def mb_at(u, m):
            if (u, m) not in mb_cache:
                mb_cache[(u, m)] = self._scatter(self.phys(u), self._mb_for(u, mbs[m]))
            return mb_cache[(u, m)]

        outs: dict = {}                 # (u, m) -> stage output shards
        stage_in: dict = {}             # (u, m) -> input shards (the stash)
        dcs: dict = {}                  # (u, m) -> d loss / d input of u, shards
        w_dout: dict = {}               # (u, m) -> dout kept for W (zb)
        grads: list = [None] * U
        losses, mets_acc = [], []
        events, stash, peak = [], 0, 0
        seed_last = 1.0 / self._ndev(self.phys(U - 1))

        def accumulate(u, dp):
            grads[u] = dp if grads[u] is None else _unflat(
                dp, [a + b for a, b in zip(_flat(grads[u]), _flat(dp), strict=True)])

        for ev in self.flat:
            s, m = ev.stage, ev.mb
            u = ev.chunk * S + s
            t0 = time.perf_counter()
            if ev.kind == "F":
                carry = None
                if u > 0:
                    carry = self._move(self.phys(u - 1), s, outs.pop((u - 1, m)), rows)
                stage_in[(u, m)] = carry
                stash += 1
                peak = max(peak, stash)
                mb = mb_at(u, m)
                with torch.no_grad():
                    out = [self.fns[u](reps[u][i], None if carry is None else carry[i], mb[i])
                           for i in range(self._ndev(s))]
                if u == U - 1:
                    losses.extend(o[0] for o in out)
                    mets_acc.append([o[1] for o in out])
                else:
                    outs[(u, m)] = out
            elif ev.kind == "B":
                if u == U - 1:
                    dout = [torch.tensor(seed_last, dtype=torch.float32, device=d)
                            for d in self.device_sets[s]]
                else:
                    dout = self._move(self.phys(u + 1), s, dcs.pop((u + 1, m)), rows)
                if self.has_w:
                    # zero-bubble: activation grad only; the stash (and dout)
                    # stay pinned until this microbatch's W
                    _, dc = self._grads(u, reps[u], stage_in[(u, m)], mb_at(u, m), dout,
                                        rows, False, u > 0)
                    w_dout[(u, m)] = dout
                else:
                    carry = stage_in.pop((u, m))
                    stash -= 1
                    dp, dc = self._grads(u, reps[u], carry, mb_at(u, m), dout, rows,
                                         True, u > 0)
                    accumulate(u, dp)
                if u > 0:
                    dcs[(u, m)] = dc
            else:                       # "W": weight grad, releases the stash
                carry = stage_in.pop((u, m))
                stash -= 1
                dp, _ = self._grads(u, reps[u], carry, mb_at(u, m), w_dout.pop((u, m)),
                                    rows, True, False)
                accumulate(u, dp)
            if record:
                self._sync_devices(s)
                events.append((ev.kind, s, m, time.perf_counter() - t0, ev.chunk,
                               t0 - t_start))

        grads = [_map(lambda g: g / M, g_u) for g_u in grads]
        if self.tied_ref is not None:
            src_key, dst_key = self.tied_ref
            dhead = self.place(0, grads[U - 1].pop(dst_key))
            grads[0] = dict(grads[0], **{src_key: grads[0][src_key] + dhead})

        dev = self.device_sets[self.phys(U - 1)][0]
        loss = float(torch.stack([x.float().to(dev) for x in losses]).mean())
        metrics = {}
        for k in mets_acc[0][0]:
            metrics[k] = sum(float(torch.stack([mm[k].float().to(dev) for mm in per]).mean())
                             for per in mets_acc) / len(mets_acc)
        wall = time.perf_counter() - t_start
        stats = StepStats(loss=loss, metrics=metrics, wall_time=wall, events=events,
                          peak_stash=peak)
        self.last_stats = stats
        if self.store is not None:
            self._record_telemetry(stats)
        if self.spool is not None:
            self._spool_events(stats, t_start)
        return grads, stats

    # -------------------------------------------------------- telemetry
    def _record_telemetry(self, stats: StepStats):
        from repro_torch.exec.schedule import FWD_FRAC, ZB_DGRAD_FRAC
        from repro_torch.runtime.telemetry import StepRecord
        bwd_frac = 1.0 - FWD_FRAC
        compute, ev_meta = [], []
        for e in stats.events:
            kind, s, m, dur, chunk = e[:5]
            start = e[5] if len(e) > 5 else 0.0
            spec = self.plan.stages[s] if s < len(self.plan.stages) else None
            if spec is None:
                flops_m = 0.0
            elif m < 0:      # an event that spans all microbatches
                flops_m = spec.flops / self.V
            else:
                flops_m = spec.flops / self.n_micro / self.V
            if kind == "F":
                frac = FWD_FRAC
            elif kind == "W":
                frac = bwd_frac * (1.0 - ZB_DGRAD_FRAC)
            else:
                frac = bwd_frac * (ZB_DGRAD_FRAC if self.has_w else 1.0)
            compute.append({
                "gpu_type": getattr(spec, "gpu_type", "") or "",
                "flops": flops_m * frac, "time": dur, "op": kind,
                "stage": s, "mb": m, "kind": kind, "chunk": chunk})
            ev_meta.append({"kind": kind, "stage": s, "mb": m, "chunk": chunk,
                            "start": start, "finish": start + dur})
        rec = StepRecord(
            graph_fp=self.graph_fp, topo_fp=self.topo_fp,
            wall_time=stats.wall_time, compute=compute,
            meta=dict(self.meta, executor="pipeline", schedule=self.schedule,
                      n_stages=self.S, n_chunks=self.V, n_micro=self.n_micro,
                      loss=stats.loss, peak_stash=stats.peak_stash, events=ev_meta))
        self.store.append(rec)

    def _spool_events(self, stats: StepStats, t_start: float):
        """Stream this step's events to the cross-process spool: one batched
        append (one lock, one write) a step, each event's time re-based from
        step-relative to this process's ``perf_counter`` clock, so that the
        collector's anchor alignment applies unchanged. It reads only the
        host-side ``StepStats``, so it adds no device synchronization."""
        from repro_torch.obs.trace import KIND_LABEL, event_name
        recs = []
        if not self._spool_tracks_done:
            self._spool_tracks_done = True
            recs += [{"type": "track", "tid": s, "name": f"stage {s}"}
                     for s in range(self.S)]
        for e in stats.events:
            kind, s, m, dur, chunk = e[:5]
            start = float(e[5]) if len(e) > 5 else 0.0
            recs.append({
                "type": "span", "name": event_name(kind, s, m, chunk),
                "cat": "pipeline", "tid": int(s),
                "t0": t_start + start, "t1": t_start + start + float(dur),
                "args": {"kind": KIND_LABEL.get(kind, kind), "stage": s,
                         "mb": m, "chunk": chunk,
                         "schedule": self.schedule}})
        self.spool.emit_many(recs)


class _Graph:
    """One shard's captured loop in the compiled engine: a CUDA graph of
    ``body`` on static copies of its inputs, on one device. ``fixed`` inputs
    (parameters, the loss seed) are read where they lie; ``fresh`` ones
    (microbatches, boundary values, SFB's factors) are copied into static
    buffers before every replay. Capture and replay run under the device on
    its current stream, so the work around them (the stage's sync, its
    cross-device copies) is ordered after the replay by that stream. Outputs
    are the graph's own buffers: the caller reads them before that graph's
    next replay. The body is passed at each call, never kept, so that no
    reference cycle holds the runner."""

    def __init__(self, device: torch.device, pool):
        self.device, self.pool = device, pool
        self.graph = self.static_in = self.out = None

    def run(self, body, fixed, fresh):
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture(body, fixed, fresh)
            for st, x in zip(self.static_in, _flat(fixed) + _flat(fresh), strict=True):
                if (st.data_ptr(), st.shape, st.stride()) != (x.data_ptr(), x.shape, x.stride()):
                    st.copy_(x)
            self.graph.replay()
        return self.out

    def _capture(self, body, fixed, fresh):
        statics = [x.clone() for x in _flat(fresh)]
        fresh_s = _unflat(fresh, statics)
        # warm-up on a side stream of this device (cuBLAS handles and
        # workspaces, the autograd engine's device thread), as PyTorch's
        # whole-network capture recipe does; then capture on that stream into
        # the device's pool (``torch.cuda.graph``'s own capture stream is one
        # for the process, made on whichever device was current first)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(fixed, fresh_s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            out = body(fixed, fresh_s)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph, self.static_in, self.out = graph, _flat(fixed) + statics, out


class CompiledPipelineRunner(PipelineRunner):
    """The compiled engine, the port of ``repro.exec.engine.
    CompiledPipelineRunner``: the eager engine's stage math (``_vjp``,
    ``_shard_vjp``, the sync, SFB's factors), run as O(U) rolled loops a
    step instead of O(U * n_micro) dispatched events.

    A virtual stage ``u`` has one forward loop over the stacked
    ``[n_micro, rows, ...]`` microbatch axis and one backward loop that
    accumulates the parameter gradient (under zero-bubble an activation-grad
    ``B`` loop and a weight-grad ``W`` loop), executed in dataflow order:
    every forward up the virtual stages, then every backward down them, the
    backward loops in reverse microbatch order as ``lax.scan(reverse=True)``
    runs them. A boundary moves as one stacked value. Every virtual stage
    stashes all ``n_micro`` inputs until its backward, whatever the
    schedule (``peak_stash == U * n_micro``, the stash of
    ``verify.memory.engine_peak_stash(..., engine="scan")`` without its
    boundary buffer). The gradient contract is the eager engine's: the sum
    over microbatches ``/ n_micro``, the tied head folded back.
    ``StepStats.events`` holds one entry a loop with ``mb == -1``: ``2U``,
    or ``3U`` under zero-bubble.

    A loop runs ``unroll`` microbatch bodies a replay, ``n_micro // unroll``
    replays and one for the remainder where ``unroll`` does not divide
    ``n_micro``. Each shard of a stage has its own body a replay, on its own
    device: the forward on its rows; the backward giving its carry gradients
    and its parameter gradient summed over the replay's microbatches,
    unsynced. Between replays, outside the bodies, the stage's sync runs once
    on the shards' sums (AR, PS; added into the gradient on the stage's first
    device), or, under SFB, the replay's carry, microbatch and output
    gradient are gathered onto shard 0 first, whose body recomputes each
    microbatch's parameter gradient on them. At ``unroll`` 1 that is one sync
    or gather a microbatch, ``repro``'s program; at ``k``, one a replay.
    ``loop_counts[(u, kind)]`` holds the last step's shard runs and syncs (or
    gathers) of each loop.

    On a CUDA device each shard's loop is captured once, at the first step,
    into a ``torch.cuda.CUDAGraph`` on that shard's device (a device's graphs
    share one memory pool, captured in the order they replay) and replayed
    at every step after; a shard on the CPU runs its body uncaptured. So the
    shards of a stage may share one card, sit on distinct cards, or mix the
    CPU and cards. At 1, capture time and graph memory stay flat in
    ``n_micro``; at ``n_micro``, one replay a loop. A capture or replay that
    fails raises: nothing falls back to the uncaptured loop or to the eager
    engine on a card.

    The parameters are read where they lie: pass the same tensors each step
    and update them in place, as ``launch.steps.make_pipeline_train_step``'s
    AdamW does (a new tensor, such as a shard's copy on another device, is
    copied into the captured one).
    """

    def __init__(self, *args, unroll: int = 1, **kw):
        super().__init__(*args, **kw)
        self.unroll = max(1, int(unroll))
        # the last stage's backward seed a shard, made at the first step (a
        # graph cannot copy from the host); the constructor touches no device
        self._seed = None
        self._graphs: dict = {}          # (u, kind, k, shard) -> _Graph
        self._pools: dict = {}           # device -> its graphs' memory pool
        self.loop_counts: dict = {}      # (u, kind) -> {"runs": n, "syncs": n}

    def _chunks(self) -> list:
        """(first microbatch, count) of each replay, in forward order."""
        k = min(self.unroll, self.n_micro)
        q, r = divmod(self.n_micro, k)
        return [(i * k, k) for i in range(q)] + ([(q * k, r)] if r else [])

    def _count(self, u: int, kind: str, what: str):
        c = self.loop_counts.setdefault((u, kind), {"runs": 0, "syncs": 0})
        c[what] += 1

    def _run(self, u: int, kind: str, k: int, i: int, body, fixed, fresh):
        """One replay of shard ``i``'s loop: its graph on a card, its body
        uncaptured elsewhere."""
        self._count(u, kind, "runs")
        dev = self.device_sets[self.phys(u)][i]
        if dev.type != "cuda":
            return body(fixed, fresh)
        g = self._graphs.get((u, kind, k, i))
        if g is None:
            if dev not in self._pools:
                self._pools[dev] = torch.cuda.graph_pool_handle()
            g = self._graphs[(u, kind, k, i)] = _Graph(dev, self._pools[dev])
        return g.run(body, fixed, fresh)

    # ------------------------------------------------------------ loops
    def _fwd_loop(self, u: int, reps, cs, mbs):
        """Virtual stage ``u``'s forward over every microbatch: per shard,
        the stacked outputs (``(loss [M], metrics [M])`` on the last)."""
        fn = self.fns[u]

        def body(k):
            def run(p, fresh):
                with torch.no_grad():
                    return _stack([fn(p, None if fresh["c"] is None else _at(fresh["c"], j),
                                      _at(fresh["mb"], j)) for j in range(k)])
            return run

        full = [None] * len(reps)
        for m0, k in self._chunks():
            for i, p in enumerate(reps):
                fresh = {"c": None if cs is None else _map(lambda t: t[m0:m0 + k], cs[i]),
                         "mb": _map(lambda t: t[m0:m0 + k], mbs[i])}
                out = self._run(u, "F", k, i, body(k), p, fresh)
                if full[i] is None:
                    full[i] = _map(lambda t: t.new_empty((self.n_micro, *t.shape[1:])), out)
                for dst, src in zip(_flat(full[i]), _flat(out), strict=True):
                    dst[m0:m0 + k].copy_(src)
        return full

    def _bwd_loop(self, u: int, kind: str, reps, cs, mbs, douts, rows: int,
                  want_p: bool, want_c: bool):
        """Virtual stage ``u``'s backward over every microbatch, last first:
        (the parameter gradient summed over microbatches, on the stage's
        first device, or None; per shard the stacked carry gradients, or
        None)."""
        s, last = self.phys(u), u == self.U - 1
        want_c = want_c and cs is not None
        workers = self._workers(s, want_p, want_c)
        if not workers:
            return None, None           # zb's B of stage 0: nothing to compute
        sfb = want_p and self._sfb(s)
        own = want_c or (want_p and not sfb)     # shards need their own rows

        def body(i, k):
            def run(fixed, fresh):
                dp_sum, dcs = None, []
                for j in reversed(range(k)):
                    mine = {key: _at(v, j) for key, v in fresh["own"].items()}
                    f = fresh["sfb"]
                    factors = None if f is None else {
                        "c": _at(f["c"], j), "mb": _at(f["mb"], j),
                        "dout": f["dout"] if last else _at(f["dout"], j)}
                    dp, dc = self._shard_vjp(
                        u, i, fixed["p"], mine.get("c"), mine.get("mb"),
                        fixed["seed"] if last else mine.get("dout"), factors, want_p, want_c)
                    if dp is not None:
                        dp_sum = dp if dp_sum is None else _unflat(
                            dp, [a + b for a, b in zip(_flat(dp_sum), _flat(dp), strict=True)])
                    if dc is not None:
                        dcs.append(dc)
                return {"dp": dp_sum, "dc": _stack(dcs[::-1]) if dcs else None}
            return run

        def cut(ts, m0, k):
            """Each shard's microbatches ``m0 .. m0 + k`` of stacked ``ts``."""
            return None if ts is None else [_map(lambda x: x[m0:m0 + k], t) for t in ts]

        acc, dc_full = None, [None] * len(reps)
        for m0, k in reversed(self._chunks()):
            c, mb, dout = cut(cs, m0, k), cut(mbs, m0, k), None if last else cut(douts, m0, k)
            factors = None
            if sfb:
                factors = self._sfb_factors(u, c, mb, self._seed if last else dout, rows, dim=1)
                self._count(u, kind, "syncs")
            outs = []
            for i in workers:
                mine = {"c": c and c[i], "mb": mb[i], "dout": dout and dout[i]} if own else {}
                outs.append(self._run(u, kind, k, i, body(i, k),
                                      {"p": reps[i], "seed": self._seed[i] if last else None},
                                      {"own": mine, "sfb": factors if i == 0 else None}))
            if want_p:
                if sfb:
                    dp = outs[0]["dp"]
                else:
                    dp = self._sync(s, [o["dp"] for o in outs])
                    self._count(u, kind, "syncs")
                dp = _flat(dp)
                if acc is None:
                    acc = [t.clone() for t in dp]
                else:
                    torch._foreach_add_(acc, dp)
            for i, o in zip(workers, outs) if want_c else ():
                if dc_full[i] is None:
                    dc_full[i] = _map(lambda t: t.new_empty((self.n_micro, *t.shape[1:])),
                                      o["dc"])
                for dst, src in zip(_flat(dc_full[i]), _flat(o["dc"]), strict=True):
                    dst[m0:m0 + k].copy_(src)
            del outs
        return (_unflat(reps[0], acc) if want_p else None), (dc_full if want_c else None)

    # ------------------------------------------------------------- step
    def step(self, params_list, batch, *, record: bool = False) -> tuple:
        """One pipelined train step through the rolled loops. Returns
        ``(grads_list, StepStats)`` under the eager engine's contract."""
        t_start = time.perf_counter()
        record = record or self.spool is not None   # spooling needs events
        S, U, M = self.S, self.U, self.n_micro
        stacked = stack_microbatches(batch, M)
        rows = next(iter(stacked.values())).shape[1]
        if self._seed is None:
            last = self.device_sets[self.phys(U - 1)]
            self._seed = [torch.full((), 1.0 / len(last), dtype=torch.float32, device=d)
                          for d in last]
        self.loop_counts = {}

        params_eff = list(params_list)
        if self.tied_ref is not None:
            src_key, dst_key = self.tied_ref
            head = self.place(self.phys(U - 1), params_list[0][src_key])
            params_eff[U - 1] = dict(params_list[U - 1], **{dst_key: head})
        reps = [[_map(lambda t, d=d: t.to(d), params_eff[u])
                 for d in self.device_sets[self.phys(u)]] for u in range(U)]
        mbs = [self._scatter(self.phys(u), self._mb_for(u, stacked), dim=1) for u in range(U)]

        def event(kind, u, t0):
            if record:
                self._sync_devices(self.phys(u))
                events.append((kind, self.phys(u), -1, time.perf_counter() - t0, u // S,
                               t0 - t_start))

        events: list = []
        stage_in: list = [None] * U     # stacked inputs of every microbatch
        outs = None
        for u in range(U):
            t0 = time.perf_counter()
            if u > 0:
                # one stacked transfer a boundary
                stage_in[u] = self._move(self.phys(u - 1), self.phys(u), outs, rows, dim=1)
            outs = self._fwd_loop(u, reps[u], stage_in[u], mbs[u])
            event("F", u, t0)
        losses = torch.cat([o[0].float().to(self.device_sets[self.phys(U - 1)][0])
                            for o in outs])
        mets = {k: torch.cat([o[1][k].float().to(losses.device) for o in outs])
                for k in outs[0][1]}
        del outs

        grads: list = [None] * U
        dcs = None
        for u in reversed(range(U)):
            t0 = time.perf_counter()
            douts = None if u == U - 1 else self._move(self.phys(u + 1), self.phys(u), dcs,
                                                       rows, dim=1)
            cs, mb = stage_in[u], mbs[u]
            if self.has_w:
                _, dcs = self._bwd_loop(u, "B", reps[u], cs, mb, douts, rows, False, u > 0)
                event("B", u, t0)
                t0 = time.perf_counter()
                grads[u], _ = self._bwd_loop(u, "W", reps[u], cs, mb, douts, rows, True, False)
                event("W", u, t0)
            else:
                grads[u], dcs = self._bwd_loop(u, "B", reps[u], cs, mb, douts, rows, True,
                                               u > 0)
                event("B", u, t0)
            stage_in[u] = None

        grads = [_map(lambda g: g / M, g_u) for g_u in grads]
        if self.tied_ref is not None:
            src_key, dst_key = self.tied_ref
            dhead = self.place(0, grads[U - 1].pop(dst_key))
            grads[0] = dict(grads[0], **{src_key: grads[0][src_key] + dhead})

        loss = float(losses.mean())
        metrics = {k: float(v.mean()) for k, v in mets.items()}
        stats = StepStats(loss=loss, metrics=metrics, wall_time=time.perf_counter() - t_start,
                          events=events, peak_stash=U * M)
        self.last_stats = stats
        if self.store is not None:
            self._record_telemetry(stats)
        if self.spool is not None:
            self._spool_events(stats, t_start)
        return grads, stats
