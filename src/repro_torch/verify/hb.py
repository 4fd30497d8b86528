"""Happens-before analysis over schedule event lists.

The eager engine (``exec.engine``) executes each stage's event list in
issue order, with cross-(virtual-)stage dependencies exactly as
``exec.schedule._dep_of`` defines them: forwards chain up the virtual
pipeline, activation-grad backwards chain down it, weight grads wait on
their own backward, and every backward waits on its own stage's
forward. This module builds that relation as an explicit graph over all
events — program-order edges per stage plus the dependency edges — and
statically proves:

  * **no deadlock** (TAG101): the graph is acyclic, i.e. the eager
    executor's no-progress condition can never trip;
  * **local issue sanity** (TAG102/TAG103): no stage issues ``B`` before
    its own ``F``, or ``W`` before its own ``B``;
  * **coverage** (TAG104/TAG105): every stage issues F/B (and W when the
    schedule splits backwards) of every (chunk, microbatch) exactly once;
  * **matched boundary traffic** (TAG106): for every directed virtual
    boundary, the producer's crossing events and the consumer's expected
    arrivals pair up one-to-one — a dropped or duplicated event shows up
    as an unmatched send or recv;
  * **transfer ordering** (TAG107): boundary links serialize transfers
    FIFO (``simulate_schedule`` models them that way and rendezvous-by-
    order transports execute them that way), so the producer must emit a
    boundary's microbatches in the same order the consumer awaits them —
    a reorder on one side only is a race.
"""
from __future__ import annotations

from repro_torch.exec.schedule import Event, n_chunks_of
from repro_torch.verify.diagnostics import Report

# cap per-analysis diagnostic emission so a badly mangled schedule does
# not flood the report with thousands of repeats of the same finding
MAX_PER_CHECK = 8

EventKey = tuple[str, int, int, int]


def _key(e: Event) -> EventKey:
    return (e.kind, e.stage, e.mb, e.chunk)


def _check_structure(order: list[list[Event]], n_stages: int,
                     rep: Report) -> bool:
    if len(order) != n_stages:
        rep.add("TAG001", f"schedule has {len(order)} stage event lists "
                          f"for {n_stages} stages")
        return False
    for s, evs in enumerate(order):
        for i, e in enumerate(evs):
            if e.kind not in ("F", "B", "W"):
                rep.add("TAG001", f"unknown event kind {e.kind!r}",
                        stage=s, event_index=i)
                return False
            if e.stage != s:
                rep.add("TAG001", f"event {e!r} issued on stage {s} but "
                                  f"names stage {e.stage}",
                        stage=s, event_index=i)
                return False
    return True


def _check_coverage(order: list[list[Event]], n_micro: int,
                    n_chunks: int, rep: Report) -> None:
    want = {(c, m) for c in range(n_chunks) for m in range(n_micro)}
    for s, evs in enumerate(order):
        kinds = ["F", "B", "W"] \
            if any(e.kind == "W" for e in evs) else ["F", "B"]
        for kind in kinds:
            seen: dict[tuple[int, int], int] = {}
            for e in evs:
                if e.kind == kind:
                    seen[(e.chunk, e.mb)] = seen.get((e.chunk, e.mb),
                                                     0) + 1
            missing = sorted(want - set(seen))
            for c, m in missing[:MAX_PER_CHECK]:
                rep.add("TAG104", f"stage {s} never issues "
                                  f"{kind}(mb={m}, chunk={c})",
                        stage=s, mb=m, chunk=c)
            dups = sorted(k for k, n in seen.items() if n > 1)
            for c, m in dups[:MAX_PER_CHECK]:
                rep.add("TAG105", f"stage {s} issues "
                                  f"{kind}(mb={m}, chunk={c}) "
                                  f"{seen[(c, m)]} times",
                        stage=s, mb=m, chunk=c)
            extra = sorted(set(seen) - want)
            for c, m in extra[:MAX_PER_CHECK]:
                rep.add("TAG104", f"stage {s} issues {kind}(mb={m}, "
                                  f"chunk={c}) outside the schedule's "
                                  f"(chunk, mb) range",
                        stage=s, mb=m, chunk=c)


def _check_local_order(order: list[list[Event]], rep: Report) -> None:
    for s, evs in enumerate(order):
        done_f: set[tuple[int, int]] = set()
        done_b: set[tuple[int, int]] = set()
        n102 = n103 = 0
        for i, e in enumerate(evs):
            cm = (e.chunk, e.mb)
            if e.kind == "F":
                done_f.add(cm)
            elif e.kind == "B":
                if cm not in done_f and n102 < MAX_PER_CHECK:
                    rep.add("TAG102",
                            f"stage {s} issues B(mb={e.mb}, "
                            f"chunk={e.chunk}) before its own F",
                            stage=s, mb=e.mb, chunk=e.chunk,
                            event_index=i)
                    n102 += 1
                done_b.add(cm)
            else:
                if cm not in done_b and n103 < MAX_PER_CHECK:
                    rep.add("TAG103",
                            f"stage {s} issues W(mb={e.mb}, "
                            f"chunk={e.chunk}) before its own B",
                            stage=s, mb=e.mb, chunk=e.chunk,
                            event_index=i)
                    n103 += 1


def _dep_key(e: Event, n_stages: int, n_chunks: int) -> EventKey | None:
    """Cross-event dependency key of ``e`` (or None).

    Re-derives ``exec.schedule._dep_of`` semantics so the verifier stays
    independent of the executor internals it is checking.
    """
    S, U = n_stages, n_stages * n_chunks
    u = e.chunk * S + e.stage
    if e.kind == "F":
        if u == 0:
            return None
        return ("F", (u - 1) % S, e.mb, (u - 1) // S)
    if e.kind == "B":
        if u == U - 1:
            return None
        return ("B", (u + 1) % S, e.mb, (u + 1) // S)
    return ("B", e.stage, e.mb, e.chunk)


def build_hb_graph(order: list[list[Event]], n_stages: int,
                   n_chunks: int
                   ) -> tuple[list[EventKey], dict[EventKey,
                                                   list[EventKey]]]:
    """The happens-before relation as an adjacency map ``pred -> succs``.

    Edges: per-stage program order (the eager executor runs each stage's
    list serially, in order), cross-virtual-stage data dependencies, and
    the own-F edge of every backward. Duplicate events collapse onto one
    node (coverage flags them separately); edges to events that do not
    exist are skipped (coverage/boundary matching flags those).
    """
    nodes: list[EventKey] = []
    present: set[EventKey] = set()
    for evs in order:
        for e in evs:
            k = _key(e)
            if k not in present:
                present.add(k)
                nodes.append(k)
    succs: dict[EventKey, list[EventKey]] = {k: [] for k in nodes}

    def edge(a: EventKey, b: EventKey) -> None:
        """Add ``a -> b`` when both endpoints exist (and differ)."""
        if a in present and b in present and a != b:
            succs[a].append(b)

    for evs in order:
        for i in range(len(evs) - 1):
            edge(_key(evs[i]), _key(evs[i + 1]))    # program order
        for e in evs:
            k = _key(e)
            dep = _dep_key(e, n_stages, n_chunks)
            if dep is not None:
                edge(dep, k)
            if e.kind == "B":                        # B waits on own F
                edge(("F", e.stage, e.mb, e.chunk), k)
    return nodes, succs


def _find_cycle(nodes: list[EventKey],
                succs: dict[EventKey, list[EventKey]]
                ) -> list[EventKey]:
    """One cycle of the graph, as a node list (empty when acyclic).

    Kahn's algorithm leaves exactly the nodes on/behind cycles
    unprocessed; walk predecessors inside that residue until a node
    repeats.
    """
    indeg: dict[EventKey, int] = {k: 0 for k in nodes}
    for k in nodes:
        for j in succs[k]:
            indeg[j] += 1
    queue = [k for k in nodes if indeg[k] == 0]
    seen = 0
    while queue:
        k = queue.pop()
        seen += 1
        for j in succs[k]:
            indeg[j] -= 1
            if indeg[j] == 0:
                queue.append(j)
    if seen == len(nodes):
        return []
    # residual nodes are on or downstream of a cycle; each has at least
    # one unprocessed predecessor (that is what indeg > 0 means after
    # Kahn's), so walking predecessors always continues until a repeat
    residual = {k for k in nodes if indeg[k] > 0}
    preds: dict[EventKey, list[EventKey]] = {k: [] for k in residual}
    for k in residual:
        for j in succs[k]:
            if j in residual:
                preds[j].append(k)
    start = next(iter(residual))
    path: list[EventKey] = []
    pos: dict[EventKey, int] = {}
    cur = start
    while cur not in pos:
        pos[cur] = len(path)
        path.append(cur)
        cur = preds[cur][0]
    return list(reversed(path[pos[cur]:]))


def _check_deadlock(order: list[list[Event]], n_stages: int,
                    n_chunks: int, rep: Report) -> None:
    nodes, succs = build_hb_graph(order, n_stages, n_chunks)
    cycle = _find_cycle(nodes, succs)
    if not cycle:
        return
    shown = cycle[:6]
    desc = " -> ".join(f"{k}{s}{'c' + str(c) if c else ''}.{m}"
                       for (k, s, m, c) in shown)
    if len(cycle) > len(shown):
        desc += f" -> ... ({len(cycle)} events in cycle)"
    k0, s0, m0, c0 = cycle[0]
    idx = next((i for i, e in enumerate(order[s0])
                if _key(e) == cycle[0]), None)
    rep.add("TAG101",
            f"happens-before cycle (the eager executor deadlocks): "
            f"{desc} -> {desc.split(' -> ')[0]}",
            stage=s0, mb=m0, chunk=c0, event_index=idx)


def _boundary_seq(order: list[list[Event]], kind: str, stage: int,
                  chunk: int) -> list[int]:
    return [e.mb for e in order[stage]
            if e.kind == kind and e.chunk == chunk]


def _check_boundaries(order: list[list[Event]], n_stages: int,
                      n_chunks: int, rep: Report) -> None:
    """Pair producer sends with consumer recvs per virtual boundary.

    Flags unmatched traffic (TAG106) and reorders (TAG107).
    """
    S, U = n_stages, n_stages * n_chunks
    n106 = n107 = 0
    for u in range(1, U):
        for kind in ("F", "B"):
            # F crosses boundary (u-1 -> u): producer u-1, consumer u.
            # B crosses (u+1 -> u) = boundary (u -> u-1) reversed; index
            # it as consumer u-1 fed by producer u.
            if kind == "F":
                p_s, p_c = (u - 1) % S, (u - 1) // S
                c_s, c_c = u % S, u // S
            else:
                p_s, p_c = u % S, u // S
                c_s, c_c = (u - 1) % S, (u - 1) // S
            prod = _boundary_seq(order, kind, p_s, p_c)
            cons = _boundary_seq(order, kind, c_s, c_c)
            if sorted(prod) != sorted(cons):
                extra_send = sorted(set(prod) - set(cons))
                extra_recv = sorted(set(cons) - set(prod))
                for m in extra_send[:2]:
                    if n106 < MAX_PER_CHECK:
                        rep.add("TAG106",
                                f"{kind}(mb={m}) produced on virtual "
                                f"stage {u - 1 if kind == 'F' else u} "
                                f"(stage {p_s}, chunk {p_c}) has no "
                                f"matching recv on the consumer stage",
                                stage=p_s, mb=m, chunk=p_c)
                        n106 += 1
                for m in extra_recv[:2]:
                    if n106 < MAX_PER_CHECK:
                        rep.add("TAG106",
                                f"{kind}(mb={m}) awaited on stage "
                                f"{c_s} (chunk {c_c}) is never "
                                f"produced by its upstream stage",
                                stage=c_s, mb=m, chunk=c_c)
                        n106 += 1
                continue
            if prod != cons and n107 < MAX_PER_CHECK:
                i = next(i for i, (a, b) in
                         enumerate(zip(prod, cons, strict=True))
                         if a != b)
                rep.add("TAG107",
                        f"transfer ordering race on the {kind} boundary "
                        f"into virtual stage "
                        f"{u if kind == 'F' else u - 1}: producer "
                        f"stage {p_s} emits mb order {prod[i:i + 4]} "
                        f"while consumer stage {c_s} awaits "
                        f"{cons[i:i + 4]} (position {i})",
                        stage=c_s, mb=cons[i], chunk=c_c)
                n107 += 1


def analyze_schedule(order: list[list[Event]], n_stages: int,
                     n_micro: int,
                     n_chunks: int | None = None) -> Report:
    """Full happens-before verification of one schedule's event lists."""
    rep = Report()
    if not _check_structure(order, n_stages, rep):
        return rep
    V = n_chunks if n_chunks is not None else n_chunks_of(order)
    V = max(V, 1)
    _check_coverage(order, n_micro, V, rep)
    _check_local_order(order, rep)
    _check_boundaries(order, n_stages, V, rep)
    _check_deadlock(order, n_stages, V, rep)
    return rep
