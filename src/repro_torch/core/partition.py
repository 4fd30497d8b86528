"""Multilevel graph partitioner (METIS replacement, paper §4.1.1).

Objective: split the computation graph into <= n_groups op groups,
minimizing the tensor bytes on cut edges while keeping per-group compute
balanced within a balance factor (paper uses 60 groups, factor 2).

Pipeline (standard multilevel scheme):
  1. coarsen by repeated heavy-edge matching (merge the heaviest tensor
     edges first) until the graph is small,
  2. initial partition by balanced topological chunking,
  3. FM-style boundary refinement (gain = cut-bytes reduction) under the
     balance constraint, projected back through the levels.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core.graph import CompGraph


class _CoarseGraph:
    def __init__(self, weights, edges, members):
        self.weights = weights          # node -> compute weight
        self.edges = edges              # (u, v) unordered -> bytes
        self.members = members          # node -> list of original op_ids

    @property
    def n(self):
        return len(self.weights)

    def adjacency(self):
        adj = defaultdict(dict)
        for (u, v), w in self.edges.items():
            adj[u][v] = adj[u].get(v, 0.0) + w
            adj[v][u] = adj[v].get(u, 0.0) + w
        return adj


def _from_comp_graph(g: CompGraph) -> _CoarseGraph:
    min_w = max(1.0, g.total_flops() / max(len(g.nodes), 1) * 1e-3)
    weights = {i: max(n.flops, min_w) for i, n in g.nodes.items()}
    edges: dict = {}
    for e in g.edges:
        if e.src == e.dst:
            continue
        key = (min(e.src, e.dst), max(e.src, e.dst))
        edges[key] = edges.get(key, 0.0) + e.bytes
    members = {i: [i] for i in g.nodes}
    return _CoarseGraph(weights, edges, members)


def _coarsen(cg: _CoarseGraph, max_node_w: float) -> _CoarseGraph:
    """One pass of heavy-edge matching."""
    matched = {}
    order = sorted(cg.edges.items(), key=lambda kv: -kv[1])
    used = set()
    for (u, v), _ in order:
        if u in used or v in used:
            continue
        if cg.weights[u] + cg.weights[v] > max_node_w:
            continue
        matched[u] = v
        used.add(u)
        used.add(v)
    if not matched:
        return cg
    rep = {}
    for node in cg.weights:
        rep[node] = node
    for u, v in matched.items():
        rep[v] = u
    weights, members = {}, {}
    for node, w in cg.weights.items():
        r = rep[node]
        weights[r] = weights.get(r, 0.0) + w
        members.setdefault(r, []).extend(cg.members[node])
    edges: dict = {}
    for (u, v), w in cg.edges.items():
        ru, rv = rep[u], rep[v]
        if ru == rv:
            continue
        key = (min(ru, rv), max(ru, rv))
        edges[key] = edges.get(key, 0.0) + w
    return _CoarseGraph(weights, edges, members)


def _topo_chunks(g: CompGraph, cg: _CoarseGraph, n_groups: int) -> dict:
    """Initial partition: fill groups along a topological order of the
    ORIGINAL graph (coarse nodes ordered by their first member)."""
    topo_pos = {op: i for i, op in enumerate(g.topo_order())}
    nodes = sorted(cg.weights, key=lambda nd: min(
        topo_pos.get(m, 0) for m in cg.members[nd]))
    total = sum(cg.weights.values())
    target = total / n_groups
    assign, gid, acc = {}, 0, 0.0
    for nd in nodes:
        assign[nd] = gid
        acc += cg.weights[nd]
        if acc >= target * (gid + 1) and gid < n_groups - 1:
            gid += 1
    return assign


def _refine(cg: _CoarseGraph, assign: dict, n_groups: int,
            balance: float, passes: int = 4):
    adj = cg.adjacency()
    total = sum(cg.weights.values())
    cap = balance * total / n_groups
    gw = defaultdict(float)
    for nd, gid in assign.items():
        gw[gid] += cg.weights[nd]
    for _ in range(passes):
        moved = 0
        for nd in list(assign):
            cur = assign[nd]
            # cut weight toward each neighboring group
            conn = defaultdict(float)
            for nb, w in adj.get(nd, {}).items():
                conn[assign[nb]] += w
            best_gid, best_gain = cur, 0.0
            for gid, w in conn.items():
                if gid == cur:
                    continue
                gain = w - conn.get(cur, 0.0)
                if gain > best_gain and gw[gid] + cg.weights[nd] <= cap:
                    best_gid, best_gain = gid, gain
            if best_gid != cur:
                gw[cur] -= cg.weights[nd]
                gw[best_gid] += cg.weights[nd]
                assign[nd] = best_gid
                moved += 1
        if moved == 0:
            break
    return assign


def cut_bytes(g: CompGraph, assignment: dict) -> float:
    return sum(e.bytes for e in g.edges
               if assignment[e.src] != assignment[e.dst])


def _condense_cycles(g: CompGraph, assign: dict) -> dict:
    """Merge strongly-connected components of the group graph so the
    grouped view is a DAG (groups must be executable in some order)."""
    gids = sorted(set(assign.values()))
    idx = {gid: i for i, gid in enumerate(gids)}
    n = len(gids)
    succ = [set() for _ in range(n)]
    for e in g.edges:
        a, b = idx[assign[e.src]], idx[assign[e.dst]]
        if a != b:
            succ[a].add(b)
    # iterative Tarjan SCC
    comp = [-1] * n
    low = [0] * n
    num = [0] * n
    on = [False] * n
    stack: list = []
    counter = [0]
    ncomp = [0]
    visited = [False] * n
    for root in range(n):
        if visited[root]:
            continue
        work = [(root, iter(succ[root]))]
        visited[root] = True
        num[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if not visited[w]:
                    visited[w] = True
                    num[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on[w] = True
                    work.append((w, iter(succ[w])))
                    advanced = True
                    break
                elif on[w]:
                    low[v] = min(low[v], num[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == num[v]:
                while True:
                    w = stack.pop()
                    on[w] = False
                    comp[w] = ncomp[0]
                    if w == v:
                        break
                ncomp[0] += 1
    return {op: comp[idx[gid]] for op, gid in assign.items()}


def _topo_renumber(g: CompGraph, assign: dict) -> dict:
    """Renumber groups in topological order of the (acyclic) group graph."""
    first_pos: dict = {}
    for i, op in enumerate(g.topo_order()):
        gid = assign[op]
        first_pos.setdefault(gid, i)
    order = sorted(first_pos, key=first_pos.get)
    remap = {gid: i for i, gid in enumerate(order)}
    return {op: remap[gid] for op, gid in assign.items()}


def _monotone_refine(g: CompGraph, assign: dict, n_groups: int,
                     balance: float, passes: int = 6):
    """FM-style refinement that PRESERVES acyclicity: a node may move to a
    neighboring group id only while every in-edge still comes from a group
    <= its own and every out-edge goes to a group >= its own."""
    g.build_adj()
    weights = {i: max(n.flops, 1.0) for i, n in g.nodes.items()}
    total = sum(weights.values())
    cap = balance * total / n_groups
    gw = defaultdict(float)
    for op, gid in assign.items():
        gw[gid] += weights[op]

    def gain(op, tgt):
        """Cut-bytes reduction from moving ``op`` assign[op] -> tgt."""
        cur = assign[op]
        d = 0.0
        for e in g._in[op] + g._out[op]:
            nb = e.src if e.dst == op else e.dst
            if nb == op:
                continue
            gnb = assign[nb]
            if gnb == tgt:
                d += e.bytes        # was cut, becomes internal
            elif gnb == cur:
                d -= e.bytes        # was internal, becomes cut
        return d

    for _ in range(passes):
        moved = 0
        for op in g.nodes:
            cur = assign[op]
            lo = max((assign[e.src] for e in g._in[op] if e.src != op),
                     default=0)
            hi = min((assign[e.dst] for e in g._out[op] if e.dst != op),
                     default=n_groups - 1)
            for tgt in {max(lo, cur - 1), min(hi, cur + 1)}:
                if tgt == cur or not (lo <= tgt <= hi):
                    continue
                if gw[tgt] + weights[op] > cap:
                    continue
                if gain(op, tgt) > 0:
                    gw[cur] -= weights[op]
                    gw[tgt] += weights[op]
                    assign[op] = tgt
                    moved += 1
                    break
        if moved == 0:
            break
    return assign


def partition(g: CompGraph, n_groups: int = 60, balance: float = 2.0) -> dict:
    """op_id -> group_id. Groups are ACYCLIC (intervals of a topological
    order, refined monotonically): required because the strategy creator
    treats each group as one schedulable unit."""
    n_groups = max(1, min(n_groups, len(g.nodes)))
    order = g.topo_order()
    weights = {i: max(g.nodes[i].flops, 1.0) for i in g.nodes}
    total = sum(weights.values())
    target = total / n_groups
    assign, gid, acc = {}, 0, 0.0
    for op in order:
        assign[op] = gid
        acc += weights[op]
        if acc >= target * (gid + 1) and gid < n_groups - 1:
            gid += 1
    assign = _monotone_refine(g, assign, n_groups, balance)
    # anchor parameter sources with their first consumer and ApplyGradient
    # sinks with their gradient producer (keeps param/grad bytes attributed
    # to the groups that actually use them; preserves monotonicity since
    # params are sources and apply nodes are sinks)
    g.build_adj()
    for op, node in g.nodes.items():
        if node.is_param and g._out[op]:
            assign[op] = min(assign[e.dst] for e in g._out[op])
        elif node.is_apply_grad and g._in[op]:
            assign[op] = max(assign[e.src] for e in g._in[op])
    out = _condense_cycles(g, assign)   # safety net (no-op when monotone)
    return _topo_renumber(g, out)
