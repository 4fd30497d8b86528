"""Automatic Sufficient Factor Broadcasting (paper §4.2.3).

For every gradient tensor (g -> l, l = ApplyGradient) inside a replicated
op group, solve the min-cut-like ILP

  min (D-1) sum_i alpha_i T_i  +  D(D-1) sum_(j,i) b_ji L_ji / tau
      - 2 alpha_g (D-1)/D * L_gl / tau
  s.t. alpha_k <= sum_{(k,i) in E} alpha_i   (k != l)
       b_ji >= alpha_i - alpha_j

exactly with branch-and-bound over alpha in reverse topological order
(b is determined by alpha at optimum; consumers are fixed before
producers, so the closure constraint is checked exactly). Cbc is not
available offline — subproblems are tiny (an op group around one
gradient), and the B&B is validated against brute force in tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.graph import CompGraph

MAX_BRUTE = 18


@dataclass
class SFBProblem:
    ops: list                    # op ids (V), excluding l
    edges: list                  # (j, i, L_ji) within V + edges into l
    times: dict                  # op id -> T_i (seconds on a replica device)
    g: int                       # gradient producer op
    l: int                       # optimizer (ApplyGradient) op
    grad_bytes: float            # L_gl
    D: int                       # replica count
    tau: float                   # bottleneck bandwidth (B/s)


@dataclass
class SFBSolution:
    alpha: dict                  # op id -> 0/1
    objective: float             # seconds (negative => beneficial)
    extra_flops_time: float      # (D-1) sum alpha_i T_i
    bcast_bytes: float           # sum over cut tensors of L_ji (per pair)
    saved_sync_bytes: float      # L_gl if alpha_g else 0

    @property
    def beneficial(self):
        return self.objective < 0 and any(self.alpha.values())


def _objective_terms(prob: SFBProblem, alpha: dict):
    D, tau = prob.D, prob.tau
    t_comp = (D - 1) * sum(prob.times.get(i, 0.0) for i, a in alpha.items()
                           if a)
    cut = sum(L for (j, i, L) in prob.edges
              if alpha.get(i, 0) and not alpha.get(j, 0))
    t_comm = D * (D - 1) * cut / tau
    t_save = 2 * alpha.get(prob.g, 0) * (D - 1) / D * prob.grad_bytes / tau
    return t_comp + t_comm - t_save, t_comp, cut


def solve_brute(prob: SFBProblem) -> SFBSolution:
    """Exhaustive reference (tests only)."""
    ops = prob.ops
    assert len(ops) <= MAX_BRUTE
    cons = {k: [] for k in ops}
    for (j, i, _) in prob.edges:
        if j in cons and i in prob.ops:
            cons[j].append(i)
    best, best_alpha = 0.0, {o: 0 for o in ops}
    for mask in range(1 << len(ops)):
        alpha = {o: (mask >> k) & 1 for k, o in enumerate(ops)}
        ok = True
        for k in ops:
            if alpha[k] and not any(alpha.get(c, 0) for c in cons[k]) \
                    and k != prob.g:
                ok = False
                break
        if not ok:
            continue
        obj, _, _ = _objective_terms(prob, alpha)
        if obj < best:
            best, best_alpha = obj, alpha
    obj, tc, cut = _objective_terms(prob, best_alpha)
    return SFBSolution(best_alpha, obj, tc, cut,
                       prob.grad_bytes if best_alpha.get(prob.g) else 0.0)


def solve(prob: SFBProblem) -> SFBSolution:
    """Exact branch-and-bound in reverse topological order."""
    ops = prob.ops
    n = len(ops)
    pos = {o: k for k, o in enumerate(ops)}
    cons: dict = {o: [] for o in ops}
    in_edges: dict = {o: [] for o in ops}
    for (j, i, L) in prob.edges:
        if j in cons and i in cons:
            cons[j].append(i)
            in_edges[i].append((j, L))

    # reverse-topo order (consumers before producers): topological sort on
    # reversed edges i -> j (consumer to producer)
    radj = {o: [] for o in ops}
    rdeg = {o: 0 for o in ops}
    for j in ops:
        for i in cons[j]:
            radj[i].append(j)
            rdeg[j] += 1
    stack = [o for o in ops if rdeg[o] == 0]
    order = []
    while stack:
        u = stack.pop()
        order.append(u)
        for w in radj[u]:
            rdeg[w] -= 1
            if rdeg[w] == 0:
                stack.append(w)
    if len(order) != n:        # cyclic residue (shouldn't happen): fallback
        order = sorted(ops, key=lambda o: -pos[o])

    D, tau = prob.D, prob.tau
    save = 2 * (D - 1) / D * prob.grad_bytes / tau
    best = {"obj": 0.0, "alpha": {o: 0 for o in ops}}

    alpha: dict = {}

    def edge_cost_if_fixed(o):
        """Costs of edges whose BOTH endpoints are now fixed (consumer o's
        in-edges j->o, plus o's out-edges to already-fixed consumers)."""
        c = 0.0
        if alpha[o]:
            for (j, L) in in_edges[o]:
                if j in alpha and not alpha[j]:
                    c += D * (D - 1) * L / tau
        else:
            pass
        for i in cons[o]:
            if i in alpha and alpha[i] and not alpha[o]:
                for (j, L) in in_edges[i]:
                    if j == o:
                        c += D * (D - 1) * L / tau
        return c

    def rec(k, cost):
        nonlocal best
        # lower bound: remaining ops can only add cost; the only remaining
        # negative term is the g-saving if g unfixed
        lb = cost - (save if prob.g not in alpha else 0.0)
        if lb >= best["obj"]:
            return
        if k == n:
            if cost < best["obj"]:
                best = {"obj": cost, "alpha": dict(alpha)}
            return
        o = order[k]
        for val in (0, 1):
            if val == 1 and o != prob.g:
                # closure: some consumer inside V must be duplicated,
                # or o's only consumer is l via g (handled by g anchor)
                if not any(alpha.get(c, 0) for c in cons[o]):
                    continue
            alpha[o] = val
            delta = (D - 1) * prob.times.get(o, 0.0) if val else 0.0
            delta += edge_cost_if_fixed(o)
            if val and o == prob.g:
                delta -= save
            rec(k + 1, cost + delta)
            del alpha[o]

    rec(0, 0.0)
    sol_alpha = {o: best["alpha"].get(o, 0) for o in ops}
    obj, tc, cut = _objective_terms(prob, sol_alpha)
    return SFBSolution(sol_alpha, obj, tc, cut,
                       prob.grad_bytes if sol_alpha.get(prob.g) else 0.0)


MAX_SUBGRAPH = 24   # paper §3.3: the problem stays small — only the
                    # subgraph around one gradient is considered


def build_problem(graph: CompGraph, group_ops, g_id: int, l_id: int,
                  D: int, tau: float, dev_flops: float) -> SFBProblem:
    """Extract the SFB subproblem for gradient (g -> l) inside an op group:
    the upstream neighborhood of g within the group, capped at
    MAX_SUBGRAPH ops (BFS by producer edges)."""
    opset_all = set(group_ops) - {l_id}
    graph.build_adj()
    ops = [g_id]
    seen = {g_id}
    frontier = [g_id]
    while frontier and len(ops) < MAX_SUBGRAPH:
        nxt = []
        for o in frontier:
            for e in graph._in.get(o, []):
                if e.src in opset_all and e.src not in seen:
                    seen.add(e.src)
                    ops.append(e.src)
                    nxt.append(e.src)
                    if len(ops) >= MAX_SUBGRAPH:
                        break
            if len(ops) >= MAX_SUBGRAPH:
                break
        frontier = nxt
    opset = set(ops)
    edges = []
    grad_bytes = 0.0
    for e in graph.edges:
        if e.src == g_id and e.dst == l_id:
            grad_bytes = max(grad_bytes, e.bytes)
        if e.src in opset and e.dst in opset:
            edges.append((e.src, e.dst, e.bytes))
    times = {o: graph.nodes[o].flops / dev_flops for o in ops}
    return SFBProblem(ops, edges, times, g_id, l_id, grad_bytes, D, tau)


@dataclass
class GroupSFB:
    """Aggregate SFB plan for one op group (consumed by the compiler)."""
    extra_flops: float = 0.0           # full-batch flops of duplicated ops
    bcast_bytes: float = 0.0           # tensors broadcast between replicas
    saved_sync_bytes: float = 0.0      # gradient bytes no longer synced
    dup_op_types: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"extra_flops": float(self.extra_flops),
                "bcast_bytes": float(self.bcast_bytes),
                "saved_sync_bytes": float(self.saved_sync_bytes),
                "dup_op_types": list(self.dup_op_types)}

    @classmethod
    def from_dict(cls, d: dict) -> "GroupSFB":
        return cls(extra_flops=float(d["extra_flops"]),
                   bcast_bytes=float(d["bcast_bytes"]),
                   saved_sync_bytes=float(d["saved_sync_bytes"]),
                   dup_op_types=list(d["dup_op_types"]))


def optimize_group(graph: CompGraph, group_ops, D: int, tau: float,
                   dev_flops: float) -> GroupSFB:
    """Paper: for every gradient tensor in a replicated op group, solve the
    ILP and apply beneficial duplications. Returns the aggregate plan."""
    plan = GroupSFB()
    opset = set(group_ops)
    for o in group_ops:
        node = graph.nodes[o]
        if not node.is_grad_producer or node.grad_of is None:
            continue
        prob = build_problem(graph, group_ops, o, node.grad_of, D, tau,
                             dev_flops)
        if prob.grad_bytes <= 0:
            continue
        sol = solve(prob)
        if sol.beneficial:
            plan.extra_flops += sum(
                graph.nodes[i].flops for i, a in sol.alpha.items() if a)
            plan.bcast_bytes += sol.bcast_bytes
            plan.saved_sync_bytes += sol.saved_sync_bytes
            plan.dup_op_types.extend(
                graph.nodes[i].op_type for i, a in sol.alpha.items() if a
                and i in opset)
    return plan
