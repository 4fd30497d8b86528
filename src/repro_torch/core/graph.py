"""Computation-graph IR for TAG (paper §4.1).

Nodes are ops with per-device-type compute costs, parameter sizes and a
splittability category; edges are tensors with byte sizes. A grouped view
(op groups from the METIS-style partitioner) exposes the same interface to
the strategy creator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import enum


class Split(enum.Enum):
    CONCAT = "concat"     # splittable in batch dim, outputs concatenated
    SUM = "sum"           # splittable, outputs summed (gradient-like)
    OTHER = "other"       # not splittable (inputs must be aggregated first)


@dataclass
class OpNode:
    op_id: int
    name: str
    op_type: str                      # primitive name ("dot_general", ...)
    flops: float = 0.0
    bytes_out: float = 0.0            # total output tensor bytes
    param_bytes: float = 0.0          # trainable parameter bytes attached
    grad_bytes: float = 0.0           # gradient tensor bytes produced here
    split: Split = Split.CONCAT
    is_grad_producer: bool = False    # produces a parameter gradient
    is_apply_grad: bool = False       # optimizer update op
    is_param: bool = False            # parameter source node
    batch_dim: bool = True            # output carries the batch dimension
    grad_of: int | None = None        # op_id of the ApplyGradient consumer


@dataclass
class TensorEdge:
    src: int
    dst: int
    bytes: float


@dataclass
class CompGraph:
    nodes: dict = field(default_factory=dict)     # op_id -> OpNode
    edges: list = field(default_factory=list)     # list[TensorEdge]
    name: str = ""

    def add_node(self, node: OpNode):
        self.nodes[node.op_id] = node

    def add_edge(self, src: int, dst: int, nbytes: float):
        self.edges.append(TensorEdge(src, dst, float(nbytes)))

    # -- adjacency helpers ------------------------------------------------
    def in_edges(self, op_id: int):
        return [e for e in self.edges if e.dst == op_id]

    def out_edges(self, op_id: int):
        return [e for e in self.edges if e.src == op_id]

    def build_adj(self):
        self._in = {i: [] for i in self.nodes}
        self._out = {i: [] for i in self.nodes}
        for e in self.edges:
            self._out[e.src].append(e)
            self._in[e.dst].append(e)
        return self

    def preds(self, op_id: int):
        return [e.src for e in self._in[op_id]]

    def succs(self, op_id: int):
        return [e.dst for e in self._out[op_id]]

    def topo_order(self):
        indeg = {i: 0 for i in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        stack = [i for i, d in indeg.items() if d == 0]
        order = []
        self.build_adj()
        while stack:
            u = stack.pop()
            order.append(u)
            for e in self._out[u]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    stack.append(e.dst)
        assert len(order) == len(self.nodes), "cycle in computation graph"
        return order

    def total_flops(self):
        return sum(n.flops for n in self.nodes.values())

    def simplify(self):
        """Paper §4.1.1: drop identity/no-op nodes and dangling subgraphs not
        connected to optimizer (apply-grad) ops."""
        # remove trivial ops by splicing edges through them, in ascending id
        # order, each tested for exactly one input on the graph as the
        # earlier splices left it. Edges get ids in list order and spliced
        # edges are appended, so each node's in/out dicts (id -> edge, kept
        # in insertion order) list its live edges in edge-list order, and the
        # survivors come out in the order a splice-and-rebuild loop leaves:
        # linear in nodes + edges.
        trivial = {i for i, n in self.nodes.items()
                   if n.op_type in ("copy", "convert_element_type",
                                    "stop_gradient", "broadcast_in_dim")
                   and n.flops == 0 and not n.is_apply_grad
                   and not n.is_param}
        live = dict(enumerate(self.edges))
        ins = {i: {} for i in self.nodes}
        outs = {i: {} for i in self.nodes}
        for k, e in live.items():
            outs[e.src][k] = e
            ins[e.dst][k] = e
        for t in sorted(trivial):
            if len(ins[t]) != 1:
                continue
            src = next(iter(ins[t].values())).src
            spliced = [TensorEdge(src, oe.dst, oe.bytes) for oe in outs[t].values()]
            for k, e in list(ins[t].items()) + list(outs[t].items()):
                if k in live:
                    del live[k]
                    outs[e.src].pop(k, None)
                    ins[e.dst].pop(k, None)
            for e in spliced:
                if e.src != t and e.dst != t:   # a self-loop's splice is dropped with t
                    k = len(self.edges)
                    self.edges.append(e)
                    live[k] = e
                    outs[e.src][k] = e
                    ins[e.dst][k] = e
            del self.nodes[t], ins[t], outs[t]
        self.edges = list(live.values())
        self.build_adj()
        # keep only nodes that reach (or are reached from) an anchor
        anchors = [i for i, n in self.nodes.items()
                   if n.is_apply_grad or n.is_grad_producer]
        if not anchors:
            return self
        keep = set(anchors)
        und = {i: set() for i in self.nodes}
        for e in self.edges:
            und[e.src].add(e.dst)
            und[e.dst].add(e.src)
        frontier = list(anchors)
        while frontier:
            u = frontier.pop()
            for v in und[u]:
                if v not in keep:
                    keep.add(v)
                    frontier.append(v)
        self.nodes = {i: n for i, n in self.nodes.items() if i in keep}
        self.edges = [e for e in self.edges if e.src in keep and e.dst in keep]
        return self


@dataclass
class OpGroup:
    group_id: int
    op_ids: list
    flops: float
    param_bytes: float
    grad_bytes: float
    bytes_out: float
    has_grad: bool
    split: Split


@dataclass
class GroupedGraph:
    """Strategy-creator view: N op groups + inter-group tensor sizes."""
    base: CompGraph
    groups: list                       # list[OpGroup], index = group id
    edges: dict = field(default_factory=dict)   # (gi, gj) -> bytes

    @property
    def n(self):
        return len(self.groups)

    def group_of(self):
        m = {}
        for g in self.groups:
            for o in g.op_ids:
                m[o] = g.group_id
        return m

    def sorted_by_cost(self):
        """Paper §4.2.2: op groups in descending order of computation time."""
        return sorted(range(self.n), key=lambda g: -self.groups[g].flops)


def group_graph(graph: CompGraph, assignment: dict) -> GroupedGraph:
    """Build the grouped view given op->group assignment."""
    n = max(assignment.values()) + 1 if assignment else 0
    groups = []
    for gid in range(n):
        ids = [o for o, g in assignment.items() if g == gid]
        nodes = [graph.nodes[o] for o in ids]
        split = Split.CONCAT
        if any(x.split == Split.OTHER for x in nodes):
            split = Split.OTHER
        elif any(x.split == Split.SUM for x in nodes):
            split = Split.SUM
        groups.append(OpGroup(
            group_id=gid, op_ids=ids,
            flops=sum(x.flops for x in nodes),
            param_bytes=sum(x.param_bytes for x in nodes),
            grad_bytes=sum(x.grad_bytes for x in nodes),
            bytes_out=sum(x.bytes_out for x in nodes),
            has_grad=any(x.is_grad_producer for x in nodes),
            split=split))
    gg = GroupedGraph(base=graph, groups=groups)
    for e in graph.edges:
        gi, gj = assignment[e.src], assignment[e.dst]
        if gi != gj:
            gg.edges[(gi, gj)] = gg.edges.get((gi, gj), 0.0) + e.bytes
    return gg
