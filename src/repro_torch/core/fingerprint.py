"""Canonical, process-stable content fingerprints for computation graphs.

Hashes are sha256 over a canonical JSON encoding (sorted keys, floats via
``repr``), so they are stable across processes and Python hash
randomization. Display names are deliberately excluded: the same model
traced under two labels is the same planning problem.

This lives in ``core`` (not the service layer) because core consumers —
``tag.sfb_post_pass``'s plan cache keys — need a collision-safe graph
identity too; ``repro.service.fingerprint`` re-exports everything here and
adds the topology/structural-feature fingerprints the planner uses.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from repro_torch.core.graph import CompGraph, GroupedGraph


def _canon(obj):
    """Convert to canonically-JSON-serializable form (numpy -> python)."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_canon(v) for v in obj.tolist()]
    if isinstance(obj, (np.floating, float)):
        return repr(float(obj))
    if isinstance(obj, (np.integer, int, bool)) or obj is None:
        return obj
    return str(obj)


def canonical_json(obj) -> str:
    return json.dumps(_canon(obj), sort_keys=True, separators=(",", ":"))


def _sha(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def fingerprint_graph(graph: CompGraph) -> str:
    """Structure + costs of a CompGraph (node names / graph name ignored)."""
    nodes = [[n.op_id, n.op_type, n.flops, n.bytes_out, n.param_bytes,
              n.grad_bytes, n.split.value, n.is_grad_producer,
              n.is_apply_grad, n.is_param, n.batch_dim, n.grad_of]
             for n in sorted(graph.nodes.values(), key=lambda x: x.op_id)]
    edges = sorted([e.src, e.dst, e.bytes] for e in graph.edges)
    return _sha({"nodes": nodes, "edges": edges})


def fingerprint_grouped(gg: GroupedGraph) -> str:
    """Grouped view: base graph + partition assignment + group costs."""
    groups = [[g.group_id, sorted(g.op_ids), g.flops, g.param_bytes,
               g.grad_bytes, g.bytes_out, g.has_grad, g.split.value]
              for g in gg.groups]
    edges = sorted([gi, gj, b] for (gi, gj), b in gg.edges.items())
    return _sha({"base": fingerprint_graph(gg.base), "groups": groups,
                 "edges": edges})


def fingerprint_grouped_cached(gg: GroupedGraph) -> str:
    """``fingerprint_grouped`` memoized on the instance itself. The cached
    digest travels — and dies — with the graph object, so unlike an
    ``id()``-keyed side table it can never alias a recycled id. Callers
    must not mutate a graph after fingerprinting it (nothing in this
    codebase does: grouped graphs are built once by ``group_graph``)."""
    fp = gg.__dict__.get("_fp_grouped")
    if fp is None:
        fp = fingerprint_grouped(gg)
        gg.__dict__["_fp_grouped"] = fp
    return fp
