"""Canonical, process-stable fingerprints for plan-cache keys.

Two requests dedupe iff their computation graph and device topology hash
identically. Graph-content fingerprints live in ``repro_torch.core.fingerprint``
(core consumers need them too) and are re-exported here; this module adds
the topology fingerprints and the structural feature vectors the planner's
cross-model transfer tier ranks donors with.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np

from repro_torch.core.device import Topology
from repro_torch.core.fingerprint import (  # noqa: F401  (re-exports)
    _sha, canonical_json, fingerprint_graph, fingerprint_grouped,
    fingerprint_grouped_cached)
from repro_torch.core.graph import GroupedGraph


def fingerprint_topology(topo: Topology) -> str:
    """Full topology identity: device specs + link matrix + efficiency
    factors (everything the simulator reads)."""
    groups = [[g.group_id, g.gpu_type, g.num_gpus, g.intra_bw, g.mem_bytes,
               g.flops] for g in topo.groups]
    return _sha({"groups": groups, "inter_bw": topo.inter_bw,
                 "latency": topo.latency,
                 "eff": [topo.coll_eff_cross, topo.coll_eff_intra,
                         topo.p2p_eff],
                 # per-pair calibrated overrides (Topology.bw reads them;
                 # two calibrations differing only per-pair must not
                 # dedupe to one cached plan)
                 "pair_eff": sorted(
                     (f"{gi}-{gj}", eff)
                     for (gi, gj), eff in topo.pair_eff.items())})


def topology_structure_fingerprint(topo: Topology) -> str:
    """Bandwidth-blind structure (device groups + types + counts): two
    topologies with equal structure but perturbed links are prime
    warm-start donors for each other."""
    return _sha({"groups": [[g.group_id, g.gpu_type, g.num_gpus]
                            for g in topo.groups]})


# -------------------------------------------------- structural features
#
# Where the hashes above answer "is this the SAME planning problem?", the
# feature vector answers "how NEAR is this problem to one we solved?" —
# the cross-model transfer tier (paper §5.2 / Table 8): an unseen model
# seeds its search from the cached plan of the structurally closest known
# graph, and the policy registry picks the checkpoint whose training
# corpus sits nearest.

STRUCT_HIST_BUCKETS = 16
STRUCT_SCALARS = 13
STRUCT_F = STRUCT_SCALARS + STRUCT_HIST_BUCKETS  # stats + op-type histogram


def _type_bucket(op_type: str) -> int:
    """Stable op-type -> histogram bucket (independent of hash seed)."""
    h = hashlib.sha256(str(op_type).encode()).digest()
    return h[0] % STRUCT_HIST_BUCKETS


def structural_features(gg: GroupedGraph) -> list:
    """Scale-normalized structural descriptor of a grouped graph.

    Entries: log-scaled node/group/edge counts, total and per-group
    compute/parameter/activation statistics, gradient-producing fraction,
    and a hashed op-type histogram (fractions). Log scaling keeps unseen
    model scales in range (same rationale as ``features.featurize``);
    fractions make the histogram batch-size independent.
    """
    nodes = list(gg.base.nodes.values())
    n_nodes = max(len(nodes), 1)
    per_group_pb = [math.log1p(g.param_bytes / 1e6) for g in gg.groups]
    per_group_fl = [math.log1p(g.flops / 1e9) for g in gg.groups]
    edge_bytes = list(gg.edges.values())

    def _mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    def _std(xs):
        if not xs:
            return 0.0
        m = _mean(xs)
        return math.sqrt(_mean([(x - m) ** 2 for x in xs]))

    vec = [
        math.log1p(len(nodes)),
        math.log1p(gg.n),
        math.log1p(len(gg.edges)),
        math.log1p(sum(g.flops for g in gg.groups) / 1e9),
        math.log1p(sum(g.param_bytes for g in gg.groups) / 1e6),
        math.log1p(sum(g.grad_bytes for g in gg.groups) / 1e6),
        math.log1p(sum(g.bytes_out for g in gg.groups) / 1e6),
        sum(g.has_grad for g in gg.groups) / max(gg.n, 1),
        _mean(per_group_pb), _std(per_group_pb),
        _mean(per_group_fl), _std(per_group_fl),
        math.log1p(_mean(edge_bytes) / 1e6),
    ]
    hist = [0.0] * STRUCT_HIST_BUCKETS
    for n in nodes:
        hist[_type_bucket(n.op_type)] += 1.0
    vec.extend(h / n_nodes for h in hist)
    return [float(v) for v in vec]


def _block_normalize(v: np.ndarray) -> np.ndarray | None:
    """Unit-normalize the scalar-stats and op-histogram blocks separately
    before comparing: raw log-scale stats are an order of magnitude larger
    than histogram fractions and strongly correlated across ALL DNNs, so
    an unweighted cosine would rank a conv net "nearest" an attention
    stack just for having similar parameter volume. Block-normalized,
    model families separate cleanly (attention<->attention ~0.006,
    conv<->conv ~0.02, cross-family ~0.3)."""
    s, h = v[:STRUCT_SCALARS], v[STRUCT_SCALARS:]
    ns, nh = float(np.linalg.norm(s)), float(np.linalg.norm(h))
    if ns == 0.0 and nh == 0.0:
        return None
    return np.concatenate([s / ns if ns else s, h / nh if nh else h])


def structural_features_cached(gg: GroupedGraph) -> list:
    """``structural_features`` memoized on the instance (same contract as
    ``fingerprint_grouped_cached``: graphs are never mutated after
    grouping). The planner computes this per request — including exact
    cache hits, which never read it — so the walk must not repeat."""
    feats = gg.__dict__.get("_struct_features")
    if feats is None:
        feats = structural_features(gg)
        gg.__dict__["_struct_features"] = feats
    return feats


def structural_distance(a, b) -> float:
    """Cosine distance between structural feature vectors (0 = identical
    direction, 1 = orthogonal), computed on block-normalized vectors.
    Length mismatches (schema drift) are treated as maximally distant."""
    if a is None or b is None or len(a) == 0 or len(b) == 0 \
            or len(a) != len(b) or len(a) != STRUCT_F:
        return float("inf")
    va = _block_normalize(np.asarray(a, float))
    vb = _block_normalize(np.asarray(b, float))
    if va is None or vb is None:
        return float("inf")
    na, nb = float(np.linalg.norm(va)), float(np.linalg.norm(vb))
    return float(1.0 - float(va @ vb) / (na * nb))
