"""Warm-start selection and strategy adaptation.

On a cache miss with a *near* hit — the same graph on a perturbed
topology, a new graph on a known topology, or (the Table 8 transfer
tier) a structurally similar graph on any topology — the cached strategy
seeds MCTS (``prior_strategy=`` in ``core.mcts``) instead of a cold
root: the first playout replays the prior actions and the search priors
are biased toward them, so the search re-converges in far fewer playouts
(the Placeto-style generalization TAG claims in §5.2).
"""
from __future__ import annotations

from repro_torch.core.device import Topology
from repro_torch.core.strategy import Action, Option, Strategy
from repro_torch.service.fingerprint import structural_distance
from repro_torch.service.store import PlanRecord, PlanStore

# Structural-similarity acceptance bound (block-normalized cosine
# distance, see fingerprint._block_normalize): same-family donors land
# around 0.006-0.02 and are accepted; cross-family pairs (a conv net vs
# an attention stack) land around 0.3 and are deliberately REJECTED — a
# dissimilar donor's replayed actions would bias the search priors toward
# the wrong region, which is worse than a cold start.
MAX_STRUCT_DISTANCE = 0.25


def adapt_strategy(prior: Strategy, n_groups: int,
                   topo: Topology) -> Strategy:
    """Remap a cached strategy onto a (possibly different) request shape:
    placements are clipped to the new topology's device groups; actions
    that no longer place anywhere — or groups the prior never decided —
    become undecided (MCTS fills them).

    Replication options are re-validated against the *clipped* placement:
    a sync option (AR/PS/DUP) left on a single surviving device, or a
    split option (MP/PIPE) with nothing to split across, is NOT a legal
    candidate action — the SFB pass and the simulator treat such actions
    inconsistently — so those degenerate to undecided too and MCTS refills
    them. (AR on a single device is kept only when the prior already
    placed it there: it is the legal "no sync" candidate.)
    """
    acts = []
    for gid in range(n_groups):
        a = prior.actions[gid] if gid < len(prior.actions) else None
        if a is None:
            acts.append(None)
            continue
        placement = tuple(g for g in a.placement if g < topo.m)
        if not placement:
            acts.append(None)
            continue
        n_dev = sum(topo.groups[g].num_gpus for g in placement)
        clipped = len(placement) < len(a.placement)
        if n_dev <= 1 and (clipped or a.option != Option.AR):
            acts.append(None)
            continue
        acts.append(Action(placement, a.option, schedule=a.schedule))
    return Strategy(acts)


def _best(records: list) -> PlanRecord:
    return max(records, key=lambda r: r.speedup)


def find_prior(store: PlanStore, graph_fp: str, topo_fp: str,
               topo_struct_fp: str | None = None,
               graph_features=None,
               max_struct_distance: float = MAX_STRUCT_DISTANCE):
    """Resolve a request against the store.

    Returns ``(kind, record)`` with kind one of:
      "hit"         exact (graph, topology) match — reuse verbatim
      "warm_topo"   same graph, different topology (prefer equal structure)
      "warm_graph"  same topology, different graph
      "warm_struct" unseen graph AND topology: nearest stored graph by
                    structural features (cross-model transfer, Table 8)
      "miss"        nothing usable — cold search
    """
    rec = store.get(graph_fp, topo_fp)
    if rec is not None:
        return "hit", rec
    same_graph = store.find(graph_fp=graph_fp)
    if same_graph:
        structural = [r for r in same_graph
                      if topo_struct_fp and r.topo_struct_fp == topo_struct_fp]
        return "warm_topo", _best(structural or same_graph)
    same_topo = store.find(topo_fp=topo_fp)
    if graph_features:
        # a same-topology donor is still a DIFFERENT graph: apply the
        # same structural guard as the struct tier, or a cross-family
        # donor (distance ~0.3) would bias priors toward the wrong
        # region. Records without features (pre-feature schema) keep the
        # legacy accept-any behaviour.
        same_topo = [r for r in same_topo
                     if not r.graph_features
                     or structural_distance(graph_features,
                                            r.graph_features)
                     <= max_struct_distance]
    if same_topo:
        return "warm_graph", _best(same_topo)
    if graph_features:
        scored = []
        for key, feats, speedup in store.feature_entries():
            d = structural_distance(graph_features, feats)
            if d <= max_struct_distance:
                scored.append((d, -speedup, key))
        if scored:
            key = min(scored, key=lambda x: x[:2])[2]
            rec = store.get(*key)       # promote only the chosen donor
            if rec is not None:
                return "warm_struct", rec
    return "miss", None
