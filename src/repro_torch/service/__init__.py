"""Planner service: persistent strategy cache + warm-started search.

Wraps the TAG pipeline (trace -> group -> MCTS -> SFB -> simulate) as a
long-lived planner that amortizes search cost across requests:

  * exact (graph, topology) repeats are served from a versioned plan
    store without re-running MCTS;
  * near repeats (same graph on a perturbed topology, or a new graph on
    a known topology) warm-start MCTS from the cached strategy.

    from repro_torch.service import PlannerService
    svc = PlannerService(cache_dir=".plans")
    resp = svc.plan(loss_fn, params, batch, topo, iterations=60)
"""
from repro_torch.service.fingerprint import (  # noqa: F401
    fingerprint_graph, fingerprint_grouped, fingerprint_grouped_cached,
    fingerprint_topology, structural_distance, structural_features,
    topology_structure_fingerprint)
from repro_torch.service.planner import (  # noqa: F401
    PlannerService, PlanRequest, PlanResponse)
from repro_torch.service.registry import (  # noqa: F401
    PolicyRecord, PolicyRegistry)
from repro_torch.service.store import PlanRecord, PlanStore  # noqa: F401
from repro_torch.service.warmstart import adapt_strategy, find_prior  # noqa: F401
