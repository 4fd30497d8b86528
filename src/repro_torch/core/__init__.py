"""The TAG planner of the port: a copy of ``repro.core``'s numpy planner
(graph, grouping, topology, strategies, cost model, simulator, MCTS, SFB)
with a PyTorch training-graph tracer (``torch_export``) in place of
``jax_export``, and the GNN policy (``hetgnn``, ``trainer``) in PyTorch."""
