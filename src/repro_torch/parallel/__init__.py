"""Parallel execution helpers of the port: logical-axis sharding rules over
a mesh of ``torch.device``s (``sharding``) and the gradient-sync primitives
of data parallelism (``sfb_dense``)."""
