"""Parallel execution helpers of the port: the gradient-sync primitives of
per-stage data parallelism (``sfb_dense``)."""
