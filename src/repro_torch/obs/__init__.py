"""Observability of the port. So far the span tracer the planner records
into (``repro.obs.spans``'s counterpart); the rest of ``repro.obs`` is a
later slice."""
from repro_torch.obs.spans import Span, Tracer, get_tracer, set_tracer, span

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer", "span"]
