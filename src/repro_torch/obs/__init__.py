"""Observability for the PyTorch port: span tracing + metrics registry.

A copy of the framework-free ``repro.obs`` package (the port imports
nothing of ``repro``), so :class:`repro_torch.sphere.dataflow.SPMDExecutor`
takes ``trace=`` and publishes the same counters as its JAX counterpart.
"""

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Span, TraceBuffer, Tracer

__all__ = ["Tracer", "TraceBuffer", "Span", "NULL_TRACER",
           "MetricsRegistry", "REGISTRY"]
