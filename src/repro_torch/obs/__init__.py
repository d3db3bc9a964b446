"""Observability: the span tracer and the metrics registry."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, labeled, parse_labels)
from repro_torch.obs.trace import TRACER, SpanRecord, Tracer, span, traced

__all__ = ["TRACER", "Tracer", "SpanRecord", "span", "traced",
           "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "labeled", "parse_labels"]
