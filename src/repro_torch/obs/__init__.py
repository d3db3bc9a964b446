"""Observability: the span tracer, the metrics registry and the event
log."""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, labeled, parse_labels)
from repro_torch.obs.trace import TRACER, SpanRecord, Tracer, span, traced
from repro_torch.obs.events import EVENTS, Event, EventLog

__all__ = ["TRACER", "Tracer", "SpanRecord", "span", "traced",
           "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "labeled", "parse_labels", "EVENTS", "Event", "EventLog"]
