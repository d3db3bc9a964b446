# Copied from src/repro/obs/__init__.py; imports point at repro_torch.
"""Observability layer: tracing, metrics, drift — and the production plane.

The three in-process pieces the paper's validation environment implies but
never shows: ``trace`` (where did the milliseconds go — Perfetto-exportable
spans across compile and serve, with the simulator's modeled engine timeline
as a parallel track), ``metrics`` (bounded counters/gauges/histograms the
server keeps), and ``drift`` (is the device profile the plan was ranked
under still true).  On top of them, the exportable plane a fleet router or a
continuous-autotuning loop consumes live: ``export`` (OpenMetrics text
exposition + HTTP scrape endpoint), ``events`` (structured severity-levelled
JSONL event log, trace-correlated), ``flight`` (bounded per-request flight
recorder with forensic auto-dumps), and ``slo`` (per-tenant error-budget
burn-rate tracking with fast/slow-window alerting).
"""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, labeled, parse_labels)
from repro_torch.obs.trace import TRACER, SpanRecord, Tracer, span, traced
from repro_torch.obs.drift import DriftProfiler, DriftReport, UnitDrift
from repro_torch.obs.events import EVENTS, Event, EventLog
from repro_torch.obs.export import (ObsHTTPServer, OpenMetricsError,
                                    find_samples, parse_openmetrics,
                                    render_openmetrics)
from repro_torch.obs.flight import FlightRecord, FlightRecorder
from repro_torch.obs.slo import BurnRateTracker

__all__ = [
    "TRACER", "Tracer", "SpanRecord", "span", "traced",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "labeled", "parse_labels",
    "DriftProfiler", "DriftReport", "UnitDrift",
    "EVENTS", "Event", "EventLog",
    "ObsHTTPServer", "OpenMetricsError", "find_samples",
    "parse_openmetrics", "render_openmetrics",
    "FlightRecord", "FlightRecorder",
    "BurnRateTracker",
]
