# Copied from src/repro/obs/metrics.py; imports point at repro_torch.
"""Metrics registry: counters, gauges, and fixed-bucket histograms.

Prometheus-shaped but in-process: the serving path increments named metrics
(queue depth, batch-size histogram, request latency, plan-cache hits, fused vs
fallback launches, SLO shrink/grow events) and :meth:`MetricsRegistry.snapshot`
renders everything as one stable, JSON-serialisable dict that ``serve_bench``
emits next to its throughput numbers.

Memory is bounded by construction: a counter/gauge is two floats, a histogram
is a fixed bucket array plus running sum/count/min/max (no sample retention),
and the registry refuses to grow past ``max_metrics`` distinct names — a typo
in a hot loop cannot leak memory.  All mutation is lock-protected; the
serving worker thread and caller threads share one registry.
"""
from __future__ import annotations

import bisect
import threading

# Request latencies in serving land between ~0.1 ms (cached toy graphs) and
# seconds (cold jit); buckets are in *milliseconds*, roughly logarithmic.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)
# Batch sizes are small integers; one bucket per power of two up to 256.
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def labeled(name: str, labels: dict | None) -> str:
    """Mangle a metric name with sorted key=value labels, Prometheus-style:
    ``labeled("requests", {"model": "vgg16"}) == 'requests{model=vgg16}'``.
    Labels must stay low-cardinality — each combination is a distinct metric
    counted against the registry cap."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_labels(name: str) -> tuple[str, dict]:
    """Inverse of :func:`labeled`: split a mangled metric name back into
    ``(base_name, labels)`` — ``'requests{model=vgg16}'`` becomes
    ``('requests', {'model': 'vgg16'})``.  Names without labels return an
    empty dict.  The OpenMetrics exporter and the registry's ``labelled``
    query both de-mangle through here, so the round trip is pinned in one
    place."""
    if not name.endswith("}") or "{" not in name:
        return name, {}
    base, _, inner = name[:-1].partition("{")
    labels = {}
    for part in inner.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k] = v
    return base, labels


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return {"type": "counter", "value": self._value}


class Gauge:
    """Point-in-time value (queue depth, current batch cap)."""
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bound bucket histogram with running sum/count/min/max.

    ``bounds`` are upper bucket edges; observations above the last bound land
    in a +inf overflow bucket.  ``percentile`` interpolates within the winning
    bucket — exact enough for p50/p99 dashboards without retaining samples.
    """
    __slots__ = ("name", "bounds", "counts", "_sum", "_count", "_min", "_max",
                 "_lock")

    def __init__(self, name: str, bounds=DEFAULT_LATENCY_BUCKETS_MS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("bucket bounds must be non-empty and sorted")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # + overflow
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) by linear interpolation inside
        the bucket containing the rank; the overflow bucket reports the
        observed max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = q * self._count
            seen = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    if i == len(self.bounds):        # overflow bucket
                        return self._max
                    lo = self.bounds[i - 1] if i else min(self._min,
                                                          self.bounds[i])
                    hi = self.bounds[i]
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * frac
                seen += c
            return self._max

    def snapshot(self):
        with self._lock:
            return {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": {
                    **{str(b): self.counts[i]
                       for i, b in enumerate(self.bounds)},
                    "+inf": self.counts[-1],
                },
            }


class MetricsRegistry:
    """Thread-safe name -> metric table with get-or-create accessors.

    Re-requesting a name returns the existing instance; requesting it as a
    different type raises.  The registry caps distinct names at
    ``max_metrics``."""

    def __init__(self, max_metrics: int = 1024):
        self.max_metrics = max_metrics
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
                return m
            if len(self._metrics) >= self.max_metrics:
                raise RuntimeError(
                    f"metrics registry full ({self.max_metrics}); "
                    "metric names must be low-cardinality")
            m = factory()
            self._metrics[name] = m
            return m

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        name = labeled(name, labels)
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        name = labeled(name, labels)
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, bounds=DEFAULT_LATENCY_BUCKETS_MS,
                  labels: dict | None = None) -> Histogram:
        name = labeled(name, labels)
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, bounds))

    def get(self, name: str):
        return self._metrics.get(name)

    def labelled(self, name: str, label: str = "model") -> dict:
        """Every metric registered under base name ``name``, keyed by the
        value of ``label``: ``labelled("serve.rejected")`` returns
        ``{"vgg16": Counter, "resnet50": Counter, ...}``.  An unlabeled
        metric of the same base name appears under ``None``.  This is the
        query API for per-tenant stats — callers never hand-format
        ``'name{model=...}'`` lookups."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for full, m in items:
            base, labels = parse_labels(full)
            if base != name:
                continue
            if not labels:
                out[None] = m
            elif label in labels:
                out[labels[label]] = m
        return out

    def __len__(self) -> int:
        return len(self._metrics)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """Stable (sorted-name) JSON-serialisable view of every metric.
        Histograms additionally report p50/p99 for dashboard convenience."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            snap = m.snapshot()
            if isinstance(m, Histogram) and m.count:
                snap["p50"] = m.percentile(0.50)
                snap["p99"] = m.percentile(0.99)
                snap["mean"] = m.mean
            out[name] = snap
        return out


# Shared default registry; the runtime wires into this unless handed its own.
REGISTRY = MetricsRegistry()
