# Copied from src/repro/obs/export.py; imports point at repro_torch.
"""OpenMetrics exposition + stdlib HTTP scrape endpoint.

The :class:`~repro_torch.obs.metrics.MetricsRegistry` is
Prometheus-*shaped*; this module makes it Prometheus-*scrapeable*.
:func:`render_openmetrics` turns a registry (or one of its snapshots) into
the OpenMetrics text format:

* metric names are sanitised (``serve.latency_ms`` -> ``serve_latency_ms``)
  and the registry's ``name{model=vgg16}`` label-mangling convention
  (:func:`repro_torch.obs.metrics.labeled`) is de-mangled back into real,
  quoted, escaped label sets;
* counters render as ``<family>_total`` samples, gauges as bare samples,
  histograms as *cumulative* ``_bucket{le="..."}`` series (the registry keeps
  per-bucket counts; exposition requires running totals) plus ``_sum`` and
  ``_count``, with an ``le="+Inf"`` bucket equal to the count;
* families are sorted, samples within a family are sorted by label set, and
  the document ends with ``# EOF`` — the strict-mode terminator.

:func:`parse_openmetrics` is the matching strict parser: it validates the
grammar line by line (TYPE-before-samples, family membership of every sample
name, quoted-label escaping, bucket monotonicity, ``+Inf``/``_count``
agreement, single trailing ``# EOF``) and returns the parsed families.  The
CI smoke gate scrapes a live serving run and feeds the body through it, so
the exposition format is enforced end to end, not assumed.

:class:`ObsHTTPServer` mounts the whole observability plane on a background
``http.server`` thread — ``/metrics`` (OpenMetrics), ``/flight`` (flight
recorder snapshot, JSON), ``/events`` (event log, JSON Lines), ``/snapshot``
(everything at once, JSON; what ``python -m repro_torch.obs.dump`` fetches).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, parse_labels)

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_SUFFIXES = {"counter": ("_total",), "gauge": ("",),
             "histogram": ("_bucket", "_sum", "_count")}


def sanitize_name(name: str) -> str:
    """Registry name -> OpenMetrics family name: dots become underscores and
    any other illegal character collapses to ``_``."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() and (i > 0 or not ch.isdigit()) or ch == "_":
            out.append(ch)
        else:
            out.append("_")
    return "".join(out)


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(f, "NaN")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{sanitize_name(k)}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _metric_type(snap_or_metric) -> str:
    if isinstance(snap_or_metric, dict):
        return snap_or_metric["type"]
    return {Counter: "counter", Gauge: "gauge",
            Histogram: "histogram"}[type(snap_or_metric)]


def render_openmetrics(registry_or_snapshot) -> str:
    """OpenMetrics text exposition of a :class:`MetricsRegistry` (or a
    ``registry.snapshot()`` dict).  Deterministic: families and samples are
    sorted, so equal registries render byte-identical documents."""
    snap = (registry_or_snapshot.snapshot()
            if isinstance(registry_or_snapshot, MetricsRegistry)
            else registry_or_snapshot)
    # group label variants under one family: {family: (type, [(labels, snap)])}
    families: dict[str, tuple] = {}
    for name in sorted(snap):
        base, labels = parse_labels(name)
        fam = sanitize_name(base)
        mtype = snap[name]["type"]
        if fam not in families:
            families[fam] = (mtype, [])
        elif families[fam][0] != mtype:
            raise ValueError(
                f"metrics {base!r} map to one family {fam!r} with "
                f"conflicting types {families[fam][0]}/{mtype}")
        families[fam][1].append((labels, snap[name]))

    lines = []
    for fam in sorted(families):
        mtype, series = families[fam]
        lines.append(f"# TYPE {fam} {mtype}")
        for labels, s in sorted(series, key=lambda ls: _fmt_labels(ls[0])):
            ls = _fmt_labels(labels)
            if mtype == "counter":
                lines.append(f"{fam}_total{ls} {_fmt_value(s['value'])}")
            elif mtype == "gauge":
                lines.append(f"{fam}{ls} {_fmt_value(s['value'])}")
            else:                                    # histogram: cumulative
                cum = 0
                for bound, count in s["buckets"].items():
                    if bound == "+inf":
                        continue
                    cum += count
                    ble = _fmt_labels({**labels, "le": bound})
                    lines.append(f"{fam}_bucket{ble} {cum}")
                cum += s["buckets"]["+inf"]
                ble = _fmt_labels({**labels, "le": "+Inf"})
                lines.append(f"{fam}_bucket{ble} {cum}")
                lines.append(f"{fam}_sum{ls} {_fmt_value(s['sum'])}")
                lines.append(f"{fam}_count{ls} {_fmt_value(s['count'])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ strict parsing
class OpenMetricsError(ValueError):
    """The document violates the OpenMetrics text format."""


def _parse_label_block(block: str, line_no: int) -> dict:
    """Parse ``k="v",k2="v2"`` with escape handling; strict on grammar."""
    labels: dict[str, str] = {}
    i, n = 0, len(block)
    while i < n:
        eq = block.find("=", i)
        if eq < 0:
            raise OpenMetricsError(f"line {line_no}: malformed label block")
        key = block[i:eq]
        if not key or not all(c.isalnum() or c == "_" for c in key):
            raise OpenMetricsError(f"line {line_no}: bad label name {key!r}")
        if eq + 1 >= n or block[eq + 1] != '"':
            raise OpenMetricsError(f"line {line_no}: label value not quoted")
        j, buf = eq + 2, []
        while j < n:
            c = block[j]
            if c == "\\":
                if j + 1 >= n:
                    raise OpenMetricsError(
                        f"line {line_no}: dangling escape")
                nxt = block[j + 1]
                buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt))
                if buf[-1] is None:
                    raise OpenMetricsError(
                        f"line {line_no}: bad escape \\{nxt}")
                j += 2
            elif c == '"':
                break
            else:
                buf.append(c)
                j += 1
        else:
            raise OpenMetricsError(f"line {line_no}: unterminated value")
        if key in labels:
            raise OpenMetricsError(f"line {line_no}: duplicate label {key!r}")
        labels[key] = "".join(buf)
        i = j + 1
        if i < n:
            if block[i] != ",":
                raise OpenMetricsError(
                    f"line {line_no}: expected ',' between labels")
            i += 1
    return labels


def _family_of(sample_name: str, families: dict) -> tuple[str, str] | None:
    """(family, suffix) the sample belongs to, honouring per-type suffixes.
    Longest match wins so ``x_bucket`` prefers family ``x`` over ``x_bucket``."""
    best = None
    for fam, info in families.items():
        for suf in _SUFFIXES[info["type"]]:
            if sample_name == fam + suf:
                if best is None or len(fam) > len(best[0]):
                    best = (fam, suf)
    return best


def parse_openmetrics(text: str) -> dict:
    """Strictly parse an OpenMetrics document; raises
    :class:`OpenMetricsError` on any format violation.  Returns
    ``{family: {"type": t, "samples": [(sample_name, labels, value)]}}``.

    Validates: single final ``# EOF``; ``# TYPE`` precedes its samples and no
    family repeats; every sample name matches its family + a type-legal
    suffix; histogram ``_bucket`` series carry ``le``, are cumulative
    (non-decreasing), end at ``le="+Inf"``, and agree with ``_count``."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise OpenMetricsError("document does not end with '# EOF'")
    families: dict[str, dict] = {}
    for ln, line in enumerate(lines[:-1], start=1):
        if line == "# EOF":
            raise OpenMetricsError(f"line {ln}: '# EOF' before end")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#" or \
                    parts[1] not in ("TYPE", "HELP", "UNIT"):
                raise OpenMetricsError(f"line {ln}: bad comment {line!r}")
            if parts[1] == "TYPE":
                fam, mtype = parts[2], (parts[3] if len(parts) > 3 else "")
                if mtype not in _SUFFIXES:
                    raise OpenMetricsError(
                        f"line {ln}: unsupported type {mtype!r}")
                if fam in families:
                    raise OpenMetricsError(
                        f"line {ln}: family {fam!r} declared twice")
                families[fam] = {"type": mtype, "samples": []}
            continue
        if not line.strip():
            raise OpenMetricsError(f"line {ln}: blank line")
        # sample: name[{labels}] value
        if "{" in line:
            name, _, rest = line.partition("{")
            block, _, tail = rest.partition("}")
            labels = _parse_label_block(block, ln)
            value_str = tail.strip()
        else:
            name, _, value_str = line.partition(" ")
            labels = {}
            value_str = value_str.strip()
        try:
            value = float(value_str.split(" ")[0])
        except (ValueError, IndexError):
            raise OpenMetricsError(f"line {ln}: bad value {value_str!r}")
        hit = _family_of(name, families)
        if hit is None:
            raise OpenMetricsError(
                f"line {ln}: sample {name!r} has no preceding # TYPE family")
        fam, _ = hit
        families[fam]["samples"].append((name, labels, value))

    for fam, info in families.items():
        if info["type"] != "histogram":
            continue
        by_series: dict[tuple, list] = {}
        counts: dict[tuple, float] = {}
        for name, labels, value in info["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            if name == fam + "_bucket":
                if "le" not in labels:
                    raise OpenMetricsError(
                        f"{fam}: _bucket sample without 'le'")
                by_series.setdefault(key, []).append((labels["le"], value))
            elif name == fam + "_count":
                counts[key] = value
        for key, buckets in by_series.items():
            if buckets[-1][0] != "+Inf":
                raise OpenMetricsError(f"{fam}: buckets must end at +Inf")
            prev_le, prev_c = float("-inf"), -1.0
            for le, c in buckets:
                fle = float("inf") if le == "+Inf" else float(le)
                if fle <= prev_le:
                    raise OpenMetricsError(
                        f"{fam}: bucket bounds not increasing at le={le}")
                if c < prev_c:
                    raise OpenMetricsError(
                        f"{fam}: bucket counts not cumulative at le={le}")
                prev_le, prev_c = fle, c
            if key in counts and buckets[-1][1] != counts[key]:
                raise OpenMetricsError(
                    f"{fam}: +Inf bucket != _count "
                    f"({buckets[-1][1]} vs {counts[key]})")
    return families


def find_samples(families: dict, family: str, **labels) -> list[tuple]:
    """Samples of ``family`` whose labels include all of ``labels`` —
    smoke-test convenience over :func:`parse_openmetrics` output."""
    info = families.get(family)
    if info is None:
        return []
    return [(n, ls, v) for n, ls, v in info["samples"]
            if all(ls.get(k) == v2 for k, v2 in labels.items())]


# ------------------------------------------------------------- HTTP endpoint
class ObsHTTPServer:
    """The observability plane's scrape endpoint, on a daemon thread.

    Serves the shared (or given) registry/flight-recorder/event-log:
    ``/metrics`` OpenMetrics text, ``/flight`` JSON, ``/events`` JSON Lines,
    ``/snapshot`` one combined JSON document, ``/explain`` the registered
    compile-report providers (``/explain`` lists models; ``/explain/<model>``
    returns that model's CompileReport as JSON — see ``add_explain``).
    ``port=0`` binds an ephemeral port (read it back from ``.port``);
    ``close()`` joins the thread."""

    def __init__(self, registry=None, *, flight=None, events=None,
                 tracer=None, explain=None, host: str = "127.0.0.1",
                 port: int = 0):
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace
        from repro_torch.obs.events import EVENTS

        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self.flight = flight
        self.events = events if events is not None else EVENTS
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        # model name -> zero-arg callable returning a JSON-safe CompileReport
        # (``Session.explain`` bound by the serving layer; lazy so each scrape
        # sees the CURRENT report — after a hot-swap the route follows)
        self._explain: dict = dict(explain or {})
        plane = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # scrapes must not spam stderr
                pass

            def _send(self, body: str, ctype: str, code: int = 200):
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        plane.registry.counter("obs.scrapes").inc()
                        self._send(render_openmetrics(plane.registry),
                                   CONTENT_TYPE)
                    elif path == "/flight":
                        snap = (plane.flight.snapshot()
                                if plane.flight is not None else {})
                        self._send(json.dumps(snap, default=str),
                                   "application/json")
                    elif path == "/events":
                        body = "".join(json.dumps(e) + "\n"
                                       for e in plane.events.snapshot())
                        self._send(body, "application/jsonl")
                    elif path == "/snapshot":
                        self._send(json.dumps(plane.snapshot(), default=str),
                                   "application/json")
                    elif path == "/explain" or path == "/explain/":
                        self._send(json.dumps(
                            {"models": sorted(plane._explain)}),
                            "application/json")
                    elif path.startswith("/explain/"):
                        model = path[len("/explain/"):]
                        fn = plane._explain.get(model)
                        if fn is None:
                            self._send(
                                json.dumps({"error": f"unknown model "
                                                     f"{model!r}",
                                            "models": sorted(plane._explain)}),
                                "application/json", 404)
                        else:
                            plane.registry.counter(
                                "obs.explain_scrapes",
                                {"model": model}).inc()
                            self._send(json.dumps(fn(), default=str),
                                       "application/json")
                    else:
                        self._send("not found\n", "text/plain", 404)
                except Exception as e:       # surface, don't kill the thread
                    self._send(f"error: {e}\n", "text/plain", 500)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dnnvm-obs-http", daemon=True)
        self._thread.start()

    def add_explain(self, model: str, provider) -> None:
        """Register (or replace) the ``/explain/<model>`` provider: a
        zero-arg callable returning the model's current CompileReport dict
        (typically ``session.explain`` — re-evaluated per scrape, so a
        hot-swapped artifact explains its new plan immediately)."""
        self._explain[model] = provider

    def remove_explain(self, model: str) -> None:
        self._explain.pop(model, None)

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def snapshot(self) -> dict:
        """Everything the plane knows, one JSON-friendly dict (what
        ``/snapshot`` serves and ``repro_torch.obs.dump`` persists)."""
        return {
            "metrics": self.registry.snapshot(),
            "flight": (self.flight.snapshot()
                       if self.flight is not None else None),
            "events": self.events.snapshot(),
            "trace": {"n_spans": len(self.tracer),
                      "n_dropped": self.tracer.n_dropped,
                      "enabled": self.tracer.enabled},
        }

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
