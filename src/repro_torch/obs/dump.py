# Copied from src/repro/obs/dump.py; imports point at repro_torch.
"""``python -m repro_torch.obs.dump`` — snapshot a running observability
plane.

Points at a live :class:`~repro_torch.obs.export.ObsHTTPServer` (the scrape
endpoint a serving bench mounts) and pulls everything it exposes into one
JSON document: the OpenMetrics exposition text (validated through the strict
parser before anything is written — a dump that would not scrape cleanly
fails loudly), the flight-recorder ring + forensic dumps, and the recent
event log.  Without ``--url`` it snapshots the *current process's* shared
registry/event log instead, which is what the tests drive.

    python -m repro_torch.obs.dump --url http://127.0.0.1:9464 --out snap.json
    python -m repro_torch.obs.dump --events-jsonl events.jsonl  # side-write
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def _fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8")


def snapshot_url(base_url: str, timeout: float = 10.0) -> dict:
    """Scrape one plane: parse-validated /metrics plus the /snapshot JSON."""
    from repro_torch.obs.export import parse_openmetrics

    base = base_url.rstrip("/")
    text = _fetch(base + "/metrics", timeout)
    families = parse_openmetrics(text)            # strict: bad format raises
    snap = json.loads(_fetch(base + "/snapshot", timeout))
    return {"scraped_from": base, "metrics_text": text,
            "n_families": len(families), **snap}


def snapshot_local() -> dict:
    """In-process fallback: the shared registry, event log, and tracer."""
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.obs.events import EVENTS
    from repro_torch.obs.export import parse_openmetrics, render_openmetrics

    text = render_openmetrics(REGISTRY)
    parse_openmetrics(text)
    return {"scraped_from": None, "metrics_text": text,
            "metrics": REGISTRY.snapshot(), "flight": None,
            "events": EVENTS.snapshot(),
            "trace": {"n_spans": len(TRACER), "n_dropped": TRACER.n_dropped,
                      "enabled": TRACER.enabled}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--url", default=None,
                    help="base URL of a running ObsHTTPServer "
                         "(e.g. http://127.0.0.1:9464); omitted = snapshot "
                         "this process's shared registry/event log")
    ap.add_argument("--out", default=None,
                    help="write the combined snapshot JSON here "
                         "(default: stdout)")
    ap.add_argument("--events-jsonl", default=None,
                    help="additionally write the event log as JSON Lines")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    snap = (snapshot_url(args.url, timeout=args.timeout) if args.url
            else snapshot_local())
    if args.events_jsonl:
        with open(args.events_jsonl, "w") as f:
            for ev in snap.get("events") or []:
                f.write(json.dumps(ev) + "\n")
        print(f"wrote {args.events_jsonl} "
              f"({len(snap.get('events') or [])} events)", file=sys.stderr)
    body = json.dumps(snap, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(body)
    return snap


if __name__ == "__main__":
    main()
