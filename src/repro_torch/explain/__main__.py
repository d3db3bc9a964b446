# Copied from src/repro/explain/__main__.py; imports point at repro_torch.
"""CLI: render a compiled artifact's decision provenance.

    python -m repro_torch.explain artifact.npz                 # text report
    python -m repro_torch.explain artifact.npz --format json   # machine-readable
    python -m repro_torch.explain a.npz --diff b.npz           # what changed a->b

Works on any loadable artifact version: pre-v5 object files render a
degraded report (structure + schedule, no search trace or DDR map) instead
of failing.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explain",
        description="Explain a compiled artifact's decisions "
                    "(fusion, tiles, memory, schedule) or diff two plans.")
    ap.add_argument("artifact", help="path to a compiled .npz artifact")
    ap.add_argument("--diff", metavar="OTHER",
                    help="second artifact: report what changed "
                         "artifact -> OTHER instead of rendering the report")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    from repro_torch.asm import load_artifact
    from repro_torch.explain import diff as plan_diff
    from repro_torch.explain import render_diff, render_report, report_of
    from repro_torch.obs.events import EVENTS

    art = load_artifact(args.artifact)
    if args.diff:
        other = load_artifact(args.diff)
        d = plan_diff(art, other)
        out = (json.dumps(d, indent=2, sort_keys=True)
               if args.format == "json" else render_diff(d))
    else:
        rep = report_of(art)
        EVENTS.emit("explain.report",
                    message=f"explain {rep['model']} ({args.artifact})",
                    model=rep["model"], device=rep["device"],
                    degraded=rep.get("degraded", False))
        out = (json.dumps(rep, indent=2, sort_keys=True)
               if args.format == "json" else render_report(rep))
    sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
