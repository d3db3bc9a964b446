# Copied from src/repro/explain/__init__.py; imports point at repro_torch.
"""Compile-decision provenance: explainable reports and plan diffs.

DNNVM's value proposition is *search* — fusion templates enumerated by
subgraph isomorphism, strategies picked by shortest path, tile shapes picked
by measured search, DDR regions packed by liveness — and this package makes
every one of those decisions inspectable after the fact:

- :func:`build_report` assembles the structured ``CompileReport`` at the
  ``Compiled`` stage (called by ``asm.assemble_artifact``; embedded in every
  v5 artifact);
- :func:`report_of` returns an artifact's embedded report, or a degraded
  reconstruction for pre-v5 artifacts (never crashes on old files);
- :func:`diff` / :func:`diff_artifacts` compute the structural + cost diff of
  two plans — the audit record the continuous-autotuning hot-swap loop emits;
- :func:`render_report` / :func:`render_diff` are the deterministic text
  renderers behind ``python -m repro_torch.explain``.

Runtime surfaces: ``Session.explain()`` joins the static report with live
drift samples; ``ObsHTTPServer`` serves ``/explain/<model>``; the event log
carries ``explain.report`` / ``plan.diff`` events.
"""
from repro_torch.explain.diff import diff, diff_artifacts, diff_reports, negate
from repro_torch.explain.render import render_diff, render_report
from repro_torch.explain.report import (REPORT_VERSION, build_report, report_of,
                                  validate_report)

__all__ = [
    "REPORT_VERSION", "build_report", "report_of", "validate_report",
    "diff", "diff_artifacts", "diff_reports", "negate",
    "render_report", "render_diff",
]
