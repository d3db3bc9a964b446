"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its entry in ``configs``; its
plain reference is ``reference/<reference>.py``, ``reference`` a key of
that file, and a layer kind that its ``OPS`` lacks is
``reference/ops/<op>.py``.  The traffic mix is ``traffic/<traffic>.json``,
driven by the load generator ``loads/<loop>.py`` that its ``loop`` names.
A per-layer metric is read by ``metrics/<name>.py``, whose ``read(run)``
returns a number or None.  Adding a configuration, a traffic mix, a load
generator, a layer kind or a metric adds files and entries; no code here
changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name: str, bench: dict, root: pathlib.Path = ROOT) -> dict:
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    return json.loads((root / entry["file"]).read_text())


def config_file(name: str, here: pathlib.Path = HERE) -> dict:
    """``configs/<name>.json``, whether or not a cell runs it yet."""
    return json.loads((here / "configs" / f"{name}.json").read_text())


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def reference(name: str):
    """The reference module that writes out architecture ``name``."""
    return importlib.import_module(f"portbench.reference.{name}")


def load(loop: str, here: pathlib.Path = HERE):
    """``Load`` of ``loads/<loop>.py``: the generator a traffic mix names."""
    return _module(here / "loads" / f"{loop}.py", "load").Load


def end_to_end(cell_name: str, bench: dict) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(cell_name: str, bench: dict) -> list:
    """The per-layer metrics the cell reports: those whose ``workloads``
    list it, and those without the key whose end-to-end metric it
    reports."""
    e2e = {m["name"] for m in end_to_end(cell_name, bench)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(metric: str, here: pathlib.Path = HERE):
    """``read`` of ``metrics/<metric>.py``, loaded from its file (a metric's
    name may hold dots)."""
    return _module(here / "metrics" / f"{metric}.py", "metric").read


def _module(path: pathlib.Path, kind: str):
    """The module in ``path``, loaded from its file (its name may hold
    dots or dashes)."""
    name = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
