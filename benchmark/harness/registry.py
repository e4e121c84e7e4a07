"""Find a cell's parts by name.

``BENCHMARK.json`` names every configuration, cell and metric. Each has
files of its own, which this module finds by that name:

- a configuration: ``configs/<config>.json``, whose ``scene`` names its
  generator ``scenes/<scene>.py`` and whose ``reference`` names its plain
  reference ``reference/<reference>.py``;
- a cell: ``workloads/<cell>.json`` (its traffic), whose ``driver`` names
  the program entry ``drivers/<driver>.py``;
- a metric, end-to-end or per-layer: its reader ``metrics/<base>.py``,
  where ``<base>`` is the metric's name up to its first dot, so that one
  quantity split over cells that report different end-to-end metrics
  (``passes_per_frame`` and ``passes_per_frame.kernel_bound``) has one
  reader.

So a later change adds a configuration, a cell, a driver or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)                                          # the checkout
PACKAGE = os.path.basename(HERE)


def spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict) -> dict:
    """The cell's entry of ``BENCHMARK.json`` merged with its traffic file."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    return {**_json("workloads", name), **entry}


def config(name: str) -> dict:
    return _json("configs", name)


def module(kind: str, name: str):
    """``<package>.<kind>.<name>``: a scene, reference, driver or metric."""
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def reader(metric: str):
    """The module that reads metric ``metric``: ``read(record)`` gives its
    value, or None where the run has nothing to read."""
    return module("metrics", metric.split(".", 1)[0])


def metrics_of(cell_entry: dict, bench: dict, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones without
    trace, its per-layer ones with it. A metric with ``workloads`` is
    reported in those cells only."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell_entry["name"] in m["workloads"]]
