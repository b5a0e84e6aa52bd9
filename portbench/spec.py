"""What a cell is made of, found by name: `BENCHMARK.json`'s entries, the
configuration's file, the traffic mix's file, the load loop it names and
each metric's reader.

Everything is looked up under a root directory (this package's by default),
so a configuration, a mix, a loop or a metric is added by adding its file
and its entry, and no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def load_benchmark(path: str | None = None) -> dict:
    """`BENCHMARK.json` at the root of the checkout."""
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    """The workload entry called `name`; raises KeyError naming the known
    cells."""
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    known = ", ".join(c["name"] for c in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")


def load_config(bench: dict, name: str, repo: str = REPO) -> dict:
    """The configuration `name`: its `configs` entry's file, read as JSON,
    with the entry itself under "entry"."""
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(os.path.join(repo, entry["file"])) as f:
                cfg = json.load(f)
            cfg["entry"] = entry
            return cfg
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_mix(name: str, root: str = HERE) -> dict:
    """The traffic mix `name`: `traffic/<name>.json` under root."""
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str) -> ModuleType:
    """`<kind>/<name>.py` under root, loaded by its path (names may hold
    dots)."""
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path
    )
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up by name
    spec.loader.exec_module(module)
    return module


def load_loop(name: str, root: str = HERE) -> type:
    """The load loop a mix's `loop` key names: the class `Loop` of
    `loops/<name>.py` under root (the interface is in `generator.py`)."""
    return load_module("loops", name, root).Loop


def metric_reader(name: str, root: str = HERE) -> ModuleType:
    """The reader of metric `name`: `metrics/<name>.py` under root. It
    defines `read(record)`, which returns a number or None where the record
    holds nothing to read."""
    return load_module("metrics", name, root)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    with trace off, its per-layer metrics with trace on. An entry with a
    "workloads" key applies to the cells it lists; one without, to every
    cell (a per-layer one: to every cell that reports the metric it
    moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [
        m
        for m in bench["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)
    ]


def read_metrics(entries: list[dict], record, root: str = HERE) -> dict:
    """{name: {"value", "unit"}} of each entry whose reader finds something
    to read in `record`; the others are left out."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
