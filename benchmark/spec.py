"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under `benchmark/` one file per configuration
(`configs/<config>.json`), per traffic mix (`traffic/<traffic>.json`), per
cell (`workloads/<cell>.json`), per metric reader (`metrics/<metric>.py`),
per kernel's work counts (`counts/<kernel>.json`) and per reference
(`reference/<name>.py`)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, NamedTuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def read_json(*parts: str) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    settings: dict      # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def num_envs(self) -> int:
        return self.traffic["num_envs"]

    @property
    def agent(self) -> dict:
        return self.config["agent"]


def applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; raises KeyError
    for a cell it does not list."""
    bench = load_benchmark()
    return cell_of({w["name"]: w for w in bench["workloads"]}[name], bench)


def cell_of(entry: dict, bench: dict) -> Cell:
    """The cell of a `workloads` entry, with its files and the metrics of
    `bench` that apply to it."""
    name = entry["name"]
    return Cell(
        name=name, chips=entry["chips"],
        config=read_json("configs", entry["config"] + ".json"),
        traffic=read_json("traffic", entry["traffic"] + ".json"),
        settings=read_json("workloads", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def load_module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (a name may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
