"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names each cell as a configuration and a traffic mix; each
configuration is `portbench/configs/<name>.json`, each mix
`portbench/traffic/<name>.json`, each per-layer metric's reader
`portbench/metrics/<name>.py` (a function `read(run)`), and each cell's
limits for `correct` `portbench/limits/<cell>.json`. A new cell, mix,
configuration or metric is new files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    limits: dict          # number -> limit


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, cfgs[w["config"]]["file"]))
    traffic = _load(os.path.join(root, "portbench", "traffic",
                                 f"{w['traffic']}.json"))
    limits = _load(os.path.join(root, "portbench", "limits", f"{name}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                limits=limits)


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` function of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
