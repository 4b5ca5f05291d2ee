"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- configuration ``<c>``: its sizes file (``configs[].file``) and, beside it
  with the suffix ``.py``, its module (``DRIVER``, ``REFERENCE``,
  ``make_params``, …);
- traffic mix ``<t>``: ``portbench/traffic/<t>.json``;
- driver ``<d>`` (named by the configuration's ``DRIVER``):
  ``portbench/drivers/<d>.py``, whose ``run`` drives the program;
- metric ``<m>``: ``portbench/metrics/<m>.py``, whose ``read(ctx)`` returns
  the metric's value or ``None``;
- the limits of a cell's checks: ``portbench/limits/<cell>.json``.

A cell added as new files and one new ``workloads`` entry is found without
an edit to any file here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]  # the checkout


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` under a name made from its path."""
    name = "portbench_" + re.sub(r"[^0-9A-Za-z_]", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    sizes: Dict
    config: ModuleType
    traffic_name: str
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: Dict, name: str):
    """The end-to-end and per-layer metric entries a cell reports."""
    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in e2e_names)]
    return e2e, per


def resolve(workload: str, root: Path = ROOT,
            bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    sizes_path = root / cfg["file"]
    with open(sizes_path) as f:
        sizes = json.load(f)
    bench_dir = root / "portbench"
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    e2e, per = cell_metrics(bench, workload)
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                sizes=sizes, config=load_module(sizes_path.with_suffix(".py")),
                traffic_name=w["traffic"], mix=mix, end_to_end=e2e,
                per_layer=per, limits=limits)


def driver(cell: Cell, root: Path = ROOT) -> ModuleType:
    return load_module(root / "portbench" / "drivers" / f"{cell.config.DRIVER}.py")


def reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "portbench" / "metrics" / f"{name}.py")
