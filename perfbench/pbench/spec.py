"""The benchmark as data: BENCHMARK.json at the checkout's root names the
cells, and each piece of a cell is a file found by its name.

- a configuration: the `file` of its entry in `configs` (a JSON object:
  LoamConfig fields, the sensor's `azimuths`, the source and the cuts);
- a traffic mix: perfbench/traffic/<traffic>.json;
- the limits of a cell's correctness numbers:
  perfbench/limits/<workload>.json;
- a per-layer metric: perfbench/metrics/<name>.py, whose read(summary)
  returns the metric's value, or None where it finds nothing to read.

A later cell, traffic mix or metric is a new file and a new entry; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of BENCHMARK.json with its files read.
    Raises KeyError for a name BENCHMARK.json does not hold."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "perfbench"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str, root: Path = ROOT):
    """read(summary) of perfbench/metrics/<name>.py, loaded from its file
    (not as a package import, so no name of it can shadow another
    module)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
