"""Finding a cell's parts by name: BENCHMARK.json's entries, each
configuration's file (portbench/configs/<name>.json), each traffic mix's
(portbench/traffic/<name>.json) and each per-layer metric's reader
(portbench/metrics/<name>.py, a function `read(run)`).  A new
configuration, mix or metric is a new file and a new entry: nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list       # the end-to-end metrics this cell reports
    per_layer: list        # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench_file: Path, name: str, here: Path = HERE) -> Cell:
    """The cell `name` of a BENCHMARK.json, with its configuration and
    mix read from their files under `here`."""
    bench = json.loads(Path(bench_file).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((Path(bench_file).parent / conf["file"]).read_text())
    mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, config, mix, int(w["chips"]),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, here: Path = HERE):
    """The `read(run)` function of portbench/metrics/<metric>.py."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
