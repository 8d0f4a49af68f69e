"""Where the benchmark's pieces live, found by the names in
``BENCHMARK.json``:

* ``bench/configs/<config>.json`` — a model configuration: the dataset,
  the paper's widths, the training constants, its source and cuts;
* ``bench/traffic/<traffic>.json`` — a traffic mix: the experiment's
  settings and the name of the driver that runs it;
* ``bench/drivers/<driver>.py`` — a driver of the timed loop, a module
  with a ``Driver`` class (``harness/drivers.py`` holds what they share);
* ``bench/workloads/<cell>.json`` — a cell's check: how much of the run
  the reference follows, and each compared number's limit;
* ``bench/metrics/<metric>.py`` — a per-layer metric's reader, a module
  with ``read(run) -> float | None``.

Adding a configuration, a mix, a driver, a cell or a per-layer metric adds
files and ``BENCHMARK.json`` entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None
    bound: Optional[float] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    chips: int
    run_seconds: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries) -> List[Metric]:
    keys = {f.name for f in dataclasses.fields(Metric)}
    return [Metric(**{k: v for k, v in e.items() if k in keys})
            for e in entries]


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic mix, check and the metrics it reports."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    config = _json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    check = _json(bench_dir / "workloads" / f"{name}.json")
    e2e = [m for m in _metrics(spec["end_to_end"]) if m.applies(name)]
    layer = [m for m in _metrics(spec["per_layer"]) if m.applies(name)]
    return Cell(name, config, traffic, check, e2e, layer, int(w["chips"]),
                int(spec["run_seconds"]))


def _module(kind: str, name: str, bench_dir: Path):
    """The module ``bench/<kind>/<name>.py``, loaded from its file."""
    path = bench_dir / kind / f"{name}.py"
    mod_name = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return _module("metrics", name, bench_dir).read


def driver_class(name: str, bench_dir: Path = BENCH_DIR):
    """The ``Driver`` class of ``bench/drivers/<name>.py``."""
    return _module("drivers", name, bench_dir).Driver


def readers(metrics: List[Metric], bench_dir: Path = BENCH_DIR) -> Dict:
    return {m.name: metric_reader(m.name, bench_dir) for m in metrics}
