"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout and
the files it names, each found by name under ``portbench/``:

  * ``configs/<config>.json``: the model as it is run (the program's
    class and arguments, the learning rate, the precision) and its sizes;
  * ``traffic/<traffic>.json``: the data set the cell trains on and how
    it trains (batch, path, epochs a dispatch, shuffle, controllers);
  * ``limits/<workload>.json``: the limit of each number that decides
    ``correct``;
  * ``metrics/<metric>.py``: the reader of one per-layer metric;
  * ``counts/<name>.py``: operations and bytes from shapes;
  * ``reference/<config>.py``: the plain reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def config_name(self) -> str:
        return self.config["name"]


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    config["name"] = w["config"]
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH / "limits" / f"{workload}.json")
    return Cell(name=workload, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def metric_reader(name: str):
    """``read(ctx) -> float | None`` of the per-layer metric ``name``, from
    ``metrics/<name>.py`` (loaded by path: a metric's name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counts(name: str):
    """The counting module ``counts/<name>.py``."""
    return importlib.import_module(f"portbench.counts.{name}")
