"""Find a cell's configuration, traffic, problem driver, reference and
per-layer readers by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

#: the contract's names: a letter, digit or _, then letters, digits, _, . -
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def problem(self) -> str:
        return check_name(self.config["problem"])

    @property
    def limits(self) -> Dict[str, float]:
        return self.traffic["limits"]


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Optional[Dict[str, Any]] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``manifest`` (``BENCHMARK.json`` by default),
    its configuration file, its traffic file
    (``benchmark/workloads/<cell>.json``) and the metrics it reports."""
    check_name(name)
    if manifest is None:
        manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if traffic.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{traffic.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], config=config,
                traffic_name=entry["traffic"], traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, name)])


def problem_module(problem: str) -> ModuleType:
    """``benchmark/problems/<problem>.py``: the driver of the program."""
    return importlib.import_module(f"benchmark.problems.{check_name(problem)}")


def reference_module(problem: str) -> ModuleType:
    """``benchmark/reference/<problem>.py``: the plain reference."""
    return importlib.import_module(
        f"benchmark.reference.{check_name(problem)}")


def metric_reader(metric: str):
    """The ``read(obs)`` of ``benchmark/metrics/<metric>.py`` (a metric's
    name may hold dots, so the file is loaded by path)."""
    path = HERE / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
