"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` is given in the manifest, the traffic mix is
``traffic/<traffic>.json``, its ``driver`` is ``drivers/<driver>.py``,
each metric is ``metrics/<name>.py`` and the limits of a cell are
``limits/<cell>.json``.  Adding a cell, a configuration, a traffic kind or
a metric is adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple]    # None: every cell that reports ``moves``
    moves: Optional[str]          # per-layer metrics only
    end_to_end: bool

    def applies_to(self, cell: str, e2e_of_cell: List[str]) -> bool:
        if self.workloads is not None:
            return cell in self.workloads
        return self.end_to_end or self.moves in e2e_of_cell


class Manifest:
    """The parsed ``BENCHMARK.json`` at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]))
                      for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.metrics: Dict[str, Metric] = {}
        for group, e2e in (("end_to_end", True), ("per_layer", False)):
            for m in self.data[group]:
                wl = m.get("workloads")
                self.metrics[m["name"]] = Metric(
                    m["name"], m["unit"], m["better"], m["source"],
                    tuple(wl) if wl is not None else None, m.get("moves"),
                    e2e)

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                           f"{', '.join(sorted(self.cells))})")
        return self.cells[name]

    def config_path(self, name: str) -> Path:
        return self.root / self.configs[name]["file"]

    def config(self, name: str) -> dict:
        return json.loads(self.config_path(name).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        path = HERE / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def end_to_end_of(self, cell: str) -> List[str]:
        return [m.name for m in self.metrics.values()
                if m.end_to_end and m.applies_to(cell, [])]

    def per_layer_of(self, cell: str) -> List[str]:
        e2e = self.end_to_end_of(cell)
        return [m.name for m in self.metrics.values()
                if not m.end_to_end and m.applies_to(cell, e2e)]


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under this folder as a module (a metric's name
    may hold dots, so it is loaded by path, not imported)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} not found for "
                                f"{kind[:-1]} {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
