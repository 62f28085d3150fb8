"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its comparison limits are
``limits/<cell>.json``; each metric is ``metrics/<metric>.py``.  The
code a cell runs is found by name in the same way:

- the configuration's ``family`` names ``families/<family>.py``: the
  inputs a request carries, drawn from the seed, and the comparison with
  the family's plain reference (``reference/``);
- the traffic's ``server`` names ``servers/<server>.py``: the program's
  serving of a step (``program.py`` gives the protocol);
- the traffic's ``loop`` names ``loops/<loop>.py``: how requests arrive
  and the measured window is paced.

Adding a cell, a configuration, a kind of traffic or a metric adds files
and entries and edits none that is there.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: Dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = _json(here / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(here / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(here / "limits" / f"{name}.json")
        self.family = plugin("families", self.config["family"], here)
        self.server = plugin("servers", self.traffic["server"], here)
        self.loop = plugin("loops", self.traffic["loop"], here)
        self.end_to_end = [m for m in bench["end_to_end"] if _in(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _in(m, name)]
        self.here = here

    def metric_reader(self, name: str) -> ModuleType:
        return plugin("metrics", name, self.here)


def plugin(kind: str, name: str, here: Path = HERE) -> ModuleType:
    """The module of ``<kind>/<name>.py``, loaded once by its path (a name
    may hold a dot or a dash)."""
    path = here / kind / f"{name}.py"
    key = f"ecc_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _in(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(load(root), name)


def names(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]
