"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

  bench/configs/<config>.json      the configuration as it is run
  bench/plainref/<reference>.py    its plain reference (named in the config)
  bench/mixes/<traffic>.json       the traffic mix, read by its kind's module
  bench/limits/<cell>.json         the limits that decide ``correct``
  bench/metrics/<metric>.py        a per-layer metric's reader: read(obs)
  bench/kernels/<kernel>.py        a kernel's operations and bytes: count()

A later cell, mix, configuration or metric adds files; none of these is
edited for it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration file
    mix: Dict[str, Any]             # the traffic mix file
    limits: Dict[str, Any]          # the limits file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def model(self) -> Dict[str, Any]:
        return self.config["model"]

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(f"plainref.{self.config['reference']}")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: Dict[str, Any] = None, files: Path = BENCH
         ) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default), its
    mix and limits read from under ``files``."""
    spec = spec or benchmark()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / conf["file"]),
        mix=load_json(files / "mixes" / f"{w['traffic']}.json"),
        limits=load_json(files / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def _load_file(path: Path, what: str):
    if not path.exists():
        raise FileNotFoundError(f"{what} {path.name} has no file {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(obs) -> float or None`` of per-layer metric ``name``."""
    return _load_file(BENCH / "metrics" / f"{name}.py", "metric").read


def kernel_count(name: str):
    """``count(**shape) -> (operations, bytes, operand dtype)`` of kernel
    ``name``."""
    return _load_file(BENCH / "kernels" / f"{name}.py", "kernel").count
