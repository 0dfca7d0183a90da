"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

  bench/configs/<config>.json      the configuration as it is run
  bench/plainref/<reference>.py    its plain reference (named in the config)
  bench/mixes/<traffic>.json       the traffic mix, read by its kind's module
  bench/limits/<cell>.json         the limits that decide ``correct``
  bench/flops/<family>.py          the model FLOPs of the config's family:
                                   param_count(m), train_step_flops(m, ...)
  bench/metrics/<metric>.py        a per-layer metric's reader: read(obs)
  bench/kernels/<kernel>.py        a kernel's operations and bytes, count(),
                                   and the op entry it is read through

A kernel file declares the entry of ``repro_torch.kernels.ops`` that
launches it (``OP``), the label its readings go under (``LABEL``), the
``torch.autograd.Function`` whose backward node launches its backward
(``NODE``, None for none), the device kernels that count as its time
(``KERNELS``, name fragments; None: every kernel launched in the entry or
node) and ``shape(*args, **kw)``, the keyword arguments of ``count`` of a
call of the entry. Files of one ``OP`` declare the same label, node and
kernels; a traced run wraps each entry once.

A later cell, mix, configuration, family, metric or kernel adds files;
none of these is edited for it.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

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


@functools.lru_cache(maxsize=None)
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


def kernel_file(name: str):
    """The module of kernel file ``name``."""
    return _load_file(BENCH / "kernels" / f"{name}.py", "kernel")


def kernel_count(name: str):
    """``count(**shape) -> (operations, bytes, operand dtype)`` of kernel
    ``name``."""
    return kernel_file(name).count


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """An entry of ``repro_torch.kernels.ops`` that a traced run wraps."""
    op: str             # the entry's name in kernels.ops
    label: str          # what the readings are kept under
    node: Optional[str]         # its autograd Function's name, or None
    kernels: Optional[Tuple[str, ...]]  # name fragments of its kernels
    shape: Callable[..., dict]  # a call's arguments -> count()'s keywords


def op_entries(kernels: Path = None) -> Dict[str, OpEntry]:
    """Every entry the kernel files under ``kernels`` (``bench/kernels``)
    declare, by label; raises where two files of one entry disagree or two
    entries share a label."""
    by_op: Dict[str, OpEntry] = {}
    for path in sorted((kernels or BENCH / "kernels").glob("*.py")):
        mod = _load_file(path, "kernel")
        kern = getattr(mod, "KERNELS", None)
        e = OpEntry(mod.OP, mod.LABEL, getattr(mod, "NODE", None),
                    None if kern is None else tuple(kern), mod.shape)
        have = by_op.setdefault(e.op, e)
        if (have.label, have.node, have.kernels) != \
                (e.label, e.node, e.kernels):
            raise ValueError(f"kernel file {path.name} declares {e} where "
                             f"another file of {e.op!r} declares {have}")
    out = {e.label: e for e in by_op.values()}
    if len(out) != len(by_op):
        raise ValueError(f"two op entries share a label: {list(by_op)}")
    return out


def flops(family: str):
    """The FLOP module of a configuration's ``family``:
    ``param_count(m)`` and ``train_step_flops(m, rows, seq)``."""
    return _load_file(BENCH / "flops" / f"{family}.py", "family")


def train_step_flops(m: Dict[str, Any], rows: int, seq: int) -> float:
    """Model FLOPs of one train step of ``rows`` x ``seq`` tokens of the
    configuration ``model`` dict ``m``, by its family's file."""
    return flops(m["family"]).train_step_flops(m, rows, seq)
