"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
from __future__ import annotations

import json
import re

import pytest

from benchlib import cells

SPEC = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(one_line(w) for w in SPEC["command"])
    files = [w for w in SPEC["command"] if w.endswith(".py")]
    assert all(any(f.startswith(p + "/") for p in SPEC["paths"])
               for f in files)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        names.append(c["name"])
    assert 1 <= len(SPEC["configs"]) <= 24
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in SPEC["configs"]}) == len(names)
    cells_ = [w["name"] for w in SPEC["workloads"]]
    assert 1 <= len(cells_) <= 24 and len(set(cells_)) == len(cells_)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(cells_)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(cells_) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells_)) <= set(cells_)
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                              SPEC["workloads"]]))
           for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = [n for n, ws in e2e.items() if w["name"] in ws]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]]


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_resolve_by_name(name):
    c = cells.cell(name)
    assert c.mix["kind"] == "sweep"
    assert c.reference().param_spec(c.model)
    lim = c.limits["limits"]
    assert set(lim) == {"loss_gap", "grad_gap", "change_gap",
                        "store_faults", "steer_faults"}
    assert lim["store_faults"] == lim["steer_faults"] == 0
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd", "ssd_fwd",
                                    "ssd_bwd"])
def test_kernel_files_resolve_by_name(kernel):
    assert callable(cells.kernel_count(kernel))


# Where the port's registry departs from the published checkpoint, the
# configuration file has the checkpoint's size.
FROM_CHECKPOINT = {"mamba2-1.3b": {"vocab_size": 50288}}


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_ports_config(conf):
    from benchlib.sweep import model_config
    from repro_torch.configs import get_config
    c = [c for c in SPEC["configs"] if c["name"] == conf][0]
    model = cells.load_json(cells.ROOT / c["file"])["model"]
    port = get_config(conf)
    assert model_config(model) == port.__class__(
        **{**port.__dict__, "source": "", **FROM_CHECKPOINT.get(conf, {})})


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_vocabulary_is_the_checkpoints(conf):
    c = [c for c in SPEC["configs"] if c["name"] == conf][0]
    f = cells.load_json(cells.ROOT / c["file"])
    pad = f["published"].get("pad_vocab_size_multiple", 1)
    rows = -(-f["published"]["vocab_size"] // pad) * pad
    assert f["model"]["vocab_size"] == rows
