"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, the kernel files' op entries, and the port's configuration
of any family built from a configuration file's ``model`` dict."""
from __future__ import annotations

import dataclasses
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


KERNELS = ["flash_fwd", "flash_bwd", "ssd_fwd", "ssd_bwd", "xent_fwd",
           "xent_bwd"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_files_resolve_by_name(kernel):
    assert callable(cells.kernel_count(kernel))
    assert callable(cells.kernel_file(kernel).shape)


def test_kernel_files_declare_the_entries_read_before():
    """Flash and SSD through the entries, nodes and shapes the traced run
    wrapped by name before the kernel files declared them; the loss's
    kernels through theirs, its time its own kernels'."""
    got = {label: (e.op, e.node, e.kernels)
           for label, e in cells.op_entries().items()}
    assert got == {"flash": ("flash_attention", "FlashAttentionFn", None),
                   "ssd": ("ssd_scan", "SSDScanFn", None),
                   "xent": ("cross_entropy", "CrossEntropyFn",
                            ("xent_fwd", "xent_bwd"))}
    import torch
    e = cells.op_entries()
    q, kv = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16)
    assert e["flash"].shape(q, kv, kv, causal=True) == {
        "q": (2, 8, 4, 16), "kv": (2, 8, 2, 16), "dtype": "float32",
        "causal": True, "window": 0}
    x, bc = torch.zeros(8, 32, 4), torch.zeros(2, 32, 6)
    assert e["ssd"].shape(x, bc, bc, x, x, chunk=16, heads_per_bc=4) == {
        "x": (8, 32, 4), "bc": (2, 32, 6), "dtype": "float32", "chunk": 16,
        "heads_per_bc": 4}
    lg = torch.zeros(3, 5, 7, dtype=torch.bfloat16)
    assert e["xent"].shape(lg, torch.zeros(3, 5)) == {
        "rows": 15, "v": 7, "dtype": "bfloat16"}


def test_kernel_files_of_one_entry_must_agree(tmp_path):
    for name, node in (("a_fwd", "AFn"), ("a_bwd", "BFn")):
        (tmp_path / f"{name}.py").write_text(
            f"OP, LABEL, NODE = 'a_op', 'a', {node!r}\n"
            "def shape(x):\n    return {}\n")
    with pytest.raises(ValueError, match="a_op"):
        cells.op_entries(tmp_path)


# Every configuration of the port's registry, as a configuration file's
# ``model`` dict holds it (JSON: tuples as lists, nested configs as dicts).
def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


@pytest.mark.parametrize("arch", _arch_ids())
def test_every_registry_config_round_trips(arch):
    from benchlib.sweep import model_config
    from repro_torch.configs import get_config
    port = get_config(arch)
    m = json.loads(json.dumps(dataclasses.asdict(port)))
    assert model_config(m) == port


def test_a_moe_config_file_builds_the_registry_config():
    """What a MoE configuration needs of the harness: its dict builds the
    port's config, experts and all; a hybrid's pattern comes back a
    tuple."""
    from benchlib.sweep import model_config
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    granite = get_config("granite-moe-3b-a800m")
    got = model_config(json.loads(json.dumps(dataclasses.asdict(granite))))
    assert got == granite and isinstance(got.moe, MoEConfig)
    assert (got.moe.num_experts, got.moe.top_k, got.moe.dispatch) == \
        (40, 8, "sort")
    rg = get_config("recurrentgemma-9b")
    got = model_config(json.loads(json.dumps(dataclasses.asdict(rg))))
    assert isinstance(got.rglru.pattern, tuple) and got == rg


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
