"""The MoE configuration's pieces of the benchmark: the plain reference
(``plainref/moe.py``) against the port's CPU path at a small width, the
frozen FLOP arithmetic (``flops/moe.py``) and the grouped product's counts
(``kernels/grouped_mm_*.py``), the six readers of the MoE cell on a
synthetic window, the port's counter records kept by ``read_program``,
and, on a tiny MoE cell run through the real harness, the control and the
planted faults reading above the cell's committed limits."""
from __future__ import annotations

import copy
import dataclasses
import json
import time
import types
from pathlib import Path

import pytest
import torch

import calibrate
import run
from benchlib import cells, program_trace, traffic, weights
from benchlib.sweep import model_config
from plainref import moe as ref
from plainref.common import Numerics
from test_bench_faults import _frozen, _half_batch, _loss_altered

CELL = "granite-moe-3b-a800m.sweep-2k"
TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 8, "d_ff": 16, "vocab_size": 96, "loss_chunk": 16,
        "moe": {"num_experts": 6, "top_k": 2, "expert_ff": 16,
                "aux_loss_weight": 0.001, "dispatch": "dropless"}}


def tiny_model() -> dict:
    return dict(cells.cell(CELL).model, **copy.deepcopy(TINY))


def test_reference_loss_and_grads_match_the_port_on_cpu():
    from repro_torch.models.registry import build_model
    m = tiny_model()
    spec = ref.param_spec(m)
    cfg = dataclasses.replace(model_config(m), dtype="float32")
    assert cfg.logits_scaling == 6.0 and cfg.moe.dispatch == "dropless"
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    weights.load_into(params, spec, 5)
    b = traffic.shard_batch(m["vocab_size"], 48, 2, 9, 3)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, _ = model.train_loss(params, batch)
    got = torch.autograd.grad(loss, list(params.parameters()))
    w = {n: t.clone().requires_grad_(True)
         for n, t in dict(weights.leaves(spec, 5, "cpu")).items()}
    want_loss = ref.loss(Numerics("fp32"), m, w, batch)
    want = dict(zip(w, torch.autograd.grad(want_loss, list(w.values()))))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-5)
    names = [n for n, _ in params.named_parameters()]
    assert sorted(names) == sorted(w)
    for n, g in zip(names, got):
        r = want[n]
        assert float((g - r).abs().max()) <= 1e-4 * (
            float(r.abs().max()) + 1e-12), n


def test_reference_routes_every_token_to_its_experts():
    """No capacity: each expert's loop sees every assignment routed to it,
    however skewed the router."""
    m = tiny_model()
    h = torch.rand(40, m["d_model"]) + 0.1
    router = torch.randn(m["d_model"], 6) * 0.01
    router[:, 0] = 1.0
    w, idx, aux = ref.route(Numerics("fp32"), m, h, router)
    assert bool((idx == 0).any(1).all()) and idx.shape == (40, 2)
    assert torch.allclose(w.sum(-1), torch.ones(40))
    p = {"l.moe.gate_up": torch.randn(6, m["d_model"], 32),
         "l.moe.down": torch.randn(6, 16, m["d_model"])}
    out = ref.experts(Numerics("fp32"), m, p, "l.", h, w, idx)
    e0 = p["l.moe.down"][0]
    gu = h @ p["l.moe.gate_up"][0]
    want0 = (torch.nn.functional.silu(gu[:, :16]) * gu[:, 16:]) @ e0
    slot = (idx == 0).float().argmax(1)
    rest = out - want0 * w[torch.arange(40), slot, None]
    assert rest.abs().max() < out.abs().max()       # expert 0 is in there


# ---------------------------------------------------------------------------
# FLOPs and counts
# ---------------------------------------------------------------------------
def test_cell_flops_are_pinned_and_equal_the_ports():
    from repro_torch.analysis.roofline import analytic_model_flops
    from repro_torch.configs.base import ShapeConfig
    c = cells.cell(CELL)
    assert (c.mix["rows"], c.mix["seq_len"]) == (16, 2048)
    got = cells.train_step_flops(c.model, 16, 2048)
    assert got == 104107691999232.0
    port = model_config(c.model)
    assert got == analytic_model_flops(port, ShapeConfig("t", 2048, 16,
                                                         "train"))
    f = cells.flops("moe")
    assert f.param_count(c.model) == port.param_count == 1687147008
    assert f.active_param_count(c.model) == port.active_param_count \
        == 479187456
    # attention, the router, 8 experts and 2 norms a layer; the table once
    layer = 1536 * 1536 * 2 + 2 * 1536 * 512 + 1536 * 40 \
        + 8 * 3 * 1536 * 512 + 2 * 1536
    assert f.active_param_count(c.model) == 49155 * 1536 + 16 * layer


def test_grouped_mm_counts():
    fwd, bwd = cells.kernel_count("grouped_mm_fwd"), \
        cells.kernel_count("grouped_mm_bwd")
    m, k, n, g = 262144, 1536, 1024, 40
    assert fwd(m, k, n, g, "bfloat16") == (
        2.0 * m * k * n, 2.0 * (m * k + g * k * n + m * n) + 4.0 * g,
        "bfloat16")
    assert bwd(m, k, n, g, "bfloat16") == (
        4.0 * m * k * n,
        2.0 * (m * n + 2 * m * k + 2 * g * k * n) + 4.0 * g, "bfloat16")
    assert fwd(8, 4, 2, 3, "float32")[2] == "float32"


def test_grouped_mm_entry_and_its_stand_in():
    from repro_torch.kernels import ops as kops
    e = cells.op_entries()["grouped_mm"]
    assert (e.op, e.node, e.kernels) == ("grouped_mm", "GroupedMm", None)
    x, w = torch.zeros(10, 6), torch.zeros(3, 6, 4)
    assert e.shape(x, w, torch.zeros(3)) == {
        "m": 10, "k": 6, "n": 4, "g": 3, "dtype": "float32"}
    # a port from before the entry is given one that raises if called
    mod = cells.kernel_file("grouped_mm_fwd")
    mine = kops.grouped_mm
    try:
        del kops.grouped_mm
        mod._give_the_port_an_entry()
        with pytest.raises(NotImplementedError):
            kops.grouped_mm(x, w, None)
    finally:
        kops.grouped_mm = mine


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------
def _obs():
    from repro_torch.trace import Counter, Span
    shapes = [{"m": 100, "k": 64, "n": 32, "g": 4, "dtype": "bfloat16"},
              {"m": 100, "k": 16, "n": 64, "g": 4, "dtype": "bfloat16"}] * 2
    spans = {"moe.route": {"device_s": 0.002}, "moe.dispatch":
             {"device_s": 0.004}, "moe.experts": {"device_s": 0.010},
             "moe.combine": {"device_s": 0.006}}
    recs = [Span("moe.route", "t", 1.0, 1.5),
            Counter("moe.expert_load", "t", 1.2, 1.2, [1.0, 3.0, 0.0, 4.0]),
            Counter("moe.expert_load", "t", 1.3, 1.3, [2.0, 2.0, 2.0, 2.0])]
    return {"tasks": 4, "task_window_s": 2.0, "step_flops": 1e14,
            "op_device_s": {"grouped_mm": [1e-4] * 4,
                            "grouped_mm.bwd": [3e-4, 2e-4]},
            "shapes": {"grouped_mm": shapes},
            "program": {"tasks": 2, "spans": spans, "records": recs}}


def _read(name, obs):
    return cells.metric_reader(name)(obs)


def test_the_six_readers_on_a_synthetic_window():
    from benchlib import peaks
    obs = _obs()
    assert _read("moe_step_mfu_pct.train", obs) == pytest.approx(
        100.0 * 4 * 1e14 / 2.0 / peaks.MFU_PEAK)
    assert _read("moe_layer_device_ms.train", obs) == pytest.approx(
        1e3 * 0.022 / 2)
    assert _read("moe_dispatch_device_ms.train", obs) == pytest.approx(
        1e3 * 0.012 / 2)
    fwd, bwd = cells.kernel_count("grouped_mm_fwd"), \
        cells.kernel_count("grouped_mm_bwd")
    b = [peaks.bound_s(*fwd(**s)) for s in obs["shapes"]["grouped_mm"]]
    assert _read("grouped_mm_fwd_roofline_pct.train", obs) == pytest.approx(
        100.0 * sum(b) / 4e-4)
    bb = [peaks.bound_s(*bwd(**s)) for s in obs["shapes"]["grouped_mm"]]
    assert _read("grouped_mm_bwd_roofline_pct.train", obs) == pytest.approx(
        100.0 * 2 * (sum(bb) / 4) / 5e-4)
    # (4 / 2) and (2 / 2) of the mean, in %, averaged over the records
    assert _read("moe_expert_load_max_pct.train", obs) == pytest.approx(
        (200.0 + 100.0) / 2)


def test_the_six_readers_read_nothing_where_nothing_ran():
    """A port without the MoE spans and counters, or a cell without the
    grouped product: every reader returns None and raises nothing."""
    obs = {"tasks": 0, "task_window_s": None, "step_flops": 1e14,
           "op_device_s": {}, "shapes": {},
           "program": {"tasks": 3, "spans": {}, "records": []}}
    for m in cells.cell(CELL).per_layer:
        assert cells.metric_reader(m["name"])(obs) is None, m["name"]


def test_read_program_keeps_the_counter_records():
    from repro_torch.trace import Counter, Span
    recs = [Span("tick.step", "MainThread", 1.0, 2.0),
            Counter("moe.expert_load", "MainThread", 1.5, 1.5, [3.0, 1.0])]
    prof = types.SimpleNamespace(events=lambda: [])
    got = program_trace.read_program(prof, recs)
    assert got["records"] == recs
    assert got["spans"]["moe.expert_load"] == {"wall_s": [0.0],
                                               "device_s": None,
                                               "idle_s": None}
    assert _read("moe_expert_load_max_pct.train", {"program": got}) == \
        pytest.approx(150.0)


# ---------------------------------------------------------------------------
# a tiny MoE cell through the real harness
# ---------------------------------------------------------------------------
# The tiny cell's own limits, for its sound run: at this size a routing
# flip moves a gradient far more than at the cell's (its readings on the
# CPU over six seeds: loss 4e-7-1.1e-5, grad 5e-3-0.12, change 5e-3-9e-3;
# at the seed below 1.1e-5, 0.023, 7.2e-3). The faults are held against
# the cell's committed limits.
TINY_LIMITS = {"loss_gap": 5e-4, "grad_gap": 0.06, "change_gap": 0.012}
SOUND_SEED = 3000000101
GAPS = ("loss_gap", "grad_gap", "change_gap")


def committed() -> dict:
    return cells.load_json(cells.BENCH / "limits" / f"{CELL}.json")["limits"]


def above_committed(values: dict) -> list:
    """The numbers of ``values`` that read above the cell's committed
    limits."""
    lim = committed()
    return [k for k in GAPS if values[k] > lim[k]]


def tiny_moe_cell(tmp: Path, rows: int = 4, seq: int = 32) -> dict:
    """A one-cell spec of the MoE configuration cut to a tiny size, with
    :data:`TINY_LIMITS`."""
    conf = copy.deepcopy(cells.load_json(
        cells.BENCH / "configs" / "granite-moe-3b-a800m.json"))
    conf["model"].update(copy.deepcopy(TINY))
    conf["model"]["name"] = "tiny-moe"
    mix = cells.load_json(cells.BENCH / "mixes" / "sweep-2k-b16.json")
    mix.update(members=4, steps_per_member=50, rows=rows, seq_len=seq)
    for d in ("configs", "mixes", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(conf))
    (tmp / "mixes" / "tiny-mix.json").write_text(json.dumps(mix))
    lim = cells.load_json(cells.BENCH / "limits" / f"{CELL}.json")
    lim["limits"].update(TINY_LIMITS)
    (tmp / "limits" / "tiny.json").write_text(json.dumps(lim))
    spec = cells.benchmark()
    spec = dict(spec, configs=[{"name": "tiny",
                                "file": str(tmp / "configs" / "tiny.json")}],
                workloads=[{"name": "tiny", "config": "tiny",
                            "traffic": "tiny-mix", "chips": 1}])
    for m in spec["per_layer"] + spec["end_to_end"]:
        m.pop("workloads", None)
    return spec


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny-moe")
    return tmp, tiny_moe_cell(tmp)


def _run(tiny):
    tmp, spec = tiny
    return run.run("tiny", SOUND_SEED, 1.0, False, device="cpu",
                   t_start=time.time(), spec=spec, files=tmp)


def test_tiny_moe_cell_sound_run_is_correct(tiny):
    out = _run(tiny)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_control_and_half_batch_read_above_the_limits(tiny):
    tmp, spec = tiny
    got = calibrate.readings("tiny", SOUND_SEED, True, "cpu", spec, tmp)
    assert got["program"]["correct"]
    for kind in ("control", "half_batch"):
        assert not got[kind]["correct"], got[kind]
        assert above_committed(got[kind]), got[kind]


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _loss_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_faults_read_above_the_limits(tiny, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny)
    assert not out["correct"], out["checks"]
    assert above_committed({k: out["checks"][k]["value"] for k in GAPS})
