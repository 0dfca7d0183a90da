"""The plain references agree with the port's CPU path at a small width
(the port's plain kernels, fp32), the steering reference with the port's
sweep, and the control (fp8 products) reads far above the program."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchlib import checks, traffic, weights
from benchlib.sweep import model_config
from plainref import steering as ref_steering
from plainref.common import Numerics, train_steps
from tinycell import TINY_MODELS

FAMILIES = {"dense": "qwen2-0.5b", "ssm": "mamba2-1.3b"}


def tiny_model(family: str) -> dict:
    from benchlib import cells
    conf = cells.load_json(cells.BENCH / "configs" /
                           f"{FAMILIES[family]}.json")
    return dict(conf["model"], **TINY_MODELS[family]), conf["reference"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_loss_and_grads_match_the_port_on_cpu(family):
    import importlib
    from repro_torch.models.registry import build_model
    m, refname = tiny_model(family)
    ref = importlib.import_module(f"plainref.{refname}")
    spec = ref.param_spec(m)
    cfg = dataclasses.replace(model_config(m), dtype="float32")
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
    want = torch.autograd.grad(want_loss, list(w.values()))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-5)
    names = [n for n, _ in params.named_parameters()]
    assert sorted(names) == sorted(w)
    want = dict(zip(w, want))
    for n, g in zip(names, got):
        r = want[n]
        scale = float(r.abs().max()) + 1e-12
        assert float((g - r).abs().max()) <= 1e-4 * scale, n


def test_steering_reference_matches_the_ports_sweep():
    from repro_torch.core.steering import SteeringEngine
    from repro_torch.core.workqueue import WorkQueue
    wq = WorkQueue(num_workers=3, device="cpu", device_claim=False)
    rng = np.random.default_rng(4)
    wq.add_tasks(0, 40, now=100.0, domain_in=rng.random((40, 3)))
    wq.add_tasks(1, 20, now=100.0, domain_in=rng.random((20, 3)))
    for t in range(6):
        got = wq.claim_all(k=2, now=110.0 + t)
        rows = np.concatenate(list(got.values()))
        wq.finish(rows[: len(rows) - 1], now=111.5 + t,
                  domain_out=rng.random((len(rows) - 1, 3)))
    eng = SteeringEngine(wq)
    view = wq.store.snapshot_view()
    out = eng.run_all(130.0, view)
    want = ref_steering.sweep(view.col, 3, 130.0)
    assert ref_steering.mismatches(out, want, 1e-9) == []
    assert want["q4"] > 0 and want["q6"]
    bad = dict(out, q4=out["q4"] + 1)
    assert ref_steering.mismatches(bad, want, 1e-9) == ["q4"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_control_reads_far_above_fp32(family):
    """The fp8 control against the fp32 reference, at a small size: every
    gap reads more than bf16 rounding of the same steps would."""
    import importlib
    m, refname = tiny_model(family)
    ref = importlib.import_module(f"plainref.{refname}")
    spec = ref.param_spec(m)
    batches = [{k: torch.as_tensor(v) for k, v in traffic.shard_batch(
        m["vocab_size"], 32, 2, 1, s).items()} for s in range(3)]
    runs = {}
    for kind in ("fp32", "fp8"):
        num = Numerics(kind)
        runs[kind] = train_steps(lambda p, b: ref.loss(num, m, p, b),
                                 dict(weights.leaves(spec, 3, "cpu")), batches,
                                 [3e-4] * 3)
    gaps = checks.train_gaps(runs["fp8"], runs["fp32"])
    assert gaps["loss_gap"] > 1e-5 and gaps["grad_gap"] > 1e-2
    same = checks.train_gaps(runs["fp32"], runs["fp32"])
    assert [same[k] for k in ("loss_gap", "grad_gap", "grad_gap_median",
                              "change_gap")] == [0.0] * 4
