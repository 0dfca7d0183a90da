"""The port's roofline module (``analysis/roofline.py``) against the
reference's: the analytic model FLOPs as exact floats for every arch x
shape, the probe depths, units and probe configs, the roofline terms fed
the same numbers; and the two-point probe's extrapolated total against a
count at full depth (the port has no scans, so the two are equal)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import roofline as R  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import HardwareConfig as RefHardware  # noqa: E402
from repro_torch.analysis import roofline as P  # noqa: E402
from repro_torch.configs import (ARCH_IDS, H100_SXM, SHAPES, ShapeConfig,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.launch.steps import shape_cells  # noqa: E402

CASES = [(a, s) for a in ARCH_IDS for s in SHAPES]


def test_forty_cases():
    assert len(CASES) == 40


@pytest.mark.parametrize("arch,shape", CASES)
def test_analytic_model_flops_equal_reference(arch, shape):
    got = P.analytic_model_flops(get_config(arch), SHAPES[shape])
    want = R.analytic_model_flops(ref_get_config(arch), REF_SHAPES[shape])
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_depths_units_and_cfg_equal_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert P.probe_depths(cfg) == R.probe_depths(ref)
    assert P.layer_units(cfg) == R.layer_units(ref)
    for d in P.probe_depths(cfg):
        assert repr(P.probe_cfg(cfg, d)) == repr(R.probe_cfg(ref, d))


@pytest.mark.parametrize("seed", range(3))
def test_roofline_terms_equal_reference(seed):
    rng = np.random.default_rng(seed)
    total = {"flops": float(rng.uniform(1e12, 1e16)),
             "bytes": float(rng.uniform(1e9, 1e13)),
             "link_bytes": float(rng.uniform(0, 1e11))}
    hw = RefHardware(peak_flops_bf16=H100_SXM.peak_flops_bf16,
                     hbm_bandwidth=H100_SXM.hbm_bandwidth,
                     ici_bandwidth=H100_SXM.ici_bandwidth,
                     hbm_bytes=H100_SXM.hbm_bytes)
    assert P.roofline_terms(total, 256) == R.roofline_terms(total, 256, hw)
    assert P.roofline_terms(total, 256, H100_SXM) == P.roofline_terms(
        total, 256)


def test_h100_config():
    assert H100_SXM.peak_flops_bf16 == 989e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.ici_bandwidth == 18 * 25e9
    assert H100_SXM.hbm_bytes == 80 * 2**30


@pytest.mark.parametrize("arch,layers", [("qwen2-0.5b", 5),
                                         ("granite-moe-3b-a800m", 4),
                                         ("seamless-m4t-large-v2", 4)])
def test_probe_total_equals_full_depth_count(arch, layers):
    """On one device, a smoke config of ``layers`` layers (enc-dec: as many
    encoder layers): the probe at depths 2 and 3, extrapolated, against
    the count of the probe config at full depth."""
    cfg = dataclasses.replace(smoke_config(arch), num_layers=layers)
    if cfg.num_encoder_layers:
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    shape = ShapeConfig("smoke", 64, 4, "train")
    probe = P.probe(cfg, shape)
    full = P.count_cell(shape_cells(P.probe_cfg(cfg, layers), shape))
    assert probe["units"] == layers
    assert probe["total"]["flops"] == full["flops"]
    assert probe["total"]["bytes"] == full["bytes"]
    assert probe["total"]["link_bytes"] == 0.0
    assert full["flops"] > 0


def test_count_cell_memory_record():
    """The smoke qwen2's train step on one device: the arguments are the
    fp32 params, both AdamW moments, the step counter and the inputs; the
    params and moments come back in place (aliased), beside a new step
    counter and the metrics."""
    cfg = smoke_config("qwen2-0.5b")
    cell = shape_cells(cfg, ShapeConfig("smoke", 64, 4, "train"))
    n = sum(p.numel() for p in cell.args[0]["params"].parameters())
    mem = P.count_cell(cell)["memory"]
    state = 3 * 4 * n                      # params, m, v (fp32)
    assert mem["argument_size_in_bytes"] == state + 4 + 2 * 4 * 64 * 4
    assert mem["alias_size_in_bytes"] == state
    assert 0 < mem["output_size_in_bytes"] - state < 1024
    assert mem["temp_size_in_bytes"] > 4 * n          # the gradients
    assert mem["per_device_total"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
