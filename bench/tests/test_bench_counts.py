"""The frozen FLOP arithmetic (``bench/flops/<family>.py``, found by the
configuration's family) and the kernels' operation and byte counts:
against closed forms, against the port's ``analytic_model_flops``, against
the numbers the cells read before the arithmetic moved into its family's
file, and against the kernel times measured before (PERF.md's table of
kernels), under which no share may pass 100%."""
from __future__ import annotations

import pytest

from benchlib import cells, peaks

SHAPES = {"qwen2-0.5b.sweep-2k": ("qwen2-0.5b", 16, 2048),
          "mamba2-1.3b.sweep-2k": ("mamba2-1.3b", 8, 2048),
          "qwen2-0.5b.sweep-8k": ("qwen2-0.5b", 4, 8192)}


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_train_flops_equal_the_ports(cell):
    from repro_torch.analysis.roofline import analytic_model_flops
    from repro_torch.configs.base import ShapeConfig
    from benchlib.sweep import model_config
    arch, rows, seq = SHAPES[cell]
    c = cells.cell(cell)
    assert (c.mix["rows"], c.mix["seq_len"], c.model["name"]) == \
        (rows, seq, arch)
    port = model_config(c.model)      # the port's config of the file's sizes
    want = analytic_model_flops(port, ShapeConfig("t", seq, rows, "train"))
    assert cells.train_step_flops(c.model, rows, seq) == pytest.approx(
        want, rel=1e-12)
    assert cells.flops(c.model["family"]).param_count(c.model) == \
        port.param_count


# Each cell's step_flops as the traced runs read it before the families'
# arithmetic moved into bench/flops/: to the bit.
STEP_FLOPS = {"qwen2-0.5b.sweep-2k": 105783836540928.0,
              "mamba2-1.3b.sweep-2k": 142116541956096.0,
              "qwen2-0.5b.sweep-8k": 131759798747136.0}


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_train_flops_are_the_cells_numbers_before(cell):
    _, rows, seq = SHAPES[cell]
    assert cells.train_step_flops(cells.cell(cell).model, rows, seq) == \
        STEP_FLOPS[cell]


def test_a_family_with_no_flops_file_names_the_file():
    m = dict(cells.cell("qwen2-0.5b.sweep-2k").model, family="moe")
    with pytest.raises(FileNotFoundError) as e:
        cells.train_step_flops(m, 16, 2048)
    assert str(cells.BENCH / "flops" / "moe.py") in str(e.value)


def test_dense_flops_closed_form():
    m = cells.cell("qwen2-0.5b.sweep-2k").model
    flops = cells.flops("dense")
    n = 151936 * 896 + 24 * (896 * 14 * 64 + 2 * 896 * 2 * 64
                             + 14 * 64 * 896 + 3 * 896 * 4864 + 2 * 896)
    assert flops.param_count(m) == n
    assert flops.train_step_flops(m, 2, 1024) == 6.0 * n * 2048 \
        + 24 * 12.0 * 2 * 1024 * 1024 * 14 * 64 * 0.5


def test_flash_counts_closed_form():
    fwd, bwd = cells.kernel_count("flash_fwd"), cells.kernel_count(
        "flash_bwd")
    s, hq, hkv, dh, b = 2048, 14, 2, 64, 3
    ops, nbytes, dt = fwd((b, s, hq, dh), (b, s, hkv, dh), "bfloat16")
    assert dt == "bfloat16"
    assert ops == 4.0 * b * hq * dh * s * (s + 1) / 2
    assert nbytes == 2 * b * dh * (2 * s * hq + 2 * s * hkv) + 4 * b * hq * s
    ops, nbytes, _ = bwd((b, s, hq, dh), (b, s, hkv, dh), "bfloat16")
    assert ops == 10.0 * b * hq * dh * s * (s + 1) / 2
    assert nbytes == 2 * b * dh * 4 * (s * hq + s * hkv) + 4 * b * hq * s
    # not causal: every pair; a window: at most `window` keys a query
    assert fwd((1, 8, 1, 4), (1, 16, 1, 4), "float32", causal=False)[0] \
        == 4.0 * 4 * 8 * 16
    assert fwd((1, 10, 1, 4), (1, 10, 1, 4), "float32", window=3)[0] \
        == 4.0 * 4 * (1 + 2 + 3 * 8)


def test_ssd_counts_closed_form():
    fwd, bwd = cells.kernel_count("ssd_fwd"), cells.kernel_count("ssd_bwd")
    bh, s, p, n, q, g = 128, 1024, 64, 128, 256, 64
    rows, chunks = bh // g, s // q
    pairs = chunks * q * (q + 1) // 2
    ops, nbytes, dt = fwd((bh, s, p), (rows, s, n), "float32", q, g)
    assert dt == "float32"
    assert ops == 2.0 * (rows * pairs * n + bh * pairs * p
                         + bh * (2 * s - q) * n * p)
    assert nbytes == 4 * (2 * bh * s * p + 2 * rows * s * n + 2 * bh * s) \
        + 4 * bh * p * n
    ops, nbytes, _ = bwd((bh, s, p), (rows, s, n), "float32", q, g)
    assert ops == 2.0 * (3 * rows * pairs * n + bh * (2 * pairs * p
                                                      + 5 * s * p * n))
    assert nbytes == 4 * (3 * bh * s * p + 4 * rows * s * n + 4 * bh * s)


def test_xent_counts_closed_form():
    fwd, bwd = cells.kernel_count("xent_fwd"), cells.kernel_count(
        "xent_bwd")
    r, v = 4096, 151936
    assert fwd(r, v, "bfloat16") == (4.0 * r * v, 2 * r * v + 16 * r,
                                     "bfloat16")
    assert bwd(r, v, "bfloat16") == (4.0 * r * v, 4 * r * v + 12 * r,
                                     "bfloat16")
    assert fwd(r, v, "float32")[1:] == (4 * r * v + 16 * r, "float32")


# (kernel file, its shape, device ms measured on the H100): the rows of
# PERF.md's table of kernels whose shapes the table states in full
MEASURED = [
    ("flash_fwd", dict(q=(1, 1000, 14, 64), kv=(1, 1000, 2, 64),
                       dtype="float32", lse=False), 0.0705),
    ("flash_fwd", dict(q=(1, 1000, 14, 64), kv=(1, 1000, 2, 64),
                       dtype="bfloat16", lse=False), 0.0367),
    ("flash_fwd", dict(q=(1, 1000, 16, 256), kv=(1, 1000, 1, 256),
                       dtype="float32", window=2048, lse=False), 0.2368),
    ("flash_fwd", dict(q=(1, 4096, 16, 256), kv=(1, 4096, 1, 256),
                       dtype="float32", window=2048, lse=False), 2.876),
    ("flash_fwd", dict(q=(1, 1000, 24, 64), kv=(1, 1000, 8, 64),
                       dtype="float32", lse=False), 0.1363),
    ("flash_fwd", dict(q=(1, 1000, 12, 128), kv=(1, 1000, 2, 128),
                       dtype="float32", lse=False), 0.1167),
    ("flash_fwd", dict(q=(1, 4096, 16, 64), kv=(1, 4096, 16, 64),
                       dtype="float32", causal=False, lse=False), 1.887),
    ("flash_fwd", dict(q=(1, 2500, 16, 64), kv=(1, 2500, 16, 64),
                       dtype="float32", causal=False, lse=False), 0.9020),
    ("flash_fwd", dict(q=(1, 64, 16, 64), kv=(1, 4096, 16, 64),
                       dtype="float32", causal=False, lse=False), 0.2541),
    ("flash_fwd", dict(q=(1, 64, 16, 64), kv=(1, 2500, 16, 64),
                       dtype="float32", causal=False, lse=False), 0.1646),
    ("flash_fwd", dict(q=(1, 64, 16, 64), kv=(1, 64, 16, 64),
                       dtype="float32", lse=False), 0.0074),
    ("flash_fwd", dict(q=(8, 2048, 14, 64), kv=(8, 2048, 2, 64),
                       dtype="bfloat16"), 0.8028),
    ("flash_fwd", dict(q=(2, 2048, 24, 64), kv=(2, 2048, 8, 64),
                       dtype="bfloat16"), 0.3436),
    ("flash_fwd", dict(q=(2, 2048, 14, 64), kv=(2, 2048, 2, 64),
                       dtype="bfloat16"), 0.2305),
    ("flash_fwd", dict(q=(8, 2048, 12, 128), kv=(8, 2048, 2, 128),
                       dtype="bfloat16"), 1.094),
    ("flash_fwd", dict(q=(8, 2048, 16, 64), kv=(8, 2048, 16, 64),
                       dtype="bfloat16", causal=False), 1.583),
    ("flash_fwd", dict(q=(8, 256, 16, 64), kv=(8, 256, 16, 64),
                       dtype="bfloat16"), 0.0331),
    ("flash_fwd", dict(q=(8, 256, 16, 64), kv=(8, 2048, 16, 64),
                       dtype="bfloat16", causal=False), 0.2128),
    ("flash_fwd", dict(q=(1, 2048, 12, 64), kv=(1, 2048, 4, 64),
                       dtype="bfloat16"), 0.1175),
    ("flash_fwd", dict(q=(2, 1000, 12, 64), kv=(2, 1000, 4, 64),
                       dtype="float32", lse=False), 0.1371),
    ("flash_fwd", dict(q=(1, 4096, 16, 256), kv=(1, 4096, 1, 256),
                       dtype="bfloat16", window=2048), 1.107),
    ("flash_bwd", dict(q=(8, 2048, 14, 64), kv=(8, 2048, 2, 64),
                       dtype="bfloat16"), 1.348),
    ("flash_bwd", dict(q=(1, 1024, 32, 128), kv=(1, 1024, 2, 128),
                       dtype="bfloat16"), 0.288),
    ("flash_bwd", dict(q=(1, 4096, 16, 256), kv=(1, 4096, 1, 256),
                       dtype="bfloat16", window=2048), 5.114),
    ("flash_bwd", dict(q=(2, 2048, 24, 64), kv=(2, 2048, 8, 64),
                       dtype="bfloat16"), 0.602),
    ("flash_bwd", dict(q=(8, 2048, 12, 128), kv=(8, 2048, 2, 128),
                       dtype="bfloat16"), 2.155),
    ("flash_bwd", dict(q=(8, 2048, 16, 64), kv=(8, 2048, 16, 64),
                       dtype="bfloat16", causal=False), 2.960),
    ("flash_bwd", dict(q=(8, 256, 16, 64), kv=(8, 256, 16, 64),
                       dtype="bfloat16"), 0.0682),
    ("flash_bwd", dict(q=(8, 256, 16, 64), kv=(8, 2048, 16, 64),
                       dtype="bfloat16", causal=False), 0.4982),
    ("flash_bwd", dict(q=(2, 2048, 14, 64), kv=(2, 2048, 2, 64),
                       dtype="bfloat16"), 0.4717),
    ("flash_bwd", dict(q=(1, 2048, 12, 64), kv=(1, 2048, 4, 64),
                       dtype="bfloat16"), 0.2093),
    ("ssd_fwd", dict(x=(64, 1000, 64), bc=(1, 1000, 128), dtype="float32",
                     heads_per_bc=64), 0.1697),
    ("ssd_fwd", dict(x=(64, 1031, 64), bc=(1, 1031, 128), dtype="float32",
                     heads_per_bc=64), 0.1794),
    ("ssd_fwd", dict(x=(64, 1000, 64), bc=(1, 1000, 128), dtype="bfloat16",
                     heads_per_bc=64), 0.1752),
    ("ssd_fwd", dict(x=(64, 4096, 64), bc=(1, 4096, 128), dtype="float32",
                     heads_per_bc=64), 0.6542),
    ("ssd_fwd", dict(x=(512, 2048, 64), bc=(8, 2048, 128), dtype="float32",
                     heads_per_bc=64), 2.467),
    ("ssd_bwd", dict(x=(512, 2048, 64), bc=(8, 2048, 128),
                     heads_per_bc=64), 3.419),
    ("ssd_bwd", dict(x=(64, 1031, 64), bc=(1, 1031, 128),
                     heads_per_bc=64), 0.560),
    ("ssd_bwd", dict(x=(64, 2048, 64), bc=(1, 2048, 128),
                     heads_per_bc=64), 0.713),
    ("xent_fwd", dict(rows=16 * 256, v=151936, dtype="bfloat16"), 0.3980),
    ("xent_fwd", dict(rows=8 * 256, v=50288, dtype="bfloat16"), 0.0719),
    ("xent_fwd", dict(rows=8 * 256, v=151936, dtype="bfloat16"), 0.206),
    ("xent_fwd", dict(rows=2 * 256, v=49155, dtype="bfloat16"), 0.020),
    ("xent_fwd", dict(rows=8 * 256, v=256206, dtype="bfloat16"), 0.340),
    ("xent_bwd", dict(rows=16 * 256, v=151936, dtype="bfloat16"), 0.8747),
    ("xent_bwd", dict(rows=8 * 256, v=50288, dtype="bfloat16"), 0.1538),
    ("xent_bwd", dict(rows=8 * 256, v=151936, dtype="bfloat16"), 0.442),
    ("xent_bwd", dict(rows=2 * 256, v=49155, dtype="bfloat16"), 0.040),
    ("xent_bwd", dict(rows=8 * 256, v=256206, dtype="bfloat16"), 0.866),
]


@pytest.mark.parametrize("kernel,shape,ms", MEASURED)
def test_measured_kernels_share_under_100(kernel, shape, ms):
    share = peaks.bound_s(*cells.kernel_count(kernel)(**shape)) / (ms / 1e3)
    assert 0 < share < 1.0
