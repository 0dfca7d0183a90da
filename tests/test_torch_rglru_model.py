"""A numpy model of the CUDA RG-LRU scan's decomposition
(``src/repro_torch/csrc/rglru_scan.cu``) held against the reference's
oracle and its Pallas kernel in interpret mode, on the same numpy inputs.

The kernel walks S in tiles of kWarps x kRows steps (the constants are read
from the source): each warp runs its kRows steps from h = 0 (its aggregate
(A, H)), the carry into the tile is folded over the warps' aggregates in
order, each warp runs its steps again from its carry-in, and the fold of all
of them is the carry into the next tile. The model does the same in fp32
with one rounding per FMA. Tolerance: the reference's kernel test, 1e-4 in
fp32; the chip check's own limit where its inputs are used."""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = (ROOT / "src/repro_torch/csrc/rglru_scan.cu").read_text()
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", SRC).group(1))
ROWS = int(re.search(r"constexpr int kRows = (\d+);", SRC).group(1))
TOL = 1e-4


def _fma(x, y, z):
    """fp32 fmaf: the product is exact in fp64, the sum rounded once more
    to fp32 (twice in all, which differs from one rounding only at ties)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def rglru_tiles(a, u, *, warps=WARPS, rows=ROWS, drop=None):
    """The kernel's arithmetic on a, u [B, S, C] (fp32): h [B, S, C].
    ``drop`` breaks it on purpose: "tile" starts every tile's carry at 0,
    "warp" starts every warp's carry-in at the tile's carry."""
    a, u = np.asarray(a, np.float32), np.asarray(u, np.float32)
    b, s, c = a.shape
    h = np.empty_like(a)
    carry = np.zeros((b, c), np.float32)
    for t0 in range(0, s, warps * rows):
        if drop == "tile":
            carry = np.zeros((b, c), np.float32)
        spans = [(min(s, t0 + w * rows), min(s, t0 + (w + 1) * rows))
                 for w in range(warps)]
        aggs = []
        for r0, r1 in spans:            # each warp from h = 0
            big_a = np.ones((b, c), np.float32)
            big_h = np.zeros((b, c), np.float32)
            for t in range(r0, r1):
                big_h = _fma(a[:, t], big_h, u[:, t])
                big_a = (big_a * a[:, t]).astype(np.float32)
            aggs.append((big_a, big_h))
        cins = []
        for big_a, big_h in aggs:       # the fold, in warp order
            cins.append(carry)
            carry = _fma(big_a, carry, big_h)
        for (r0, r1), cin in zip(spans, cins):
            if drop == "warp":
                cin = cins[0]
            for t in range(r0, r1):
                cin = _fma(a[:, t], cin, u[:, t])
                h[:, t] = cin
    return h


def _inputs(b, s, c, seed=0):
    """The reference kernel test's distributions, made with numpy."""
    rng = np.random.default_rng(seed)
    a = 0.95 / (1.0 + np.exp(-rng.standard_normal((b, s, c))))
    u = 0.3 * rng.standard_normal((b, s, c))
    return a.astype(np.float32), u.astype(np.float32)


def _err(x, y):
    return float(np.abs(np.asarray(x, np.float32)
                        - np.asarray(y, np.float32)).max())


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_model_reads_the_kernel_constants():
    """8 warps of 16 steps: a tile of 128 steps, the reference's time
    block."""
    assert (WARPS, ROWS) == (8, 16)


@pytest.mark.parametrize("b,s,c", [(2, 128, 64), (1, 256, 32),
                                   (2, 384, 40)])
def test_tiles_match_pallas_and_oracle(b, s, c):
    """Whole tiles (S a multiple of the Pallas time block, 128): against
    the oracle and the Pallas kernel in interpret mode."""
    a, u = _inputs(b, s, c)
    h = rglru_tiles(a, u)
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    assert _err(h, jax_rglru_ref(ja, ju)) < TOL
    assert _err(h, jax_rglru_scan(ja, ju, interpret=True)) < TOL


@pytest.mark.parametrize("b,s,c", [
    (3, 1031, 33),   # ragged tail: 7 steps in the last tile, one warp busy
    (2, 200, 20),    # a tile and a half
    (1, 5, 8),       # fewer steps than warps: warps 1-7 hold the identity
    (2, 1, 3),
    (1, 17, 16),     # one warp full, the next with 1 step
])
def test_ragged_tails_match_oracle(b, s, c):
    a, u = _inputs(b, s, c, seed=s)
    h = rglru_tiles(a, u)
    assert _err(h, jax_rglru_ref(jnp.asarray(a), jnp.asarray(u))) < TOL
    assert _err(h, rglru_scan_ref(torch.as_tensor(a),
                                  torch.as_tensor(u))) < TOL


def test_slow_decay_carry_within_the_chip_limit(chip_smoke):
    """The chip check's slow-decay case at a CPU cut (S 1024, C 64; a about
    0.999, so h remembers ~1000 steps and the carry across the 8 tiles and
    their warps dominates it): within the limit against the plain version,
    and against the oracle."""
    a, u = chip_smoke.rglru_inputs(np.random.default_rng(5), 1, 1024, 64,
                                   slow=True)
    h = rglru_tiles(a.numpy(), u.numpy())
    ref = rglru_scan_ref(a, u)
    err = chip_smoke.rglru_error(torch.as_tensor(h), ref)
    assert err["err_over_tol"] < 0.1
    want = jax_rglru_ref(jnp.asarray(a.numpy()), jnp.asarray(u.numpy()))
    assert _err(h, want) <= 1e-4 * float(np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("drop", ["tile", "warp"])
def test_chip_limit_rejects_a_fold_without_the_carry(chip_smoke, drop):
    """The same slow-decay inputs through the model with the carry dropped,
    across tiles or from the warps before: the chip check's limit rejects
    either by more than 100x, so a kernel that lost it could not pass."""
    a, u = chip_smoke.rglru_inputs(np.random.default_rng(5), 1, 1024, 64,
                                   slow=True)
    h = rglru_tiles(a.numpy(), u.numpy(), drop=drop)
    err = chip_smoke.rglru_error(torch.as_tensor(h), rglru_scan_ref(a, u))
    assert err["err_over_tol"] > 100


def test_bf16_inputs_round_once(chip_smoke):
    """bf16 a and u are computed in fp32 and h is rounded to bf16 once: the
    model's fp32 h, rounded, is within the chip check's bf16 limit of the
    plain version."""
    a, u = chip_smoke.rglru_inputs(np.random.default_rng(6), 1, 300, 64,
                                   dtype=torch.bfloat16)
    h = rglru_tiles(a.float().numpy(), u.float().numpy())
    got = torch.as_tensor(h).to(torch.bfloat16)
    err = chip_smoke.rglru_error(got, rglru_scan_ref(a, u))
    assert err["err_over_tol"] <= 1.0
