"""A numpy model of the CUDA claim kernel's three phases
(``src/repro_torch/csrc/wq_claim.cu``) held against the reference's oracle
and its Pallas kernel in interpret mode, on the same numpy inputs.

Tiles of 1024 rows, 8 warps of 4 steps of 32 rows each (the constants are
read from the source). Phase 1: per warp, a running count of each worker's
READY rows over its steps, a row's rank within the warp being that count
plus the READY rows of its worker in lower lanes of the same step; per tile,
the warps' counts as an exclusive prefix over warps and the tile's totals.
Phase 2: each worker's totals as an exclusive prefix over tiles, summed in
8 slices and combined, as the kernel's blocks do. Phase 3: rank = tile
prefix + warp prefix + rank within the warp. Integer results: equal, not
close."""
import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wq_claim.ops import wq_claim as jax_wq_claim  # noqa: E402
from repro.kernels.wq_claim.ref import wq_claim_ref as jax_wq_claim_ref  # noqa: E402
from repro_torch.kernels.wq_claim.ref import wq_claim_ref  # noqa: E402

SRC = (pathlib.Path(__file__).resolve().parents[1]
       / "src/repro_torch/csrc/wq_claim.cu").read_text()
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", SRC).group(1))
STEPS = int(re.search(r"constexpr int kSteps = (\d+);", SRC).group(1))
TILE = WARPS * STEPS * 32
READY, RUNNING = 2, 3


def count_phase(status, worker, w):
    """Phase 1. Returns (rank within the warp [N], warp prefix [tiles, warps,
    W], tile totals [tiles, W]); rows outside [0, W) or not READY are not
    counted (rank 0)."""
    n = len(status)
    tiles = math.ceil(n / TILE)
    counted = (status == READY) & (worker >= 0) & (worker < w)
    within = np.zeros(n, np.int64)
    counts = np.zeros((tiles, WARPS, w), np.int64)
    for t in range(tiles):
        for j in range(WARPS):
            run = np.zeros(w, np.int64)
            for s in range(STEPS):
                i0 = t * TILE + j * STEPS * 32 + s * 32
                rows = np.arange(i0, min(n, i0 + 32))
                for lane, i in enumerate(rows):
                    if counted[i]:
                        lower = rows[:lane]
                        within[i] = run[worker[i]] + int(
                            (counted[lower] & (worker[lower] == worker[i]))
                            .sum())
                step = rows[counted[rows]]
                np.add.at(run, worker[step], 1)
            counts[t, j] = run
    prefix = np.cumsum(counts, axis=1) - counts
    return within, prefix, counts.sum(axis=1)


def prefix_phase(totals):
    """Phase 2: the exclusive prefix over tiles of each worker's totals, as
    the 8 warps of a block sum slices of ceil(tiles / 8) tiles and combine
    the slice sums in order."""
    tiles = totals.shape[0]
    per = math.ceil(tiles / WARPS)
    out = np.zeros_like(totals)
    run = np.zeros(totals.shape[1], np.int64)
    for j in range(WARPS):
        r0, r1 = min(tiles, j * per), min(tiles, j * per + per)
        slice_run = run.copy()
        for r in range(r0, r1):
            out[r] = slice_run
            slice_run += totals[r]
        run = run + totals[r0:r1].sum(axis=0)
    return out


def claim_model(status, worker, w, k):
    """Phase 3 on top of the other two: (new_status, claimed) int32."""
    status = np.asarray(status, np.int64)
    worker = np.asarray(worker, np.int64)
    within, warp_prefix, totals = count_phase(status, worker, w)
    tile_prefix = prefix_phase(totals)
    n = len(status)
    i = np.arange(n)
    t, j = i // TILE, (i % TILE) // (STEPS * 32)
    counted = (status == READY) & (worker >= 0) & (worker < w)
    wk = np.where(counted, worker, 0)
    rank = np.where(counted, tile_prefix[t, wk] + warp_prefix[t, j, wk]
                    + within, 0)
    claim = (status == READY) & (rank < k)
    return (np.where(claim, RUNNING, status).astype(np.int32),
            claim.astype(np.int32))


def _columns(n, w, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    status = rng.choice([0, 2, 3, 4], n, p=[.1, .5, .2, .2]).astype(np.int32)
    worker = rng.integers(lo, w if hi is None else hi, n).astype(np.int32)
    return status, worker


def test_model_reads_the_kernel_constants():
    assert (WARPS, STEPS, TILE) == (8, 4, 1024)


@pytest.mark.parametrize("n,w,k", [
    (1, 1, 1), (31, 3, 1), (1000, 7, 2), (2048, 16, 1),
    (5000, 40, 3),       # five tiles, the last ragged
    (9000, 300, 1),      # nine tiles: two slices of the prefix hold two
])
def test_model_equals_oracle_and_pallas(n, w, k):
    status, worker = _columns(n, w, seed=n + w)
    got = claim_model(status, worker, w, k)
    ref = jax_wq_claim_ref(jnp.asarray(status), jnp.asarray(worker),
                           num_workers=w, k=k)
    pal = jax_wq_claim(jnp.asarray(status), jnp.asarray(worker),
                       num_workers=w, k=k, interpret=True)
    for want in (ref, pal):
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("n,w,k", [(3000, 9, 2), (4100, 5, 1)])
def test_out_of_range_workers_rank_zero(n, w, k):
    """Worker ids outside [0, W) are not counted and rank 0: claimed
    whenever READY, and they move no other row's rank."""
    status, worker = _columns(n, w, seed=n, lo=-3, hi=w + 4)
    got = claim_model(status, worker, w, k)
    want = wq_claim_ref(torch.as_tensor(status), torch.as_tensor(worker),
                        num_workers=w, k=k)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
    orphan = ((worker < 0) | (worker >= w)) & (status == READY)
    assert orphan.any() and (got[1][orphan] == 1).all()


def test_k_past_every_count_claims_every_ready_row():
    status, worker = _columns(6000, 12, seed=3)
    big = int(np.bincount(worker).max()) + 1
    got = claim_model(status, worker, 12, big)
    assert np.array_equal(got[1], (status == READY).astype(np.int32))
    assert np.array_equal(got[0], np.where(status == READY, RUNNING,
                                           status))


def test_phases_add_up_to_the_oracle_rank():
    """Per-tile counts sum to each worker's READY count; the prefix over
    tiles is the exclusive cumsum; and prefix + warp prefix + rank within
    the warp is the oracle's rank (the count of READY rows of the same
    worker before the row)."""
    n, w = 7000, 25
    status, worker = _columns(n, w, seed=11)
    within, warp_prefix, totals = count_phase(status, worker, w)
    ready = status == READY
    assert np.array_equal(totals.sum(axis=0),
                          np.bincount(worker[ready], minlength=w))
    tile_prefix = prefix_phase(totals)
    assert np.array_equal(tile_prefix, np.cumsum(totals, axis=0) - totals)
    i = np.arange(n)
    t, j = i // TILE, (i % TILE) // (STEPS * 32)
    rank = tile_prefix[t, worker] + warp_prefix[t, j, worker] + within
    onehot = (worker[:, None] == np.arange(w)) & ready[:, None]
    oracle = (np.cumsum(onehot, axis=0) - onehot)[i, worker]
    assert np.array_equal(rank[ready], oracle[ready])
