"""A model of the CUDA flash-attention backward's decomposition and
rounding (``src/repro_torch/csrc/flash_attention_bwd.cu``), on the CPU.

- Coverage: the dK/dV kernel's blocks (one per 64-key tile, batch, KV head
  and run of the group's query heads; each warp 16 keys, skipping chunks
  of query columns wholly masked for its keys) and the dQ kernel's blocks
  (one per 64-row query tile and head; each warp 16 rows, skipping chunks
  of keys wholly masked for them) visit every visible (head, query, key)
  pair exactly once. The tile and chunk sizes are read from the ``.cu``.
- Head runs: ``bwd_heads_per_split`` is a pure function of the shapes, at
  least 1, with every run non-empty.
- Rounding: in bf16, P and dS enter the last three products as a bf16 high
  part plus remainder; the chip check's limit (1e-4 of the gradient's
  largest element plus one bf16 step of the value) holds for that and
  fails for one bf16 P or one bf16 dS, which is why the kernel makes two
  products of each. The model is float64 arithmetic with those roundings,
  held against the port's plain backward, which
  ``tests/test_torch_flash_bwd.py`` holds against ``jax.grad`` of the
  reference's attention."""
import itertools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BWD_BLOCKS_WANTED, BWD_KEY_TILE, bwd_heads_per_split)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)

SRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "csrc" / "flash_attention_bwd.cu").read_text()
TILE = int(re.search(r"constexpr int kTile = (\d+);", SRC).group(1))
# columns of S^T (dK/dV) and of S (dQ) a warp computes at once, by width
CHUNK = {name: {hd: 8 * int(n) for hd, n in zip((64, 128), re.search(
    name + r" = HD == 64 \? (\d+) : (\d+);", SRC).groups())}
    for name in ("NCK", "NCQ")}
ROWS = 16                      # keys (dK/dV) or query rows (dQ) of a warp
BF16_STEP = 2.0 ** -7
REL_TOL = 1e-4                 # chip_smoke.BWD_REL_TOL


def _visible(sq, skv, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    return ok


def _dkdv_visits(sq, skv, g, causal, window, hps, qc):
    """[g, sq, skv] counts of the pairs the dK/dV blocks of one (batch, KV
    head) compute with their P unmasked."""
    vis = _visible(sq, skv, causal, window)
    count = np.zeros((g, sq, skv), int)
    for split in range(-(-g // hps)):
        heads = range(split * hps, min(g, split * hps + hps))
        for k0 in range(0, skv, TILE):
            q_begin = k0 if causal else 0
            q_end = sq
            if window > 0:
                q_end = min(sq, min(k0 + TILE, skv) - 1 + window)
            for h, q0 in itertools.product(heads,
                                           range(q_begin, q_end, TILE)):
                for kw in range(k0, k0 + TILE, ROWS):
                    for qc0 in range(q0, q0 + TILE, qc):
                        if (kw >= skv or qc0 >= sq
                                or (causal and qc0 + qc - 1 < kw)
                                or (window > 0 and kw + ROWS - 1
                                    <= qc0 - window)):
                            continue
                        qs = slice(qc0, min(qc0 + qc, sq))
                        ks = slice(kw, min(kw + ROWS, skv))
                        count[h, qs, ks] += vis[qs, ks]
    return count


def _dq_visits(sq, skv, g, causal, window, kc):
    """[g, sq, skv] counts of the pairs the dQ blocks of one batch and the
    g heads of one group compute with their P unmasked."""
    vis = _visible(sq, skv, causal, window)
    count = np.zeros((g, sq, skv), int)
    for h, q0 in itertools.product(range(g), range(0, sq, TILE)):
        kv_end = min(skv, min(q0 + TILE, sq)) if causal else skv
        kv_begin = max(0, q0 - window + 1) if window > 0 else 0
        kv_begin = kv_begin // TILE * TILE
        for k0 in range(kv_begin, kv_end, TILE):
            for qw in range(q0, q0 + TILE, ROWS):
                for kc0 in range(k0, k0 + TILE, kc):
                    if (qw >= sq or kc0 >= skv
                            or (causal and kc0 > qw + ROWS - 1)
                            or (window > 0 and kc0 + kc - 1 <= qw - window)):
                        continue
                    qs = slice(qw, min(qw + ROWS, sq))
                    ks = slice(kc0, min(kc0 + kc, skv))
                    count[h, qs, ks] += vis[qs, ks]
    return count


COVER = [  # sq, skv, g, causal, window, dh
    (200, 200, 7, True, 0, 64),       # ragged, runs of heads
    (257, 257, 4, True, 0, 128),      # narrower chunks
    (300, 300, 3, True, 100, 64),     # window edge inside tiles
    (130, 130, 2, False, 0, 128),     # not causal
    (190, 190, 5, False, 40, 64),     # windowed, not causal
    (64, 100, 1, True, 0, 64),        # more keys than queries
    (256, 2048, 1, False, 0, 64),     # cross-attention training (seamless)
    (64, 1000, 2, False, 0, 128),     # cross-attention, ragged keys
]


@pytest.mark.parametrize("sq,skv,g,causal,window,dh", COVER)
def test_blocks_visit_each_visible_pair_exactly_once(sq, skv, g, causal,
                                                     window, dh):
    want = np.broadcast_to(_visible(sq, skv, causal, window), (g, sq, skv))
    for hps in sorted({1, max(1, g // 2), g}):
        got = _dkdv_visits(sq, skv, g, causal, window, hps,
                           CHUNK["NCK"][dh])
        np.testing.assert_array_equal(got, want)
    got = _dq_visits(sq, skv, g, causal, window, CHUNK["NCQ"][dh])
    np.testing.assert_array_equal(got, want)


def test_heads_per_split_is_a_pure_function_of_the_shapes():
    """At least 1 and at most g; every run non-empty; the blocks reach at
    least half of ``BWD_BLOCKS_WANTED`` where one head a block can, and all
    the runs are one when the blocks reach it without; the train shape keeps
    one run, glm4-9b's heads at B 1 take runs of 2 (256 blocks), qwen2's at
    B 1 and S 2048 runs of 2, 2, 2, 1."""
    assert BWD_KEY_TILE == TILE                  # the kernel's key tile
    assert bwd_heads_per_split(8, 2048, 14, 2) == 7
    assert bwd_heads_per_split(1, 1024, 32, 2) == 2
    assert bwd_heads_per_split(1, 2048, 14, 2) == 2
    for b, skv, hq, hkv in itertools.product((1, 2, 8), (1, 63, 1031, 4096),
                                             (4, 14, 32), (1, 2, 4)):
        if hq % hkv:
            continue
        g = hq // hkv
        hps = bwd_heads_per_split(b, skv, hq, hkv)
        assert hps == bwd_heads_per_split(b, skv, hq, hkv)
        assert 1 <= hps <= g
        runs = -(-g // hps)
        assert (runs - 1) * hps < g          # the last run is not empty
        blocks = b * hkv * -(-skv // BWD_KEY_TILE)
        assert 2 * blocks * runs >= min(BWD_BLOCKS_WANTED, blocks * g)
        assert runs == 1 or blocks < BWD_BLOCKS_WANTED


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _split(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _model_grads(q, k, v, o, lse, do, window, p_round, ds_round):
    """(dq, dk, dv) in bf16 from float64 arithmetic on the bf16 inputs, with
    P rounded by ``p_round`` before dV and dS by ``ds_round`` before dK and
    dQ, as the kernel rounds them; causal."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    qg, dog = (t.reshape(b, s, hkv, g, dh) for t in (q, do))
    st = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    vis = torch.as_tensor(_visible(s, s, True, window))
    p = torch.where(vis, torch.exp(
        st - lse.double().reshape(b, hkv, g, s)[..., None]), 0.0)
    delta = (dog * o.reshape(b, s, hkv, g, dh)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v)
    ds = ds_round(p * (dp - delta.permute(0, 2, 3, 1)[..., None]))
    p = p_round(p)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k) * scale
    return tuple(t.to(torch.bfloat16)
                 for t in (dq.reshape(b, s, hq, dh), dk, dv))


def _worst_ratio(got, want):
    """The largest error over the chip check's per-element limit."""
    want = want.double()
    tol = REL_TOL * max(1.0, float(want.abs().max())) + \
        BF16_STEP * want.abs()
    return float(((got.double() - want).abs() / tol).max())


ROUNDING = [  # b, s, hq, hkv, dh, window
    (1, 256, 8, 2, 64, 0),
    (1, 256, 4, 1, 64, 0),
    (1, 200, 8, 2, 32, 50),
]


@pytest.mark.parametrize("b,s,hq,hkv,dh,window", ROUNDING)
def test_bf16_split_p_and_ds_hold_the_chip_limit_and_one_bf16_does_not(
        b, s, hq, hkv, dh, window):
    rng = np.random.default_rng(s + hq)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, s, h, dh)),
                                dtype=torch.float32).bfloat16()
                   for h in (hq, hkv, hkv, hq))
    o = flash_attention_ref(q, k, v, window=window)
    lse = flash_attention_lse_ref(q, k, window=window)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)
    split = _model_grads(q, k, v, o, lse, do, window, _split, _split)
    assert max(_worst_ratio(a, w) for a, w in zip(split, want)) <= 1.0
    # one bf16 P misses on dv, one bf16 dS on dq and dk
    one_p = _model_grads(q, k, v, o, lse, do, window, _bf16, _split)
    assert _worst_ratio(one_p[2], want[2]) > 3.0
    one_ds = _model_grads(q, k, v, o, lse, do, window, _split, _bf16)
    assert min(_worst_ratio(one_ds[i], want[i]) for i in (0, 1)) > 3.0
