"""A numpy model of the CUDA flash-attention kernel's arithmetic
(``src/repro_torch/csrc/flash_attention.cu``), held against the port's
plain version, the reference's oracle and its Pallas kernel in interpret
mode on the same numpy inputs.

The model follows the kernel's decomposition: one block takes query tiles
i and n - 1 - i (64 rows each), each tile visits only the K/V tiles its
mask allows (``key_tile`` keys each), and each half of every K/V tile's
keys feeds its own online softmax (the two warps of a row), which rescales
its running max, sum and accumulator per tile, in the log2 domain with the
scale folded into log2(e) * scale; the two are merged once per query tile.
The sm90 kernel (``csrc/flash_attention_sm90.cu``, bf16 at width 64) is
the same model with 128-row query tiles walked by a persistent grid in a
fixed order (``sm90_blocks``), 128-key tiles and one online softmax a row
over all of them (``SM90``).
Products are emulated as the kernel makes them: fp32 as 3xTF32 (each
operand split into a high part, rounded to 11 significant bits or for K
truncated to TF32, and a remainder that the tensor core truncates to TF32;
lo.hi + hi.lo + hi.hi),
bf16 as exact products of bf16 values with fp32 sums, and P.V with P split
into a bf16 high part and remainder. The tests also show that the chip
check's limits tell these routes apart from the cheaper ones (one TF32
product; one bf16 P), and that the tile pairing visits every (query, key)
pair the mask allows exactly once."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BQ = 64                     # query rows per tile
LOG2E = np.float32(1.4426950408889634)
TOL = 2e-5                  # the reference's own kernel tests, fp32


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32(a):
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero): the bits plus half of the last kept bit, then the
    13 low bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _trunc_tf32(a):
    """fp32 truncated to TF32: the tensor core reads the top 19 bits of a
    TF32 operand."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _hi11(a):
    """The kernel's high part: a rounded to 11 significant bits by
    Veltkamp's split in fp32 (c = a (2^13 + 1), hi = c - (c - a))."""
    a = np.asarray(a, np.float32)
    c = (a * np.float32(8193.0)).astype(np.float32)
    return (c - (c - a).astype(np.float32)).astype(np.float32)


def _bf16(a):
    """fp32 rounded to bf16 (to nearest even), as fp32 values."""
    return torch.as_tensor(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def mm_3xtf32(a, b, b_hi=_hi11):
    """The kernel's 3xTF32: hi (by default 11 bits, exact in TF32) and the
    remainder lo = x - hi, truncated to TF32 by the tensor core; lo.hi +
    hi.lo + hi.hi summed in fp32."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    ah, bh = _hi11(a), b_hi(b)
    assert np.array_equal(_trunc_tf32(ah), ah)
    al, bl = _trunc_tf32(a - ah), _trunc_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_3xtf32_k(q, kt):
    """S = Q K^T as the kernel splits it: K's high part truncated to TF32,
    Q's rounded to 11 bits."""
    return mm_3xtf32(q, kt, b_hi=_trunc_tf32)


def mm_tf32(a, b):
    """One TF32 product: operands rounded to TF32 (``cvt.rna``), fp32
    sums."""
    return _tf32(a) @ _tf32(b)


def mm_fp32(a, b):
    """Exact products, fp32 sums: the bf16 route's Q.K^T (bf16 values)."""
    return a.astype(np.float32) @ b.astype(np.float32)


def pv_bf16_split(p, v):
    """The bf16 route's P.V: P = hi + lo, each rounded to bf16."""
    hi = _bf16(p)
    return hi @ v + _bf16(p - hi) @ v


def pv_bf16(p, v):
    """P rounded to bf16 once (what FlashAttention-2 feeds its P.V)."""
    return _bf16(p) @ v


FP32_ROUTE = {"qk": mm_3xtf32_k, "pv": mm_3xtf32}


def key_tile(dh, fp32):
    """K/V rows per tile at the width dh is run at (the next of 64 / 128 /
    256): 32 at width 256 (shared memory, registers), 128 for bf16 at width
    64, else 64."""
    if dh > 128:
        return 32
    return 128 if not fp32 and dh <= 64 else 64


def block_tiles(nq, window):
    """Query tiles of each block, in launch order: block x takes tiles p
    and nq - 1 - p (the middle tile of an odd nq alone), p = x, or with a
    window p = npairs - 1 - x (the heaviest pairs first)."""
    npairs = (nq + 1) // 2
    out = []
    for x in range(npairs):
        p = npairs - 1 - x if window > 0 else x
        out.append([p] if nq - 1 - p == p else [p, nq - 1 - p])
    return out


def sm90_blocks(nq, bh, grid):
    """The sm90 kernel's (query tile, batch x head) pairs of each of a grid
    of ``grid`` persistent blocks, in its order: block x takes t = x, x +
    grid, ...; t is query tile nq - 1 - t // bh (the longest causal tiles
    first) of batch x head t % bh."""
    return [[(nq - 1 - t // bh, t % bh) for t in range(x, nq * bh, grid)]
            for x in range(grid)]


# the sm90 kernel's tiling: query and key tiles of 128, one online softmax a
# row over all of a tile's keys
SM90 = {"bq": 128, "bk": 128, "halves": 1}


def kv_tiles(q0, skv, causal, window, bk, bq=BQ):
    """First keys of the K/V tiles query tile q0 (of ``bq`` rows) visits."""
    end = min(skv, q0 + bq) if causal else skv
    begin = max(0, q0 - window + 1) if window > 0 else 0
    begin = begin // bk * bk
    return list(range(begin, end, bk))


def visible(rows, cols, causal, window, skv):
    ok = (rows[:, None] >= 0) & (cols[None, :] < skv)
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None])
    if window:
        ok = ok & (cols[None, :] > rows[:, None] - window)
    return ok


def _exp2(x):
    return np.exp2(x).astype(np.float32)


@np.errstate(invalid="ignore")   # -inf - -inf where a row sees nothing yet
def flash_model(q, k, v, *, causal=True, window=0, qk=mm_3xtf32_k,
                pv=mm_3xtf32, bk=64, bq=BQ, halves=2):
    """The kernel's decomposition on numpy inputs q [B,S,Hq,dh], k/v
    [B,Skv,Hkv,dh] (bf16 inputs as their fp32 values); fp32 output. Query
    tiles of ``bq`` rows, K/V tiles of ``bk`` keys, each cut into ``halves``
    parts with an online softmax each (``**SM90``: the sm90 kernel's)."""
    b, s, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale2 = np.float32(np.float32(dh ** -0.5) * LOG2E)
    out = np.zeros(q.shape, np.float32)
    nq = -(-s // bq)
    part = bk // halves
    for bi in range(b):
        for h in range(hq):
            kh = h // (hq // hkv)
            for tiles in block_tiles(nq, window):
                for qt in tiles:
                    rows = np.arange(qt * bq, min(qt * bq + bq, s))
                    # one online softmax per part of each tile's keys
                    m = np.full((halves, len(rows)), -np.inf, np.float32)
                    l = np.zeros((halves, len(rows)), np.float32)
                    acc = np.zeros((halves, len(rows), dh), np.float32)
                    for k0 in kv_tiles(qt * bq, skv, causal, window, bk, bq):
                        for half in range(halves):
                            lo = k0 + half * part
                            cols = np.arange(lo, min(lo + part, skv))
                            if not len(cols):
                                continue
                            sc = qk(q[bi, rows, h], k[bi, cols, kh].T)
                            sc = np.where(
                                visible(rows, cols, causal, window, skv),
                                (sc * scale2).astype(np.float32), -np.inf)
                            mn = np.maximum(m[half], sc.max(1))
                            none = mn == -np.inf    # nothing visible yet
                            alpha = np.where(none, np.float32(1),
                                             _exp2(m[half] - mn))
                            p = np.where(none[:, None], np.float32(0),
                                         _exp2(sc - mn[:, None]))
                            l[half] = l[half] * alpha + p.sum(
                                1, dtype=np.float32)
                            acc[half] = acc[half] * alpha[:, None] + pv(
                                p, v[bi, cols, kh])
                            m[half] = mn
                    mm = m.max(0)
                    a = np.where(mm == -np.inf, np.float32(0),
                                 _exp2(m - mm))
                    lsum = (l * a).sum(0, dtype=np.float32)
                    o = (acc * a[:, :, None]).sum(0, dtype=np.float32)
                    out[bi, rows, h] = o / np.maximum(lsum, 1e-30)[:, None]
    return out


def _inputs(seed, b, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, dh)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", [
    (1, 256, 4, 2, 64, True, 0),        # qwen2-0.5b's heads, cut
    (1, 256, 4, 1, 256, True, 0),       # recurrentgemma-9b's, cut
    (2, 128, 2, 2, 128, False, 0),
    (1, 300, 4, 1, 256, True, 96),      # ragged, window biting
    (1, 203, 4, 2, 64, True, 0),        # ragged
    (1, 200, 2, 1, 112, True, 64),      # a width below its instantiation
    (1, 64, 2, 1, 64, True, 0),         # one tile
])
def test_fp32_model_matches_refs_and_pallas(b, s, hq, hkv, dh, causal,
                                            window):
    q, k, v = _inputs(s + dh, b, s, hq, hkv, dh)
    got = flash_model(q, k, v, causal=causal, window=window,
                      bk=key_tile(dh, True), **FP32_ROUTE)
    ref = flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                              causal=causal, window=window)
    assert _err(got, ref) < TOL
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert _err(got, jax_flash_ref(jq, jk, jv, causal=causal,
                                   window=window)) < TOL
    if s <= 256 or s % 256 == 0:   # the Pallas grid floor-divides S
        assert _err(got, jax_flash(jq, jk, jv, causal=causal, window=window,
                                   interpret=True)) < TOL


@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 200, 1000, 1031, 2112])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (True, 2048), (False, 0),
                                           (False, 64)])
@pytest.mark.parametrize("bk", [32, 64, 128, "sm90"])
def test_pairing_visits_each_visible_pair_once(s, causal, window, bk):
    """Every (query, key) pair the mask allows is computed exactly once
    (odd and even tile counts, S 1, a window at a tile edge: S 2048 + 64);
    with plain causal masking every two-tile block does nq or nq + 1 tiles
    of work (64-key tiles), where the old grid's tiles did 1 to nq. "sm90":
    the sm90 kernel's persistent order over 3 (batch, head) pairs and a
    grid of 4 blocks, each tile once, and with a causal mask no block's
    tiles grow in work."""
    if bk == "sm90":
        _sm90_order_visits_each_visible_pair_once(s, causal, window)
        return
    nq = -(-s // BQ)
    seen = np.zeros((s, s), np.int32)
    work = []
    for tiles in block_tiles(nq, window):
        n = 0
        for qt in tiles:
            rows = np.arange(qt * BQ, min(qt * BQ + BQ, s))
            for k0 in kv_tiles(qt * BQ, s, causal, window, bk):
                cols = np.arange(k0, min(k0 + bk, s))
                seen[np.ix_(rows, cols)] += visible(rows, cols, causal,
                                                    window, s)
                n += 1
        work.append((len(tiles), n))
    allowed = visible(np.arange(s), np.arange(s), causal, window, s)
    assert np.array_equal(seen, allowed.astype(np.int32))
    assert sorted(t for tiles in block_tiles(nq, window) for t in tiles) \
        == list(range(nq))
    if causal and not window and bk == BQ:
        assert {n for t, n in work if t == 2} <= {nq, nq + 1}


def _sm90_order_visits_each_visible_pair_once(s, causal, window, bh=3,
                                              grid=4):
    bq, bk = SM90["bq"], SM90["bk"]
    nq = -(-s // bq)
    seen = np.zeros((bh, s, s), np.int32)
    for block in sm90_blocks(nq, bh, grid):
        work = []
        for qt, x in block:
            rows = np.arange(qt * bq, min(qt * bq + bq, s))
            starts = kv_tiles(qt * bq, s, causal, window, bk, bq)
            for k0 in starts:
                cols = np.arange(k0, min(k0 + bk, s))
                seen[x][np.ix_(rows, cols)] += visible(rows, cols, causal,
                                                        window, s)
            work.append(len(starts))
        if causal:
            assert work == sorted(work, reverse=True)
    allowed = visible(np.arange(s), np.arange(s), causal, window, s)
    for x in range(bh):
        assert np.array_equal(seen[x], allowed.astype(np.int32))
    assert sorted(t for block in sm90_blocks(nq, bh, grid) for t in block) \
        == [(qt, x) for qt in range(nq) for x in range(bh)]


def _cut(case):
    """CPU cuts of the chip check's fp32 serve shapes: qwen2-0.5b (dh 64,
    GQA) and recurrentgemma-9b (dh 256, MQA), S 300 (ragged: 4 full tiles
    and 44 rows), and recurrentgemma-9b's window biting (96 at S 300)."""
    s, hq, hkv, dh, window = {"qwen2": (300, 4, 2, 64, 0),
                              "recurrentgemma": (300, 4, 1, 256, 0),
                              "window": (300, 4, 1, 256, 96),
                              "qwen2-sm90": (300, 4, 2, 64, 0),
                              "window-sm90": (300, 4, 2, 64, 96)}[case]
    return _inputs(7, 1, s, hq, hkv, dh), dh, window


def _over_tol(chip_smoke, got, ref):
    """Largest ratio of the error to the chip check's per-element limit
    (``FP32_TOL``, plus one bf16 step of the value in bf16)."""
    ref = ref.float()
    tol = chip_smoke.FP32_TOL
    if got.dtype == torch.bfloat16:
        tol = tol + chip_smoke.BF16_STEP * ref.abs()
    return float(((got.float() - ref).abs() / tol).max())


@pytest.mark.parametrize("case", ["qwen2", "recurrentgemma", "window"])
def test_3xtf32_holds_chip_limit_and_tf32_does_not(chip_smoke, case):
    """Why the kernel splits each fp32 operand: with 3xTF32 products the
    model stays within 0.1 of the chip check's 1e-4 limit; with one TF32
    product per product it misses the limit."""
    (q, k, v), dh, window = _cut(case)
    ref = flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                              window=window)
    routes = {"3xtf32": FP32_ROUTE, "tf32": {"qk": mm_tf32, "pv": mm_tf32}}
    errs = {name: _over_tol(chip_smoke, torch.as_tensor(flash_model(
        q, k, v, window=window, bk=key_tile(dh, True), **route)), ref)
        for name, route in routes.items()}
    assert errs["3xtf32"] <= 0.1, errs
    assert errs["tf32"] > 1.0, errs


@pytest.mark.parametrize("case", ["qwen2", "recurrentgemma", "window",
                                  "qwen2-sm90", "window-sm90"])
def test_bf16_split_p_holds_chip_limit_and_one_bf16_p_does_not(chip_smoke,
                                                               case):
    """Why the bf16 routes split P: with P = hi + lo in bf16 the model's
    bf16 output stays within the chip check's limit (1e-4 plus one bf16 step
    of the value); with P rounded to bf16 once it misses it. "-sm90": the
    sm90 kernel's tiling, 128-key tiles under one softmax a row."""
    (q, k, v), dh, window = _cut(case)
    qb, kb, vb = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    ref = flash_attention_ref(qb, kb, vb, window=window)
    tiling = SM90 if case.endswith("-sm90") else {"bk": key_tile(dh, False)}
    errs = {}
    for name, pv in (("split", pv_bf16_split), ("one", pv_bf16)):
        got = flash_model(*(x.float().numpy() for x in (qb, kb, vb)),
                          window=window, qk=mm_fp32, pv=pv, **tiling)
        errs[name] = _over_tol(chip_smoke,
                               torch.as_tensor(got).bfloat16(), ref)
    assert errs["split"] <= 1.0, errs
    assert errs["one"] > 1.0, errs
