"""Each CUDA kernel of the port against its plain PyTorch version on the
card. Marked ``gpu``: whether a card is present is decided in a fixture, so
every process collects the same tests; without a card they skip.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import WorkQueue  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd  # noqa: E402
from repro_torch.kernels.wq_claim.ref import wq_claim_ref  # noqa: E402
from repro_torch.models.attention import _sdpa, sdpa_ref  # noqa: E402
from repro_torch.models.rglru import RGLRU, _rglru_core  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor  # noqa: E402

pytestmark = pytest.mark.gpu

# fp32: the kernel sums in another order than the plain einsum. bf16: both
# sides compute in fp32 and round the output to bf16 once, so an element may
# also differ by one bf16 step of its value, 2**-7 * |ref|; a key dropped or
# added at a ragged kv_len moves outputs by far more.
FP32_TOL = 2e-5


def _assert_close(got, want):
    """Every element within the per-element limit above."""
    assert got.dtype == want.dtype
    tol = FP32_TOL
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                           device=dev).to(dtype)


@pytest.mark.parametrize("n,w,k", [
    (1, 1, 1), (1000, 1, 3), (1024, 7, 1), (5000, 16, 4), (100_000, 936, 1),
    (262_144, 64, 4), (70_001, 13_000, 2),      # W past the shared-memory path
])
def test_wq_claim_kernel_equals_plain(dev, n, w, k):
    rng = np.random.default_rng(n + w)
    status = torch.as_tensor(rng.choice([0, 1, 2, 3, 4], n).astype(np.int32),
                             device=dev)
    worker = torch.as_tensor(rng.integers(-2, w + 2, n).astype(np.int32),
                             device=dev)
    got = wq_claim_fwd(status, worker, num_workers=w, k=k)
    want = wq_claim_ref(status, worker, num_workers=w, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _claim_columns(rng, n, w, dev):
    status = torch.as_tensor(rng.choice([0, 2, 3, 4], n, p=[.1, .5, .2, .2])
                             .astype(np.int32), device=dev)
    worker = torch.as_tensor(rng.integers(-1, w + 1, n).astype(np.int32),
                             device=dev)
    return status, worker


@pytest.mark.parametrize("n,w,k", [
    (100_000, 936, 1),
    (1 << 22, 64, 4),         # 4096 tiles: more than the resident blocks
    (3_000_000, 5000, 3),     # and W past the shared-memory path
])
def test_wq_claim_kernel_repeats_bit_identical(dev, n, w, k):
    """20 calls back to back on one stream give the same results, equal to
    the plain version: the grid barrier's words are left zeroed, and a
    block that owns several tiles counts them again for the rank pass."""
    status, worker = _claim_columns(np.random.default_rng(n), n, w, dev)
    outs = [wq_claim_fwd(status, worker, num_workers=w, k=k)
            for _ in range(20)]
    want = wq_claim_ref(status, worker, num_workers=w, k=k)
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wq_claim_kernel_alternating_k_on_one_stream(dev):
    """Calls with different k (and a k past every worker's count) on one
    stream, back to back, each equal to the plain version."""
    status, worker = _claim_columns(np.random.default_rng(5), 262_144, 64,
                                    dev)
    ks = [1, 4, 2, 100_000, 0, 1]
    outs = [wq_claim_fwd(status, worker, num_workers=64, k=k) for k in ks]
    torch.cuda.synchronize()
    for k, got in zip(ks, outs):
        want = wq_claim_ref(status, worker, num_workers=64, k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wq_claim_empty_launch_is_not_counted(dev):
    from repro_torch.kernels.wq_claim.kernel import empty_launch
    status = torch.full((100_000,), 2, dtype=torch.int32, device=dev)
    before = wq_claim_fwd.launches
    empty_launch(status, 936)
    torch.cuda.synchronize()
    assert wq_claim_fwd.launches == before


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,dtype", [
    (1, 1000, 14, 2, 64, True, 0, torch.float32),
    (1, 1000, 14, 2, 64, True, 0, torch.bfloat16),
    (2, 333, 4, 4, 128, False, 0, torch.float32),
    (1, 200, 2, 1, 112, True, 64, torch.float32),
    (1, 130, 8, 2, 256, True, 0, torch.bfloat16),
    (3, 1, 4, 2, 64, True, 0, torch.float32),
    # recurrentgemma-9b's prefill: fp32, dh 256, MQA, window 2048 (biting
    # past 2048 positions)
    (1, 1000, 16, 1, 256, True, 2048, torch.float32),
    (1, 2100, 16, 1, 256, True, 2048, torch.float32),
    # an odd query-tile count (17 tiles: the middle tile alone) and short S
    (1, 1031, 4, 2, 64, True, 0, torch.float32),
    (1, 1031, 4, 1, 256, True, 0, torch.bfloat16),
    (1, 1, 4, 1, 256, True, 0, torch.float32),
    (1, 17, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 65, 4, 2, 64, True, 0, torch.float32),
    (2, 300, 6, 6, 64, True, 0, torch.float32),     # B 2, Hq = Hkv
    (2, 300, 6, 6, 64, True, 0, torch.bfloat16),
    (1, 257, 4, 2, 112, True, 0, torch.bfloat16),
    (1, 257, 4, 2, 128, True, 0, torch.float32),
    (1, 257, 4, 2, 128, True, 0, torch.bfloat16),
    # the window's edge exactly at a tile edge
    (1, 2112, 4, 1, 256, True, 2048, torch.float32),
    (1, 2112, 4, 1, 64, True, 2048, torch.bfloat16),
    (1, 500, 4, 2, 256, False, 0, torch.bfloat16),  # not causal
    # rows that are not whole 16-byte copies: staged element by element
    (1, 130, 4, 2, 50, True, 0, torch.float32),
    (1, 300, 4, 2, 100, True, 0, torch.bfloat16),
    # bf16 at width 64, the sm90 kernel: the benchmark cells' heads and rows
    # cut in batch (qwen2 14/2 at S 2048 and 8192, granite 24/8), S 1 and
    # 1031 (17 and 2112 above), not causal, a window inside the key tiles
    (2, 2048, 14, 2, 64, True, 0, torch.bfloat16),
    (2, 2048, 24, 8, 64, True, 0, torch.bfloat16),
    (1, 8192, 14, 2, 64, True, 0, torch.bfloat16),
    (3, 1, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 1031, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 500, 4, 2, 64, False, 0, torch.bfloat16),
    (2, 700, 6, 2, 64, True, 100, torch.bfloat16),
])
def test_flash_kernel_equals_plain(dev, b, s, hq, hkv, dh, causal, window,
                                   dtype):
    """The output, and the row LSE the train path's call also writes (1e-4,
    the limit the backward's inputs are held to), against the plain
    versions; a repeat is bit-identical."""
    rng = np.random.default_rng(s)
    q = _randn(rng, (b, s, hq, dh), dtype, dev)
    k, v = (_randn(rng, (b, s, hkv, dh), dtype, dev) for _ in range(2))
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _assert_close(got, want)
    assert torch.equal(out, got)
    assert float((lse - flash_attention_lse_ref(q, k, causal=causal,
                                                window=window))
                 .abs().max()) <= 1e-4


# the enc-dec and cross-attention shapes: queries and keys of different
# counts, not causal (every query sees every key)
CROSS_CASES = [  # b, sq, skv, hq, hkv, dh, dtype
    (1, 4096, 4096, 16, 16, 64, torch.float32),   # seamless's encoder
    (1, 64, 4096, 16, 16, 64, torch.float32),     # cross-attention prefill
    (8, 256, 2048, 16, 16, 64, torch.bfloat16),   # cross-attention training
    (1, 1000, 300, 4, 2, 128, torch.float32),     # more queries than keys
    (2, 17, 1031, 6, 3, 64, torch.bfloat16),      # ragged, one query tile
    (1, 1000, 300, 4, 2, 64, torch.bfloat16),     # the sm90 kernel: Sq > Skv
    (2, 300, 1031, 24, 8, 64, torch.bfloat16),    # Sq < Skv, granite's GQA
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,dtype", CROSS_CASES)
def test_flash_kernel_cross_shapes_equal_plain(dev, b, sq, skv, hq, hkv, dh,
                                               dtype):
    """Not causal, Sq != Skv: every query tile reads all of the keys (the
    pairing of query tiles i and n-1-i only orders the work)."""
    rng = np.random.default_rng(sq + skv)
    q = _randn(rng, (b, sq, hq, dh), dtype, dev)
    k, v = (_randn(rng, (b, skv, hkv, dh), dtype, dev) for _ in range(2))
    got, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    want = flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_close(got, want)
    assert float((lse - flash_attention_lse_ref(q, k, causal=False))
                 .abs().max()) <= 1e-4


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,dtype", CROSS_CASES[1:])
def test_flash_backward_cross_shapes_equal_plain(dev, b, sq, skv, hq, hkv,
                                                 dh, dtype):
    """The backward at the same shapes: dq, dk and dv each within 1e-4 of
    its largest (plus one bf16 step in bf16) of the plain backward on the
    forward kernel's own output and LSE; every key tile's block walks all
    of the query tiles, fewer or more than its keys."""
    rng = np.random.default_rng(sq * skv)
    q, do = (_randn(rng, (b, sq, hq, dh), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (b, skv, hkv, dh), dtype, dev) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = 1e-4 * max(1.0, float(w.float().abs().max()))
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * w.float().abs()
        assert bool(((g.float() - w.float()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_query_against_every_key_goes_to_the_decode_kernel(dev, dtype):
    """Enc-dec's cross-attention at decode: one query, no cache tail, 4096
    encoder frames at 16/16 heads of 64. ``_sdpa`` sends it to the decode
    kernel with kv_len = Smax = 4096, made on the card; it equals the plain
    attention."""
    rng = np.random.default_rng(4096)
    q = _randn(rng, (1, 1, 16, 64), dtype, dev)
    k, v = (_randn(rng, (1, 4096, 16, 64), dtype, dev) for _ in range(2))
    reset_launch_counts()
    got = _sdpa(q, k, v, causal=False)
    counts = launch_counts()
    assert counts["decode_attention"] == 1 and counts["flash_attention"] == 0
    want = sdpa_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_close(got, want)
    kvl = torch.tensor([4096], dtype=torch.int32, device=dev)
    _assert_close(decode_attention_fwd(q, k, v, kvl),
                  decode_attention_ref(q, k, v, kvl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bit_identical(dev, dtype):
    """20 back-to-back calls at qwen2-0.5b's prefill shape give the same
    bits: no atomics, and the order of every sum is fixed."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 1000, 14, 64), dtype, dev)
    k, v = (_randn(rng, (1, 1000, 2, 64), dtype, dev) for _ in range(2))
    first = flash_attention_fwd(q, k, v)
    outs = [flash_attention_fwd(q, k, v) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


def test_flash_forward_routes_by_dtype_and_width(dev):
    """bf16 at width 64 with 16-byte aligned q/k/v goes to the sm90 kernel,
    whatever the mask, lengths or GQA ratio; fp32, the widths 128 and 256
    and an unaligned q go to the kernel of csrc/flash_attention.cu, whose
    results the other tests hold unchanged. ``flash_attention`` counts
    every call, ``sm90_launches`` those on the sm90 route."""
    rng = np.random.default_rng(5)

    def call(b, sq, skv, hq, hkv, dh, dtype, **kw):
        q = _randn(rng, (b, sq, hq, dh), dtype, dev)
        k, v = (_randn(rng, (b, skv, hkv, dh), dtype, dev) for _ in range(2))
        flash_attention_fwd(q, k, v, **kw)

    reset_launch_counts()
    call(1, 300, 300, 4, 2, 64, torch.bfloat16)
    call(2, 17, 1031, 24, 8, 64, torch.bfloat16, causal=False)
    call(1, 500, 500, 4, 1, 64, torch.bfloat16, window=100, return_lse=True)
    assert flash_attention_fwd.sm90_launches == 3
    call(1, 300, 300, 4, 2, 64, torch.float32)
    for dh in (128, 256):
        call(1, 300, 300, 4, 2, dh, torch.bfloat16)
    # q 8 bytes past a 16-byte boundary (its rows stay whole 16-byte rows)
    buf = torch.zeros(4 + 300 * 4 * 64, dtype=torch.bfloat16, device=dev)
    q = buf[4:].view(1, 300, 4, 64)
    kv = _randn(rng, (1, 300, 2, 64), torch.bfloat16, dev)
    assert q.data_ptr() % 16 == 8
    flash_attention_fwd(q, kv, kv)
    torch.cuda.synchronize()
    assert flash_attention_fwd.sm90_launches == 3
    assert launch_counts()["flash_attention"] == 7
    reset_launch_counts()
    assert flash_attention_fwd.sm90_launches == 0


@pytest.mark.parametrize("b,smax,hq,hkv,dh,kv_len,dtype", [
    (1, 4096, 14, 2, 64, 1, torch.bfloat16),
    (1, 4096, 14, 2, 64, 1031, torch.bfloat16),
    (1, 4096, 14, 2, 64, 1031, torch.float32),
    (1, 4096, 14, 2, 64, 4096, torch.bfloat16),
    (2, 1024, 4, 2, 64, 700, torch.float32),
    (1, 2048, 8, 1, 128, 2048, torch.float32),
    (2, 1024, 4, 4, 112, 513, torch.float32),
    (1, 300, 32, 2, 256, 299, torch.bfloat16),   # 16 query heads per KV head
    # recurrentgemma-9b's decode: the ring of 2048 slots, full and not
    (1, 2048, 16, 1, 256, 1001, torch.bfloat16),
    (1, 2048, 16, 1, 256, 2048, torch.bfloat16),
])
@pytest.mark.parametrize("window", [0, 700])
def test_decode_kernel_equals_plain(dev, b, smax, hq, hkv, dh, kv_len,
                                    dtype, window):
    """With a window (a linear cache past the window), positions below
    kv_len - window are masked too."""
    rng = np.random.default_rng(kv_len)
    q = _randn(rng, (b, 1, hq, dh), dtype, dev)
    k, v = (_randn(rng, (b, smax, hkv, dh), dtype, dev) for _ in range(2))
    kvl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    got = decode_attention_fwd(q, k, v, kvl, window)
    want = decode_attention_ref(q, k, v, kvl, window)
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.parametrize("smax,hq,hkv,dh,kv_len,window", [
    (4096, 14, 2, 64, 1, 0),        # far more splits than live positions
    (4096, 14, 2, 64, 5, 0),
    (4096, 16, 1, 256, 5, 0),
    (4096, 16, 1, 256, 3000, 2048),
    (2048, 16, 1, 256, 2048, 0),    # 16 query heads over one KV head
    (64, 40, 2, 96, 37, 0),         # 20 heads per KV head: two head groups
    (300, 4, 2, 100, 250, 0),       # rows not whole 16-byte copies
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_split_edges(dev, smax, hq, hkv, dh, kv_len, window,
                                   dtype):
    """Splits past the live positions write empty partials; the merge of
    the clusters' partials keeps every head of a KV head."""
    rng = np.random.default_rng(kv_len + hq)
    q = _randn(rng, (1, 1, hq, dh), dtype, dev)
    k, v = (_randn(rng, (1, smax, hkv, dh), dtype, dev) for _ in range(2))
    kvl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    got = decode_attention_fwd(q, k, v, kvl, window)
    want = decode_attention_ref(q, k, v, kvl, window)
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_decode_kernel_repeats_bit_identical(dev):
    """100 calls back to back give the same bits: the arrival counters are
    left zeroed by every call, and the merge order does not depend on which
    cluster arrives last."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (1, 1, 16, 256), torch.bfloat16, dev)
    k, v = (_randn(rng, (1, 2048, 1, 256), torch.bfloat16, dev)
            for _ in range(2))
    kvl = torch.tensor([1001], dtype=torch.int32, device=dev)
    outs = [decode_attention_fwd(q, k, v, kvl) for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    _assert_close(outs[0], decode_attention_ref(q, k, v, kvl))


@pytest.mark.parametrize("bh,s,p,n,chunk,g,dtype,slow", [
    (64, 1000, 64, 128, 256, 64, torch.float32, False),   # mamba2 prefill
    (64, 1031, 64, 128, 256, 64, torch.float32, False),   # ragged
    (64, 1000, 64, 128, 256, 64, torch.bfloat16, False),
    (64, 4096, 64, 128, 256, 64, torch.float32, True),    # carry dominates
    (4, 128, 64, 32, 32, 1, torch.float32, False),        # the reference's
    (2, 256, 64, 128, 64, 1, torch.float32, False),       # kernel-test
    (1, 64, 128, 16, 64, 1, torch.float32, False),        # shapes
    (2, 300, 48, 256, 128, 2, torch.float32, True),       # N 256, P 48
    (3, 10, 8, 16, 256, 3, torch.bfloat16, False),        # S < chunk
    (4, 1024, 64, 128, 256, 1, torch.float32, True),      # g 1, 4 chunks
    (2, 1000, 72, 100, 256, 1, torch.bfloat16, False),    # P, N past a tile
])
def test_ssd_scan_kernel_equals_plain(dev, bh, s, p, n, chunk, g, dtype,
                                      slow):
    """Against the sequential recurrence: max |got - ref| / max |ref| < 1e-4
    (the reference's rule) for y and the final state; a bf16 y may also
    differ by one bf16 step of its value."""
    rng = np.random.default_rng(s + n)
    x = _randn(rng, (bh, s, p), dtype, dev)
    bm, cm = (_randn(rng, (bh // g, s, n), dtype, dev) * 0.5
              for _ in range(2))
    if slow:
        dt = torch.full((bh, s), 0.01, device=dev).to(dtype)
        a = -torch.linspace(0.1, 1.0, bh, device=dev)[:, None]
    else:
        dt = torch.nn.functional.softplus(_randn(rng, (bh, s), torch.float32,
                                                 dev)).to(dtype)
        a = -torch.linspace(1.0, 16.0, bh, device=dev)[:, None]
    da = (dt.float() * a).to(dtype)
    y, st = ssd_scan_fwd(x, bm, cm, dt, da, chunk=chunk, heads_per_bc=g)
    ry, rst = ssd_scan_ref(x, bm, cm, dt, da, heads_per_bc=g)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 1e-4 * ry.float().abs().max()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ry.float().abs()
    assert bool(((y.float() - ry.float()).abs() <= tol).all())
    assert float((st - rst).abs().max()) <= 1e-4 * float(rst.abs().max())


def _rglru_inputs(rng, b, s, c, dtype, dev, slow):
    """a in (0.9, 1) as the model's Lambda init gives it (about 0.999 in the
    slow-decay case, where the carry across time chunks dominates h), u
    normalised by sqrt(1 - a^2)."""
    if slow:
        a = 1.0 - 1e-3 * np.exp(0.1 * rng.standard_normal((b, s, c)))
    else:
        a = np.linspace(0.9, 0.999, c) ** (
            1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, c)))))
    u = np.sqrt(1.0 - a * a) * rng.standard_normal((b, s, c))
    return [torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)
            for x in (a, u)]


@pytest.mark.parametrize("b,s,c,dtype,slow", [
    (1, 1000, 4096, torch.float32, False),   # recurrentgemma-9b prefill
    (1, 1031, 4096, torch.float32, False),   # ragged
    (1, 1000, 4096, torch.bfloat16, False),
    (1, 4096, 4096, torch.float32, True),    # carry dominates
    (2, 64, 128, torch.float32, False),      # the reference's kernel-test
    (1, 256, 512, torch.float32, False),     # shapes
    (3, 5, 40, torch.float32, True),         # S below one warp's 16 steps
    (2, 300, 100, torch.bfloat16, True),     # C not a multiple of 32
    (1, 1, 33, torch.float32, False),
    # tile edges on S (tiles of 128 steps): 10 tiles exactly, a step past
    # them, and 30 tiles and a step
    (1, 1280, 256, torch.float32, True),
    (1, 1281, 256, torch.float32, True),
    (2, 3841, 96, torch.bfloat16, True),
    (3, 1031, 200, torch.float32, False),    # B > 1, ragged S and C
    (3, 1031, 200, torch.bfloat16, True),
    (1, 7, 4096, torch.float32, True),       # fewer steps than blocks
])
def test_rglru_scan_kernel_equals_plain(dev, b, s, c, dtype, slow):
    """Against the sequential recurrence: |got - ref| <= 1e-4 max |ref| per
    element, plus one bf16 step of the value for a bf16 h."""
    a, u = _rglru_inputs(np.random.default_rng(s + c), b, s, c, dtype, dev,
                         slow)
    got = rglru_scan_fwd(a, u)
    want = rglru_scan_ref(a, u)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 1e-4 * want.float().abs().max()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("b,s,c,dtype", [
    (1, 1000, 4096, torch.float32),
    (1, 4096, 4096, torch.bfloat16),
    (8, 1000, 8192, torch.float32),   # 2048 blocks: more than resident
])
def test_rglru_scan_kernel_repeats_bit_identical(dev, b, s, c, dtype):
    """20 calls back to back give the same bits: every fold runs in a fixed
    order, whichever warp finishes first."""
    a, u = _rglru_inputs(np.random.default_rng(c), b, s, c, dtype, dev, True)
    first = rglru_scan_fwd(a, u)
    outs = [rglru_scan_fwd(a, u) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    want = rglru_scan_ref(a, u)
    tol = 1e-4 * want.float().abs().max()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    assert bool(((first.float() - want.float()).abs() <= tol).all())


def test_rglru_core_from_a_state_launches_the_scan(dev):
    """Several steps from a state (S > 1 with h0) go through the scan kernel
    on the card, then carry h0 in, and agree with the same weights on the
    CPU (plain versions) within 1e-4 of the output's size."""
    cfg = smoke_config("recurrentgemma-9b")
    mixer = RGLRU(torch.Generator().manual_seed(0), cfg, torch.float32)
    rng = np.random.default_rng(7)
    lw = mixer.conv_w.shape[1]
    x, h0 = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
             for shape in ((2, 6, lw), (2, lw)))
    with torch.no_grad():
        want = _rglru_core(mixer, x, h0)
        reset_launch_counts()
        got = _rglru_core(copy.deepcopy(mixer).to(dev), x.to(dev), h0.to(dev))
        assert launch_counts()["rglru_scan"] == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= tol


def test_dispatch_launches_kernels_or_raises(dev):
    q = torch.zeros((1, 4, 2, 64), device=dev)
    reset_launch_counts()
    kops.flash_attention(q, q, q)
    kops.decode_attention(q[:, :1], q, q,
                          kv_len=torch.tensor([3], dtype=torch.int32,
                                              device=dev))
    kops.wq_claim(torch.full((5,), 2, dtype=torch.int32, device=dev),
                  torch.zeros(5, dtype=torch.int32, device=dev),
                  num_workers=1, k=2)
    # a 1-token prefill: one query, no cache tail, so the decode kernel
    # (the reference's Pallas dispatch sends it there too)
    _sdpa(q[:, :1], q[:, :1], q[:, :1], causal=True)
    x = torch.zeros((4, 5, 8), device=dev)
    kops.ssd_scan(x, x[:2, :, :4], x[:2, :, :4], x[..., 0], x[..., 0],
                  heads_per_bc=2)
    kops.rglru_scan(x, x)
    _sdpa(q[:, :1], q, q, causal=True, window=2, q_offset=3,
          kv_len=torch.tensor([4], dtype=torch.int32, device=dev))
    labels = torch.zeros((4, 5), dtype=torch.int32, device=dev)
    kops.cross_entropy(x, labels)
    assert launch_counts() == {"wq_claim": 1, "flash_attention": 1,
                               "flash_attention_bwd": 0,
                               "decode_attention": 3, "ssd_scan": 1,
                               "ssd_scan_bwd": 0, "rglru_scan": 1,
                               "rglru_scan_bwd": 0, "cross_entropy": 1,
                               "cross_entropy_bwd": 0}
    with pytest.raises(TypeError):
        kops.cross_entropy(x.half(), labels)
    with pytest.raises(TypeError):
        kops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        kops.ssd_scan(x, x, x, x[..., 0].double(), x[..., 0])
    with pytest.raises(TypeError):
        kops.rglru_scan(x, x.to(torch.bfloat16))


def test_device_claim_queue_on_card(dev):
    a = WorkQueue(num_workers=9, device_claim=True, device=dev)
    b = WorkQueue(num_workers=9, device="cpu")
    for q in (a, b):
        q.add_tasks(0, 500)
    for r, k in enumerate((1, 4, 2)):
        got, want = a.claim_all(k=k, now=float(r)), \
            b.claim_all_reference(k=k, now=float(r))
        assert all(np.array_equal(got[w], want[w]) for w in want)


def test_serve_on_card_matches_cpu(dev):
    cfg = smoke_config("qwen2-0.5b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 70)).astype(np.int32)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = ServeExecutor(cfg, slots=2, max_len=96, device=name)
        if name == "cpu":
            ex.set_params(copy.deepcopy(outs["params"]).to("cpu"))
        outs["params"] = ex.params
        ids = ex.submit(prompts, max_new=6)
        assert ex.drain() == 3
        outs[name] = [ex.wq.store.blobs[int(t)]["output"] for t in ids]
    assert all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                    outs["cpu"]))


def test_ssm_serve_on_card_matches_cpu(dev):
    """mamba2 smoke: the SSD kernel in every prefill, decode in plain torch;
    greedy outputs on the card equal those of the same weights on the CPU,
    with one ssd_scan launch per layer and request."""
    cfg = smoke_config("mamba2-1.3b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 70)).astype(np.int32)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = ServeExecutor(cfg, slots=2, max_len=96, device=name)
        if name == "cpu":
            ex.set_params(copy.deepcopy(outs["params"]).to("cpu"))
        outs["params"] = ex.params
        reset_launch_counts()
        ids = ex.submit(prompts, max_new=6)
        assert ex.drain() == 3
        if name == "cuda":
            assert launch_counts()["ssd_scan"] == 3 * cfg.num_layers
        outs[name] = [ex.wq.store.blobs[int(t)]["output"] for t in ids]
    assert all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                    outs["cpu"]))


def test_hybrid_serve_on_card_matches_cpu(dev):
    """recurrentgemma smoke (window 8; 70-token prompts, so the prefill's
    window bites and the ring wraps): the RG-LRU scan in every rec layer's
    prefill, flash and ring decode attention in the attention layer; greedy
    outputs on the card equal those of the same weights on the CPU."""
    cfg = smoke_config("recurrentgemma-9b")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 70)).astype(np.int32)
    outs = {}
    for name in ("cuda", "cpu"):
        ex = ServeExecutor(cfg, slots=2, max_len=96, device=name)
        if name == "cpu":
            ex.set_params(copy.deepcopy(outs["params"]).to("cpu"))
        outs["params"] = ex.params
        reset_launch_counts()
        ids = ex.submit(prompts, max_new=6)
        assert ex.drain() == 3
        if name == "cuda":
            counts = launch_counts()
            assert counts["rglru_scan"] == 3 * 2
            assert counts["flash_attention"] == 3
            assert counts["decode_attention"] == 3 * 5
        outs[name] = [ex.wq.store.blobs[int(t)]["output"] for t in ids]
    assert all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                    outs["cpu"]))
