"""The port's SSD scan (the plain version, reached through ``ops.ssd_scan`` on
CPU tensors) against the reference's Pallas kernel in interpret mode, its
sequential oracle and the model's chunked dual form, on the same numpy
inputs. Tolerance: the reference's own, max |got - ref| / max |ref| < 1e-4.
Also: the shared-B/C layout the model uses equals the per-head layout, and
the chip check's limit rejects a scan that drops the state carried across
chunk boundaries."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _kernel_test_inputs(bh, s, p, n, seed=0):
    """The distributions of the reference's kernel test, made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    b = (rng.standard_normal((bh, s, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bh, s, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, s, 1)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((bh, 1, 1)) * 0.3).astype(np.float32)
    return x, b, c, dt, (dt * a).astype(np.float32)


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (4, 128, 64, 32, 32), (2, 256, 64, 128, 64), (1, 64, 128, 16, 64),
    (2, 200, 64, 16, 64),       # ragged: 3 full chunks and 8 steps
])
def test_ssd_scan_matches_pallas_and_oracle(bh, s, p, n, chunk):
    args = _kernel_test_inputs(bh, s, p, n)
    y, state = kops.ssd_scan(*map(torch.as_tensor, args), chunk=chunk)
    assert y.shape == (bh, s, p) and y.dtype == torch.float32
    assert state.shape == (bh, p, n) and state.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    assert _rel(y, jax_ssd_ref(*jargs)) < TOL
    if s % chunk == 0:          # the Pallas grid floor-divides S
        assert _rel(y, jax_ssd_scan(*jargs, chunk=chunk,
                                    interpret=True)) < TOL


@pytest.mark.parametrize("b,s,h,chunk", [(2, 64, 4, 16), (1, 50, 3, 16)])
def test_final_state_matches_ssd_chunked(b, s, h, chunk):
    """Model layout ([B,S,H,P], B/C once per batch row) against the
    reference model's chunked form; a ragged S is zero-dt padded there, as
    its ssd_mixer does."""
    p, n = 8, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    pad = (-s) % chunk
    padded = [np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
              for v in (x, dt, bm, cm)]
    jy, jfin = jax.jit(ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, padded[:2]), jnp.asarray(a),
        *map(jnp.asarray, padded[2:]), chunk)
    xs = x.transpose(0, 2, 1, 3).reshape(b * h, s, p)
    dts = dt.transpose(0, 2, 1).reshape(b * h, s)
    das = dts * np.tile(a, b)[:, None]
    y, fin = kops.ssd_scan(*map(torch.as_tensor, (xs, bm, cm, dts, das)),
                           chunk=chunk, heads_per_bc=h)
    y = y.reshape(b, h, s, p).permute(0, 2, 1, 3)
    assert _rel(y, np.asarray(jy)[:, :s]) < TOL
    assert _rel(fin.reshape(b, h, p, n), jfin) < TOL


def test_shared_bc_layout_equals_per_head_layout():
    h = 4
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((2 * h, 40, 8)),
                        dtype=torch.float32)
    bm, cm = (torch.as_tensor(rng.standard_normal((2, 40, 16)),
                              dtype=torch.float32) for _ in range(2))
    dt = torch.rand((2 * h, 40), generator=torch.Generator().manual_seed(0))
    shared = kops.ssd_scan(x, bm, cm, dt, -dt, chunk=16, heads_per_bc=h)
    rep = kops.ssd_scan(x, bm.repeat_interleave(h, 0),
                        cm.repeat_interleave(h, 0), dt, -dt, chunk=16)
    assert torch.equal(shared[0], rep[0]) and torch.equal(shared[1], rep[1])


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_per_chunk(x, bm, cm, dt, da, *, chunk, heads_per_bc):
    """A stand-in for a kernel that drops the carried state: each chunk
    starts from h = 0."""
    ys, st = [], None
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        y, st = ssd_scan_ref(x[:, sl], bm[:, sl], cm[:, sl], dt[:, sl],
                             da[:, sl], heads_per_bc=heads_per_bc)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def test_chip_limit_rejects_a_scan_without_carry(chip_smoke):
    """The chip check's slow-decay case, cut to a CPU size (BH 8, S 1024,
    chunk 256): the plain version passes its limit, a scan that resets the
    state at each chunk boundary misses it by more than 100x."""
    h, chunk = 4, 256
    args = chip_smoke.ssd_inputs(np.random.default_rng(3), 2 * h, 1024, 16,
                                 32, h, slow=True)
    ref = ssd_scan_ref(*args, heads_per_bc=h)
    assert chip_smoke.ssd_error(ref, ref)["err_over_tol"] == 0.0
    bad = _reset_per_chunk(*args, chunk=chunk, heads_per_bc=h)
    err = chip_smoke.ssd_error(bad, ref)
    assert err["y_err"]["err_over_tol"] > 100
    assert err["state_err"]["err_over_tol"] > 100


def test_bound_counts_shared_scores_once(chip_smoke):
    """The bound of the serve shape (BH 64, S 1000, P 64, N 128, chunk 256,
    B/C shared): C.B^T counted once per batch row, lower triangle only."""
    ops, nbytes = chip_smoke.ssd_ops_bytes(64, 1000, 64, 128, 256, 64,
                                           torch.float32)
    pairs = 3 * 256 * 257 // 2 + 232 * 233 // 2
    assert ops == 2.0 * (pairs * 128 + 64 * pairs * 64
                         + 64 * (1000 - 256 + 1000) * 128 * 64)
    assert nbytes == 4 * (2 * 64 * 1000 * 64 + 2 * 1000 * 128
                          + 2 * 64 * 1000 + 64 * 64 * 128)


def _tf32(a):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: the magnitude's bits plus
    half of the last kept bit, then the 13 low bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mm_fp32(a, b):
    return np.matmul(a.astype(np.float32), b.astype(np.float32))


def _mm_tf32(a, b):
    """One TF32 product on the tensor cores: operands rounded to TF32,
    products exact, sums in fp32."""
    return np.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a, b):
    """The kernel's 3xTF32: each operand split into a TF32 high part and a
    TF32 remainder; lo.hi + hi.lo + hi.hi summed in fp32."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return np.matmul(al, bh) + np.matmul(ah, bl) + np.matmul(ah, bh)


def ssd_chunk_parallel(x, bm, cm, dt, da, *, chunk, heads_per_bc=1,
                       mm=_mm_fp32):
    """The kernel's decomposition in numpy (fp32 values, fp64 cumsums and
    decay exponents, products through ``mm``): per chunk, the scores C B^T
    once per B/C row and each head's own state contribution
    sum_j w_j x_j^T B_j; then the scan over chunks passes the state; then
    each chunk's output from the entering state plus the masked, decayed
    scores times x. Returns (y, final state) like ``ssd_scan_ref``."""
    x = np.asarray(x, np.float32)
    bm, cm = np.asarray(bm, np.float32), np.asarray(cm, np.float32)
    bh, s, p = x.shape
    n, g = bm.shape[-1], heads_per_bc
    dt = np.asarray(dt, np.float32).reshape(bh, s)
    da = np.asarray(da, np.float32).reshape(bh, s)
    q = min(chunk, s)
    starts = list(range(0, s, q))
    rows = np.arange(bh) // g
    scores, own, gdec, dacs = [], [], [], []
    for c0 in starts:                      # chunk-parallel phase
        sl = slice(c0, c0 + q)
        scores.append(mm(cm[:, sl], bm[:, sl].transpose(0, 2, 1)))
        dac = np.cumsum(da[:, sl].astype(np.float64), axis=1)
        dacs.append(dac)
        w = dt[:, sl] * np.exp((dac[:, -1:] - dac).astype(np.float32))
        own.append(mm((w[..., None] * x[:, sl]).transpose(0, 2, 1),
                      bm[rows, sl]))       # [bh, P, N]
        gdec.append(np.exp(dac[:, -1].astype(np.float32)))
    state = np.zeros((bh, p, n), np.float32)
    enter = []
    for c in range(len(starts)):           # the sequential pass
        enter.append(state)
        state = gdec[c][:, None, None] * state + own[c]
    ys = []
    for c, c0 in enumerate(starts):        # chunk-parallel outputs
        sl = slice(c0, c0 + q)
        dac = dacs[c]
        qc = dac.shape[1]
        diff = dac[:, :, None] - dac[:, None, :]
        mask = np.tril(np.ones((qc, qc), bool))
        decay = np.exp(np.where(mask, diff, -np.inf).astype(np.float32))
        m = scores[c][rows] * decay * dt[:, None, sl]
        y = mm(m, x[:, sl])
        y += np.exp(dac.astype(np.float32))[..., None] * mm(
            cm[rows, sl], enter[c].transpose(0, 2, 1))
        ys.append(y)
    return np.concatenate(ys, axis=1), state


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (4, 128, 64, 32, 32), (2, 256, 64, 128, 64), (1, 64, 128, 16, 64),
    (2, 200, 64, 16, 64),       # ragged: 3 full chunks and 8 steps
])
def test_chunk_parallel_model_matches_ref_and_pallas(bh, s, p, n, chunk):
    """The kernel's decomposition (fp32 products) against the plain
    version, the reference's oracle and its Pallas kernel."""
    args = _kernel_test_inputs(bh, s, p, n)
    y, state = ssd_chunk_parallel(*args, chunk=chunk)
    ry, rstate = ssd_scan_ref(*map(torch.as_tensor, args))
    assert _rel(y, ry) < TOL and _rel(state, rstate) < TOL
    jargs = [jnp.asarray(a) for a in args]
    assert _rel(y, jax_ssd_ref(*jargs)) < TOL
    if s % chunk == 0:
        assert _rel(y, jax_ssd_scan(*jargs, chunk=chunk,
                                    interpret=True)) < TOL


def _cut_cases(chip_smoke):
    """CPU-sized cuts of the chip check's serve case (B/C shared by 8
    heads, S 600 over 3 chunks of 256, the last ragged) and its slow-decay
    case (S 1024, 4 chunks), with the chip's inputs."""
    rng = np.random.default_rng(4)
    serve = chip_smoke.ssd_inputs(rng, 8, 600, 64, 128, 8)
    slow = chip_smoke.ssd_inputs(rng, 8, 1024, 32, 64, 8, slow=True)
    return {"serve": serve, "slow_decay": slow}


@pytest.mark.parametrize("case", ["serve", "slow_decay"])
def test_chunk_parallel_model_passes_chip_limit(chip_smoke, case):
    args = _cut_cases(chip_smoke)[case]
    ref = ssd_scan_ref(*args, heads_per_bc=8)
    got = ssd_chunk_parallel(*[a.numpy() for a in args], chunk=256,
                             heads_per_bc=8)
    err = chip_smoke.ssd_error(tuple(map(torch.as_tensor, got)), ref)
    assert err["err_over_tol"] <= 0.1


@pytest.mark.parametrize("case", ["serve", "slow_decay"])
def test_3xtf32_holds_chip_limit_and_tf32_does_not(chip_smoke, case):
    """Why the kernel splits each operand: with every product emulated as
    3xTF32 the decomposition stays well inside the chip check's limit
    (1e-4 of max |ref| per element); with one TF32 product it misses it."""
    args = _cut_cases(chip_smoke)[case]
    ref = ssd_scan_ref(*args, heads_per_bc=8)
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        got = ssd_chunk_parallel(*[a.numpy() for a in args], chunk=256,
                                 heads_per_bc=8, mm=mm)
        errs[name] = chip_smoke.ssd_error(tuple(map(torch.as_tensor, got)),
                                          ref)["err_over_tol"]
    assert errs["3xtf32"] <= 0.1
    assert errs["tf32"] > 1.0
