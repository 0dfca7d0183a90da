"""The SSD scan's backward: the plain reverse recurrence
(``ssd_scan_bwd_ref``) on the CPU against ``jax.grad`` of
the reference's ``ssd_chunked`` with the mixer's zero-dt padding (the
reference has no backward of its own: XLA differentiates its dual form), on
the same numpy inputs; a model of the backward kernel's chunked
decomposition (``csrc/ssd_scan_bwd.cu``) in fp64 against the plain backward;
and (marked ``gpu``, skipped without a card) the backward kernel against
the plain backward on the card.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_ssd_scan_bwd.py

Limits: on the CPU 1e-4 of each gradient's largest element (fp32; the
reference's chunked sums against a sequential recurrence, exponents of
cumsums that reach tens); the model 1e-6 (fp64 against the fp32 plain
backward); on the card the forward's rule, 1e-4 of the largest element,
plus one bf16 step of the value for bf16 outputs."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402

CPU_REL_TOL = 1e-4
# ssd_bwd_w's head groups (the blocks of one cluster), from the kernel
HEAD_GROUPS = int(re.search(r"constexpr int kHG = (\d+);", (
    Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/"
    "ssd_scan_bwd.cu").read_text()).group(1))

CASES = [  # batch, S, heads, P, N, chunk, slow decay, final-state gradient
    (2, 37, 4, 8, 16, 16, False, True),    # ragged, B/C shared by 4 heads
    (3, 40, 1, 8, 16, 16, False, False),   # heads_per_bc 1
    (1, 70, 4, 8, 16, 16, True, True),     # slow decay: the carry dominates
    (2, 12, 2, 4, 8, 16, False, True),     # S below one chunk
]


def _inputs(b, s, h, p, n, seed, slow):
    """The mixer's regime: x ~ N(0, 1), B and C ~ N(0, 0.5^2) per batch
    row, dt = softplus(N(0, 1)) and a = -linspace(1, 16) over the heads (the
    A_log init); slow decay: dt ~ 0.01, |a| <= 1. dy and the final state's
    gradient ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    bm = rng.standard_normal((b, s, n)) * 0.5
    cm = rng.standard_normal((b, s, n)) * 0.5
    if slow:
        dt = 0.01 * np.exp(0.1 * rng.standard_normal((b, s, h)))
        a = -rng.uniform(0.1, 1.0, h)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
        a = -np.linspace(1.0, 16.0, h)
    dy = rng.standard_normal((b, s, h, p))
    dst = rng.standard_normal((b, h, p, n))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, dy, dst)]


def _jax_loss(x, dt, a, bm, cm, dy, dst, *, chunk, use_state):
    """<dy, y> (+ <dst, final state>) of the reference's ssd_chunked, padded
    with zero dt to a whole number of chunks as its mixer pads."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        bm = jnp.pad(bm, ((0, 0), (0, pad), (0, 0)))
        cm = jnp.pad(cm, ((0, 0), (0, pad), (0, 0)))
        dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
    y, fin = ssd_chunked(x, dt, a, bm, cm, chunk)
    loss = jnp.sum(y[:, :s] * dy)
    return loss + jnp.sum(fin * dst) if use_state else loss


def _to_port(x, dt, a, bm, cm):
    """The mixer's layout: x [B,S,H,P] -> [BH,S,P], dt -> [BH,S], da = dt
    a, B/C [B,S,N] shared by the H heads of a batch row."""
    b, s, h, p = x.shape
    xs = x.permute(0, 2, 1, 3).reshape(b * h, s, p)
    dts = dt.permute(0, 2, 1).reshape(b * h, s)
    return xs, bm, cm, dts, dts * a.repeat(b)[:, None]


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("b,s,h,p,n,chunk,slow,use_state", CASES)
def test_plain_backward_matches_jax_grad_of_ssd_chunked(b, s, h, p, n, chunk,
                                                        slow, use_state):
    """ssd_scan_bwd_ref (the function the backward kernel is held against)
    on the mixer's layout and da = dt a, its gradients carried back through
    the layout by autograd, against jax.grad with respect to x, dt, a, B
    and C."""
    x, dt, a, bm, cm, dy, dst = _inputs(b, s, h, p, n, seed=s + h, slow=slow)
    grad = jax.jit(jax.grad(_jax_loss, argnums=(0, 1, 2, 3, 4)),
                   static_argnames=("chunk", "use_state"))
    want = grad(*map(jnp.asarray, (x, dt, a, bm, cm, dy, dst)), chunk=chunk,
                use_state=use_state)
    leaves = [torch.as_tensor(v).requires_grad_(True)
              for v in (x, dt, a, bm, cm)]
    port = _to_port(*leaves)
    tdy = torch.as_tensor(dy).permute(0, 2, 1, 3).reshape(b * h, s, p)
    tdst = torch.as_tensor(dst).reshape(b * h, p, n) if use_state else None
    dport = ssd_scan_bwd_ref(*(t.detach() for t in port), tdy, tdst,
                             heads_per_bc=h)
    got = torch.autograd.grad(port, leaves, dport)
    for name, g_, w in zip(("x", "dt", "a", "B", "C"), got, want):
        assert bool((g_ != 0).any()), name
        _close(g_, w, CPU_REL_TOL)


def test_function_takes_cuda_tensors_only():
    """SSDScanFn pairs the two kernels: on CPU tensors it raises, and the
    dispatcher leaves CPU calls to plain autograd through ssd_scan_ref."""
    from repro_torch.kernels.ssd_scan.ops import SSDScanFn
    x = torch.zeros(2, 4, 3, requires_grad=True)
    bc = torch.zeros(1, 4, 5)
    dt = torch.ones(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        SSDScanFn.apply(x, bc, bc, dt, -dt, 4, 2)
    y, _ = kops.ssd_scan(x, bc, bc, dt, -dt, chunk=4, heads_per_bc=2)
    assert y.grad_fn is not None and "SSDScanFn" not in type(
        y.grad_fn).__name__


@pytest.mark.parametrize("g", [1, 3])
def test_plain_backward_matches_autograd(g):
    """ssd_scan_bwd_ref against autograd through ssd_scan_ref, da taken as
    an input of its own (dda directly), with a final-state gradient."""
    rng = np.random.default_rng(g)
    bh, s, p, n = 6, 23, 5, 7
    x = torch.tensor(rng.standard_normal((bh, s, p)), dtype=torch.float32)
    bm, cm = (torch.tensor(rng.standard_normal((bh // g, s, n)),
                           dtype=torch.float32) for _ in range(2))
    dt = torch.tensor(rng.uniform(0.1, 1.0, (bh, s)), dtype=torch.float32)
    da = -dt * torch.tensor(rng.uniform(0.1, 2.0, (bh, 1)),
                            dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (x, bm, cm, dt, da)]
    y, fin = ssd_scan_ref(*leaves, heads_per_bc=g)
    dy, dst = torch.randn_like(y), torch.randn_like(fin)
    want = torch.autograd.grad((y * dy).sum() + (fin * dst).sum(), leaves)
    got = ssd_scan_bwd_ref(x, bm, cm, dt, da, dy, dst, heads_per_bc=g)
    for a_, w in zip(got, want):
        _close(a_, w, 1e-5)


def _chunked_bwd_model(x, bm, cm, dt, da, dy, dstate, g, q):
    """The backward kernel's decomposition (csrc/ssd_scan_bwd.cu), in the
    tensors' dtype and the kernel's order: per (head, chunk) the states
    entering each chunk; dH by the fused reverse walk over chunks (dstate
    seeds the carry, each chunk scales it by exp(cum_end) and adds its own
    term, slot c gets dH_{c+1}); W per B/C row summed over head groups of
    g / HG heads, each group's heads in order and the HG partials in rank
    order; the column sums Cs by 32-row group; dx's state part first, the
    decayed scores times dy added to it; dC and dB as the W product, then
    the state terms head by head; U, and dda as the reverse cumsum
    sum_{i>=k} (dy_i . y_i - Cs_i) + E + sum_{j<k} U_j."""
    bh, s, p = x.shape
    n = bm.shape[-1]
    nch = -(-s // q)
    y, _ = ssd_scan_ref(x, bm, cm, dt, da, heads_per_bc=g)
    y = y.to(x.dtype)
    outs = [torch.zeros_like(t) for t in (x, bm, cm, dt, da)]
    dx, db, dc, ddt, dda = outs
    cum = torch.cat([torch.cumsum(da[:, c:c + q], 1) for c in range(0, s, q)],
                    1)
    sls = [slice(c * q, min(s, c * q + q)) for c in range(nch)]
    enter = torch.zeros(bh, nch, p, n, dtype=x.dtype)
    dh = torch.zeros(bh, nch, p, n, dtype=x.dtype)
    for h in range(bh):
        r, st = h // g, torch.zeros(p, n, dtype=x.dtype)
        for c, sl in enumerate(sls):
            cu = cum[h, sl]
            enter[h, c] = st
            st = torch.exp(cu[-1]) * st + ((dt[h, sl] * torch.exp(
                cu[-1] - cu))[:, None] * x[h, sl]).T @ bm[r, sl]
        acc = dstate[h].clone() if dstate is not None else \
            torch.zeros(p, n, dtype=x.dtype)
        dh[h, nch - 1] = acc
        for c in range(nch - 1, 0, -1):   # chunk 0's own term: unused
            cu = cum[h, sls[c]]
            acc = torch.exp(cu[-1]) * acc + (torch.exp(cu)[:, None] * dy[
                h, sls[c]]).T @ cm[r, sls[c]]
            dh[h, c - 1] = acc
    nrg = 2 * -(-q // 64)   # the column sums' 32-row groups
    for r in range(bh // g):
        for c, sl in enumerate(sls):
            qc = sl.stop - sl.start
            cb = cm[r, sl] @ bm[r, sl].T
            mask = torch.tril(torch.ones(qc, qc, dtype=torch.bool))
            w = torch.zeros(qc, qc, dtype=x.dtype)
            for hg in range(HEAD_GROUPS):
                part = torch.zeros(qc, qc, dtype=x.dtype)
                for h in range(r * g + hg * g // HEAD_GROUPS,
                               r * g + (hg + 1) * g // HEAD_GROUPS):
                    cu = cum[h, sl]
                    dec = torch.where(mask, torch.exp(torch.where(
                        mask, cu[:, None] - cu[None, :], 0.0)), 0.0)
                    wh = (dy[h, sl] @ x[h, sl].T) * dec * dt[h, sl][None, :]
                    part += wh
                    cs = torch.zeros(nrg, qc, dtype=x.dtype)
                    for rg in range(min(nrg, -(-qc // 32))):
                        rows = slice(32 * rg, 32 * rg + 32)
                        cs[rg] = (wh[rows] * cb[rows]).sum(0)
                    f = torch.exp(cu[-1] - cu)
                    st = f[:, None] * (bm[r, sl] @ dh[h, c].T)
                    inner = st + (cb * dec).T @ dy[h, sl]
                    dx[h, sl] = dt[h, sl][:, None] * inner
                    ddt[h, sl] = (x[h, sl] * inner).sum(1)
                    u = dt[h, sl] * (x[h, sl] * st).sum(1)
                    e = torch.exp(cu[-1]) * (dh[h, c] * enter[h, c]).sum()
                    csum = torch.stack([cs[2 * (j // 64):2 * -(-qc // 64)]
                                        .sum(0)[j] for j in range(qc)])
                    v = (dy[h, sl] * y[h, sl]).sum(1) - csum
                    dda[h, sl] = torch.flip(torch.cumsum(torch.flip(
                        v, [0]), 0), [0]) + e + torch.cumsum(u, 0) - u
                w = w + part
            dc[r, sl] = w @ bm[r, sl]
            db[r, sl] = w.T @ cm[r, sl]
            for h in range(r * g, r * g + g):
                cu = cum[h, sl]
                if c > 0:
                    dc[r, sl] += torch.exp(cu)[:, None] * (
                        dy[h, sl] @ enter[h, c])
                db[r, sl] += (dt[h, sl] * torch.exp(cu[-1] - cu))[:, None] \
                    * (x[h, sl] @ dh[h, c])
    return outs


@pytest.mark.parametrize("g,bh,s,p,n,q", [
    (4, 8, 37, 3, 5, 16), (1, 3, 20, 4, 6, 7), (2, 2, 16, 3, 3, 16),
    (2, 4, 10, 3, 5, 16),      # one chunk: S below the chunk
    (2, 4, 150, 3, 5, 70),     # chunks of 70: not whole slabs or tiles
    (1, 2, 90, 80, 96, 64),    # g 1; P past a 64 tile, N short of 128
    (8, 8, 70, 5, 7, 32),      # two heads in each of the 4 head groups
    (3, 6, 50, 4, 6, 16),      # g 3: a head group with no heads
])
def test_kernel_decomposition_matches_plain_backward(g, bh, s, p, n, q):
    """The chunked form the kernel computes (in fp64), in the kernel's
    order, equals the sequential reverse recurrence: ragged chunks, one
    chunk, chunks that are not whole slabs, g 1, g > 1 over the head
    groups, P and N off the tile widths, a final-state gradient."""
    rng = np.random.default_rng(s)
    t = [torch.tensor(v) for v in (
        rng.standard_normal((bh, s, p)), rng.standard_normal((bh // g, s, n)),
        rng.standard_normal((bh // g, s, n)), rng.uniform(0.0, 1.0, (bh, s)))]
    da = -t[3] * torch.tensor(rng.uniform(0.0, 3.0, (bh, 1)))
    dy = torch.tensor(rng.standard_normal((bh, s, p)))
    dst = torch.tensor(rng.standard_normal((bh, p, n)))
    want = ssd_scan_bwd_ref(*t, da, dy, dst, heads_per_bc=g)
    got = _chunked_bwd_model(*t, da, dy, dst, g, q)
    for a_, w in zip(got, want):
        _close(a_, w, 1e-6)


# ------------------------------------------------------------------ card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(rng, bh, s, p, n, g, dtype, dev, slow):
    x = rng.standard_normal((bh, s, p))
    bm = rng.standard_normal((bh // g, s, n)) * 0.5
    cm = rng.standard_normal((bh // g, s, n)) * 0.5
    if slow:
        dt = 0.01 * np.exp(0.1 * rng.standard_normal((bh, s)))
        a = -rng.uniform(0.1, 1.0, (bh, 1))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((bh, s))))
        a = -np.resize(np.linspace(1.0, 16.0, g), bh)[:, None]
    dy = rng.standard_normal((bh, s, p))
    return [torch.as_tensor(v, dtype=torch.float32, device=dev).to(dtype)
            for v in (x, bm, cm, dt, dt * a, dy)]


def _assert_card_close(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    tol = 1e-4 * float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), (what, float(diff.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,p,n,chunk,g,dtype,slow,state", [
    (64, 2048, 64, 128, 256, 64, torch.float32, False, False),  # mamba2, B 1
    (64, 1031, 64, 128, 256, 64, torch.float32, False, True),   # ragged
    (64, 2048, 64, 128, 256, 64, torch.float32, True, True),    # slow decay
    (4, 600, 64, 128, 256, 1, torch.float32, True, False),      # g 1
    (2, 300, 72, 100, 128, 2, torch.float32, False, True),      # P, N past a tile
    (3, 10, 8, 16, 256, 3, torch.float32, False, True),         # S < chunk
    (4, 500, 64, 64, 256, 4, torch.float32, False, False),
    (4, 700, 64, 96, 256, 4, torch.float32, False, True),       # N 96
    (4, 700, 80, 128, 256, 4, torch.float32, False, True),      # P 80
    (8, 2085, 64, 128, 256, 8, torch.float32, False, True),     # 9 chunks
    (2, 1031, 64, 128, 256, 1, torch.float32, True, True),      # g 1, slow
])
def test_ssd_scan_bwd_kernel_equals_plain(dev, bh, s, p, n, chunk, g, dtype,
                                          slow, state):
    rng = np.random.default_rng(s + n + g)
    x, bm, cm, dt, da, dy = _card_inputs(rng, bh, s, p, n, g, dtype, dev,
                                         slow)
    dst = torch.as_tensor(rng.standard_normal((bh, p, n)),
                          dtype=torch.float32, device=dev) if state else None
    y, _, work = ssd_scan_fwd(x, bm, cm, dt, da, chunk=chunk, heads_per_bc=g,
                              return_work=True)
    got = ssd_scan_bwd(x, bm, cm, dt, da, y, work, dy, dst, chunk=chunk,
                       heads_per_bc=g)
    want = ssd_scan_bwd_ref(x, bm, cm, dt, da, dy, dst, heads_per_bc=g)
    torch.cuda.synchronize()
    for name, a_, w in zip(("dx", "dB", "dC", "ddt", "dda"), got, want):
        _assert_card_close(a_, w, name)
    del want
    again = ssd_scan_bwd(x, bm, cm, dt, da, y, work, dy, dst, chunk=chunk,
                         heads_per_bc=g)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))


@pytest.mark.gpu
def test_ssd_scan_bwd_kernel_repeats_are_bit_identical(dev):
    """Ten calls back to back at mamba2's heads (64 a B/C row, BH 64) over
    a ragged S: every output equal to the first call's, bit for bit (no
    atomics; every sum in a fixed order)."""
    rng = np.random.default_rng(7)
    x, bm, cm, dt, da, dy = _card_inputs(rng, 64, 1031, 64, 128, 64,
                                         torch.float32, dev, False)
    dst = torch.as_tensor(rng.standard_normal((64, 64, 128)),
                          dtype=torch.float32, device=dev)
    y, _, work = ssd_scan_fwd(x, bm, cm, dt, da, heads_per_bc=64,
                              return_work=True)
    calls = [ssd_scan_bwd(x, bm, cm, dt, da, y, work, dy, dst,
                          heads_per_bc=64) for _ in range(10)]
    torch.cuda.synchronize()
    for again in calls[1:]:
        assert all(torch.equal(a_, b_) for a_, b_ in zip(calls[0], again))


@pytest.mark.gpu
def test_dispatch_goes_through_the_kernels_when_grad_is_needed(dev):
    rng = np.random.default_rng(2)
    x, bm, cm, dt, da, dy = _card_inputs(rng, 8, 300, 16, 32, 4,
                                         torch.float32, dev, False)
    leaves = [t.requires_grad_(True) for t in (x, bm, cm, dt, da)]
    reset_launch_counts()
    y, fin = kops.ssd_scan(*leaves, chunk=128, heads_per_bc=4)
    y.backward(dy)
    counts = launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    with torch.no_grad():
        want = ssd_scan_bwd_ref(x, bm, cm, dt, da, dy, heads_per_bc=4)
    for name, t, w in zip(("dx", "dB", "dC", "ddt", "dda"), leaves, want):
        _assert_card_close(t.grad, w, name)
    with pytest.raises(RuntimeError):   # the direct call: forward-only
        ssd_scan_fwd(x, bm, cm, dt, da, heads_per_bc=4)
    with torch.no_grad():
        assert kops.ssd_scan(x, bm, cm, dt, da,
                             heads_per_bc=4)[0].grad_fn is None
    # the backward kernel takes fp32 (the mixer scans in fp32): a bf16 call
    # that needs a gradient raises rather than run without one
    with pytest.raises(TypeError, match="fp32"):
        kops.ssd_scan(*(t.detach().to(torch.bfloat16).requires_grad_(True)
                        for t in (x, bm, cm, dt, da)), heads_per_bc=4)
